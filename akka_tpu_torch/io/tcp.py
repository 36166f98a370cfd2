"""TCP as actors over a selector loop.

A copy of `akka_tpu/io/tcp.py` at commit 43876c4 (host code, no
jax; the port keeps its own copy of every module it needs). Where the
reference lets threads outlive the system, the port joins them: the
selector thread is joined at the system's termination with no time limit
(the reference gives up after 2 s), and a listener closes its socket on
the selector thread before it answers `Unbind` with `Unbound`, so an
`Unbound` means the port is free (the reference answers first and closes
later).

Reference parity: akka-actor/src/main/scala/akka/io/Tcp.scala (:40 extension,
:596 message surface — Connect/Bind/Register/Received/Write/Close and the
close variants), io/TcpManager.scala, io/TcpListener.scala,
io/TcpOutgoingConnection.scala, io/TcpConnection.scala, driven by a
SelectionHandler (io/SelectionHandler.scala) — here one `selectors`-based IO
thread per Tcp extension instead of the reference's selector-dispatcher
actors; readiness events enter the actor world as plain tells (thread-safe),
so connection actors keep the reference's protocol exactly.
"""

from __future__ import annotations

import collections
import selectors
import socket
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from ..actor.actor import Actor
from ..actor.props import Props
from ..actor.ref import ActorRef
from ..actor.system import ActorSystem


# -- user API messages (reference: Tcp.scala message surface) ----------------

@dataclass(frozen=True)
class Connect:
    remote_address: Tuple[str, int]
    local_address: Optional[Tuple[str, int]] = None
    timeout: float = 10.0


@dataclass(frozen=True)
class Connected:
    remote_address: Tuple[str, int]
    local_address: Tuple[str, int]


@dataclass(frozen=True)
class Bind:
    handler: ActorRef
    local_address: Tuple[str, int]
    backlog: int = 100


@dataclass(frozen=True)
class Bound:
    local_address: Tuple[str, int]


@dataclass(frozen=True)
class Unbind:
    pass


@dataclass(frozen=True)
class Unbound:
    pass


@dataclass(frozen=True)
class Register:
    handler: ActorRef
    keep_open_on_peer_closed: bool = False


@dataclass(frozen=True)
class Received:
    data: bytes


@dataclass(frozen=True)
class Write:
    data: bytes
    ack: Any = None  # if set, sender gets this message once written


@dataclass(frozen=True)
class WritingResumed:
    pass


@dataclass(frozen=True)
class CommandFailed:
    cmd: Any
    cause: str = ""


@dataclass(frozen=True)
class Close:
    pass


@dataclass(frozen=True)
class ConfirmedClose:
    pass


@dataclass(frozen=True)
class Abort:
    pass


class ConnectionClosed:
    pass


@dataclass(frozen=True)
class Closed(ConnectionClosed):
    pass


@dataclass(frozen=True)
class Aborted(ConnectionClosed):
    pass


@dataclass(frozen=True)
class ConfirmedClosed(ConnectionClosed):
    pass


@dataclass(frozen=True)
class PeerClosed(ConnectionClosed):
    pass


@dataclass(frozen=True)
class ErrorClosed(ConnectionClosed):
    cause: str = ""


# -- internal selector events ------------------------------------------------

@dataclass(frozen=True)
class _Readable:
    pass


@dataclass(frozen=True)
class _Writable:
    pass


@dataclass(frozen=True)
class _Acceptable:
    pass


@dataclass(frozen=True)
class _ConnectFinished:
    ok: bool
    error: str = ""


class _SelectorLoop:
    """One IO thread multiplexing all sockets of a Tcp/Udp extension;
    readiness is delivered to owner actors as tells."""

    def __init__(self, name: str):
        self.sel = selectors.DefaultSelector()
        self._lock = threading.Lock()
        self._pending: list = []
        self._stopped = threading.Event()
        self._waker_r, self._waker_w = socket.socketpair()
        self._waker_r.setblocking(False)
        # the write end MUST be nonblocking too: when the pipe is full the
        # loop is already awake, and a blocking send here can deadlock the
        # selector thread against itself (cb -> _set_mask -> execute)
        self._waker_w.setblocking(False)
        self.sel.register(self._waker_r, selectors.EVENT_READ, ("waker", None))
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._thread.start()

    def execute(self, fn) -> None:
        """Run fn on the selector thread (register/modify must happen there)."""
        with self._lock:
            self._pending.append(fn)
        try:
            self._waker_w.send(b"x")
        except OSError:
            pass

    def _run(self) -> None:
        try:
            self._loop()
        finally:
            # the closures posted before the stop (socket closes, Unbound
            # replies) still run once the loop has ended
            with self._lock:
                pending, self._pending = self._pending, []
            for fn in pending:
                try:
                    fn()
                except Exception:  # noqa: BLE001
                    pass

    def _loop(self) -> None:
        while not self._stopped.is_set():
            events = self.sel.select(timeout=0.2)
            with self._lock:
                pending, self._pending = self._pending, []
            for fn in pending:
                try:
                    fn()
                except Exception:  # noqa: BLE001
                    pass
            for key, mask in events:
                kind, cb = key.data
                if kind == "waker":
                    try:
                        while self._waker_r.recv(4096):
                            pass
                    except (BlockingIOError, OSError):
                        pass
                    continue
                try:
                    cb(key, mask)
                except Exception:  # noqa: BLE001
                    pass

    def shutdown(self) -> None:
        self._stopped.set()
        try:
            self._waker_w.send(b"x")
        except OSError:
            pass
        if threading.current_thread() is not self._thread:
            self._thread.join()
        try:
            self.sel.close()
            self._waker_r.close()
            self._waker_w.close()
        except OSError:
            pass


class TcpConnectionActor(Actor):
    """One per connection (reference: io/TcpConnection.scala). Speaks
    Register/Received/Write/Close with its handler."""

    def __init__(self, loop: _SelectorLoop, sock: socket.socket,
                 remote: Tuple[str, int], commander: ActorRef,
                 is_outgoing: bool):
        super().__init__()
        self.loop = loop
        self.sock = sock
        self.remote = remote
        self.commander = commander
        self.is_outgoing = is_outgoing
        self.handler: Optional[ActorRef] = None
        self.keep_open = False
        self._peer_closed = False  # peer EOF seen while keep_open
        self.out_buf: collections.deque = collections.deque()  # (bytes, ack, sender)
        self.closing: Optional[Any] = None
        self._registered = False

    def pre_start(self) -> None:
        self.sock.setblocking(False)
        if self.is_outgoing:
            local = self.sock.getsockname()
            self.commander.tell(Connected(self.remote, local), self.self_ref)
        # reads start only after Register (reference: suspended until then)

    def post_stop(self) -> None:
        self._unregister_and_close()

    def _unregister_and_close(self) -> None:
        sock = self.sock

        def do():
            try:
                self.loop.sel.unregister(sock)
            except (KeyError, ValueError, OSError):
                pass
            try:
                sock.close()
            except OSError:
                pass
        self.loop.execute(do)

    def _interest(self, read: bool, write: bool) -> None:
        mask = (selectors.EVENT_READ if read else 0) | \
               (selectors.EVENT_WRITE if write else 0)
        ref = self.self_ref

        def cb(key, events):
            if events & selectors.EVENT_READ:
                ref.tell(_Readable(), None)
                # pause reads until the actor processed this one (one event
                # per readiness cycle keeps delivery ordered)
                self._set_mask(key.fileobj, selectors.EVENT_WRITE
                               if self.out_buf else 0)
            if events & selectors.EVENT_WRITE:
                ref.tell(_Writable(), None)
                self._set_mask(key.fileobj, selectors.EVENT_READ
                               if self._registered else 0)

        def do():
            try:
                if mask == 0:
                    try:
                        self.loop.sel.unregister(self.sock)
                    except (KeyError, ValueError):
                        pass
                    return
                try:
                    self.loop.sel.modify(self.sock, mask, ("conn", cb))
                except (KeyError, ValueError):
                    self.loop.sel.register(self.sock, mask, ("conn", cb))
            except OSError:
                pass
        self.loop.execute(do)

    def _set_mask(self, sock, mask) -> None:
        def do():
            try:
                if mask == 0:
                    self.loop.sel.unregister(sock)
                else:
                    key = self.loop.sel.get_key(sock)
                    self.loop.sel.modify(sock, mask, key.data)
            except (KeyError, ValueError, OSError):
                pass
        self.loop.execute(do)

    # -- receive -------------------------------------------------------------
    def receive(self, message: Any) -> Any:  # noqa: C901
        if isinstance(message, Register):
            self.handler = message.handler
            self.keep_open = message.keep_open_on_peer_closed
            self._registered = True
            self._interest(read=True, write=bool(self.out_buf))
        elif isinstance(message, Write):
            if self.closing is not None:
                self.sender.tell(CommandFailed(message, "closing"),
                                 self.self_ref)
                return
            self.out_buf.append((message.data, message.ack, self.sender))
            self._try_write()
        elif isinstance(message, _Readable):
            self._do_read()
        elif isinstance(message, _Writable):
            self._try_write()
        elif isinstance(message, Close):
            self.closing = Closed()
            if not self.out_buf:
                self._finish_close()
        elif isinstance(message, ConfirmedClose):
            self.closing = ConfirmedClosed()
            if not self.out_buf:
                try:
                    self.sock.shutdown(socket.SHUT_WR)
                except OSError:
                    pass
        elif isinstance(message, Abort):
            try:
                self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                                     b"\x01\x00\x00\x00\x00\x00\x00\x00")
            except OSError:
                pass
            self._notify_closed(Aborted())
            self.context.stop(self.self_ref)
        else:
            return NotImplemented

    def _do_read(self) -> None:
        try:
            while True:
                data = self.sock.recv(65536)
                if data == b"":
                    # peer closed
                    if isinstance(self.closing, ConfirmedClosed):
                        self._notify_closed(ConfirmedClosed())
                    elif self.keep_open:
                        # half-open: writes continue; read side is done —
                        # drop READ interest (an EOF socket stays
                        # read-ready, so leaving it armed busy-loops the
                        # selector and spams PeerClosed) and remember the
                        # EOF for the eventual ConfirmedClose handshake
                        if not self._peer_closed:
                            self._peer_closed = True
                            if self.handler:
                                self.handler.tell(PeerClosed(),
                                                  self.self_ref)
                        self._interest(read=False,
                                       write=bool(self.out_buf))
                        return
                    else:
                        self._notify_closed(PeerClosed())
                    self.context.stop(self.self_ref)
                    return
                if self.handler is not None:
                    self.handler.tell(Received(data), self.self_ref)
                if len(data) < 65536:
                    break
        except (BlockingIOError, InterruptedError):
            pass
        except OSError as e:
            self._notify_closed(ErrorClosed(str(e)))
            self.context.stop(self.self_ref)
            return
        self._interest(read=True, write=bool(self.out_buf))

    def _try_write(self) -> None:
        while self.out_buf:
            data, ack, sender = self.out_buf[0]
            try:
                n = self.sock.send(data)
            except (BlockingIOError, InterruptedError):
                self._interest(read=self._registered, write=True)
                return
            except OSError as e:
                self._notify_closed(ErrorClosed(str(e)))
                self.context.stop(self.self_ref)
                return
            if n < len(data):
                self.out_buf[0] = (data[n:], ack, sender)
                self._interest(read=self._registered, write=True)
                return
            self.out_buf.popleft()
            if ack is not None and sender is not None:
                sender.tell(ack, self.self_ref)
        if self.closing is not None:
            self._finish_close()

    def _finish_close(self) -> None:
        if isinstance(self.closing, ConfirmedClosed):
            try:
                self.sock.shutdown(socket.SHUT_WR)
            except OSError:
                pass
            if self._peer_closed:
                # the peer's EOF already arrived (keep_open half-open):
                # both directions are now shut — finish immediately, the
                # selector will never re-report the consumed EOF
                self._notify_closed(ConfirmedClosed())
                self.context.stop(self.self_ref)
            return  # wait for peer EOF
        self._notify_closed(self.closing)
        self.context.stop(self.self_ref)

    def _notify_closed(self, event) -> None:
        target = self.handler or self.commander
        if target is not None:
            target.tell(event, self.self_ref)


class TcpListenerActor(Actor):
    """(reference: io/TcpListener.scala)"""

    def __init__(self, loop: _SelectorLoop, bind: Bind, commander: ActorRef):
        super().__init__()
        self.loop = loop
        self.bind = bind
        self.commander = commander
        self.sock: Optional[socket.socket] = None

    def pre_start(self) -> None:
        try:
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(self.bind.local_address)
            s.listen(self.bind.backlog)
            s.setblocking(False)
            self.sock = s
        except OSError as e:
            self.commander.tell(CommandFailed(self.bind, str(e)),
                                self.self_ref)
            self.context.stop(self.self_ref)
            return
        self.commander.tell(Bound(self.sock.getsockname()), self.self_ref)
        ref = self.self_ref

        def cb(key, events):
            ref.tell(_Acceptable(), None)

        sock = self.sock

        def do():
            self.loop.sel.register(sock, selectors.EVENT_READ,
                                   ("listener", cb))
        self.loop.execute(do)

    def post_stop(self) -> None:
        sock = self.sock
        if sock is not None:
            def do():
                try:
                    self.loop.sel.unregister(sock)
                except (KeyError, ValueError, OSError):
                    pass
                try:
                    sock.close()
                except OSError:
                    pass
            self.loop.execute(do)

    def receive(self, message: Any) -> Any:
        if isinstance(message, _Acceptable):
            while self.sock is not None:
                try:
                    conn, addr = self.sock.accept()
                except (BlockingIOError, InterruptedError):
                    break
                except OSError:
                    break
                child = self.context.actor_of(Props.create(
                    TcpConnectionActor, self.loop, conn, addr,
                    self.bind.handler, False))
                self.bind.handler.tell(
                    Connected(addr, conn.getsockname()), child)
        elif isinstance(message, Unbind):
            # close the socket on the selector thread, then answer: an
            # Unbound means nothing listens on the address any more
            sock, self.sock = self.sock, None
            sender, me = self.sender, self.self_ref

            def do():
                try:
                    self.loop.sel.unregister(sock)
                except (KeyError, ValueError, OSError):
                    pass
                try:
                    sock.close()
                except OSError:
                    pass
                if sender is not None:
                    sender.tell(Unbound(), me)
            self.loop.execute(do)
            self.context.stop(self.self_ref)
        else:
            return NotImplemented


class TcpManagerActor(Actor):
    """(reference: io/TcpManager.scala; obtained via Tcp.get(system).manager)"""

    def __init__(self, loop: _SelectorLoop):
        super().__init__()
        self.loop = loop

    def receive(self, message: Any) -> Any:
        if isinstance(message, Connect):
            commander = self.sender
            try:
                s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                if message.local_address:
                    s.bind(message.local_address)
                s.settimeout(message.timeout)
                s.connect(message.remote_address)  # blocking on manager: the
                # reference connects async; acceptable for the host control
                # plane (connect is rare), data path is fully non-blocking
                s.settimeout(0)
            except OSError as e:
                commander.tell(CommandFailed(message, str(e)), self.self_ref)
                return
            self.context.actor_of(Props.create(
                TcpConnectionActor, self.loop, s, message.remote_address,
                commander, True))
        elif isinstance(message, Bind):
            self.context.actor_of(Props.create(
                TcpListenerActor, self.loop, message, self.sender))
        else:
            return NotImplemented


class Tcp:
    """Tcp.get(system).manager (reference: Tcp.scala:40 extension)."""

    _instances: Dict[ActorSystem, "Tcp"] = {}
    _lock = threading.Lock()

    @staticmethod
    def get(system: ActorSystem) -> "Tcp":
        with Tcp._lock:
            inst = Tcp._instances.get(system)
            if inst is None:
                inst = Tcp._instances[system] = Tcp(system)
                system.register_on_termination(inst._shutdown)
            return inst

    def __init__(self, system: ActorSystem):
        self.system = system
        self.loop = _SelectorLoop(f"akka-tpu-io-{system.name}")
        self.manager = system.system_actor_of(
            Props.create(TcpManagerActor, self.loop), "IO-TCP")

    def _shutdown(self) -> None:
        self.loop.shutdown()
        Tcp._instances.pop(self.system, None)
