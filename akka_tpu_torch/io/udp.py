"""UDP as actors (reference: akka-actor/src/main/scala/akka/io/Udp.scala,
UdpListener.scala, UdpSender.scala): Bind a handler for datagrams, or
SimpleSender for fire-and-forget sends.

A copy of `akka_tpu/io/udp.py` at commit 43876c4 (host code, no
jax; the port keeps its own copy of every module it needs)."""

from __future__ import annotations

import socket
import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

from ..actor.actor import Actor
from ..actor.props import Props
from ..actor.ref import ActorRef
from ..actor.system import ActorSystem
from .tcp import CommandFailed, _SelectorLoop
import selectors


@dataclass(frozen=True)
class UdpBind:
    handler: ActorRef
    local_address: Tuple[str, int]


@dataclass(frozen=True)
class UdpBound:
    local_address: Tuple[str, int]


@dataclass(frozen=True)
class UdpReceived:
    data: bytes
    sender_address: Tuple[str, int]


@dataclass(frozen=True)
class UdpSend:
    data: bytes
    target: Tuple[str, int]


@dataclass(frozen=True)
class SimpleSender:
    pass


@dataclass(frozen=True)
class SimpleSenderReady:
    sender_ref: ActorRef


@dataclass(frozen=True)
class UdpUnbind:
    pass


@dataclass(frozen=True)
class UdpUnbound:
    pass


@dataclass(frozen=True)
class _UdpReadable:
    pass


class UdpListenerActor(Actor):
    def __init__(self, loop: _SelectorLoop, bind: UdpBind, commander: ActorRef):
        super().__init__()
        self.loop = loop
        self.bind = bind
        self.commander = commander
        self.sock: Optional[socket.socket] = None

    def pre_start(self) -> None:
        try:
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(self.bind.local_address)
            s.setblocking(False)
            self.sock = s
        except OSError as e:
            self.commander.tell(CommandFailed(self.bind, str(e)),
                                self.self_ref)
            self.context.stop(self.self_ref)
            return
        self.commander.tell(UdpBound(self.sock.getsockname()), self.self_ref)
        ref, sock = self.self_ref, self.sock

        def cb(key, events):
            ref.tell(_UdpReadable(), None)

        def do():
            self.loop.sel.register(sock, selectors.EVENT_READ, ("udp", cb))
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
        if isinstance(message, _UdpReadable):
            while True:
                try:
                    data, addr = self.sock.recvfrom(65536)
                except (BlockingIOError, InterruptedError):
                    break
                except OSError:
                    break
                self.bind.handler.tell(UdpReceived(data, addr), self.self_ref)
        elif isinstance(message, UdpSend):
            try:
                self.sock.sendto(message.data, message.target)
            except OSError as e:
                self.sender.tell(CommandFailed(message, str(e)), self.self_ref)
        elif isinstance(message, UdpUnbind):
            self.sender.tell(UdpUnbound(), self.self_ref)
            self.context.stop(self.self_ref)
        else:
            return NotImplemented


class UdpSenderActor(Actor):
    def __init__(self):
        super().__init__()
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def post_stop(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    def receive(self, message: Any) -> Any:
        if isinstance(message, UdpSend):
            try:
                self.sock.sendto(message.data, message.target)
            except OSError as e:
                self.sender.tell(CommandFailed(message, str(e)), self.self_ref)
        else:
            return NotImplemented


class UdpManagerActor(Actor):
    def __init__(self, loop: _SelectorLoop):
        super().__init__()
        self.loop = loop

    def receive(self, message: Any) -> Any:
        if isinstance(message, UdpBind):
            self.context.actor_of(Props.create(
                UdpListenerActor, self.loop, message, self.sender))
        elif isinstance(message, SimpleSender):
            ref = self.context.actor_of(Props.create(UdpSenderActor))
            self.sender.tell(SimpleSenderReady(ref), self.self_ref)
        else:
            return NotImplemented


class Udp:
    """Udp.get(system).manager (reference: Udp.scala extension)."""

    _instances: Dict[ActorSystem, "Udp"] = {}
    _lock = threading.Lock()

    @staticmethod
    def get(system: ActorSystem) -> "Udp":
        with Udp._lock:
            inst = Udp._instances.get(system)
            if inst is None:
                inst = Udp._instances[system] = Udp(system)
                system.register_on_termination(inst._shutdown)
            return inst

    def __init__(self, system: ActorSystem):
        self.system = system
        from .tcp import Tcp
        self.loop = Tcp.get(system).loop  # share the IO thread
        self.manager = system.system_actor_of(
            Props.create(UdpManagerActor, self.loop), "IO-UDP")

    def _shutdown(self) -> None:
        Udp._instances.pop(self.system, None)
