"""Transports: the host control-plane wire (TCP + in-process).

A copy of `akka_tpu/remote/transport.py` at commit 56e9e23 (host code, no jax;
the port keeps its own copy of every module it needs). One change:
`shutdown()` joins the threads the transport started (the in-proc
listener's drain thread; the TCP accept thread and every read thread, whose
sockets it closes first), each within 5 s; the reference's shutdown joins
none of them.

Reference parity: akka-remote Artery transports — TCP framing
(remote/artery/tcp/ArteryTcpTransport.scala, TcpFraming.scala) and the
scriptable TestTransport (remote/transport/TestTransport.scala). The in-proc
transport doubles as the multi-node testkit's fault-injectable link
(ThrottlerTransportAdapter.scala:212 / FailureInjectorTransportAdapter.scala:65
semantics via FaultInjector).

On the card the DATA plane is the step's delivery (batched/), and across
ranks the sharded step's all_to_all_single (batched/sharded.py); these
transports carry the control plane
(membership gossip, remote watch, system messages) the way Artery's control
lane does (ArteryTransport.scala:383-397).
"""

from __future__ import annotations


import queue
import socket
import struct
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

from ..actor.path import Address

_LEN = struct.Struct(">I")


_ENV_HEAD = struct.Struct(">HBBiqqq")   # magic, version, flags, sid, uid, seq, ack
_ENV_MAGIC = 0xAF7A
# version 2 added the flag-bit2 reserved metadata section (RemoteInstrument
# header space); a v1 peer would misparse the count byte as a string length,
# so the layout change rides a version bump and v1 frames are still readable
_ENV_VERSION = 2
_LANES = ("ordinary", "control", "large")


@dataclass
class WireEnvelope:
    """What crosses the wire (reference: artery Codecs.scala EnvelopeBuffer
    layout — recipient, sender, serializer id, class manifest, payload; plus
    the system-message seq/ack channel of SystemMessageDelivery.scala).

    Fixed binary layout — NO pickle at the framing layer:
      >H magic  >B version  >B flags(bit0 is_system, bit2 metadata present,
      bits4-5 lane)  >i serializer_id  >q from_uid  >q seq(-1=None)
      >q ack(-1=None); when flag bit2: the RESERVED METADATA SECTION —
      >B entry count, then per entry >B key >I length + bytes (the
      RemoteInstrument header space, artery Codecs/EnvelopeBuffer metadata
      block; keys 1..31 belong to instruments); then length-prefixed
      UTF-8: recipient, sender(flag bit1 = present), manifest,
      from_address; length-prefixed payload bytes."""

    recipient: str                 # serialization-format path
    sender: Optional[str]
    serializer_id: int
    manifest: str
    payload: bytes
    is_system: bool = False
    seq: Optional[int] = None      # system-message sequence number
    ack: Optional[int] = None      # cumulative ack
    from_address: str = ""
    from_uid: int = 0
    lane: str = "ordinary"         # control | ordinary | large
    metadata: Optional[Dict[int, bytes]] = None  # instrument key -> bytes

    def to_bytes(self) -> bytes:
        flags = (1 if self.is_system else 0) | \
                (2 if self.sender is not None else 0) | \
                (4 if self.metadata else 0) | \
                (_LANES.index(self.lane) << 4)
        # the v1 and v2 layouts are identical when flag bit2 is clear, so
        # metadata-free frames are stamped v1 — a rolling upgrade keeps
        # working in BOTH directions until an instrument actually writes
        # metadata (the v2 stamp is reserved for frames that carry it)
        version = _ENV_VERSION if self.metadata else 1
        parts = [_ENV_HEAD.pack(
            _ENV_MAGIC, version, flags, self.serializer_id,
            self.from_uid, -1 if self.seq is None else self.seq,
            -1 if self.ack is None else self.ack)]
        if self.metadata:
            parts.append(struct.pack(">B", len(self.metadata)))
            for key, blob in sorted(self.metadata.items()):
                parts.append(struct.pack(">B", key))
                parts.append(_LEN.pack(len(blob)))
                parts.append(blob)
        for s in (self.recipient, self.sender or "", self.manifest,
                  self.from_address):
            b = s.encode("utf-8")
            parts.append(_LEN.pack(len(b)))
            parts.append(b)
        parts.append(_LEN.pack(len(self.payload)))
        parts.append(self.payload)
        return b"".join(parts)

    @staticmethod
    def from_bytes(data: bytes) -> "WireEnvelope":
        magic, version, flags, sid, uid, seq, ack = _ENV_HEAD.unpack_from(data, 0)
        if magic != _ENV_MAGIC:
            raise ValueError(f"bad envelope magic 0x{magic:04x}")
        if not 1 <= version <= _ENV_VERSION:
            raise ValueError(f"unsupported envelope version {version}")
        off = _ENV_HEAD.size
        metadata = None
        if version >= 2 and flags & 4:
            (count,) = struct.unpack_from(">B", data, off)
            off += 1
            metadata = {}
            for _ in range(count):
                (key,) = struct.unpack_from(">B", data, off)
                off += 1
                (n,) = _LEN.unpack_from(data, off)
                off += 4
                metadata[key] = data[off:off + n]
                off += n
        strings = []
        for _ in range(4):
            (n,) = _LEN.unpack_from(data, off)
            off += 4
            strings.append(data[off:off + n].decode("utf-8"))
            off += n
        (n,) = _LEN.unpack_from(data, off)
        off += 4
        payload = data[off:off + n]
        if len(payload) != n:
            raise ValueError("truncated envelope payload")
        recipient, sender_s, manifest, from_address = strings
        return WireEnvelope(
            recipient=recipient,
            sender=sender_s if flags & 2 else None,
            serializer_id=sid, manifest=manifest, payload=payload,
            is_system=bool(flags & 1),
            seq=None if seq < 0 else seq,
            ack=None if ack < 0 else ack,
            from_address=from_address, from_uid=uid,
            lane=_LANES[(flags >> 4) & 3],
            metadata=metadata)


InboundHandler = Callable[[WireEnvelope], None]


class Transport:
    scheme = "akka"

    def listen(self, host: str, port: int, handler: InboundHandler) -> Tuple[str, int]:
        raise NotImplementedError

    def send(self, host: str, port: int, envelope: WireEnvelope) -> bool:
        raise NotImplementedError

    def shutdown(self) -> None:
        pass


class FaultInjector:
    """Per-link fault injection (reference: TestConductor throttle/blackhole,
    remote/testconductor/Conductor.scala:128,148)."""

    def __init__(self):
        self._modes: Dict[Tuple[str, str], Any] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _key(a: str, b: str) -> Tuple[str, str]:
        return (a, b)

    def blackhole(self, from_addr: str, to_addr: str) -> None:
        with self._lock:
            self._modes[(from_addr, to_addr)] = "blackhole"

    def throttle(self, from_addr: str, to_addr: str, rate_msgs_per_sec: float) -> None:
        with self._lock:
            self._modes[(from_addr, to_addr)] = ("throttle", rate_msgs_per_sec, [0.0])

    def pass_through(self, from_addr: str, to_addr: str) -> None:
        with self._lock:
            self._modes.pop((from_addr, to_addr), None)

    def reset(self) -> None:
        with self._lock:
            self._modes.clear()

    def allow(self, from_addr: str, to_addr: str) -> bool:
        """False -> drop; may sleep for throttling."""
        with self._lock:
            mode = self._modes.get((from_addr, to_addr))
        if mode is None:
            return True
        if mode == "blackhole":
            return False
        if isinstance(mode, tuple) and mode[0] == "throttle":
            _, rate, last = mode
            now = time.monotonic()
            min_gap = 1.0 / max(rate, 1e-9)
            if now - last[0] < min_gap:
                time.sleep(min_gap - (now - last[0]))
            last[0] = time.monotonic()
            return True
        return True


class InProcTransport(Transport):
    """Process-local 'network': multi-node tests run N systems in one process
    with real serialization + fault injection, no sockets."""

    _registry: Dict[Tuple[str, int], InboundHandler] = {}
    _reg_lock = threading.Lock()
    _port_counter = [20000]
    fault_injector = FaultInjector()

    _registry_queues: Dict[Tuple[str, int], "queue.Queue[Optional[WireEnvelope]]"] = {}

    def __init__(self, local_address: str = ""):
        self.local_address = local_address
        self._bound: Optional[Tuple[str, int]] = None
        self._down = False
        self._drain_thread: Optional[threading.Thread] = None

    def listen(self, host: str, port: int, handler: InboundHandler) -> Tuple[str, int]:
        with self._reg_lock:
            if port == 0:
                self._port_counter[0] += 1
                port = self._port_counter[0]
            if (host, port) in self._registry:
                raise OSError(f"inproc address {host}:{port} already bound")
            self._registry[(host, port)] = handler
            self._bound = (host, port)
            # one delivery queue + worker per listener: FIFO per link, async
            # w.r.t. the sender (like a real socket's receive path)
            q: "queue.Queue[Optional[WireEnvelope]]" = queue.Queue()
            self._registry_queues[(host, port)] = q

            def _drain():
                while True:
                    env = q.get()
                    if env is None:
                        return
                    try:
                        handler(env)
                    except Exception:  # noqa: BLE001 — bad frame must not kill the loop
                        pass

            self._drain_thread = threading.Thread(
                target=_drain, daemon=True,
                name=f"akka-tpu-inproc-{host}:{port}")
            self._drain_thread.start()
        return host, port

    def send(self, host: str, port: int, envelope: WireEnvelope) -> bool:
        if self._down:  # a dead process sends nothing
            return False
        q = self._registry_queues.get((host, port))
        if q is None:
            return False
        to_addr = f"{host}:{port}"
        if not self.fault_injector.allow(self.local_address, to_addr):
            return False
        q.put(envelope)
        return True

    def shutdown(self) -> None:
        self._down = True
        with self._reg_lock:
            if self._bound is not None:
                self._registry.pop(self._bound, None)
                q = self._registry_queues.pop(self._bound, None)
                if q is not None:
                    q.put(None)
        _join([self._drain_thread], time.monotonic() + _JOIN_S)


class TcpTransport(Transport):
    """Framed TCP: 4-byte big-endian length + binary WireEnvelope. One
    outbound connection per (peer, LANE), kept open — the control /
    ordinary / large lanes each get their own socket so a multi-megabyte
    payload in flight on the large lane cannot head-of-line-block
    heartbeats or ordinary tells (ArteryTransport.scala:383-428 lane
    partitioning; ordering is per-lane, as in Artery).

    The port keeps every thread it starts (the accept loop, one per
    inbound connection) and every inbound socket, so that `shutdown()`
    can close the sockets and join the threads; a shut-down transport
    sends nothing."""

    def __init__(self, local_address: str = ""):
        self.local_address = local_address
        self._server_sock: Optional[socket.socket] = None
        self._conns: Dict[Tuple[str, int, str], socket.socket] = {}
        self._peer_locks: Dict[Tuple[str, int, str], threading.Lock] = {}
        self._conn_lock = threading.Lock()
        self._stop = threading.Event()
        self.fault_injector = FaultInjector()
        self._threads: set = set()        # accept + per-connection readers
        self._inbound: set = set()        # accepted sockets, raw or wrapped

    # TLS seam (SSLEngineProvider.scala:66 createServerSSLEngine /
    # createClientSSLEngine): the plain transport returns sockets as-is
    def _wrap_server(self, conn: socket.socket) -> socket.socket:
        return conn

    def _connect(self, host: str, port: int) -> socket.socket:
        return socket.create_connection((host, port), timeout=5.0)

    def _spawn(self, target, name: str) -> None:
        """Start a daemon thread the transport tracks until it ends."""
        def run():
            try:
                target()
            finally:
                with self._conn_lock:
                    self._threads.discard(threading.current_thread())

        th = threading.Thread(target=run, daemon=True, name=name)
        with self._conn_lock:
            self._threads.add(th)
        th.start()

    def _track(self, conn: socket.socket) -> bool:
        """Keep an inbound socket for shutdown; False (the socket closed)
        once the transport is shutting down."""
        with self._conn_lock:
            if self._stop.is_set():
                _close(conn)
                return False
            self._inbound.add(conn)
            return True

    def listen(self, host: str, port: int, handler: InboundHandler) -> Tuple[str, int]:
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(128)
        self._server_sock = srv
        bound_host, bound_port = srv.getsockname()

        def accept_loop():
            while not self._stop.is_set():
                try:
                    conn, _ = srv.accept()
                except OSError:
                    return
                if not self._track(conn):
                    return

                def start(conn=conn):
                    try:
                        wrapped = self._wrap_server(conn)
                    except Exception:  # noqa: BLE001 — bad/unauthenticated peer
                        with self._conn_lock:
                            self._inbound.discard(conn)
                        _close(conn)
                        return
                    if wrapped is not conn:
                        with self._conn_lock:
                            self._inbound.discard(conn)
                        if not self._track(wrapped):
                            return
                    self._read_loop(wrapped, handler)
                self._spawn(start, f"akka-tpu-tcp-read-{bound_port}")

        self._spawn(accept_loop, f"akka-tpu-tcp-accept-{bound_port}")
        return bound_host, bound_port

    def _read_loop(self, conn: socket.socket, handler: InboundHandler) -> None:
        try:
            buf = b""
            while not self._stop.is_set():
                while len(buf) < 4:
                    chunk = conn.recv(65536)
                    if not chunk:
                        return
                    buf += chunk
                (length,) = _LEN.unpack(buf[:4])
                while len(buf) < 4 + length:
                    chunk = conn.recv(65536)
                    if not chunk:
                        return
                    buf += chunk
                frame, buf = buf[4: 4 + length], buf[4 + length:]
                try:
                    handler(WireEnvelope.from_bytes(frame))
                except Exception:  # noqa: BLE001 — bad frame must not kill the loop
                    pass
        except (OSError, ValueError):  # closed under us: shutdown, reset,
            return                     # or a TLS socket shut down mid-read
        finally:
            with self._conn_lock:
                self._inbound.discard(conn)
            _close(conn)

    def _peer_lock(self, key: Tuple[str, int, str]) -> threading.Lock:
        # per-(peer, lane) lock so a slow/blocked transfer on one lane
        # doesn't stall sends (e.g. failure-detector heartbeats) on others
        with self._conn_lock:
            lock = self._peer_locks.get(key)
            if lock is None:
                lock = self._peer_locks[key] = threading.Lock()
            return lock

    def send(self, host: str, port: int, envelope: WireEnvelope) -> bool:
        if self._stop.is_set():  # a shut-down transport sends nothing
            return False
        if not self.fault_injector.allow(self.local_address, f"{host}:{port}"):
            return False
        data = envelope.to_bytes()
        frame = _LEN.pack(len(data)) + data
        key = (host, port, envelope.lane)
        with self._peer_lock(key):
            sock = self._conns.get(key)
            if sock is None:
                try:
                    sock = self._connect(host, port)
                except OSError:
                    return False
                with self._conn_lock:
                    if self._stop.is_set():
                        _close(sock)
                        return False
                    self._conns[key] = sock
            try:
                sock.sendall(frame)
                return True
            except OSError:
                with self._conn_lock:
                    self._conns.pop(key, None)
                _close(sock)
                return False

    def shutdown(self) -> None:
        with self._conn_lock:
            self._stop.set()
            socks = list(self._conns.values()) + list(self._inbound)
            self._conns.clear()
            self._inbound.clear()
            threads = list(self._threads)
        if self._server_sock is not None:
            _close(self._server_sock)   # wakes the accept loop
        for s in socks:
            _close(s)                   # wakes each read loop
        _join(threads, time.monotonic() + _JOIN_S)


_JOIN_S = 5.0   # the bound on a transport's shutdown joins


def _close(sock: socket.socket) -> None:
    """Shut a socket down both ways (which wakes a thread blocked in its
    accept or recv) and close it."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


def _join(threads, deadline: float) -> None:
    """Join `threads` by `deadline`, except the calling thread."""
    me = threading.current_thread()
    for th in threads:
        if th is not None and th is not me:
            th.join(max(0.0, deadline - time.monotonic()))


@dataclass(frozen=True)
class TlsSettings:
    """PEM-based TLS configuration (reference: artery's
    remote/artery/tcp/ssl/ConfigSSLEngineProvider — key-store/trust-store
    paths + mutual-auth flags; here PEM files via the port's pki instead of
    JKS, which is the idiomatic non-JVM form)."""

    cert_file: str
    key_file: str
    ca_file: str
    require_mutual_auth: bool = True

    @staticmethod
    def from_config(cfg) -> "TlsSettings":
        return TlsSettings(
            cert_file=cfg.get_string("akka.remote.tls.cert-file", ""),
            key_file=cfg.get_string("akka.remote.tls.key-file", ""),
            ca_file=cfg.get_string("akka.remote.tls.ca-file", ""),
            require_mutual_auth=cfg.get_bool(
                "akka.remote.tls.require-mutual-auth", True))


class TlsTcpTransport(TcpTransport):
    """TLS on the wire (reference: remote/artery/tcp/ArteryTcpTransport with
    SSLEngineProvider.scala:66 server/client engines): same framing as
    TcpTransport, sockets wrapped in SSLContext with CA-pinned verification
    and optional mutual auth (client certs REQUIRED by default — a peer
    without a CA-signed cert is rejected during the handshake).

    Certificates/keys are PEM (validated up-front via pki/ so
    misconfiguration fails at system start with a clear error, not at the
    first connection)."""

    def __init__(self, settings: TlsSettings, local_address: str = ""):
        super().__init__(local_address)
        import ssl

        from ..pki import load_certificates, load_private_key

        # fail fast on malformed PEM (PEMDecoder semantics)
        load_certificates(settings.cert_file)
        load_private_key(settings.key_file)
        load_certificates(settings.ca_file)
        self.settings = settings

        srv = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        srv.load_cert_chain(settings.cert_file, settings.key_file)
        srv.load_verify_locations(settings.ca_file)
        srv.verify_mode = (ssl.CERT_REQUIRED if settings.require_mutual_auth
                           else ssl.CERT_NONE)
        self._server_ctx = srv

        cli = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        cli.load_cert_chain(settings.cert_file, settings.key_file)
        cli.load_verify_locations(settings.ca_file)
        # peers are addressed by host:port, not DNS names; trust is the CA
        # pin + (mutual) client certs, as in artery's ConfigSSLEngineProvider
        cli.check_hostname = False
        cli.verify_mode = ssl.CERT_REQUIRED
        self._client_ctx = cli

    def _wrap_server(self, conn: socket.socket) -> socket.socket:
        return self._server_ctx.wrap_socket(conn, server_side=True)

    def _connect(self, host: str, port: int) -> socket.socket:
        raw = socket.create_connection((host, port), timeout=5.0)
        try:
            return self._client_ctx.wrap_socket(raw)
        except Exception:
            try:
                raw.close()
            except OSError:
                pass
            raise OSError("TLS handshake failed")
