"""IO: TCP/UDP/DNS as actors (reference: akka-actor io/ — SURVEY.md §2.1,
"IO (TCP/UDP/DNS): NIO selector-based networking as actors", io/Tcp.scala:40).
One selector thread per system multiplexes sockets; readiness enters the
actor world as messages, so handlers speak the reference protocol
(Connect/Bind/Register/Received/Write/Close...).

A copy of `akka_tpu/io/__init__.py` at commit 43876c4 (host code, no
jax; the port keeps its own copy of every module it needs)."""

from .tcp import (Abort, Aborted, Bind, Bound, Close, Closed,  # noqa: F401
                  CommandFailed, ConfirmedClose, ConfirmedClosed, Connect,
                  Connected, ConnectionClosed, ErrorClosed, PeerClosed,
                  Received, Register, Tcp, Unbind, Unbound, Write,
                  WritingResumed)
from .udp import (SimpleSender, SimpleSenderReady, Udp, UdpBind,  # noqa: F401
                  UdpBound, UdpReceived, UdpSend, UdpUnbind, UdpUnbound)
from .dns import Dns, Resolve, Resolved, ResolveFailed  # noqa: F401

__all__ = [
    "Tcp", "Connect", "Connected", "Bind", "Bound", "Unbind", "Unbound",
    "Register", "Received", "Write", "CommandFailed", "Close",
    "ConfirmedClose", "Abort", "ConnectionClosed", "Closed", "Aborted",
    "ConfirmedClosed", "PeerClosed", "ErrorClosed", "WritingResumed",
    "Udp", "UdpBind", "UdpBound", "UdpReceived", "UdpSend", "SimpleSender",
    "SimpleSenderReady", "UdpUnbind", "UdpUnbound",
    "Dns", "Resolve", "Resolved", "ResolveFailed",
]
