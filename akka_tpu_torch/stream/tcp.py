"""TCP as stream stages: Tcp().outgoing_connection / Tcp().bind.

A copy of `akka_tpu/stream/tcp.py` at commit 43876c4 (host code, no
jax; the port keeps its own copy of every module it needs).
`ServerBinding.unbind()` returns a Future that completes once the
listener's socket is closed (`ServerBinding.unbound`); the reference's
returns None and closes later. A bind stage that stops without an unbind
(cancelled, failed) unbinds its listener all the same, and the adapter
that waits for the `Unbound` stops itself when it comes.

Reference parity: akka-stream/src/main/scala/akka/stream/scaladsl/Tcp.scala
(outgoingConnection :105, bind :210-245, IncomingConnection.handleWith) and
impl/io/TcpStages.scala — here the stages ride the actor-IO layer
(akka_tpu/io/tcp.py, the io/TcpConnection.scala analogue): an adapter actor
registers as the connection handler and feeds the GraphStage through async
callbacks, so the selector loop, write-ack flow control, and close protocol
are shared with the actor API rather than duplicated.

Backpressure: writes are ack-gated (one Write in flight — the stage pulls
upstream only after the connection acks, io/TcpConnection.scala ack
semantics); reads buffer in the stage and are pushed on demand.
"""

from __future__ import annotations

import itertools
import threading
from collections import deque
from concurrent.futures import Future
from typing import Any, Optional, Tuple

from ..actor.actor import Actor
from ..actor.props import Props
from ..io import tcp as iotcp
from .dsl import Flow, Keep, Materializer, Sink, Source, _Builder
from .stage import (FlowShape, GraphStage, GraphStageLogic, Inlet, Outlet,
                    SourceShape, make_in_handler, make_out_handler)

_counter = itertools.count()

_ACK = object()  # write-ack token (ack-based write flow control)


class OutgoingConnection:
    """Mat value of outgoing_connection (scaladsl Tcp.OutgoingConnection)."""

    def __init__(self, remote_address, local_address):
        self.remote_address = remote_address
        self.local_address = local_address


class ServerBinding:
    """Mat value of bind (scaladsl Tcp.ServerBinding)."""

    def __init__(self, local_address, unbind_fn):
        self.local_address = local_address
        self._unbind = unbind_fn
        self.unbound: Future = Future()  # set once nothing listens

    def unbind(self) -> Future:
        """Close the listener; the Future completes once its socket is
        closed. Connections already accepted stay open."""
        self._unbind()
        return self.unbound


class IncomingConnection:
    """One accepted connection (scaladsl Tcp.IncomingConnection): carries
    the peer address and a Flow[bytes, bytes] joined to the socket."""

    def __init__(self, system, conn_ref, local_address, remote_address):
        self._system = system
        self._conn_ref = conn_ref
        self.local_address = local_address
        self.remote_address = remote_address

    @property
    def flow(self) -> Flow:
        """Flow whose input is bytes to SEND and output is bytes RECEIVED."""
        system, conn = self._system, self._conn_ref
        return Flow.from_graph(
            lambda: _TcpConnectionStage(system, existing=conn))

    def handle_with(self, handler_flow: Flow, system=None) -> Any:
        """Join the connection to a Flow[received -> to-send] (the
        reference's connection.handleWith): received bytes feed the handler,
        its output is written back. Returns the handler's mat value."""
        system = system or self._system
        conn = self._conn_ref

        def build(b: _Builder):
            logic, _ = b.add(_TcpConnectionStage(self._system, existing=conn))
            o2, m2 = handler_flow._build(b, logic.shape.outlets[0])
            b.connect(o2, logic.shape.inlets[0])
            return m2
        return Materializer(getattr(system, "classic", system)).materialize(build)


class _StreamTcpAdapter(Actor):
    """Forwards every connection message (and its sender) into the stage's
    async-callback queue — the Register handler the stage hides behind."""

    def __init__(self, invoke, on_unbound=None):
        super().__init__()
        self._invoke = invoke
        self._on_unbound = on_unbound

    def receive(self, message: Any):
        self._invoke((message, self.sender))
        if self._on_unbound is not None and \
                isinstance(message, iotcp.Unbound):
            # a bind stage's adapter outlives its stage until the
            # listener has answered its Unbind
            self._on_unbound()
            self.context.stop(self.self_ref)


class _TcpConnectionStage(GraphStage):
    """FlowShape stage bound to one TCP connection: IN = bytes to send,
    OUT = bytes received (impl/io/TcpStages.scala TcpStreamLogic).

    Two modes: `connect_to` dials a new connection through the Tcp manager;
    `existing` adopts an already-accepted connection ref (server side)."""

    def __init__(self, system, connect_to: Optional[Tuple[str, int]] = None,
                 existing=None, mat_future: Optional[Future] = None):
        self.name = "TcpConnection"
        self.system = system
        self.connect_to = connect_to
        self.existing = existing
        self.mat_future = mat_future
        self.in_ = Inlet("Tcp.in")
        self.out = Outlet("Tcp.out")
        self._shape = FlowShape(self.in_, self.out)

    @property
    def shape(self):
        return self._shape

    def create_logic(self):
        stage = self
        in_, out = self.in_, self.out
        system = getattr(self.system, "classic", self.system)
        recv: deque = deque()
        st = {"conn": self.existing, "connected": self.existing is not None,
              "await_ack": False, "up_done": False, "read_done": False,
              "closed": False, "adapter": None}

        logic = GraphStageLogic(self._shape)

        def _pump():
            while recv and logic.is_available(out):
                logic.push(out, recv.popleft())
            if st["read_done"] and not recv and not logic.is_closed(out):
                logic.complete(out)
            if st["closed"] and not recv:
                logic.complete_stage()
                return
            # write path: pull upstream once connected and no write pending
            if st["connected"] and not st["await_ack"] and \
                    not st["up_done"] and not logic.has_been_pulled(in_) \
                    and not logic.is_closed(in_):
                logic.pull(in_)

        def _on_event(msg_sender):
            msg, sender = msg_sender
            if isinstance(msg, iotcp.Connected):
                st["conn"] = sender
                st["connected"] = True
                sender.tell(iotcp.Register(st["adapter"],
                                           keep_open_on_peer_closed=True),
                            st["adapter"])
                if stage.mat_future is not None and \
                        not stage.mat_future.done():
                    stage.mat_future.set_result(OutgoingConnection(
                        msg.remote_address, msg.local_address))
                if st["up_done"]:  # upstream already finished pre-connect
                    st["conn"].tell(iotcp.ConfirmedClose(), st["adapter"])
                _pump()
            elif isinstance(msg, iotcp.Received):
                recv.append(msg.data)
                _pump()
            elif msg is _ACK:
                st["await_ack"] = False
                _pump()
            elif isinstance(msg, iotcp.CommandFailed):
                err = ConnectionError(
                    f"TCP command failed: {msg.cmd!r} {msg.cause}")
                if stage.mat_future is not None and \
                        not stage.mat_future.done():
                    stage.mat_future.set_exception(err)
                logic.fail_stage(err)
            elif isinstance(msg, iotcp.ErrorClosed):
                logic.fail_stage(ConnectionError(str(msg)))
            elif isinstance(msg, iotcp.PeerClosed):
                # half-close: the peer stopped WRITING; our write side stays
                # open (Register keep_open_on_peer_closed=True) — only the
                # read side completes after draining
                st["read_done"] = True
                _pump()
            elif isinstance(msg, (iotcp.Closed, iotcp.ConfirmedClosed,
                                  iotcp.Aborted)):
                st["read_done"] = True
                st["closed"] = True
                _pump()

        cb = logic.get_async_callback(_on_event)

        def pre_start():
            st["adapter"] = system.system_actor_of(
                Props.create(_StreamTcpAdapter, cb.invoke),
                f"stream-tcp-{next(_counter)}")
            if stage.existing is not None:
                # adopt the accepted connection: register as its handler
                stage.existing.tell(
                    iotcp.Register(st["adapter"],
                                   keep_open_on_peer_closed=True),
                    st["adapter"])
            else:
                iotcp.Tcp.get(system).manager.tell(
                    iotcp.Connect(stage.connect_to), st["adapter"])
        logic.pre_start = pre_start  # type: ignore[method-assign]

        def post_stop():
            # the stage can die by cancellation/failure, not only by clean
            # upstream finish: close the socket explicitly or the
            # connection actor + selector registration leak until the peer
            # closes (Close flushes pending writes first)
            if st["conn"] is not None and not st["closed"]:
                st["conn"].tell(iotcp.Close(), st["adapter"])
            if st["adapter"] is not None:
                system.stop(st["adapter"])
        logic.post_stop = post_stop  # type: ignore[method-assign]

        def on_push():
            data = logic.grab(in_)
            st["await_ack"] = True
            st["conn"].tell(iotcp.Write(bytes(data), ack=_ACK), st["adapter"])

        def on_up_finish():
            st["up_done"] = True
            if st["connected"]:
                # half-close: flush writes, FIN, keep reading
                # (io/TcpConnection.scala ConfirmedClose)
                st["conn"].tell(iotcp.ConfirmedClose(), st["adapter"])

        logic.set_handler(in_, make_in_handler(on_push, on_up_finish))
        logic.set_handler(out, make_out_handler(_pump))
        return logic


class _TcpBindSource(GraphStage):
    """SourceShape stage emitting IncomingConnection per accepted socket
    (impl/io/TcpStages.scala ConnectionSourceStage)."""

    def __init__(self, system, local_address: Tuple[str, int],
                 backlog: int, mat_future: Future):
        self.name = "TcpBind"
        self.system = system
        self.local_address = local_address
        self.backlog = backlog
        self.mat_future = mat_future
        self.out = Outlet("TcpBind.connections")
        self._shape = SourceShape(self.out)

    @property
    def shape(self):
        return self._shape

    def create_logic(self):
        stage = self
        out = self.out
        system = getattr(self.system, "classic", self.system)
        pending: deque = deque()
        st = {"adapter": None, "listener": None, "binding": None,
              "unbinding": False}

        logic = GraphStageLogic(self._shape)

        def _pump():
            while pending and logic.is_available(out):
                logic.push(out, pending.popleft())

        def _on_event(msg_sender):
            msg, sender = msg_sender
            if isinstance(msg, iotcp.Bound):
                st["listener"] = sender
                if not stage.mat_future.done():
                    st["binding"] = ServerBinding(msg.local_address,
                                                  _unbind)
                    stage.mat_future.set_result(st["binding"])
            elif isinstance(msg, iotcp.Connected):
                pending.append(IncomingConnection(
                    system, sender, msg.local_address, msg.remote_address))
                _pump()
            elif isinstance(msg, iotcp.CommandFailed):
                err = ConnectionError(f"bind failed: {msg.cause}")
                if not stage.mat_future.done():
                    stage.mat_future.set_exception(err)
                logic.fail_stage(err)
            elif isinstance(msg, iotcp.Unbound):
                logic.complete(out)

        def _unbind():
            if st["listener"] is not None and not st["unbinding"]:
                st["unbinding"] = True
                st["listener"].tell(iotcp.Unbind(), st["adapter"])

        def _unbound():
            b = st["binding"]
            if b is not None and not b.unbound.done():
                b.unbound.set_result(None)

        cb = logic.get_async_callback(_on_event)

        def pre_start():
            st["adapter"] = system.system_actor_of(
                Props.create(_StreamTcpAdapter, cb.invoke, _unbound),
                f"stream-tcp-bind-{next(_counter)}")
            iotcp.Tcp.get(system).manager.tell(
                iotcp.Bind(st["adapter"], stage.local_address,
                           stage.backlog), st["adapter"])
        logic.pre_start = pre_start  # type: ignore[method-assign]

        def post_stop():
            _unbind()
            b = st["binding"]
            # while an Unbind is unanswered its adapter stops itself
            if st["adapter"] is not None and (b is None or b.unbound.done()):
                system.stop(st["adapter"])
        logic.post_stop = post_stop  # type: ignore[method-assign]

        logic.set_handler(out, make_out_handler(_pump))
        return logic


class Tcp:
    """Stream-TCP entry point (scaladsl Tcp extension)."""

    def __init__(self, system):
        self.system = system

    @staticmethod
    def get(system) -> "Tcp":
        return Tcp(system)

    def outgoing_connection(self, host: str, port: int) -> Flow:
        """Flow[bytes -> bytes] over a new connection; mat value is a
        Future[OutgoingConnection] (scaladsl Tcp.outgoingConnection:105)."""
        system = self.system

        def build(b: _Builder, upstream):
            fut: Future = Future()
            logic, _ = b.add(_TcpConnectionStage(
                system, connect_to=(host, port), mat_future=fut))
            b.connect(upstream, logic.shape.inlets[0])
            return logic.shape.outlets[0], fut
        return Flow(build)

    def bind(self, host: str, port: int, backlog: int = 100) -> Source:
        """Source[IncomingConnection]; mat value is Future[ServerBinding]
        (scaladsl Tcp.bind:210-245)."""
        system = self.system

        def build(b: _Builder):
            fut: Future = Future()
            logic, _ = b.add(_TcpBindSource(system, (host, port), backlog,
                                            fut))
            return logic.shape.outlets[0], fut
        return Source(build)
