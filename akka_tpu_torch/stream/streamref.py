"""StreamRefs: source/sink handles that cross the node boundary with
backpressure.

A copy of `akka_tpu/stream/streamref.py` at commit 43876c4 (host code, no
jax; the port keeps its own copy of every module it needs).

Reference parity: akka-stream/src/main/scala/akka/stream/impl/streamref/ —
SinkRefImpl.scala:42,152-161 / SourceRefImpl.scala / StreamRefs.scala and
the wire protocol (StreamRefsProtocol): OnSubscribeHandshake(targetRef),
CumulativeDemand(seqNr), SequencedOnNext(seqNr, payload),
RemoteStreamCompleted(seqNr), RemoteStreamFailure(msg). Demand is
cumulative (the highest seq nr the consumer is ready to receive); data is
at-most-once, a sequence gap fails the stream (InvalidSequenceNumberException
semantics).

Usage (mirrors the reference):
    # origin node: run a stream INTO a sink-ref; ship the SourceRef away
    source_ref = my_source.run_with(StreamRefs.source_ref(), system)
    other_node_actor.tell(("here", source_ref))
    # remote node: turn the handle back into a live Source
    SourceRef.source(source_ref).run_with(Sink.foreach(...), remote_system)

SinkRef is the dual: materialize `StreamRefs.sink_ref()` as a Source, ship
the SinkRef, and the remote runs a stream into it.

Refs serialize as actor paths (ActorRef payload serialization is already
wire-supported), so they work over any transport.
"""

from __future__ import annotations

import collections
import threading
from dataclasses import dataclass
from typing import Any, Optional

from ..actor.actor import Actor
from ..actor.props import Props
from .dsl import Sink, Source
from .stage import (GraphStage, GraphStageLogic, Inlet, Outlet, SinkShape,
                    SourceShape, make_in_handler, make_out_handler)


# -- wire protocol (reference: StreamRefsProtocol) ---------------------------

@dataclass(frozen=True)
class OnSubscribeHandshake:
    target_path: str   # consumer-side partner actor


@dataclass(frozen=True)
class CumulativeDemand:
    seq_nr: int        # consumer ready to receive up to this seq


@dataclass(frozen=True)
class SequencedOnNext:
    seq_nr: int
    payload: Any


@dataclass(frozen=True)
class RemoteStreamCompleted:
    seq_nr: int


@dataclass(frozen=True)
class RemoteStreamFailure:
    message: str


@dataclass(frozen=True)
class SourceRef:
    """Serializable handle to a stream running on the origin node."""
    origin_path: str

    @staticmethod
    def source(ref: "SourceRef") -> Source:
        return Source.from_graph(lambda: _SourceRefStage(ref.origin_path))


@dataclass(frozen=True)
class SinkRef:
    """Serializable handle accepting a stream from a remote node."""
    target_path: str

    @staticmethod
    def sink(ref: "SinkRef") -> Sink:
        return Sink.from_graph(lambda: _SinkRefStage(ref.target_path))


DEMAND_BATCH = 16  # demand window granularity (reference buffers ~32)


class _OriginActor(Actor):
    """Origin-side partner: forwards demand into the stream, relays elements
    out (reference: SinkRefImpl's stage-internal actor, here explicit)."""

    def __init__(self):
        super().__init__()
        self.stage_cb = None          # async callback into the origin stage
        self.early: list = []

    def receive(self, message: Any) -> Any:
        if message == "___bind___":
            pass
        elif isinstance(message, tuple) and message[0] == "___cb___":
            self.stage_cb = message[1]
            for m in self.early:
                self.stage_cb.invoke(m)
            self.early = []
        elif isinstance(message, (OnSubscribeHandshake, CumulativeDemand)):
            if self.stage_cb is None:
                self.early.append(message)
            else:
                self.stage_cb.invoke(message)
        else:
            return NotImplemented


class _SourceRefSinkStage(GraphStage):
    """The Sink materialized on the ORIGIN: its mat value is the SourceRef
    to ship away (reference: StreamRefs.sourceRef() -> Sink[T, SourceRef])."""

    def __init__(self):
        self.name = "SourceRefSink"
        self.in_ = Inlet("SourceRefSink.in")
        self._shape = SinkShape(self.in_)

    @property
    def shape(self):
        return self._shape

    def create_logic_and_mat(self):
        stage = self
        in_ = self.in_
        state = {"partner": None, "demand": 0, "seq": 0, "target": None,
                 "origin_ref": None, "ready": threading.Event()}

        class _L(GraphStageLogic):
            def pre_start(self):
                self.set_keep_going(True)
                system = self.materializer.system
                cb = self.get_async_callback(self._on_remote)
                ref = system.actor_of(Props.create(_OriginActor))
                state["origin_ref"] = ref
                state["ready"].set()
                ref.tell(("___cb___", cb), None)

            def _on_remote(self, msg):
                system = self.materializer.system
                if isinstance(msg, OnSubscribeHandshake):
                    state["target"] = system.provider.resolve_actor_ref(
                        msg.target_path)
                elif isinstance(msg, CumulativeDemand):
                    state["demand"] = max(state["demand"], msg.seq_nr)
                    if not self.has_been_pulled(in_) and \
                            not self.is_closed(in_) and \
                            state["seq"] < state["demand"]:
                        self.pull(in_)
                    if self.is_closed(in_) and state.get("done") is not None:
                        self._flush_done()

            def _flush_done(self):
                if state["target"] is not None:
                    done = state["done"]
                    if done[0] == "complete":
                        state["target"].tell(
                            RemoteStreamCompleted(state["seq"]),
                            state["origin_ref"])
                    else:
                        state["target"].tell(RemoteStreamFailure(done[1]),
                                             state["origin_ref"])
                    self.set_keep_going(False)

            def post_stop(self):
                ref = state["origin_ref"]
                if ref is not None:
                    self.materializer.system.stop(ref)
        logic = _L(self._shape)

        def on_push():
            elem = logic.grab(in_)
            state["seq"] += 1
            if state["target"] is not None:
                state["target"].tell(SequencedOnNext(state["seq"], elem),
                                     state["origin_ref"])
            if state["seq"] < state["demand"] and not logic.is_closed(in_):
                logic.pull(in_)

        def on_finish():
            state["done"] = ("complete",)
            logic._flush_done() if state["target"] is not None else None

        def on_failure(ex):
            state["done"] = ("fail", str(ex))
            if state["target"] is not None:
                logic._flush_done()
            logic.fail_stage(ex)
        logic.set_handler(in_, make_in_handler(on_push, on_finish, on_failure))

        # mat value needs the partner's FULL path (with address) so it
        # resolves from the remote side; computed lazily via a thunk-ref
        class _LazySourceRef:
            def _path(self):
                # the partner actor is spawned in pre_start on the stream's
                # actor thread; wait for materialization to reach it
                if not state["ready"].wait(10.0):
                    raise RuntimeError("stream ref not materialized")
                system = logic.materializer.system
                ref = state["origin_ref"]
                addr = getattr(system.provider, "default_address", None)
                rel = ref.path.to_string_without_address()
                return f"{addr}{rel}" if addr is not None else rel

            def __reduce__(self):
                return (SourceRef, (self._path(),))

            @property
            def origin_path(self):
                return self._path()
        return logic, _LazySourceRef()


class _ConsumerActor(Actor):
    """Consumer-side partner: receives sequenced elements, feeds the stage."""

    def __init__(self):
        super().__init__()
        self.stage_cb = None
        self.early: list = []

    def receive(self, message: Any) -> Any:
        if isinstance(message, tuple) and message[0] == "___cb___":
            self.stage_cb = message[1]
            for m in self.early:
                self.stage_cb.invoke(m)
            self.early = []
        elif isinstance(message, (SequencedOnNext, RemoteStreamCompleted,
                                  RemoteStreamFailure)):
            if self.stage_cb is None:
                self.early.append(message)
            else:
                self.stage_cb.invoke(message)
        else:
            return NotImplemented


class _SourceRefStage(GraphStage):
    """The Source materialized on the CONSUMER from a SourceRef."""

    def __init__(self, origin_path: str):
        self.name = "SourceRef"
        self.origin_path = origin_path
        self.out = Outlet("SourceRef.out")
        self._shape = SourceShape(self.out)

    @property
    def shape(self):
        return self._shape

    def create_logic(self):
        stage = self
        out = self.out
        buf: collections.deque = collections.deque()
        state = {"received": 0, "demanded": 0, "consumer_ref": None,
                 "origin": None, "done": None}

        class _L(GraphStageLogic):
            def pre_start(self):
                system = self.materializer.system
                cb = self.get_async_callback(self._on_remote)
                ref = system.actor_of(Props.create(_ConsumerActor))
                state["consumer_ref"] = ref
                ref.tell(("___cb___", cb), None)
                origin = system.provider.resolve_actor_ref(stage.origin_path)
                state["origin"] = origin
                addr = getattr(system.provider, "default_address", None)
                rel = ref.path.to_string_without_address()
                full = f"{addr}{rel}" if addr is not None else rel
                origin.tell(OnSubscribeHandshake(full), ref)
                self._demand_more()

            def _demand_more(self):
                want = state["received"] + DEMAND_BATCH - len(buf)
                if want > state["demanded"]:
                    state["demanded"] = want
                    state["origin"].tell(CumulativeDemand(want),
                                         state["consumer_ref"])

            def _on_remote(self, msg):
                if isinstance(msg, SequencedOnNext):
                    if msg.seq_nr != state["received"] + 1:
                        self.fail(out, RuntimeError(
                            f"invalid sequence nr {msg.seq_nr}, expected "
                            f"{state['received'] + 1} (at-most-once "
                            f"transport dropped a frame)"))
                        return
                    state["received"] = msg.seq_nr
                    if self.is_available(out) and not buf:
                        self.push(out, msg.payload)
                    else:
                        buf.append(msg.payload)
                    self._demand_more()
                elif isinstance(msg, RemoteStreamCompleted):
                    state["done"] = ("complete",)
                    if not buf:
                        self.complete(out)
                elif isinstance(msg, RemoteStreamFailure):
                    self.fail(out, RuntimeError(
                        f"remote stream failed: {msg.message}"))

            def post_stop(self):
                ref = state["consumer_ref"]
                if ref is not None:
                    self.materializer.system.stop(ref)
        logic = _L(self._shape)

        def on_pull():
            if buf:
                logic.push(out, buf.popleft())
                logic._demand_more()
            if state["done"] is not None and not buf:
                logic.complete(out)
        logic.set_handler(out, make_out_handler(on_pull))
        return logic


class _SinkRefSourceStage(GraphStage):
    """The Source materialized LOCALLY whose mat is a SinkRef for a remote
    producer (reference: StreamRefs.sinkRef() -> Source[T, SinkRef])."""

    def __init__(self):
        self.name = "SinkRefSource"
        self.out = Outlet("SinkRefSource.out")
        self._shape = SourceShape(self.out)

    @property
    def shape(self):
        return self._shape

    def create_logic_and_mat(self):
        out = self.out
        buf: collections.deque = collections.deque()
        state = {"received": 0, "demanded": 0, "consumer_ref": None,
                 "producer": None, "done": None,
                 "ready": threading.Event()}

        class _L(GraphStageLogic):
            def pre_start(self):
                system = self.materializer.system
                cb = self.get_async_callback(self._on_remote)
                ref = system.actor_of(Props.create(_SinkTargetActor))
                state["consumer_ref"] = ref
                state["ready"].set()
                ref.tell(("___cb___", cb), None)

            def _demand_more(self):
                if state["producer"] is None:
                    return
                want = state["received"] + DEMAND_BATCH - len(buf)
                if want > state["demanded"]:
                    state["demanded"] = want
                    state["producer"].tell(CumulativeDemand(want),
                                           state["consumer_ref"])

            def _on_remote(self, msg):
                system = self.materializer.system
                if isinstance(msg, OnSubscribeHandshake):
                    state["producer"] = system.provider.resolve_actor_ref(
                        msg.target_path)
                    self._demand_more()
                elif isinstance(msg, SequencedOnNext):
                    if msg.seq_nr != state["received"] + 1:
                        self.fail(out, RuntimeError(
                            f"invalid sequence nr {msg.seq_nr}"))
                        return
                    state["received"] = msg.seq_nr
                    if self.is_available(out) and not buf:
                        self.push(out, msg.payload)
                    else:
                        buf.append(msg.payload)
                    self._demand_more()
                elif isinstance(msg, RemoteStreamCompleted):
                    state["done"] = ("complete",)
                    if not buf:
                        self.complete(out)
                elif isinstance(msg, RemoteStreamFailure):
                    self.fail(out, RuntimeError(msg.message))

            def post_stop(self):
                ref = state["consumer_ref"]
                if ref is not None:
                    self.materializer.system.stop(ref)
        logic = _L(self._shape)

        def on_pull():
            if buf:
                logic.push(out, buf.popleft())
                logic._demand_more()
            if state["done"] is not None and not buf:
                logic.complete(out)
        logic.set_handler(out, make_out_handler(on_pull))

        class _LazySinkRef:
            def _path(self):
                if not state["ready"].wait(10.0):
                    raise RuntimeError("stream ref not materialized")
                system = logic.materializer.system
                ref = state["consumer_ref"]
                addr = getattr(system.provider, "default_address", None)
                rel = ref.path.to_string_without_address()
                return f"{addr}{rel}" if addr is not None else rel

            def __reduce__(self):
                return (SinkRef, (self._path(),))

            @property
            def target_path(self):
                return self._path()
        return logic, _LazySinkRef()


class _SinkTargetActor(_ConsumerActor):
    """Also accepts the handshake (the remote producer initiates it)."""

    def receive(self, message: Any) -> Any:
        if isinstance(message, OnSubscribeHandshake):
            if self.stage_cb is None:
                self.early.append(message)
            else:
                self.stage_cb.invoke(message)
            return None
        return super().receive(message)


class _SinkRefStage(GraphStage):
    """The Sink materialized on the PRODUCER side from a shipped SinkRef:
    initiates the handshake then pushes on demand."""

    def __init__(self, target_path: str):
        self.name = "SinkRef"
        self.target_path = target_path
        self.in_ = Inlet("SinkRef.in")
        self._shape = SinkShape(self.in_)

    @property
    def shape(self):
        return self._shape

    def create_logic(self):
        stage = self
        in_ = self.in_
        state = {"target": None, "demand": 0, "seq": 0, "origin_ref": None,
                 "done": None}

        class _L(GraphStageLogic):
            def pre_start(self):
                self.set_keep_going(True)
                system = self.materializer.system
                cb = self.get_async_callback(self._on_remote)
                ref = system.actor_of(Props.create(_OriginActor))
                state["origin_ref"] = ref
                ref.tell(("___cb___", cb), None)
                state["target"] = system.provider.resolve_actor_ref(
                    stage.target_path)
                addr = getattr(system.provider, "default_address", None)
                rel = ref.path.to_string_without_address()
                full = f"{addr}{rel}" if addr is not None else rel
                state["target"].tell(OnSubscribeHandshake(full), ref)

            def _on_remote(self, msg):
                if isinstance(msg, CumulativeDemand):
                    state["demand"] = max(state["demand"], msg.seq_nr)
                    if not self.has_been_pulled(in_) and \
                            not self.is_closed(in_) and \
                            state["seq"] < state["demand"]:
                        self.pull(in_)
                    if state["done"] is not None:
                        self._flush_done()

            def _flush_done(self):
                done = state["done"]
                if done[0] == "complete":
                    state["target"].tell(RemoteStreamCompleted(state["seq"]),
                                         state["origin_ref"])
                else:
                    state["target"].tell(RemoteStreamFailure(done[1]),
                                         state["origin_ref"])
                self.set_keep_going(False)

            def post_stop(self):
                ref = state["origin_ref"]
                if ref is not None:
                    self.materializer.system.stop(ref)
        logic = _L(self._shape)

        def on_push():
            elem = logic.grab(in_)
            state["seq"] += 1
            state["target"].tell(SequencedOnNext(state["seq"], elem),
                                 state["origin_ref"])
            if state["seq"] < state["demand"] and not logic.is_closed(in_):
                logic.pull(in_)

        def on_finish():
            state["done"] = ("complete",)
            logic._flush_done()

        def on_failure(ex):
            state["done"] = ("fail", str(ex))
            logic._flush_done()
            logic.fail_stage(ex)
        logic.set_handler(in_, make_in_handler(on_push, on_finish, on_failure))
        return logic


class StreamRefs:
    """(reference: stream/StreamRefs.scala)"""

    @staticmethod
    def source_ref() -> Sink:
        """A Sink whose mat value is a SourceRef (ship it; the remote side
        calls SourceRef.source(ref) to consume this stream)."""
        return Sink.from_graph(_SourceRefSinkStage)

    @staticmethod
    def sink_ref() -> Source:
        """A Source whose mat value is a SinkRef (ship it; the remote side
        calls SinkRef.sink(ref) to produce into this stream)."""
        return Source.from_graph(_SinkRefSourceStage)
