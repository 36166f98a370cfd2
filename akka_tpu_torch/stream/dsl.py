"""Source/Flow/Sink DSL + materializer.

A copy of `akka_tpu/stream/dsl.py` at commit 05a11d4 (host code, no
jax; the port keeps its own copy of every module it needs).

Reference parity: akka-stream/src/main/scala/akka/stream/scaladsl/
(Source.scala, Flow.scala, Sink.scala, Keep.scala, RunnableGraph in
Flow.scala) and impl/PhasedFusingActorMaterializer.scala — here every
materialization fuses the whole graph into ONE island hosted by one
ActorGraphInterpreter actor (the reference's default is maximal fusion too;
async islands come from mapAsync/hubs, which in this design use async
callbacks into the same interpreter instead of actor-to-actor batches).

Blueprints are REUSABLE: each Source/Flow/Sink holds a build function that
instantiates fresh stages per run (the reference's traversal re-walk).
Materialized values compose with Keep.left/right/both/none.
"""

from __future__ import annotations

import collections
import itertools
import threading
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..actor.props import Props
from .interpreter import ActorGraphInterpreter, Connection, GraphInterpreter
from .stage import (FlowShape, GraphStage, GraphStageLogic, Inlet, Outlet,
                    SinkShape, SourceShape, make_in_handler, make_out_handler)
from . import ops as _ops
from . import ops2 as _ops2
from . import ops3 as _ops3
from . import ops4 as _ops4


def _map_future(fut: Future, fn) -> Future:
    """Future[A] -> Future[fn(A)] (mat-value adaption for composed sinks)."""
    out: Future = Future()

    def done(f):
        ex = f.exception()
        if ex is not None:
            out.set_exception(ex)
        else:
            try:
                out.set_result(fn(f.result()))
            except Exception as e:  # noqa: BLE001
                out.set_exception(e)
    fut.add_done_callback(done)
    return out


class Keep:
    left = staticmethod(lambda l, r: l)
    right = staticmethod(lambda l, r: r)
    both = staticmethod(lambda l, r: (l, r))
    none = staticmethod(lambda l, r: None)


class _Builder:
    """Collects stage logics + edges during one materialization. Stages are
    tagged with the CURRENT ISLAND; `next_island()` (the `.async_()`
    boundary) starts a new one — edges that end up crossing islands become
    backpressured actor-to-actor channels (the reference's island tracking
    in PhasedFusingActorMaterializer.scala:391 islandTracking)."""

    def __init__(self, materializer: "Materializer"):
        self.materializer = materializer
        self.logics: List[GraphStageLogic] = []
        self.logic_by_port: Dict[int, GraphStageLogic] = {}
        self.edges: List[Tuple[Outlet, Inlet]] = []
        self.current_island = 0
        self.island_of: Dict[int, int] = {}  # id(logic) -> island
        # the with_attributes section currently being built; stamped onto
        # every stage added inside it (Attributes.scala section scoping)
        self.current_attributes = None

    def add(self, stage: GraphStage) -> Tuple[GraphStageLogic, Any]:
        logic, mat = stage.create_logic_and_mat()
        if self.current_attributes is not None and logic.attributes is None:
            logic.attributes = self.current_attributes
        self.logics.append(logic)
        self.island_of[id(logic)] = self.current_island
        for p in logic.shape.inlets:
            self.logic_by_port[p.id] = logic
        for p in logic.shape.outlets:
            self.logic_by_port[p.id] = logic
        return logic, mat

    def connect(self, outlet: Outlet, inlet: Inlet) -> None:
        self.edges.append((outlet, inlet))

    def next_island(self) -> None:
        self.current_island += 1


_CHANNEL_BATCH = 16


class _IslandChannel:
    """Backpressured element channel across an async boundary: both ends
    talk ONLY through the target interpreter's async-callback mailbox (the
    reference's BatchingActorInputBoundary / ActorOutputBoundary pair in
    impl/fusing/ActorGraphInterpreter.scala). Demand flows upstream in
    batches; elements, completion, and failure flow downstream."""

    def __init__(self):
        self.sink = None    # _ChannelSink (upstream island)
        self.source = None  # _ChannelSource (downstream island)
        # events sent before the peer island's actor started are held and
        # flushed from its pre_start (islands spawn in arbitrary order)
        self._lock = threading.Lock()
        self._sink_ready = False
        self._source_ready = False
        self._pend_sink: List[Any] = []
        self._pend_source: List[Any] = []

    def to_source(self, ev) -> None:
        with self._lock:
            if not self._source_ready:
                self._pend_source.append(ev)
                return
        self.source._cb.invoke(ev)

    def to_sink(self, ev) -> None:
        with self._lock:
            if not self._sink_ready:
                self._pend_sink.append(ev)
                return
        self.sink._cb.invoke(ev)

    def source_started(self) -> None:
        with self._lock:
            self._source_ready = True
            pending, self._pend_source = self._pend_source, []
        for ev in pending:
            self.source._cb.invoke(ev)

    def sink_started(self) -> None:
        with self._lock:
            self._sink_ready = True
            pending, self._pend_sink = self._pend_sink, []
        for ev in pending:
            self.sink._cb.invoke(ev)


class _ChannelSink(GraphStageLogic):
    """Upstream-island end of an async boundary (output boundary)."""

    def __init__(self, channel: _IslandChannel):
        in_ = Inlet("Island.in")
        super().__init__(SinkShape(in_))
        self.in_ = in_
        self.channel = channel
        self.demand = 0
        channel.sink = self
        self._cb = self.get_async_callback(self._on_event)

        def on_push():
            self.demand -= 1
            channel.to_source(("elem", self.grab(in_)))
            if self.demand > 0:
                self.pull(in_)

        def on_finish():
            channel.to_source(("complete", None))

        def on_fail(ex):
            channel.to_source(("fail", ex))

        self.set_handler(in_, make_in_handler(on_push, on_finish, on_fail))

    def pre_start(self):
        self.channel.sink_started()

    def _on_event(self, ev):
        kind, arg = ev
        if kind == "demand":
            self.demand += arg
            if self.demand > 0 and not self.has_been_pulled(self.in_) \
                    and not self.is_closed(self.in_):
                self.pull(self.in_)
        elif kind == "cancel":
            self.cancel(self.in_)


class _ChannelSource(GraphStageLogic):
    """Downstream-island end of an async boundary (input boundary):
    buffers up to a batch of elements and keeps demand outstanding. The
    batch size is the downstream stage's Attributes.input_buffer max (the
    reference's InputBuffer attribute sizes exactly this boundary buffer,
    BatchingActorInputBoundary)."""

    def __init__(self, channel: _IslandChannel, batch: int = _CHANNEL_BATCH):
        out = Outlet("Island.out")
        super().__init__(SourceShape(out))
        self.out = out
        self.channel = channel
        self.batch = max(int(batch), 1)
        self.buf = collections.deque()
        self.outstanding = 0
        self.done = False
        self.failure: Optional[BaseException] = None
        channel.source = self
        self._cb = self.get_async_callback(self._on_event)

        def on_cancel(cause=None):
            channel.to_sink(("cancel", None))

        self.set_handler(out, make_out_handler(self._pump, on_cancel))

    def pre_start(self):
        self.channel.source_started()
        self.outstanding = self.batch
        self.channel.to_sink(("demand", self.batch))

    def _pump(self):
        if self.failure is not None:
            self.fail(self.out, self.failure)
            return
        if self.buf and self.is_available(self.out):
            self.push(self.out, self.buf.popleft())
        if self.done and not self.buf:
            self.complete(self.out)
            return
        want = self.batch - len(self.buf) - self.outstanding
        if want >= max(self.batch // 2, 1) and not self.done:
            self.outstanding += want
            self.channel.to_sink(("demand", want))

    def _on_event(self, ev):
        kind, arg = ev
        if kind == "elem":
            self.outstanding -= 1
            self.buf.append(arg)
        elif kind == "complete":
            self.done = True
        elif kind == "fail":
            self.failure = arg
        self._pump()


class Materializer:
    """(reference: stream/Materializer.scala / SystemMaterializer.scala).

    Materialization walks the blueprint once, groups stages into fused
    ISLANDS split at `.async_()` boundaries, and spawns ONE
    ActorGraphInterpreter per island — cross-island edges run through
    backpressured async channels (PhasedFusingActorMaterializer.scala:391
    materialize + island assignment; a single-island graph stays one
    actor, the reference's default maximal fusion)."""

    _counter = itertools.count()

    def __init__(self, system):
        self.system = system

    @staticmethod
    def _island_props(interp, logics) -> "Props":
        """Island actor Props, honoring ActorAttributes.dispatcher: the
        first stage in the island that names one selects the dispatcher
        its interpreter runs on (reference: PhasedFusingActorMaterializer
        resolving Attributes.dispatcher per island)."""
        props = Props.create(ActorGraphInterpreter, interp)
        for lg in logics:
            attrs = getattr(lg, "attributes", None)
            if attrs is not None:
                d = attrs.get("dispatcher")
                if d:
                    return props.with_dispatcher(d)
        return props

    def materialize(self, build: Callable[[_Builder], Any]) -> Any:
        b = _Builder(self)
        mat = build(b)
        islands = sorted({b.island_of[id(lg)] for lg in b.logics})
        run_id = next(Materializer._counter)
        if len(islands) <= 1:
            connections = []
            for i, (outlet, inlet) in enumerate(b.edges):
                connections.append(Connection(
                    i, b.logic_by_port[outlet.id], outlet,
                    b.logic_by_port[inlet.id], inlet))
            interp = GraphInterpreter(b.logics, connections,
                                      materializer=self)
            self.system.actor_of(
                self._island_props(interp, b.logics), f"stream-{run_id}")
            return mat

        # multi-island: split edges at boundaries
        by_island: Dict[int, List[GraphStageLogic]] = {
            isl: [] for isl in islands}
        for lg in b.logics:
            by_island[b.island_of[id(lg)]].append(lg)
        island_edges: Dict[int, List[Tuple[Outlet, Inlet]]] = {
            isl: [] for isl in islands}
        for outlet, inlet in b.edges:
            out_isl = b.island_of[id(b.logic_by_port[outlet.id])]
            in_isl = b.island_of[id(b.logic_by_port[inlet.id])]
            if out_isl == in_isl:
                island_edges[out_isl].append((outlet, inlet))
            else:
                ch = _IslandChannel()
                snk = _ChannelSink(ch)
                # boundary buffer sized by the downstream stage's
                # Attributes.input_buffer (max), the reference's InputBuffer
                in_logic = b.logic_by_port[inlet.id]
                attrs = getattr(in_logic, "attributes", None)
                batch = attrs.effective_input_buffer(
                    (_CHANNEL_BATCH, _CHANNEL_BATCH))[1] \
                    if attrs is not None else _CHANNEL_BATCH
                src = _ChannelSource(ch, batch=batch)
                by_island[out_isl].append(snk)
                by_island[in_isl].append(src)
                island_edges[out_isl].append((outlet, snk.in_))
                island_edges[in_isl].append((src.out, inlet))

        for isl in islands:
            port_owner: Dict[int, GraphStageLogic] = {}
            for lg in by_island[isl]:
                for p in lg.shape.inlets:
                    port_owner[p.id] = lg
                for p in lg.shape.outlets:
                    port_owner[p.id] = lg
            connections = [
                Connection(i, port_owner[o.id], o, port_owner[i_.id], i_)
                for i, (o, i_) in enumerate(island_edges[isl])]
            interp = GraphInterpreter(by_island[isl], connections,
                                      materializer=self)
            self.system.actor_of(
                self._island_props(interp, by_island[isl]),
                f"stream-{run_id}-island-{isl}")
        return mat


# -- Source -------------------------------------------------------------------

class Source:
    """build(b) -> (open outlet, mat value)."""

    def __init__(self, build: Callable[[_Builder], Tuple[Outlet, Any]]):
        self._build = build

    # -- constructors ---------------------------------------------------------
    @staticmethod
    def from_graph(stage_factory: Callable[[], GraphStage]) -> "Source":
        def build(b: _Builder):
            logic, mat = b.add(stage_factory())
            return logic.shape.outlets[0], mat
        return Source(build)

    @staticmethod
    def from_iterable(it) -> "Source":
        return Source.from_graph(lambda: _ops.IterableSource(it))

    @staticmethod
    def apply(it) -> "Source":
        return Source.from_iterable(it)

    @staticmethod
    def single(elem) -> "Source":
        return Source.from_iterable([elem])

    @staticmethod
    def empty() -> "Source":
        return Source.from_iterable([])

    @staticmethod
    def failed(ex: BaseException) -> "Source":
        return Source.from_graph(lambda: _ops.FailedSource(ex))

    @staticmethod
    def repeat(elem) -> "Source":
        return Source.from_graph(lambda: _ops.RepeatSource(elem))

    @staticmethod
    def cycle(factory: Callable[[], Any]) -> "Source":
        return Source.from_graph(lambda: _ops.CycleSource(factory))

    @staticmethod
    def unfold(zero, fn: Callable[[Any], Optional[Tuple[Any, Any]]]) -> "Source":
        return Source.from_graph(lambda: _ops.UnfoldSource(zero, fn))

    @staticmethod
    def tick(initial_delay: float, interval: float, tick: Any) -> "Source":
        return Source.from_graph(lambda: _ops.TickSource(
            initial_delay, interval, tick))

    @staticmethod
    def queue(buffer_size: int = 256) -> "Source":
        """Materializes a SourceQueue with offer/complete/fail."""
        return Source.from_graph(lambda: _ops.QueueSource(buffer_size))

    @staticmethod
    def from_future(fut: Future) -> "Source":
        return Source.from_graph(lambda: _ops.FutureSource(fut))

    @staticmethod
    def never() -> "Source":
        """Emits nothing and never completes (scaladsl Source.never)."""
        return Source.from_graph(lambda: _ops3.NeverSource())

    @staticmethod
    def maybe() -> "Source":
        """Mat: a MaybePromise — success(elem) emits-and-completes,
        success(None) completes empty, failure(ex) fails
        (scaladsl Source.maybe)."""
        return Source.from_graph(lambda: _ops4.MaybeSource())

    @staticmethod
    def range(start: int, end: int, step: int = 1) -> "Source":
        """Emit start..end INCLUSIVE by step (javadsl Source.range)."""
        return Source.from_iterable(range(
            start, end + (1 if step > 0 else -1), step))

    @staticmethod
    def from_iterator(factory) -> "Source":
        """A FRESH iterator per materialization (Source.fromIterator) —
        unlike from_iterable, the factory is called each run."""
        class _PerRun:
            def __iter__(self):
                return iter(factory())
        return Source.from_graph(lambda: _ops.IterableSource(_PerRun()))

    @staticmethod
    def unfold_async(zero, fn) -> "Source":
        """unfoldAsync: fn(state) -> Future[None | (state, elem)]."""
        return Source.from_graph(lambda: _ops4.UnfoldAsync(zero, fn))

    @staticmethod
    def unfold_resource_async(create, read, close) -> "Source":
        """unfoldResourceAsync: create/read/close may return Futures; read
        resolving None completes; close runs on every termination path."""
        return Source.from_graph(
            lambda: _ops4.UnfoldResourceAsync(create, read, close))

    @staticmethod
    def actor_ref_with_backpressure(ack_message) -> "Source":
        """Mat: Future[ActorRef]; the ref replies `ack_message` to each
        sender once its element is accepted
        (Source.actorRefWithBackpressure)."""
        return Source.from_graph(
            lambda: _ops4.ActorRefBackpressureSource(ack_message))

    @staticmethod
    def zip_n(sources: Sequence["Source"]) -> "Source":
        """zipN: emit lists of one element from every source."""
        return Source.zip_with_n(lambda xs: list(xs), sources)

    @staticmethod
    def zip_with_n(fn, sources: Sequence["Source"]) -> "Source":
        """zipWithN: emit fn([heads...]) per zipped row."""
        builds = [s._build for s in sources]

        def build(b: _Builder):
            logic, _ = b.add(_ops4.ZipNStage(len(builds), fn))
            mat0 = None
            for i, sb in enumerate(builds):
                o, m = sb(b)
                if i == 0:
                    mat0 = m
                b.connect(o, logic.shape.ins[i])
            return logic.shape.out, mat0
        return Source(build)

    @staticmethod
    def merge_prioritized_n(sources_and_priorities) -> "Source":
        """mergePrioritizedN: [(source, priority)] — higher priority wins
        when several inputs have an element buffered."""
        pairs = list(sources_and_priorities)
        builds = [s._build for s, _p in pairs]
        prios = [p for _s, p in pairs]

        def build(b: _Builder):
            from .ops3 import MergePrioritizedStage
            logic, _ = b.add(MergePrioritizedStage(prios))
            mat0 = None
            for i, sb in enumerate(builds):
                o, m = sb(b)
                if i == 0:
                    mat0 = m
                b.connect(o, logic.shape.ins[i])
            return logic.shape.out, mat0
        return Source(build)

    @staticmethod
    def lazy_source(factory: Callable[[], "Source"]) -> "Source":
        """Defer building the inner Source until the stream is pulled
        (scaladsl Source.lazySource)."""
        return Source.single(None).flat_map_concat(lambda _: factory())

    @staticmethod
    def lazy_single(thunk: Callable[[], Any]) -> "Source":
        """Defer computing the single element until pulled
        (scaladsl Source.lazySingle)."""
        return Source.single(None).map(lambda _: thunk())

    @staticmethod
    def lazy_future(thunk: Callable[[], Future]) -> "Source":
        """Defer creating the Future until pulled (Source.lazyFuture)."""
        return Source.lazy_source(lambda: Source.from_future(thunk()))

    @staticmethod
    def unfold_resource(create: Callable[[], Any],
                        read: Callable[[Any], Optional[Any]],
                        close: Callable[[Any], None]) -> "Source":
        """Open a resource per materialization, emit read() values until it
        returns None, close on EVERY termination path — exhaustion, failure,
        AND downstream cancel (Source.unfoldResource; a real stage whose
        post_stop closes, not a generator finally that waited for GC —
        ADVICE r3)."""
        from .ops3 import UnfoldResourceSource
        return Source.from_graph(
            lambda: UnfoldResourceSource(create, read, close))

    @staticmethod
    def actor_ref(buffer_size: int = 256) -> "Source":
        """Materializes an ActorRef; messages sent to it are emitted
        (reference: Source.actorRef; complete with Status.Success)."""
        return Source.from_graph(lambda: _ops.ActorRefSource(buffer_size))

    @staticmethod
    def combine(first: "Source", second: "Source", *rest: "Source") -> "Source":
        return first.merge(second) if not rest else \
            Source.combine(first.merge(second), *rest)

    # -- composition ----------------------------------------------------------
    def via(self, flow: "Flow", combine=Keep.left) -> "Source":
        src_build, flow_build = self._build, flow._build

        def build(b: _Builder):
            outlet, m1 = src_build(b)
            outlet2, m2 = flow_build(b, outlet)
            return outlet2, combine(m1, m2)
        return Source(build)

    def via_mat(self, flow: "Flow", combine) -> "Source":
        return self.via(flow, combine)

    def to(self, sink: "Sink", combine=Keep.left) -> "RunnableGraph":
        src_build, sink_build = self._build, sink._build

        def build(b: _Builder):
            outlet, m1 = src_build(b)
            m2 = sink_build(b, outlet)
            return combine(m1, m2)
        return RunnableGraph(build)

    def to_mat(self, sink: "Sink", combine) -> "RunnableGraph":
        return self.to(sink, combine)

    def run_with(self, sink: "Sink", materializer_or_system) -> Any:
        return self.to(sink, Keep.right).run(materializer_or_system)

    # -- fan-in convenience ---------------------------------------------------
    def merge(self, other: "Source") -> "Source":
        b1, b2 = self._build, other._build

        def build(b: _Builder):
            o1, m1 = b1(b)
            o2, _m2 = b2(b)
            logic, _ = b.add(_ops.MergeStage(2))
            b.connect(o1, logic.shape.ins[0])
            b.connect(o2, logic.shape.ins[1])
            return logic.shape.out, m1
        return Source(build)

    def concat(self, other: "Source") -> "Source":
        b1, b2 = self._build, other._build

        def build(b: _Builder):
            o1, m1 = b1(b)
            o2, _m2 = b2(b)
            logic, _ = b.add(_ops.ConcatStage(2))
            b.connect(o1, logic.shape.ins[0])
            b.connect(o2, logic.shape.ins[1])
            return logic.shape.out, m1
        return Source(build)

    def prepend(self, other: "Source") -> "Source":
        return other.concat(self)

    def concat_lazy(self, other: "Source") -> "Source":
        """concatLazy: `other` is not built until this source completes
        and it is actually pulled (scaladsl concatLazy)."""
        return self.concat(Source.lazy_source(lambda: other))

    def prepend_lazy(self, other: "Source") -> "Source":
        """prependLazy (scaladsl prependLazy)."""
        return Source.lazy_source(lambda: other).concat(self)

    def map_materialized_value(self, fn) -> "Source":
        """mapMaterializedValue: transform this Source's mat value."""
        prev = self._build

        def build(b: _Builder):
            o, m = prev(b)
            return o, fn(m)
        return Source(build)

    def pre_materialize(self, materializer_or_system):
        """preMaterialize: run this source NOW; returns (mat, Source) where
        the Source replays the running stream's elements to one consumer
        (scaladsl Source.preMaterialize, via a queue bridge)."""
        pair = self.to_mat(Sink.queue(), Keep.both).run(materializer_or_system)
        mat, queue = pair

        def fn(state):
            fut = queue.pull()
            out: Future = Future()

            def done(f):
                if f.exception() is not None:
                    out.set_exception(f.exception())
                elif f.result() is _ops._QUEUE_END:
                    out.set_result(None)
                else:
                    out.set_result((state, f.result()))
            fut.add_done_callback(done)
            return out
        return mat, Source.unfold_async(None, fn)

    def or_else(self, other: "Source") -> "Source":
        b1, b2 = self._build, other._build

        def build(b: _Builder):
            o1, m1 = b1(b)
            o2, _m2 = b2(b)
            logic, _ = b.add(_ops.OrElseStage())
            b.connect(o1, logic.shape.ins[0])
            b.connect(o2, logic.shape.ins[1])
            return logic.shape.out, m1
        return Source(build)

    def zip(self, other: "Source") -> "Source":
        return self.zip_with(other, lambda a, b: (a, b))

    def zip_with(self, other: "Source", fn) -> "Source":
        b1, b2 = self._build, other._build

        def build(b: _Builder):
            o1, m1 = b1(b)
            o2, _m2 = b2(b)
            logic, _ = b.add(_ops.ZipWithStage(fn))
            b.connect(o1, logic.shape.ins[0])
            b.connect(o2, logic.shape.ins[1])
            return logic.shape.out, m1
        return Source(build)

    def interleave(self, other: "Source", segment_size: int) -> "Source":
        b1, b2 = self._build, other._build

        def build(b: _Builder):
            o1, m1 = b1(b)
            o2, _m2 = b2(b)
            logic, _ = b.add(_ops.InterleaveStage(segment_size))
            b.connect(o1, logic.shape.ins[0])
            b.connect(o2, logic.shape.ins[1])
            return logic.shape.out, m1
        return Source(build)

    def also_to(self, sink: "Sink") -> "Source":
        src_build, sink_build = self._build, sink._build

        def build(b: _Builder):
            o1, m1 = src_build(b)
            logic, _ = b.add(_ops.BroadcastStage(2, eager_cancel=False))
            b.connect(o1, logic.shape.in_)
            sink_build(b, logic.shape.outs[1])
            return logic.shape.outs[0], m1
        return Source(build)

    def wire_tap(self, fn: Callable[[Any], None]) -> "Source":
        return self.via(Flow().wire_tap(fn))

    # -- attributes -----------------------------------------------------------
    def with_attributes(self, attrs) -> "Source":
        """Attach Attributes to every stage this Source has built SO FAR
        (section scoping: operators appended after this call are outside —
        Attributes.scala:662; supervision deciders are the headline use)."""
        return Source(_scoped_attributes(self._build, attrs))

    add_attributes = with_attributes

    def named(self, name: str) -> "Source":
        from .attributes import Attributes
        return self.with_attributes(Attributes.name(name))

    # -- run ------------------------------------------------------------------
    def run(self, materializer_or_system) -> Any:
        return self.to(Sink.ignore(), Keep.left).run(materializer_or_system)

    def run_fold(self, zero, fn, materializer_or_system) -> Future:
        return self.run_with(Sink.fold(zero, fn), materializer_or_system)

    def run_foreach(self, fn, materializer_or_system) -> Future:
        return self.run_with(Sink.foreach(fn), materializer_or_system)

    def run_reduce(self, fn, materializer_or_system) -> Future:
        return self.run_with(Sink.reduce(fn), materializer_or_system)


def _linear(op_factory: Callable[[], GraphStage]):
    """Helper: append one 1-in/1-out stage to a Flow/Source chain."""
    def flow_build(b: _Builder, upstream: Outlet):
        logic, mat = b.add(op_factory())
        b.connect(upstream, logic.shape.in_)
        return logic.shape.out, mat
    return flow_build


def _scoped_attributes(prev_build, attrs):
    """Wrap a build so stages created inside it carry `attrs` layered over
    any enclosing section's attributes (innermost wins — the reference's
    `and` composition order)."""
    def build(b: _Builder, *args):
        saved = b.current_attributes
        b.current_attributes = attrs if saved is None \
            else saved.and_then(attrs)
        try:
            return prev_build(b, *args)
        finally:
            b.current_attributes = saved
    return build


class Flow:
    """build(b, upstream_outlet) -> (outlet, mat)."""

    def __init__(self, build: Optional[Callable] = None):
        if build is None:
            def build(b: _Builder, upstream: Outlet):
                return upstream, None
        self._build = build

    @staticmethod
    def from_graph(stage_factory: Callable[[], GraphStage]) -> "Flow":
        def build(b: _Builder, upstream: Outlet):
            logic, mat = b.add(stage_factory())
            b.connect(upstream, logic.shape.inlets[0])
            return logic.shape.outlets[0], mat
        return Flow(build)

    @staticmethod
    def from_function(fn: Callable[[Any], Any]) -> "Flow":
        return Flow().map(fn)

    @staticmethod
    def from_sink_and_source(sink: "Sink", source: "Source") -> "Flow":
        """fromSinkAndSource: inputs go to `sink`, outputs come from
        `source`; the two sides are NOT coupled (scaladsl
        Flow.fromSinkAndSource)."""
        sink_build, src_build = sink._build, source._build

        def build(b: _Builder, upstream: Outlet):
            m1 = sink_build(b, upstream)
            o, m2 = src_build(b)
            return o, (m1, m2)
        return Flow(build)

    @staticmethod
    def from_sink_and_source_coupled(sink: "Sink", source: "Source") -> "Flow":
        """fromSinkAndSourceCoupled: like from_sink_and_source but
        termination of either side tears down the other (coupled through a
        per-materialization shared kill switch — the reference's
        CoupledTerminationFlow)."""
        sink_build, src_build = sink._build, source._build

        def build(b: _Builder, upstream: Outlet):
            from .killswitch import KillSwitches
            ks = KillSwitches.shared("coupled")
            watched = Flow().via(ks.flow).watch_termination()  # .flow is a property

            def couple(f):
                # a FAILED side aborts the other with the error; a clean
                # completion shuts it down (CoupledTerminationFlow
                # propagates failure, not completion)
                ex = f.exception()
                if ex is not None:
                    ks.abort(ex)
                else:
                    ks.shutdown()

            o1, fut1 = watched._build(b, upstream)
            m1 = sink_build(b, o1)
            fut1.add_done_callback(couple)

            o2, m2 = src_build(b)
            o3, fut2 = watched._build(b, o2)
            fut2.add_done_callback(couple)
            return o3, (m1, m2)
        return Flow(build)

    @staticmethod
    def lazy_flow(factory: Callable[[], "Flow"]) -> "Flow":
        """lazyFlow: defer building the inner Flow until the first element
        arrives; that element and all following flow through it
        (scaladsl Flow.lazyFlow, via flatMapPrefix(1))."""
        def with_first(prefix):
            inner = factory()
            inner_build = inner._build

            def build(b: _Builder, upstream: Outlet):
                head, _ = b.add(_ops.IterableSource(list(prefix)))
                concat, _ = b.add(_ops.ConcatStage(2))
                b.connect(head.shape.outlets[0], concat.shape.ins[0])
                b.connect(upstream, concat.shape.ins[1])
                return inner_build(b, concat.shape.out)
            return Flow(build)
        return Flow().flat_map_prefix(1, with_first)

    def _append(self, op_factory: Callable[[], GraphStage],
                combine=Keep.left) -> "Flow":
        prev = self._build
        nxt = _linear(op_factory)

        def build(b: _Builder, upstream: Outlet):
            o1, m1 = prev(b, upstream)
            o2, m2 = nxt(b, o1)
            return o2, combine(m1, m2)
        return Flow(build)

    def via(self, other: "Flow", combine=Keep.left) -> "Flow":
        prev, nxt = self._build, other._build

        def build(b: _Builder, upstream: Outlet):
            o1, m1 = prev(b, upstream)
            o2, m2 = nxt(b, o1)
            return o2, combine(m1, m2)
        return Flow(build)

    via_mat = via

    def to(self, sink: "Sink", combine=Keep.left) -> "Sink":
        prev, sink_build = self._build, sink._build

        def build(b: _Builder, upstream: Outlet):
            o1, m1 = prev(b, upstream)
            m2 = sink_build(b, o1)
            return combine(m1, m2)
        return Sink(build)

    to_mat = to

    # -- attributes -----------------------------------------------------------
    def with_attributes(self, attrs) -> "Flow":
        """Attach Attributes to every stage this Flow has built so far
        (Attributes.scala:662 section scoping)."""
        return Flow(_scoped_attributes(self._build, attrs))

    add_attributes = with_attributes

    def named(self, name: str) -> "Flow":
        from .attributes import Attributes
        return self.with_attributes(Attributes.name(name))

    # -- operator library (reference: scaladsl/Flow.scala ~200 defs;
    #    the stages live in stream/ops.py) --------------------------
    def via_stage(self, stage_factory) -> "Flow":
        """Append any custom 1-in/1-out GraphStage (the GraphStage SPI of
        stream/stage/GraphStage.scala for user-defined operators)."""
        return self._append(stage_factory)

    def map(self, fn) -> "Flow":
        return self._append(lambda: _ops.Map(fn))

    def map_concat(self, fn) -> "Flow":
        return self._append(lambda: _ops.MapConcat(fn))

    def stateful_map_concat(self, factory) -> "Flow":
        return self._append(lambda: _ops.StatefulMapConcat(factory))

    def filter(self, pred) -> "Flow":
        return self._append(lambda: _ops.Filter(pred))

    def filter_not(self, pred) -> "Flow":
        return self._append(lambda: _ops.Filter(lambda x: not pred(x)))

    def collect(self, fn) -> "Flow":
        """fn returns None to drop (partial-function analogue)."""
        return self._append(lambda: _ops.Collect(fn))

    def take(self, n: int) -> "Flow":
        return self._append(lambda: _ops.Take(n))

    def take_while(self, pred, inclusive: bool = False) -> "Flow":
        return self._append(lambda: _ops.TakeWhile(pred, inclusive))

    def drop(self, n: int) -> "Flow":
        return self._append(lambda: _ops.Drop(n))

    def drop_while(self, pred) -> "Flow":
        return self._append(lambda: _ops.DropWhile(pred))

    def scan(self, zero, fn) -> "Flow":
        return self._append(lambda: _ops.Scan(zero, fn))

    def fold(self, zero, fn) -> "Flow":
        return self._append(lambda: _ops.Fold(zero, fn))

    def reduce(self, fn) -> "Flow":
        return self._append(lambda: _ops.Reduce(fn))

    def grouped(self, n: int) -> "Flow":
        return self._append(lambda: _ops.Grouped(n))

    def sliding(self, n: int, step: int = 1) -> "Flow":
        return self._append(lambda: _ops.Sliding(n, step))

    def intersperse(self, sep, start=None, end=None) -> "Flow":
        return self._append(lambda: _ops.Intersperse(sep, start, end))

    def zip_with_index(self) -> "Flow":
        return self.stateful_map_concat(
            lambda: (lambda counter=itertools.count():
                     (lambda x: [(x, next(counter))]))())

    def buffer(self, size: int, overflow_strategy: str = "backpressure"
               ) -> "Flow":
        return self._append(lambda: _ops.Buffer(size, overflow_strategy))

    def conflate(self, aggregate) -> "Flow":
        return self.conflate_with_seed(lambda x: x, aggregate)

    def conflate_with_seed(self, seed, aggregate) -> "Flow":
        return self._append(lambda: _ops.Conflate(seed, aggregate))

    def batch(self, max_n: int, seed, aggregate) -> "Flow":
        return self._append(lambda: _ops.Batch(max_n, seed, aggregate))

    def expand(self, extrapolate) -> "Flow":
        return self._append(lambda: _ops.Expand(extrapolate))

    def map_async(self, parallelism: int, fn) -> "Flow":
        return self._append(lambda: _ops.MapAsync(parallelism, fn,
                                                  ordered=True))

    def map_async_unordered(self, parallelism: int, fn) -> "Flow":
        return self._append(lambda: _ops.MapAsync(parallelism, fn,
                                                  ordered=False))

    def throttle(self, elements: int, per: float,
                 maximum_burst: Optional[int] = None) -> "Flow":
        return self._append(lambda: _ops.Throttle(
            elements, per, maximum_burst or elements))

    def delay(self, of: float) -> "Flow":
        return self._append(lambda: _ops.Delay(of))

    def recover(self, fn) -> "Flow":
        """fn(exc) -> final element (or raise to propagate)."""
        return self._append(lambda: _ops.Recover(fn))

    def log(self, name: str, extract=lambda x: x) -> "Flow":
        return self._append(lambda: _ops.Log(name, extract))

    def wire_tap(self, fn) -> "Flow":
        return self._append(lambda: _ops.WireTap(fn))

    def also_to(self, sink: "Sink") -> "Flow":
        prev, sink_build = self._build, sink._build

        def build(b: _Builder, upstream: Outlet):
            o1, m1 = prev(b, upstream)
            logic, _ = b.add(_ops.BroadcastStage(2, eager_cancel=False))
            b.connect(o1, logic.shape.in_)
            sink_build(b, logic.shape.outs[1])
            return logic.shape.outs[0], m1
        return Flow(build)

    def flat_map_concat(self, fn: Callable[[Any], "Source"]) -> "Flow":
        return self._append(lambda: _ops.FlatMapConcat(fn))

    def _fan_in(self, other: Source, stage_factory,
                self_first: bool = True) -> "Flow":
        """Join this flow's output with another Source through a 2-in
        stage (the scaladsl pattern of merge/zip/concat/orElse/... taking
        a Graph[SourceShape] argument)."""
        prev, other_build = self._build, other._build

        def build(b: _Builder, upstream: Outlet):
            o1, m1 = prev(b, upstream)
            o2, _ = other_build(b)
            logic, _l = b.add(stage_factory())
            first, second = (o1, o2) if self_first else (o2, o1)
            b.connect(first, logic.shape.ins[0])
            b.connect(second, logic.shape.ins[1])
            return logic.shape.out, m1
        return Flow(build)

    def merge(self, other: Source) -> "Flow":
        return self._fan_in(other, lambda: _ops.MergeStage(2))

    def zip(self, other: Source) -> "Flow":
        return self._fan_in(
            other, lambda: _ops.ZipWithStage(lambda a, bb: (a, bb)))

    def zip_with(self, other: Source, fn) -> "Flow":
        return self._fan_in(other, lambda: _ops.ZipWithStage(fn))

    def zip_latest(self, other: Source) -> "Flow":
        return self.zip_latest_with(other, lambda a, b: (a, b))

    def zip_latest_with(self, other: Source, fn) -> "Flow":
        return self._fan_in(other, lambda: _ops3.ZipLatestStage(fn))

    def zip_all(self, other: Source, this_default, that_default) -> "Flow":
        return self._fan_in(other, lambda: _ops3.ZipAllStage(
            this_default, that_default))

    def concat(self, other: Source) -> "Flow":
        return self._fan_in(other, lambda: _ops.ConcatStage(2))

    def prepend(self, other: Source) -> "Flow":
        return self._fan_in(other, lambda: _ops.ConcatStage(2),
                            self_first=False)

    def or_else(self, other: Source) -> "Flow":
        return self._fan_in(other, lambda: _ops.OrElseStage())

    def interleave(self, other: Source, segment_size: int) -> "Flow":
        return self._fan_in(other, lambda: _ops.InterleaveStage(segment_size))

    def merge_sorted(self, other: Source, key=None) -> "Flow":
        return self._fan_in(other, lambda: _ops3.MergeSortedStage(key))

    def merge_prioritized(self, other: Source, this_prio: int,
                          that_prio: int) -> "Flow":
        return self._fan_in(other, lambda: _ops3.MergePrioritizedStage(
            [this_prio, that_prio]))

    def divert_to(self, sink: "Sink", when) -> "Flow":
        """Route elements matching `when` into `sink`, pass the rest on
        (scaladsl/Flow.scala divertTo)."""
        prev, sink_build = self._build, sink._build

        def build(b: _Builder, upstream: Outlet):
            o1, m1 = prev(b, upstream)
            logic, _ = b.add(_ops3.DivertToStage(when))
            b.connect(o1, logic.shape.in_)
            sink_build(b, logic.shape.outs[1])
            return logic.shape.outs[0], m1
        return Flow(build)

    def fold_async(self, zero, fn) -> "Flow":
        """fn(acc, elem) -> Future (or plain value); emits the final
        aggregate at completion (scaladsl foldAsync)."""
        return self._append(lambda: _ops3.FoldAsync(zero, fn))

    def scan_async(self, zero, fn) -> "Flow":
        return self._append(lambda: _ops3.FoldAsync(zero, fn,
                                                    emit_each=True))

    def on_error_complete(self, pred=None) -> "Flow":
        return self._append(lambda: _ops3.OnErrorComplete(pred))

    def also_to_all(self, *sinks: "Sink") -> "Flow":
        """also_to chained over every sink (scaladsl alsoToAll)."""
        flow = self
        for s in sinks:
            flow = flow.also_to(s)
        return flow

    def merge_all(self, sources) -> "Flow":
        """Merge every source into this flow (scaladsl mergeAll)."""
        flow = self
        for src in sources:
            flow = flow.merge(src)
        return flow

    def interleave_all(self, sources, segment_size: int) -> "Flow":
        """Round-robin interleave across this flow AND every source in ONE
        N-way stage (scaladsl interleaveAll) — chaining 2-way interleaves
        would scramble the round-robin order across sources."""
        sources = list(sources)
        prev = self._build
        builds = [s._build for s in sources]

        def build(b: _Builder, upstream: Outlet):
            o1, m1 = prev(b, upstream)
            logic, _l = b.add(_ops.InterleaveStage(segment_size,
                                                   n=1 + len(builds)))
            b.connect(o1, logic.shape.ins[0])
            for i, sb in enumerate(builds):
                oi, _mi = sb(b)
                b.connect(oi, logic.shape.ins[1 + i])
            return logic.shape.out, m1
        return Flow(build)

    def concat_all_lazy(self, *sources: Source) -> "Flow":
        """Concat every source after this flow's elements, each materialized
        only when reached (scaladsl concatAllLazy — our ConcatStage pulls
        an input only once it becomes active)."""
        flow = self
        for src in sources:
            flow = flow.concat(src)
        return flow

    def collect_type(self, cls) -> "Flow":
        """Pass through only instances of `cls` (scaladsl collectType).
        A dedicated filter, not collect's None-sentinel: a legitimate None
        element matching `cls` (e.g. collect_type(object)) must survive
        (ADVICE r3)."""
        return self.filter(lambda x: isinstance(x, cls))

    def flat_map_prefix(self, n: int, fn) -> "Flow":
        """Consume the first n elements, then run the REST of the stream
        through the Flow `fn(prefix)` returns (scaladsl flatMapPrefix) —
        composed from prefix_and_tail + flat_map_concat."""
        return self.prefix_and_tail(n).flat_map_concat(
            lambda pt: pt[1].via(fn(pt[0])))

    def extrapolate(self, extrapolator, initial=None) -> "Flow":
        """Meet faster downstream demand by extrapolating from the last
        element (scaladsl extrapolate, an expand specialization: the
        element itself is emitted first, then extrapolations)."""
        def expander(elem):
            def gen():
                yield elem
                yield from extrapolator(elem)
            return gen()
        flow = self.expand(expander)
        if initial is not None:
            flow = flow.prepend(Source.single(initial))
        return flow

    # -- fourth operator tranche (scaladsl/Flow.scala long tail) -------------
    def stateful_map(self, create, fn, on_complete=None) -> "Flow":
        """statefulMap(create)(f, onComplete): f(state, elem) ->
        (state, out); onComplete(state) may emit one final element."""
        return self._append(lambda: _ops4.StatefulMap(create, fn, on_complete))

    def map_with_resource(self, create, fn, close) -> "Flow":
        """mapWithResource: per-materialization resource used by
        fn(resource, elem), closed on every termination path."""
        return self._append(lambda: _ops4.MapWithResource(create, fn, close))

    def map_async_partitioned(self, parallelism: int, partitioner,
                              fn) -> "Flow":
        """mapAsyncPartitioned: one future in flight per partition,
        results in input order; fn(elem, partition) -> Future | value."""
        return self._append(lambda: _ops4.MapAsyncPartitioned(
            parallelism, partitioner, fn))

    def grouped_weighted(self, min_weight: float, cost) -> "Flow":
        return self._append(lambda: _ops4.GroupedWeighted(min_weight, cost))

    def grouped_weighted_within(self, max_weight: float, seconds: float,
                                cost, max_number: int = 0) -> "Flow":
        return self._append(lambda: _ops4.GroupedWeightedWithin(
            max_weight, seconds, cost, max_number))

    def batch_weighted(self, max_weight: float, cost, seed,
                       aggregate) -> "Flow":
        return self._append(lambda: _ops4.BatchWeighted(
            max_weight, cost, seed, aggregate))

    def initial_delay(self, seconds: float) -> "Flow":
        return self._append(lambda: _ops4.InitialDelay(seconds))

    def backpressure_timeout(self, seconds: float) -> "Flow":
        return self._append(lambda: _ops4.BackpressureTimeout(seconds))

    def delay_with(self, strategy_factory, buffer_size: int = 16) -> "Flow":
        """delayWith(DelayStrategy): strategy_factory() -> fn(elem) ->
        seconds, fresh per materialization."""
        return self._append(lambda: _ops4.DelayWith(strategy_factory,
                                                    buffer_size))

    def monitor(self) -> "Flow":
        """monitor: mat value is a FlowMonitor exposing the stream's last
        state (initialized/received/failed/finished)."""
        return self._append(lambda: _ops4.MonitorStage(), combine=Keep.right)

    def fold_while(self, zero, pred, fn) -> "Flow":
        """foldWhile(zero)(pred)(f): stop folding (and cancel upstream)
        once pred(acc) is false; emits the aggregate."""
        return self._append(lambda: _ops4.FoldWhile(zero, pred, fn))

    def merge_latest(self, other: Source) -> "Flow":
        """mergeLatest: after both inputs emitted once, emit [a, b] on
        every update from either side."""
        return self._fan_in(other, lambda: _ops4.MergeLatestStage(2))

    def merge_latest_with(self, other: Source, fn) -> "Flow":
        return self._fan_in(other, lambda: _ops4.MergeLatestStage(
            2, lambda xs: fn(*xs)))

    def ask(self, parallelism: int, ref, timeout: float = 5.0) -> "Flow":
        """ask: each element is asked to `ref`; replies emitted in order
        (scaladsl Flow.ask via mapAsync + pattern.ask)."""
        from ..pattern.ask import ask as _ask

        def do_ask(elem):
            return _ask(ref, elem, timeout)
        return self.map_async(parallelism, do_ask)

    def watch(self, ref) -> "Flow":
        """watch(ref): fail the stream with
        WatchedActorTerminatedException when `ref` terminates."""
        return self._append(lambda: _ops4.WatchStage(ref))

    def detach(self) -> "Flow":
        """detach: decouple upstream/downstream rates with a one-element
        pump (the reference's Detacher; a 1-slot backpressure buffer)."""
        return self.buffer(1, "backpressure")

    def recover_with(self, fn) -> "Flow":
        """recoverWith: switch to fn(exception)'s Source on failure,
        unlimited retries (recoverWithRetries(-1))."""
        return self.recover_with_retries(-1, fn)

    def collect_first(self, fn) -> "Flow":
        """collectFirst: emit the first element fn maps non-None, then
        complete."""
        return self.collect(fn).take(1)

    def collect_while(self, fn) -> "Flow":
        """collectWhile: map through fn until it first returns None, then
        complete (fn evaluated once per element)."""
        return self.map(fn).take_while(lambda v: v is not None)

    def flatten_merge(self, breadth: int = 8) -> "Flow":
        """flattenMerge: flatten a stream of Sources, running up to
        `breadth` concurrently."""
        return self.flat_map_merge(breadth, lambda s: s)

    def switch_map(self, fn) -> "Flow":
        """switchMap (flatMapLatest): a new element cancels the current
        inner Source and switches to fn(elem)."""
        return self._append(lambda: _ops4.SwitchMap(fn))

    def map_materialized_value(self, fn) -> "Flow":
        """mapMaterializedValue: transform this Flow's mat value."""
        prev = self._build

        def build(b: _Builder, upstream: Outlet):
            o, m = prev(b, upstream)
            return o, fn(m)
        return Flow(build)

    def async_(self) -> "Flow":
        """Mark an ASYNC BOUNDARY: stages after this point run in their own
        island (one interpreter actor per island), with backpressure across
        the boundary (scaladsl .async; PhasedFusingActorMaterializer
        island assignment)."""
        prev = self._build

        def build(b: _Builder, upstream: Outlet):
            o, m = prev(b, upstream)
            b.next_island()
            return o, m
        return Flow(build)

    # -- sub-streams (impl/fusing/StreamOfStreams.scala) ---------------------
    def group_by(self, max_substreams: int, key_fn,
                 sub_buffer: int = 1024) -> "Flow":
        """Demultiplex into (key, Source) pairs, one per distinct key."""
        from .substreams import GroupBy
        return self._append(lambda: GroupBy(max_substreams, key_fn,
                                            sub_buffer))

    def split_when(self, predicate) -> "Flow":
        from .substreams import SplitWhen
        return self._append(lambda: SplitWhen(predicate, after=False))

    def split_after(self, predicate) -> "Flow":
        from .substreams import SplitWhen
        return self._append(lambda: SplitWhen(predicate, after=True))

    def flat_map_merge(self, breadth: int, fn) -> "Flow":
        from .substreams import FlatMapMerge
        return self._append(lambda: FlatMapMerge(breadth, fn))

    def prefix_and_tail(self, n: int) -> "Flow":
        from .substreams import PrefixAndTail
        return self._append(lambda: PrefixAndTail(n))

    def merge_substreams(self, breadth: int = 16) -> "Flow":
        """Flatten a stream of Sources (or (key, Source) pairs from
        group_by) by merging up to `breadth` concurrently."""
        def pick(x):
            return x[1] if isinstance(x, tuple) and len(x) == 2 else x
        return self.flat_map_merge(breadth, pick)

    def concat_substreams(self) -> "Flow":
        def pick(x):
            return x[1] if isinstance(x, tuple) and len(x) == 2 else x
        return self.flat_map_concat(pick)

    # -- timed windows / limits / timeouts (impl/Timers.scala, Ops.scala) ----
    def take_within(self, seconds: float) -> "Flow":
        return self._append(lambda: _ops2.TakeWithin(seconds))

    def drop_within(self, seconds: float) -> "Flow":
        return self._append(lambda: _ops2.DropWithin(seconds))

    def grouped_within(self, n: int, seconds: float) -> "Flow":
        return self._append(lambda: _ops2.GroupedWithin(n, seconds))

    def limit(self, max_elements: int) -> "Flow":
        return self._append(lambda: _ops2.Limit(max_elements))

    def limit_weighted(self, max_cost: int, cost_fn) -> "Flow":
        return self._append(lambda: _ops2.Limit(max_cost, cost_fn))

    def initial_timeout(self, seconds: float) -> "Flow":
        return self._append(lambda: _ops2.InitialTimeout(seconds))

    def completion_timeout(self, seconds: float) -> "Flow":
        return self._append(lambda: _ops2.CompletionTimeout(seconds))

    def idle_timeout(self, seconds: float) -> "Flow":
        return self._append(lambda: _ops2.IdleTimeout(seconds))

    def keep_alive(self, seconds: float, inject_fn) -> "Flow":
        return self._append(lambda: _ops2.KeepAlive(seconds, inject_fn))

    # -- errors / termination ------------------------------------------------
    def map_error(self, fn) -> "Flow":
        return self._append(lambda: _ops2.MapError(fn))

    def deduplicate(self, key_fn=None) -> "Flow":
        return self._append(lambda: _ops2.Deduplicate(key_fn))

    def recover_with_retries(self, attempts: int, fn) -> "Flow":
        return self._append(lambda: _ops2.RecoverWithRetries(attempts, fn))

    def watch_termination(self) -> "Flow":
        """Mat value becomes a Future completing with the stream's end."""
        return self._append(lambda: _ops2.WatchTermination(),
                            combine=Keep.right)


class Sink:
    """build(b, upstream_outlet) -> mat."""

    def __init__(self, build: Callable[[_Builder, Outlet], Any]):
        self._build = build

    def with_attributes(self, attrs) -> "Sink":
        return Sink(_scoped_attributes(self._build, attrs))

    add_attributes = with_attributes

    def named(self, name: str) -> "Sink":
        from .attributes import Attributes
        return self.with_attributes(Attributes.name(name))

    @staticmethod
    def from_graph(stage_factory: Callable[[], GraphStage]) -> "Sink":
        def build(b: _Builder, upstream: Outlet):
            logic, mat = b.add(stage_factory())
            b.connect(upstream, logic.shape.inlets[0])
            return mat
        return Sink(build)

    @staticmethod
    def ignore() -> "Sink":
        return Sink.from_graph(lambda: _ops.IgnoreSink())

    @staticmethod
    def foreach(fn) -> "Sink":
        return Sink.from_graph(lambda: _ops.ForeachSink(fn))

    @staticmethod
    def foreach_async(parallelism: int, fn) -> "Sink":
        """foreachAsync: fn(elem) -> Future; up to `parallelism` in
        flight; mat Future completes at stream end."""
        return Flow().map_async(parallelism, fn).to(
            Sink.ignore(), Keep.right)

    @staticmethod
    def cancelled() -> "Sink":
        """Sink.cancelled: immediately cancel upstream."""
        return Sink.from_graph(lambda: _ops4.CancelledSink())

    @staticmethod
    def lazy_sink(factory: Callable[[], "Sink"]) -> "Sink":
        """lazySink: build+materialize the real sink only when the first
        element arrives (that element is delivered to it)."""
        return Sink.from_graph(lambda: _ops4.LazySink(factory))

    @staticmethod
    def future_sink(fut: Future) -> "Sink":
        """futureSink: materialize the Sink the future resolves to,
        buffering demand until then."""
        return Sink.from_graph(
            lambda: _ops4.LazySink(lambda: fut.result(), trigger=fut))

    @staticmethod
    def seq() -> "Sink":
        return Sink.from_graph(lambda: _ops.SeqSink())

    @staticmethod
    def fold(zero, fn) -> "Sink":
        return Sink.from_graph(lambda: _ops.FoldSink(zero, fn))

    @staticmethod
    def reduce(fn) -> "Sink":
        return Sink.from_graph(lambda: _ops.ReduceSink(fn))

    @staticmethod
    def head() -> "Sink":
        return Sink.from_graph(lambda: _ops.HeadSink(require=True))

    @staticmethod
    def head_option() -> "Sink":
        return Sink.from_graph(lambda: _ops.HeadSink(require=False))

    @staticmethod
    def last() -> "Sink":
        return Sink.from_graph(lambda: _ops.LastSink(require=True))

    @staticmethod
    def last_option() -> "Sink":
        return Sink.from_graph(lambda: _ops.LastSink(require=False))

    @staticmethod
    def on_complete(fn: Callable[[Optional[BaseException]], None]) -> "Sink":
        return Sink.from_graph(lambda: _ops.OnCompleteSink(fn))

    @staticmethod
    def queue(buffer_size: int = 256) -> "Sink":
        return Sink.from_graph(lambda: _ops.QueueSink(buffer_size))

    @staticmethod
    def actor_ref(ref, on_complete_message: Any,
                  on_failure_message: Callable[[BaseException], Any] = None
                  ) -> "Sink":
        return Sink.from_graph(lambda: _ops.ActorRefSink(
            ref, on_complete_message, on_failure_message))

    @staticmethod
    def actor_ref_with_backpressure(ref, on_init_message: Any,
                                    ack_message: Any,
                                    on_complete_message: Any,
                                    on_failure_message: Callable[
                                        [BaseException], Any] = None
                                    ) -> "Sink":
        """Each element waits for the target actor's `ack_message` before
        the next is pulled (scaladsl Sink.actorRefWithBackpressure)."""
        from . import ops4 as _ops4
        return Sink.from_graph(lambda: _ops4.ActorRefBackpressureSink(
            ref, on_init_message, ack_message, on_complete_message,
            on_failure_message))

    @staticmethod
    def combine(first: "Sink", second: "Sink", *rest: "Sink") -> "Sink":
        """Broadcast every element to all given sinks; mat value is the
        tuple of their mat values (scaladsl Sink.combine with a
        Broadcast strategy)."""
        sinks = [first, second, *rest]

        def build(b: _Builder, upstream: Outlet):
            bc, _ = b.add(_ops.BroadcastStage(len(sinks)))
            b.connect(upstream, bc.shape.inlets[0])
            return tuple(s._build(b, out)
                         for s, out in zip(sinks, bc.shape.outlets))
        return Sink(build)

    @staticmethod
    def count() -> "Sink":
        return Sink.fold(0, lambda acc, _elem: acc + 1)

    @staticmethod
    def take_last(n: int) -> "Sink":
        """Future completing with the last n elements (Sink.takeLast)."""
        import collections as _c

        def build(b: _Builder, upstream: Outlet):
            logic, mat = b.add(_ops.FoldSink(
                _c.deque(maxlen=n),
                lambda acc, e: (acc.append(e), acc)[1]))
            b.connect(upstream, logic.shape.inlets[0])
            return _map_future(mat, list)
        return Sink(build)

    @staticmethod
    def exists(pred) -> "Sink":
        """Future[bool]: does any element satisfy pred? Cancels upstream at
        the first match (Sink.exists)."""
        inner = Flow().filter(pred).take(1) \
            .to(Sink.head_option(), Keep.right)

        def build(b: _Builder, upstream: Outlet):
            fut = inner._build(b, upstream)
            return _map_future(fut, lambda v: v is not None)
        return Sink(build)

    @staticmethod
    def forall(pred) -> "Sink":
        """Future[bool]: do ALL elements satisfy pred? (Sink.forall)"""
        neg = Sink.exists(lambda x: not pred(x))

        def build(b: _Builder, upstream: Outlet):
            return _map_future(neg._build(b, upstream), lambda v: not v)
        return Sink(build)

    @staticmethod
    def never() -> "Sink":
        """Consumes nothing — never signals demand (Sink.never)."""
        def build(b: _Builder, upstream: Outlet):
            logic, mat = b.add(_ops3.NeverSink())
            b.connect(upstream, logic.shape.inlets[0])
            return mat
        return Sink(build)

    def contramap(self, fn) -> "Sink":
        return Flow().map(fn).to(self, Keep.right)


class RunnableGraph:
    def __init__(self, build: Callable[[_Builder], Any]):
        self._build = build

    def run(self, materializer_or_system) -> Any:
        mat = materializer_or_system
        if not isinstance(mat, Materializer):
            mat = Materializer(getattr(mat, "classic", mat))
        return mat.materialize(self._build)


class BidiFlow:
    """A pair of flows forming a protocol stage: `top` transforms traffic
    flowing one way (I1 -> O1), `bottom` the other way (I2 -> O2)
    (reference: scaladsl/BidiFlow.scala — the codec/framing stacking
    primitive: `codec.atop(framing).join(transport)`)."""

    def __init__(self, top: Flow, bottom: Flow):
        self.top = top
        self.bottom = bottom

    @staticmethod
    def from_flows(top: Flow, bottom: Flow) -> "BidiFlow":
        return BidiFlow(top, bottom)

    @staticmethod
    def from_functions(outbound: Callable[[Any], Any],
                       inbound: Callable[[Any], Any]) -> "BidiFlow":
        """(reference: BidiFlow.fromFunctions) — map each direction."""
        return BidiFlow(Flow().map(outbound), Flow().map(inbound))

    def atop(self, other: "BidiFlow") -> "BidiFlow":
        """Stack `other` below this stage: outbound runs self.top then
        other.top; inbound runs other.bottom then self.bottom."""
        return BidiFlow(self.top.via(other.top),
                        other.bottom.via(self.bottom))

    def reversed(self) -> "BidiFlow":
        return BidiFlow(self.bottom, self.top)

    def join(self, flow: Flow) -> Flow:
        """Close the stack over `flow`: I1 -> top -> flow -> bottom -> O2
        becomes one Flow (the transport at the bottom of a protocol
        stack — BidiFlow.join)."""
        return self.top.via(flow).via(self.bottom)


class _GraphBuilder:
    """User-facing graph assembly surface handed to GraphDSL.create's
    build function (reference: scaladsl/GraphDSL.Builder — add shapes,
    wire ports explicitly)."""

    def __init__(self, b: _Builder):
        self._b = b

    # -- adding shapes --------------------------------------------------------
    def add(self, stage: GraphStage):
        """Add any GraphStage; returns its logic (ports via .shape)."""
        logic, _mat = self._b.add(stage)
        return logic

    def source(self, source: Source) -> Outlet:
        outlet, _mat = source._build(self._b)
        return outlet

    def sink(self, sink: Sink, outlet: Outlet) -> Any:
        """Wire `outlet` into `sink`; returns the sink's mat value."""
        return sink._build(self._b, outlet)

    def flow(self, outlet: Outlet, flow: Flow) -> Outlet:
        """Append a linear flow after `outlet`; returns the new outlet."""
        new_outlet, _mat = flow._build(self._b, outlet)
        return new_outlet

    def edge(self, outlet: Outlet, inlet: Inlet) -> None:
        self._b.connect(outlet, inlet)

    # -- junction shorthands --------------------------------------------------
    def broadcast(self, n: int):
        return self.add(_ops.BroadcastStage(n))

    def merge(self, n: int):
        return self.add(_ops.MergeStage(n))

    def balance(self, n: int):
        return self.add(_ops.BalanceStage(n))

    def concat(self, n: int = 2):
        return self.add(_ops.ConcatStage(n))

    def zip(self):
        return self.add(_ops.ZipWithStage(lambda a, b: (a, b)))


class GraphDSL:
    """Arbitrary-graph construction (reference: scaladsl/GraphDSL.create):

        def build(g):
            bcast = g.broadcast(2)
            merge = g.merge(2)
            g.edge(g.source(Source.from_iterable(range(10))),
                   bcast.shape.in_)
            g.edge(g.flow(bcast.shape.outs[0], Flow().map(f)),
                   merge.shape.ins[0])
            g.edge(g.flow(bcast.shape.outs[1], Flow().map(h)),
                   merge.shape.ins[1])
            return g.sink(Sink.seq(), merge.shape.out)

        fut = GraphDSL.create(build).run(system)
    """

    @staticmethod
    def create(build_fn: Callable[["_GraphBuilder"], Any]) -> RunnableGraph:
        return RunnableGraph(lambda b: build_fn(_GraphBuilder(b)))


# -- Source gets the whole linear operator library ----------------------------
# (scaladsl/Source.scala mirrors Flow's operators; delegating through
# `self.via(Flow().<op>(...))` keeps one implementation per stage)
_SOURCE_MIRRORED_OPS = [
    "map", "map_concat", "stateful_map_concat", "filter", "filter_not",
    "collect", "take", "take_while", "drop", "drop_while", "scan", "fold",
    "reduce", "grouped", "sliding", "intersperse", "zip_with_index",
    "buffer", "conflate", "conflate_with_seed", "batch", "expand",
    "map_async", "map_async_unordered", "throttle", "delay", "recover",
    "log", "flat_map_concat", "via_stage",
    "group_by", "split_when", "split_after", "flat_map_merge",
    "prefix_and_tail", "merge_substreams", "concat_substreams",
    "take_within", "drop_within", "grouped_within", "limit",
    "limit_weighted", "initial_timeout", "completion_timeout",
    "idle_timeout", "keep_alive", "map_error", "deduplicate",
    "recover_with_retries", "watch_termination",
    "zip_latest", "zip_latest_with", "zip_all", "merge_sorted",
    "merge_prioritized", "divert_to", "fold_async", "scan_async",
    "on_error_complete", "async_", "also_to_all", "merge_all",
    "interleave_all", "concat_all_lazy", "collect_type",
    "flat_map_prefix", "extrapolate",
    "stateful_map", "map_with_resource", "map_async_partitioned",
    "grouped_weighted", "grouped_weighted_within", "batch_weighted",
    "initial_delay", "backpressure_timeout", "delay_with", "monitor",
    "fold_while", "merge_latest", "merge_latest_with", "ask", "watch",
    "detach", "recover_with", "collect_first", "collect_while",
    "flatten_merge", "switch_map",
]


def _mirror_op(name: str):
    def method(self, *args, **kwargs):
        flow = getattr(Flow(), name)(*args, **kwargs)
        combine = Keep.right if name == "watch_termination" else Keep.left
        return self.via(flow, combine)
    method.__name__ = name
    method.__qualname__ = f"Source.{name}"
    return method


for _name in _SOURCE_MIRRORED_OPS:
    if not hasattr(Source, _name):
        setattr(Source, _name, _mirror_op(_name))
del _name
