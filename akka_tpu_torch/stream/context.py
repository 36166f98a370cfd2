"""SourceWithContext / FlowWithContext: data with a carried context.

A copy of `akka_tpu/stream/context.py` at commit 43876c4 (host code, no
jax; the port keeps its own copy of every module it needs).

Reference parity: akka-stream scaladsl SourceWithContext.scala /
FlowWithContext.scala — a stream of (data, context) pairs where the
operator vocabulary applies to the DATA while the context follows each
element automatically (the pattern behind offset-committing Kafka
pipelines: the committable offset rides as context). Context rules match
the reference:

- map/mapAsync transform data, context unchanged
- filter/collect drop the pair together
- mapConcat duplicates the context onto every expanded element
- grouped emits (list of data, list of contexts)
- unsafe/arbitrary reordering ops are NOT exposed (the reference
  deliberately restricts the vocabulary so contexts can't be lost or
  reordered silently)

Internally a thin wrapper over a Source/Flow of (data, ctx) tuples —
`as_source()`/`as_flow()` unwraps, `via(...)` composes wrappers.
"""

from __future__ import annotations

from typing import Any, Callable

from .dsl import Flow, Keep, Sink, Source


def _pairify(fn):
    """Lift fn(data) -> data onto (data, ctx) pairs."""
    return lambda p: (fn(p[0]), p[1])


class FlowWithContext:
    """(reference: scaladsl/FlowWithContext.scala)"""

    def __init__(self, under: Flow):
        self._under = under  # Flow of (data, ctx) -> (data, ctx)

    # -- creation -------------------------------------------------------------
    @staticmethod
    def create() -> "FlowWithContext":
        return FlowWithContext(Flow())

    @staticmethod
    def from_tuples(flow: Flow) -> "FlowWithContext":
        """Wrap a Flow that already processes (data, ctx) tuples
        (reference: FlowWithContext.fromTuples)."""
        return FlowWithContext(flow)

    def as_flow(self) -> Flow:
        """The underlying Flow of (data, ctx) tuples (asFlow)."""
        return self._under

    # -- data ops (context follows) ------------------------------------------
    def map(self, fn) -> "FlowWithContext":
        return FlowWithContext(self._under.map(_pairify(fn)))

    def map_error(self, fn) -> "FlowWithContext":
        return FlowWithContext(self._under.map_error(fn))

    def map_async(self, parallelism: int, fn) -> "FlowWithContext":
        from concurrent.futures import Future

        def lifted(p):
            data, ctx = p
            fut = fn(data)
            if isinstance(fut, Future):
                out: Future = Future()

                def done(f):
                    if f.exception() is not None:
                        out.set_exception(f.exception())
                    else:
                        out.set_result((f.result(), ctx))
                fut.add_done_callback(done)
                return out
            return (fut, ctx)
        return FlowWithContext(self._under.map_async(parallelism, lifted))

    def filter(self, pred) -> "FlowWithContext":
        return FlowWithContext(self._under.filter(lambda p: pred(p[0])))

    def filter_not(self, pred) -> "FlowWithContext":
        return FlowWithContext(self._under.filter(lambda p: not pred(p[0])))

    def collect(self, fn) -> "FlowWithContext":
        """fn returns None to drop the pair (partial-function analogue)."""
        def lifted(p):
            v = fn(p[0])
            return None if v is None else (v, p[1])
        return FlowWithContext(self._under.collect(lifted))

    def map_concat(self, fn) -> "FlowWithContext":
        """Each output element carries the ORIGINAL element's context."""
        def lifted(p):
            data, ctx = p
            return [(v, ctx) for v in fn(data)]
        return FlowWithContext(self._under.map_concat(lifted))

    def grouped(self, n: int) -> "FlowWithContext":
        """Emits ([data...], [ctx...]) per group (reference grouped)."""
        def split(grp):
            return ([d for d, _c in grp], [c for _d, c in grp])
        return FlowWithContext(self._under.grouped(n).map(split))

    def sliding(self, n: int, step: int = 1) -> "FlowWithContext":
        def split(grp):
            return ([d for d, _c in grp], [c for _d, c in grp])
        return FlowWithContext(self._under.sliding(n, step).map(split))

    def map_context(self, fn) -> "FlowWithContext":
        """Transform the CONTEXT, data unchanged (mapContext)."""
        return FlowWithContext(self._under.map(lambda p: (p[0], fn(p[1]))))

    def log(self, name: str, extract=lambda x: x) -> "FlowWithContext":
        return FlowWithContext(self._under.log(name,
                                               lambda p: extract(p[0])))

    def throttle(self, elements: int, per_seconds: float,
                 **kw) -> "FlowWithContext":
        return FlowWithContext(self._under.throttle(elements, per_seconds,
                                                    **kw))

    # -- composition ----------------------------------------------------------
    def via(self, other: "FlowWithContext") -> "FlowWithContext":
        return FlowWithContext(self._under.via(other._under))

    def with_attributes(self, attrs) -> "FlowWithContext":
        return FlowWithContext(self._under.with_attributes(attrs))


class SourceWithContext:
    """(reference: scaladsl/SourceWithContext.scala)"""

    def __init__(self, under: Source):
        self._under = under  # Source of (data, ctx)

    @staticmethod
    def from_tuples(source: Source) -> "SourceWithContext":
        return SourceWithContext(source)

    def as_source(self) -> Source:
        return self._under

    def via(self, flow: FlowWithContext) -> "SourceWithContext":
        return SourceWithContext(self._under.via(flow.as_flow()))

    def with_attributes(self, attrs) -> "SourceWithContext":
        return SourceWithContext(self._under.with_attributes(attrs))

    # mirror the FlowWithContext vocabulary by delegation
    def _lift(self, name, *args, **kw) -> "SourceWithContext":
        fwc = getattr(FlowWithContext.create(), name)(*args, **kw)
        return self.via(fwc)

    def map(self, fn):
        return self._lift("map", fn)

    def map_error(self, fn):
        return self._lift("map_error", fn)

    def map_async(self, parallelism, fn):
        return self._lift("map_async", parallelism, fn)

    def filter(self, pred):
        return self._lift("filter", pred)

    def filter_not(self, pred):
        return self._lift("filter_not", pred)

    def collect(self, fn):
        return self._lift("collect", fn)

    def map_concat(self, fn):
        return self._lift("map_concat", fn)

    def grouped(self, n):
        return self._lift("grouped", n)

    def sliding(self, n, step=1):
        return self._lift("sliding", n, step)

    def map_context(self, fn):
        return self._lift("map_context", fn)

    def log(self, name, extract=lambda x: x):
        return self._lift("log", name, extract)

    def throttle(self, elements, per_seconds, **kw):
        return self._lift("throttle", elements, per_seconds, **kw)

    # -- run ------------------------------------------------------------------
    def to_mat(self, sink: Sink, combine=Keep.right):
        return self._under.to_mat(sink, combine)

    def run_with(self, sink: Sink, materializer_or_system):
        return self._under.run_with(sink, materializer_or_system)


def _source_as_source_with_context(self, extract_ctx: Callable[[Any], Any]
                                   ) -> SourceWithContext:
    """Source.as_source_with_context(f): pair every element with f(elem)
    as its carried context (reference: Source.asSourceWithContext)."""
    return SourceWithContext(self.map(lambda x: (x, extract_ctx(x))))


def _flow_as_flow_with_context(self, collapse: Callable[[Any, Any], Any],
                               extract_ctx: Callable[[Any], Any]
                               ) -> FlowWithContext:
    """Flow.as_flow_with_context(collapse, extract): adapt a plain Flow —
    incoming (data, ctx) pairs are collapsed into the Flow's input
    elements, contexts are re-extracted from its outputs (reference:
    Flow.asFlowWithContext)."""
    inner = self

    def build_pair_flow():
        return Flow().map(lambda p: collapse(p[0], p[1])).via(inner) \
            .map(lambda out: (out, extract_ctx(out)))
    return FlowWithContext(build_pair_flow())


Source.as_source_with_context = _source_as_source_with_context
Flow.as_flow_with_context = _flow_as_flow_with_context
