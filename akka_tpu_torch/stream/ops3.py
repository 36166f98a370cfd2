"""Operator library, third tranche: the remaining Flow/Source families the
round-2 verdict named — divertTo, mergeSorted/mergePrioritized,
zipLatest/zipAll, foldAsync/scanAsync, onErrorComplete, lazy/never sources.

A copy of `akka_tpu/stream/ops3.py` at commit 05a11d4 (host code, no
jax; the port keeps its own copy of every module it needs).

Reference parity: scaladsl/Flow.scala (divertTo :2061, mergeSorted,
mergePrioritized, zipLatest/zipLatestWith, zipAll, foldAsync, scanAsync,
onErrorComplete), scaladsl/Source.scala (lazySource/lazySingle, never),
impl/fusing/ZipLatestWith / MergeSorted / GraphStages.scala.
"""

from __future__ import annotations

import collections
from concurrent.futures import Future
from typing import Any, Callable, List, Optional

from .ops import _LinearStage, make_in_handler, make_out_handler
from .stage import (FanInShape, FanOutShape, GraphStage, GraphStageLogic,
                    Inlet, Outlet, SourceShape)


class DivertToStage(GraphStage):
    """1-in / 2-out: elements matching `when` leave via the divert outlet
    (wired to a Sink by the DSL), the rest continue downstream
    (scaladsl/Flow.scala divertTo)."""

    def __init__(self, when: Callable[[Any], bool]):
        self.name = "DivertTo"
        self.when = when
        self.in_ = Inlet("DivertTo.in")
        self.outs = [Outlet("DivertTo.main"), Outlet("DivertTo.divert")]
        self._shape = FanOutShape(self.in_, self.outs)

    @property
    def shape(self):
        return self._shape

    def create_logic(self):
        in_, (main, divert), when = self.in_, self.outs, self.when
        logic = GraphStageLogic(self._shape)

        def _maybe_pull():
            # need demand on BOTH open outlets before pulling: the element's
            # route is unknown until it arrives
            if all(logic.is_available(o) or logic.is_closed(o)
                   for o in (main, divert)) \
                    and not (logic.is_closed(main) and logic.is_closed(divert)) \
                    and not logic.has_been_pulled(in_) \
                    and not logic.is_closed(in_):
                logic.pull(in_)

        def on_push():
            elem = logic.grab(in_)
            target = divert if when(elem) else main
            if logic.is_closed(target):
                # reference parity: divertTo is Partition(eagerCancel=true)
                # — losing either route cancels the whole stream, so no
                # element is ever silently dropped (ADVICE r3)
                logic.complete_stage()
            else:
                logic.push(target, elem)

        def on_downstream_finish(cause=None):
            # eagerCancel: either outlet closing tears the stage down
            logic.cancel_stage(cause)

        logic.set_handler(in_, make_in_handler(
            on_push, lambda: logic.complete_stage()))
        for o in (main, divert):
            logic.set_handler(o, make_out_handler(_maybe_pull,
                                                  on_downstream_finish))
        return logic


class MergeSortedStage(GraphStage):
    """Merge two ALREADY-SORTED inputs into one sorted output
    (scaladsl/Flow.scala mergeSorted; impl MergeSorted.scala)."""

    def __init__(self, key: Optional[Callable[[Any], Any]] = None):
        self.name = "MergeSorted"
        self.key = key or (lambda x: x)
        self.ins = [Inlet("MSort.in0"), Inlet("MSort.in1")]
        self.out = Outlet("MSort.out")
        self._shape = FanInShape(self.ins, self.out)

    @property
    def shape(self):
        return self._shape

    def create_logic(self):
        i0, i1 = self.ins
        out, key = self.out, self.key
        # one-element lookahead per inlet
        head = {i0: None, i1: None}  # inlet -> [elem] | None
        logic = GraphStageLogic(self._shape)

        def _emit_if_ready():
            if not logic.is_available(out):
                return
            h0, h1 = head[i0], head[i1]
            c0, c1 = logic.is_closed(i0), logic.is_closed(i1)
            pick = None
            if h0 is not None and h1 is not None:
                pick = i0 if key(h0[0]) <= key(h1[0]) else i1
            elif h0 is not None and c1:
                pick = i0
            elif h1 is not None and c0:
                pick = i1
            elif h0 is None and h1 is None and c0 and c1:
                logic.complete(out)
                return
            if pick is None:
                for inlet in (i0, i1):
                    if head[inlet] is None and not logic.is_closed(inlet) \
                            and not logic.has_been_pulled(inlet):
                        logic.pull(inlet)
                return
            elem = head[pick][0]
            head[pick] = None
            logic.push(out, elem)
            if not logic.is_closed(pick):
                logic.pull(pick)
            elif head[i0] is None and head[i1] is None and \
                    logic.is_closed(i0) and logic.is_closed(i1):
                logic.complete(out)

        def mk_push(inlet):
            def on_push():
                head[inlet] = [logic.grab(inlet)]
                _emit_if_ready()
            return on_push

        def mk_finish(inlet):
            return _emit_if_ready

        for inlet in (i0, i1):
            logic.set_handler(inlet, make_in_handler(mk_push(inlet),
                                                     mk_finish(inlet)))
        logic.set_handler(out, make_out_handler(_emit_if_ready))
        return logic


class MergePrioritizedStage(GraphStage):
    """Merge n inputs; when several have an element buffered, the highest
    priority wins (deterministic form of scaladsl MergePrioritized — the
    reference randomizes proportionally to priorities; picking max keeps
    the test surface deterministic and the starvation-freedom property:
    a lone buffered element is always eligible)."""

    def __init__(self, priorities: List[int]):
        self.name = "MergePrioritized"
        if not priorities or any(p <= 0 for p in priorities):
            raise ValueError("priorities must be positive")
        self.priorities = list(priorities)
        self.ins = [Inlet(f"MPrio.in{i}") for i in range(len(priorities))]
        self.out = Outlet("MPrio.out")
        self._shape = FanInShape(self.ins, self.out)

    @property
    def shape(self):
        return self._shape

    def create_logic(self):
        ins, out, prios = self.ins, self.out, self.priorities
        buf = {inlet: None for inlet in ins}
        logic = GraphStageLogic(self._shape)

        def _emit_if_ready():
            if not logic.is_available(out):
                return
            ready = [(prios[i], i) for i, inlet in enumerate(ins)
                     if buf[inlet] is not None]
            if not ready:
                if all(logic.is_closed(i) for i in ins):
                    logic.complete(out)
                else:
                    for inlet in ins:
                        if buf[inlet] is None and not logic.is_closed(inlet) \
                                and not logic.has_been_pulled(inlet):
                            logic.pull(inlet)
                return
            _, idx = max(ready)
            inlet = ins[idx]
            elem = buf[inlet][0]
            buf[inlet] = None
            logic.push(out, elem)
            if not logic.is_closed(inlet):
                logic.pull(inlet)
            elif all(buf[i] is None for i in ins) and \
                    all(logic.is_closed(i) for i in ins):
                logic.complete(out)

        def mk_push(inlet):
            def on_push():
                buf[inlet] = [logic.grab(inlet)]
                _emit_if_ready()
            return on_push

        for inlet in ins:
            logic.set_handler(inlet, make_in_handler(mk_push(inlet),
                                                     _emit_if_ready))
        logic.set_handler(out, make_out_handler(_emit_if_ready))
        return logic


class ZipLatestStage(GraphStage):
    """Combine the LATEST value of each input; emits whenever either side
    produces a new element once both have produced at least one
    (scaladsl zipLatest / zipLatestWith)."""

    def __init__(self, fn: Callable[[Any, Any], Any]):
        self.name = "ZipLatest"
        self.fn = fn
        self.ins = [Inlet("ZLatest.in0"), Inlet("ZLatest.in1")]
        self.out = Outlet("ZLatest.out")
        self._shape = FanInShape(self.ins, self.out)

    @property
    def shape(self):
        return self._shape

    def create_logic(self):
        i0, i1 = self.ins
        out, fn = self.out, self.fn
        latest = {i0: None, i1: None}
        state = {"fresh": False}
        logic = GraphStageLogic(self._shape)

        def _emit_if_ready():
            if state["fresh"] and logic.is_available(out) and \
                    latest[i0] is not None and latest[i1] is not None:
                state["fresh"] = False
                logic.push(out, fn(latest[i0][0], latest[i1][0]))
            for inlet in (i0, i1):
                if not logic.is_closed(inlet) and \
                        not logic.has_been_pulled(inlet):
                    logic.pull(inlet)
            if all(logic.is_closed(i) for i in (i0, i1)) \
                    and not state["fresh"]:
                logic.complete(out)

        def mk_push(inlet):
            def on_push():
                latest[inlet] = [logic.grab(inlet)]
                state["fresh"] = True
                _emit_if_ready()
            return on_push

        def mk_finish(inlet):
            def on_finish():
                # a side that never produced ends the zip; otherwise defer
                # to _emit_if_ready, whose completion path is guarded on
                # `fresh` — completing here directly would drop a combined
                # element still waiting for downstream demand
                if latest[inlet] is None:
                    logic.complete_stage()
                else:
                    _emit_if_ready()
            return on_finish

        for inlet in (i0, i1):
            logic.set_handler(inlet, make_in_handler(mk_push(inlet),
                                                     mk_finish(inlet)))
        logic.set_handler(out, make_out_handler(_emit_if_ready))
        return logic


class ZipAllStage(GraphStage):
    """Zip two inputs, padding the exhausted side with its default until
    BOTH complete (scaladsl zipAll)."""

    def __init__(self, this_default: Any, that_default: Any):
        self.name = "ZipAll"
        self.d0 = this_default
        self.d1 = that_default
        self.ins = [Inlet("ZAll.in0"), Inlet("ZAll.in1")]
        self.out = Outlet("ZAll.out")
        self._shape = FanInShape(self.ins, self.out)

    @property
    def shape(self):
        return self._shape

    def create_logic(self):
        i0, i1 = self.ins
        out, d0, d1 = self.out, self.d0, self.d1
        logic = GraphStageLogic(self._shape)

        def _emit_if_ready():
            a0, a1 = logic.is_available(i0), logic.is_available(i1)
            c0, c1 = logic.is_closed(i0), logic.is_closed(i1)
            if not logic.is_available(out):
                return
            if a0 and a1:
                logic.push(out, (logic.grab(i0), logic.grab(i1)))
            elif a0 and c1:
                logic.push(out, (logic.grab(i0), d1))
            elif a1 and c0:
                logic.push(out, (d0, logic.grab(i1)))
            elif c0 and c1:
                logic.complete(out)
                return
            else:
                for inlet in (i0, i1):
                    if not logic.is_closed(inlet) and \
                            not logic.has_been_pulled(inlet) and \
                            not logic.is_available(inlet):
                        logic.pull(inlet)
                return
            for inlet in (i0, i1):
                if not logic.is_closed(inlet) and \
                        not logic.has_been_pulled(inlet) and \
                        not logic.is_available(inlet):
                    logic.pull(inlet)
            if logic.is_closed(i0) and logic.is_closed(i1) and \
                    not logic.is_available(i0) and not logic.is_available(i1):
                logic.complete(out)

        for inlet in (i0, i1):
            logic.set_handler(inlet, make_in_handler(_emit_if_ready,
                                                     _emit_if_ready))
        logic.set_handler(out, make_out_handler(_emit_if_ready))
        return logic


class FoldAsync(_LinearStage):
    """fold whose aggregate fn returns a Future (scaladsl foldAsync);
    one aggregation in flight at a time, emits the final value at end."""

    def __init__(self, zero: Any, fn: Callable[[Any, Any], Any],
                 emit_each: bool = False):
        super().__init__("ScanAsync" if emit_each else "FoldAsync")
        self.zero = zero
        self.fn = fn
        self.emit_each = emit_each  # True = scanAsync semantics

    def create_logic(self):
        in_, out = self.in_, self.out
        zero, fn, emit_each = self.zero, self.fn, self.emit_each
        state = {"acc": zero, "busy": False, "finishing": False,
                 "emitted_zero": False, "pending_emit": False}

        logic = GraphStageLogic(self._shape)

        def _finish():
            if emit_each:
                if not state["emitted_zero"]:
                    # upstream finished before the first downstream pull:
                    # scan still owes the zero (reference Scan always
                    # emits it; ADVICE r3 — this was timing-dependent)
                    state["emitted_zero"] = True
                    logic.emit(out, state["acc"])
                logic.complete(out)
            elif logic.is_available(out):
                logic.push(out, state["acc"])
                logic.complete(out)
            else:
                state["pending_emit"] = True

        def _completed(res):
            ex, val = res
            state["busy"] = False
            if ex is not None:
                logic.fail_stage(ex)
                return
            state["acc"] = val
            if emit_each:
                if logic.is_available(out):
                    logic.push(out, val)
                else:
                    state["pending_emit"] = True
            if state["finishing"]:
                if not (emit_each and state["pending_emit"]):
                    _finish()
            elif not logic.has_been_pulled(in_) and not logic.is_closed(in_):
                logic.pull(in_)

        def on_push():
            elem = logic.grab(in_)
            state["busy"] = True
            cb = logic.get_async_callback(_completed)
            try:
                fut = fn(state["acc"], elem)
            except Exception as e:  # noqa: BLE001
                logic.fail_stage(e)
                return
            if isinstance(fut, Future):
                fut.add_done_callback(
                    lambda f: cb.invoke((f.exception(), None)
                                        if f.exception() is not None
                                        else (None, f.result())))
            else:
                _completed((None, fut))

        def on_finish():
            state["finishing"] = True
            if not state["busy"] and not state["pending_emit"]:
                _finish()

        logic.set_handler(in_, make_in_handler(on_push, on_finish))

        def on_pull():
            if emit_each and not state["emitted_zero"]:
                state["emitted_zero"] = True
                logic.push(out, state["acc"])  # scan emits zero first
                return
            if state["pending_emit"]:
                state["pending_emit"] = False
                if emit_each:
                    logic.push(out, state["acc"])
                    if state["finishing"] and not state["busy"]:
                        logic.complete(out)
                else:
                    logic.push(out, state["acc"])
                    logic.complete(out)
                return
            if not state["busy"] and not state["finishing"] and \
                    not logic.has_been_pulled(in_) and \
                    not logic.is_closed(in_):
                logic.pull(in_)
        logic.set_handler(out, make_out_handler(on_pull))
        return logic


class OnErrorComplete(_LinearStage):
    """Swallow a matching upstream failure and complete instead
    (scaladsl onErrorComplete)."""

    def __init__(self, pred: Optional[Callable[[BaseException], bool]] = None):
        super().__init__("OnErrorComplete")
        self.pred = pred or (lambda e: True)

    def create_logic(self):
        in_, out, pred = self.in_, self.out, self.pred
        logic = GraphStageLogic(self._shape)

        def on_fail(ex):
            if pred(ex):
                logic.complete(out)
            else:
                logic.fail_stage(ex)

        logic.set_handler(in_, make_in_handler(
            lambda: logic.push(out, logic.grab(in_)),
            lambda: logic.complete_stage(), on_fail))
        logic.set_handler(out, make_out_handler(lambda: logic.pull(in_)))
        return logic


class NeverSink(GraphStage):
    """Signals no demand, ever (scaladsl Sink.never)."""

    def __init__(self):
        self.name = "NeverSink"
        self.in_ = Inlet("NeverSink.in")
        from .stage import SinkShape
        self._shape = SinkShape(self.in_)

    @property
    def shape(self):
        return self._shape

    def create_logic(self):
        logic = GraphStageLogic(self._shape)
        logic.set_handler(self.in_, make_in_handler(lambda: None))
        return logic


class NeverSource(GraphStage):
    """Emits nothing and never completes (scaladsl Source.never)."""

    def __init__(self):
        self.name = "NeverSource"
        self.out = Outlet("Never.out")
        self._shape = SourceShape(self.out)

    @property
    def shape(self):
        return self._shape

    def create_logic(self):
        logic = GraphStageLogic(self._shape)
        logic.set_handler(self.out, make_out_handler(lambda: None))
        return logic


class UnfoldResourceSource(GraphStage):
    """Source.unfoldResource as a real stage: the resource is opened at
    pre_start and closed in post_stop, which the interpreter runs on EVERY
    termination path — exhaustion, stage failure, and downstream cancel
    (reference: impl/UnfoldResourceSource.scala; the close must not wait
    for GC)."""

    def __init__(self, create: Callable[[], Any],
                 read: Callable[[Any], Optional[Any]],
                 close: Callable[[Any], None]):
        self.name = "UnfoldResourceSource"
        self.create = create
        self.read = read
        self.close = close
        self.out = Outlet("UnfoldResource.out")
        self._shape = SourceShape(self.out)

    @property
    def shape(self):
        return self._shape

    def create_logic(self):
        stage = self
        out = self.out
        state = {"resource": None, "open": False}

        class _L(GraphStageLogic):
            def pre_start(self):
                state["resource"] = stage.create()
                state["open"] = True

            def post_stop(self):
                if state["open"]:
                    state["open"] = False
                    stage.close(state["resource"])

        logic = _L(self._shape)

        def _reopen():
            # Supervision.restart: close the (possibly wedged) resource and
            # open a fresh one before the retried read (reference
            # UnfoldResourceSource restartState)
            if state["open"]:
                state["open"] = False
                stage.close(state["resource"])
            state["resource"] = stage.create()
            state["open"] = True
        logic.restart_state = _reopen

        def on_pull():
            v = stage.read(state["resource"])
            if v is None:
                logic.complete(out)
            else:
                logic.push(out, v)
        logic.set_handler(out, make_out_handler(on_pull))
        return logic
