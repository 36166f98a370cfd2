"""Sub-stream operators: groupBy, splitWhen/splitAfter, flatMapMerge,
prefixAndTail.

A copy of `akka_tpu/stream/substreams.py` at commit 05a11d4 (host code, no
jax; the port keeps its own copy of every module it needs).

Reference parity: akka-stream's stream-of-streams stages
(impl/fusing/StreamOfStreams.scala — GroupBy, Split, FlattenMerge;
scaladsl/Flow.scala groupBy/splitWhen/flatMapMerge/prefixAndTail). The
architecture differs host-style: each sub-stream is a queue-fed Source
the consumer materializes as its own interpreter actor (our hubs already
follow this shape), rather than a nested logic inside the parent
interpreter. Demand propagates through the bounded sub-queues.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List, Optional

from .ops import SourceQueue, _LinearStage, make_in_handler, make_out_handler
from .stage import (GraphStage, GraphStageLogic, Outlet, SourceShape)


class _PrefedQueueSource(GraphStage):
    """A QueueSource whose SourceQueue exists BEFORE materialization — the
    parent stage feeds it while the consumer decides when (whether) to run
    the sub-source. Offers before materialization buffer in the queue's
    early list."""

    def __init__(self, queue: SourceQueue, buffer_size: int = 1024):
        self.queue = queue
        self.buffer_size = buffer_size
        self.out = Outlet("PrefedQueueSource.out")
        self._shape = SourceShape(self.out)

    @property
    def shape(self):
        return self._shape

    def create_logic_and_mat(self):
        stage = self
        buf: collections.deque = collections.deque()
        state = {"completing": False}
        size_box = getattr(stage.queue, "size_box", None)

        def dec():
            if size_box is not None:
                size_box[0] -= 1

        class _L(GraphStageLogic):
            def pre_start(self):
                stage.queue._bind(
                    self.get_async_callback(self._on_offer),
                    self.get_async_callback(self._on_done))

            def _on_offer(self, pair):
                elem, fut = pair
                if state["completing"]:
                    fut.set_result(False)
                    return
                if self.is_available(stage.out) and not buf:
                    self.push(stage.out, elem)
                    dec()
                    fut.set_result(True)
                else:
                    # NEVER silently drop a sub-stream element: the parent
                    # throttles its upstream pulls on size_box, so growth
                    # past buffer_size means the parent is mid-flight —
                    # bounded by its in-flight window, not by luck
                    buf.append(elem)
                    fut.set_result(True)

            def _on_done(self, item):
                if item[0] == "fail":
                    self.fail_stage(item[1])
                    return
                state["completing"] = True
                if not buf:
                    self.complete(stage.out)

            def post_stop(self):
                stage.queue._set_closed()

        logic = _L(self._shape)

        def on_pull():
            if buf:
                logic.push(stage.out, buf.popleft())
                dec()
            if state["completing"] and not buf:
                logic.complete(stage.out)

        logic.set_handler(stage.out, make_out_handler(on_pull))
        return logic, None


def _sub_source(queue: SourceQueue, buffer_size: int):
    from .dsl import Source
    return Source.from_graph(
        lambda: _PrefedQueueSource(queue, buffer_size))


def _new_queue() -> SourceQueue:
    q = SourceQueue()
    q.size_box = [0]  # in-flight elements; the parent throttles on this
    return q


def _offer(q: SourceQueue, elem) -> None:
    q.size_box[0] += 1
    q.offer(elem)


_RESUME_POLL = 0.005  # parent re-checks a throttled sub-queue at 200Hz


class GroupBy(_LinearStage):
    """Demultiplex by key: emits (key, Source) ONCE per distinct key; every
    element is offered to its key's sub-queue (StreamOfStreams.scala
    GroupBy). Exceeding max_substreams fails the stage, like the
    reference."""

    def __init__(self, max_substreams: int, key_fn: Callable[[Any], Any],
                 sub_buffer: int = 1024):
        super().__init__("GroupBy")
        self.max_substreams = max_substreams
        self.key_fn = key_fn
        self.sub_buffer = sub_buffer

    def create_logic(self):
        from .ops2 import _TimerLogic
        logic = _TimerLogic(self._shape)
        in_, out = self.in_, self.out
        stage = self
        queues: Dict[Any, SourceQueue] = {}

        def throttled() -> bool:
            return any(q.size_box[0] >= stage.sub_buffer
                       for q in queues.values())

        def maybe_pull():
            if logic.is_closed(in_) or logic.has_been_pulled(in_):
                return
            if throttled():
                logic.schedule_once("resume", _RESUME_POLL)
            else:
                logic.pull(in_)

        logic._on_timer_fn = lambda key: maybe_pull()

        def on_push():
            elem = logic.grab(in_)
            key = stage.key_fn(elem)
            q = queues.get(key)
            if q is None:
                if len(queues) >= stage.max_substreams:
                    logic.fail_stage(RuntimeError(
                        f"too many substreams (max {stage.max_substreams})"))
                    return
                q = queues[key] = _new_queue()
                _offer(q, elem)
                logic.push(out, (key, _sub_source(q, stage.sub_buffer)))
            else:
                _offer(q, elem)
                maybe_pull()

        def on_finish():
            for q in queues.values():
                q.complete()
            logic.complete_stage()

        logic.set_handler(in_, make_in_handler(on_push, on_finish))
        logic.set_handler(out, make_out_handler(maybe_pull))
        return logic


class SplitWhen(_LinearStage):
    """Start a NEW sub-stream whenever the predicate fires (splitWhen; with
    after=True, the splitting element CLOSES the current sub-stream instead
    — splitAfter). Emits each sub-stream as a Source."""

    def __init__(self, predicate: Callable[[Any], bool], after: bool = False,
                 sub_buffer: int = 1024):
        super().__init__("SplitAfter" if after else "SplitWhen")
        self.predicate = predicate
        self.after = after
        self.sub_buffer = sub_buffer

    def create_logic(self):
        from .ops2 import _TimerLogic
        logic = _TimerLogic(self._shape)
        in_, out = self.in_, self.out
        stage = self
        current: List[Optional[SourceQueue]] = [None]
        # sub-sources born before downstream pulled again: the parent keeps
        # CONSUMING upstream while an emitted sub-stream is drained — the
        # demand link the reference wires through SubSource/SubSink pairs;
        # bounding pending emissions + sub-queue depth applies the
        # downstream backpressure
        pending: collections.deque = collections.deque()

        def open_sub(first_elem) -> None:
            q = _new_queue()
            current[0] = q
            _offer(q, first_elem)
            src = _sub_source(q, stage.sub_buffer)
            if logic.is_available(out):
                logic.push(out, src)
            else:
                pending.append(src)

        def maybe_pull():
            if logic.is_closed(in_) or logic.has_been_pulled(in_) or \
                    len(pending) > 1:
                return
            q = current[0]
            if q is not None and q.size_box[0] >= stage.sub_buffer:
                logic.schedule_once("resume", _RESUME_POLL)
            else:
                logic.pull(in_)

        logic._on_timer_fn = lambda key: maybe_pull()

        def on_push():
            elem = logic.grab(in_)
            if current[0] is None:
                open_sub(elem)
            elif stage.after:
                _offer(current[0], elem)
                if stage.predicate(elem):
                    current[0].complete()
                    current[0] = None
            elif stage.predicate(elem):
                current[0].complete()
                open_sub(elem)
            else:
                _offer(current[0], elem)
            maybe_pull()

        def on_finish():
            if current[0] is not None:
                current[0].complete()
            if pending:
                logic.emit_multiple(out, list(pending))
                pending.clear()
            logic.complete_stage()

        def on_pull():
            if pending:
                logic.push(out, pending.popleft())
            maybe_pull()

        logic.set_handler(in_, make_in_handler(on_push, on_finish))
        logic.set_handler(out, make_out_handler(on_pull))
        return logic


class FlatMapMerge(_LinearStage):
    """Map each element to a Source and run up to `breadth` of them
    concurrently, merging their outputs as they arrive
    (StreamOfStreams.scala FlattenMerge). Sub-sources materialize as their
    own interpreter actors feeding this stage through async callbacks."""

    def __init__(self, breadth: int, fn: Callable[[Any], Any]):
        super().__init__("FlatMapMerge")
        self.breadth = breadth
        self.fn = fn

    def create_logic(self):
        logic, in_, out = self._logic(), self.in_, self.out
        stage = self
        buf: collections.deque = collections.deque()
        state = {"active": 0, "upstream_done": False}
        switches: set = set()  # live sub-stream kill switches

        def maybe_finish():
            if state["upstream_done"] and state["active"] == 0 and not buf:
                logic.complete_stage()

        def start_sub(src) -> None:
            from .dsl import Keep, Sink
            from .killswitch import KillSwitches
            state["active"] += 1
            on_elem = logic.get_async_callback(sub_elem)
            on_done = logic.get_async_callback(sub_done)
            # a kill switch rides every sub-stream so stage teardown (fail,
            # cancel, system stop) also stops still-running sub-interpreters
            sw, fut = (src.via_mat(KillSwitches.single(), Keep.right)
                       .to(Sink.foreach(lambda e: on_elem.invoke(e)), Keep.both)
                       .run(logic.materializer))
            switches.add(sw)
            fut.add_done_callback(lambda f: on_done.invoke((sw, f)))

        def sub_elem(elem):
            if logic.is_available(out) and not buf:
                logic.push(out, elem)
            else:
                buf.append(elem)

        def sub_done(sw_fut):
            sw, fut = sw_fut
            switches.discard(sw)
            state["active"] -= 1
            exc = fut.exception() if fut is not None else None
            if exc is not None:
                logic.fail_stage(exc)
                return
            if not state["upstream_done"] and state["active"] < stage.breadth \
                    and not logic.has_been_pulled(in_) \
                    and not logic.is_closed(in_):
                logic.pull(in_)
            maybe_finish()

        def on_push():
            src = stage.fn(logic.grab(in_))
            start_sub(src)
            if state["active"] < stage.breadth:
                logic.pull(in_)

        def on_finish():
            state["upstream_done"] = True
            maybe_finish()

        def on_pull():
            if buf:
                logic.push(out, buf.popleft())
                maybe_finish()
            elif not logic.has_been_pulled(in_) and not logic.is_closed(in_) \
                    and state["active"] < stage.breadth:
                logic.pull(in_)
            else:
                maybe_finish()

        def post_stop():
            # stage is going away for ANY reason — kill surviving sub-streams
            for sw in list(switches):
                try:
                    sw.shutdown()
                except Exception:  # noqa: BLE001
                    pass
            switches.clear()

        logic.post_stop = post_stop
        logic.set_handler(in_, make_in_handler(on_push, on_finish))
        logic.set_handler(out, make_out_handler(on_pull))
        return logic


class PrefixAndTail(_LinearStage):
    """Emit ([first n elements], Source-of-the-rest) once, then complete
    (scaladsl/Flow.scala prefixAndTail)."""

    def __init__(self, n: int, sub_buffer: int = 1024):
        super().__init__("PrefixAndTail")
        self.n = n
        self.sub_buffer = sub_buffer

    def create_logic(self):
        from .ops2 import _TimerLogic
        logic = _TimerLogic(self._shape)
        in_, out = self.in_, self.out
        stage = self
        prefix: List[Any] = []
        tail: List[Optional[SourceQueue]] = [None]

        def tail_pull():
            if logic.is_closed(in_) or logic.has_been_pulled(in_):
                return
            if tail[0] is not None and \
                    tail[0].size_box[0] >= stage.sub_buffer:
                logic.schedule_once("resume", _RESUME_POLL)
            else:
                logic.pull(in_)

        logic._on_timer_fn = lambda key: tail_pull()

        def on_push():
            elem = logic.grab(in_)
            if tail[0] is None:
                prefix.append(elem)
                if len(prefix) >= stage.n:
                    q = _new_queue()
                    tail[0] = q
                    logic.set_keep_going(True)  # outlive the outer cancel
                    logic.push(out, (list(prefix),
                                     _sub_source(q, stage.sub_buffer)))
                    tail_pull()  # tail drain is self-driven
                else:
                    logic.pull(in_)
            else:
                _offer(tail[0], elem)
                tail_pull()

        def on_finish():
            if tail[0] is None:
                # short stream: emit what we have + an empty tail
                q = _new_queue()
                q.complete()
                logic.emit(out, (list(prefix),
                                 _sub_source(q, stage.sub_buffer)))
                logic.complete_stage()
            else:
                tail[0].complete()
                logic.complete_stage()

        def on_downstream_finish(cause=None):
            # the outer stream (typically Sink.head) cancelling must NOT
            # cancel upstream while the tail sub-stream is still live —
            # the tail keeps draining through the queue
            if tail[0] is None:
                logic.cancel_stage(cause)

        logic.set_handler(in_, make_in_handler(on_push, on_finish))
        logic.set_handler(out, make_out_handler(
            lambda: logic.has_been_pulled(in_) or logic.is_closed(in_)
            or logic.pull(in_), on_downstream_finish))
        return logic
