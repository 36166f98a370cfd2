"""Operator library, second tranche: timed windows, limits, timeouts,
dedup, recover-with, watch-termination.

A copy of `akka_tpu/stream/ops2.py` at commit 05a11d4 (host code, no
jax; the port keeps its own copy of every module it needs).

Reference parity: scaladsl/Flow.scala (196 defs) — takeWithin/dropWithin/
groupedWithin (impl/fusing/Ops.scala timed stages), limit/limitWeighted,
initialTimeout/completionTimeout/idleTimeout (impl/Timers.scala),
keepAlive, recoverWithRetries, watchTermination, statefulMap-backed
deduplicate."""

from __future__ import annotations

import time as _time
from concurrent.futures import Future
from typing import Any, Callable, List, Optional

from .ops import _LinearStage, make_in_handler, make_out_handler
from .stage import GraphStageLogic


class StreamLimitReachedException(RuntimeError):
    pass


class _TimerLogic(GraphStageLogic):
    """GraphStageLogic with a pluggable on_timer."""

    def __init__(self, shape, on_timer_fn=None):
        super().__init__(shape)
        self._on_timer_fn = on_timer_fn

    def on_timer(self, key):
        if self._on_timer_fn is not None:
            self._on_timer_fn(key)


class TakeWithin(_LinearStage):
    def __init__(self, seconds: float):
        super().__init__("TakeWithin")
        self.seconds = seconds

    def create_logic(self):
        stage = self
        logic = _TimerLogic(self._shape)
        logic._on_timer_fn = lambda key: logic.complete_stage()
        in_, out = self.in_, self.out

        def pre_start():
            logic.schedule_once("deadline", stage.seconds)
        logic.pre_start = pre_start  # type: ignore[method-assign]

        logic.set_handler(in_, make_in_handler(
            lambda: logic.push(out, logic.grab(in_))))
        logic.set_handler(out, make_out_handler(lambda: logic.pull(in_)))
        return logic


class DropWithin(_LinearStage):
    def __init__(self, seconds: float):
        super().__init__("DropWithin")
        self.seconds = seconds

    def create_logic(self):
        stage = self
        logic = _TimerLogic(self._shape)
        in_, out = self.in_, self.out
        state = {"open": False}
        logic._on_timer_fn = lambda key: state.update(open=True)

        def pre_start():
            logic.schedule_once("deadline", stage.seconds)
        logic.pre_start = pre_start  # type: ignore[method-assign]

        def on_push():
            elem = logic.grab(in_)
            if state["open"]:
                logic.push(out, elem)
            else:
                logic.pull(in_)

        logic.set_handler(in_, make_in_handler(on_push))
        logic.set_handler(out, make_out_handler(lambda: logic.pull(in_)))
        return logic


class GroupedWithin(_LinearStage):
    """Batch up to n elements or a time window, whichever fires first
    (groupedWithin)."""

    def __init__(self, n: int, seconds: float):
        super().__init__("GroupedWithin")
        self.n = n
        self.seconds = seconds

    def create_logic(self):
        stage = self
        logic = _TimerLogic(self._shape)
        in_, out = self.in_, self.out
        buf: List[Any] = []
        pending: List[List[Any]] = []

        def flush():
            if buf:
                pending.append(list(buf))
                buf.clear()

        def deliver():
            if pending and logic.is_available(out):
                logic.push(out, pending.pop(0))
                return True
            return False

        def on_timer(key):
            flush()
            deliver()

        logic._on_timer_fn = on_timer

        def pre_start():
            logic.schedule_periodically("window", stage.seconds,
                                        stage.seconds)
            logic.pull(in_)
        logic.pre_start = pre_start  # type: ignore[method-assign]

        def on_push():
            buf.append(logic.grab(in_))
            if len(buf) >= stage.n:
                flush()
            deliver()
            # backpressure: stop pulling while flushed groups back up (the
            # reference's groupedWithin holds demand until consumed)
            if len(pending) < 2 and not logic.is_closed(in_) and \
                    not logic.has_been_pulled(in_):
                logic.pull(in_)

        def on_finish():
            flush()
            for group in pending:
                logic.emit(out, group)
            pending.clear()
            logic.complete_stage()

        logic.set_handler(in_, make_in_handler(on_push, on_finish))
        logic.set_handler(out, make_out_handler(
            lambda: deliver() or (not logic.has_been_pulled(in_)
                                  and not logic.is_closed(in_)
                                  and logic.pull(in_))))
        return logic


class Limit(_LinearStage):
    def __init__(self, max_elements: int, cost_fn: Optional[Callable] = None):
        super().__init__("Limit")
        self.max = max_elements
        self.cost_fn = cost_fn

    def create_logic(self):
        logic, in_, out = self._logic(), self.in_, self.out
        stage = self
        seen = [0]

        def on_push():
            elem = logic.grab(in_)
            seen[0] += stage.cost_fn(elem) if stage.cost_fn else 1
            if seen[0] > stage.max:
                logic.fail_stage(StreamLimitReachedException(
                    f"limit of {stage.max} exceeded"))
                return
            logic.push(out, elem)

        logic.set_handler(in_, make_in_handler(on_push))
        logic.set_handler(out, make_out_handler(lambda: logic.pull(in_)))
        return logic


class _TimeoutBase(_LinearStage):
    kind = "initial"   # initial | completion | idle

    def __init__(self, seconds: float):
        super().__init__(f"{self.kind.capitalize()}Timeout")
        self.seconds = seconds

    def create_logic(self):
        stage = self
        logic = _TimerLogic(self._shape)
        in_, out = self.in_, self.out
        state = {"got_first": False}

        def on_timer(key):
            if stage.kind == "initial" and state["got_first"]:
                return
            logic.fail_stage(TimeoutError(
                f"{stage.kind} timeout after {stage.seconds}s"))

        logic._on_timer_fn = on_timer

        def pre_start():
            logic.schedule_once("t", stage.seconds)
        logic.pre_start = pre_start  # type: ignore[method-assign]

        def on_push():
            state["got_first"] = True
            if stage.kind == "idle":
                logic.schedule_once("t", stage.seconds)  # re-arm
            logic.push(out, logic.grab(in_))

        logic.set_handler(in_, make_in_handler(on_push))
        logic.set_handler(out, make_out_handler(lambda: logic.pull(in_)))
        return logic


class InitialTimeout(_TimeoutBase):
    kind = "initial"


class CompletionTimeout(_TimeoutBase):
    kind = "completion"


class IdleTimeout(_TimeoutBase):
    kind = "idle"


class KeepAlive(_LinearStage):
    """Inject a heartbeat element when no element flowed for `seconds`
    (keepAlive)."""

    def __init__(self, seconds: float, inject_fn: Callable[[], Any]):
        super().__init__("KeepAlive")
        self.seconds = seconds
        self.inject_fn = inject_fn

    def create_logic(self):
        stage = self
        logic = _TimerLogic(self._shape)
        in_, out = self.in_, self.out
        held: List[Any] = []  # upstream element that arrived demand-less
                              # because a heartbeat consumed the pull

        def on_timer(key):
            # inject only when demand exists AND no upstream element is in
            # flight toward that demand (we pulled but not yet received) —
            # otherwise the real element would arrive with no demand left
            if logic.is_available(out) and not held and \
                    not logic.has_been_pulled(in_):
                logic.push(out, stage.inject_fn())

        logic._on_timer_fn = on_timer

        def pre_start():
            logic.schedule_periodically("ka", stage.seconds, stage.seconds)
        logic.pre_start = pre_start  # type: ignore[method-assign]

        def on_push():
            logic.schedule_periodically("ka", stage.seconds, stage.seconds)
            elem = logic.grab(in_)
            if logic.is_available(out):
                logic.push(out, elem)
            else:
                held.append(elem)

        def on_pull():
            if held:
                logic.push(out, held.pop())
            elif not logic.is_closed(in_) and not logic.has_been_pulled(in_):
                logic.pull(in_)

        logic.set_handler(in_, make_in_handler(on_push))
        logic.set_handler(out, make_out_handler(on_pull))
        return logic


class MapError(_LinearStage):
    def __init__(self, fn: Callable[[BaseException], BaseException]):
        super().__init__("MapError")
        self.fn = fn

    def create_logic(self):
        logic, in_, out = self._logic(), self.in_, self.out
        stage = self

        def on_failure(ex):
            try:
                mapped = stage.fn(ex)
            except Exception as e:  # noqa: BLE001
                mapped = e
            logic.fail_stage(mapped)

        logic.set_handler(in_, make_in_handler(
            lambda: logic.push(out, logic.grab(in_)), None, on_failure))
        logic.set_handler(out, make_out_handler(lambda: logic.pull(in_)))
        return logic


class Deduplicate(_LinearStage):
    """Drop consecutive repeats (the statefulMap-based dedup pattern)."""

    def __init__(self, key_fn: Optional[Callable] = None):
        super().__init__("Deduplicate")
        self.key_fn = key_fn or (lambda x: x)

    def create_logic(self):
        logic, in_, out = self._logic(), self.in_, self.out
        stage = self
        last: List[Any] = []

        def on_push():
            elem = logic.grab(in_)
            key = stage.key_fn(elem)
            if last and last[0] == key:
                logic.pull(in_)
            else:
                last[:] = [key]
                logic.push(out, elem)

        logic.set_handler(in_, make_in_handler(on_push))
        logic.set_handler(out, make_out_handler(lambda: logic.pull(in_)))
        return logic


class RecoverWithRetries(_LinearStage):
    """On upstream failure, switch to fn(exception)'s Source, at most
    `attempts` times (recoverWithRetries). The fallback materializes as its
    own interpreter feeding this stage through async callbacks."""

    def __init__(self, attempts: int, fn: Callable[[BaseException], Any]):
        super().__init__("RecoverWithRetries")
        self.attempts = attempts
        self.fn = fn

    def create_logic(self):
        logic, in_, out = self._logic(), self.in_, self.out
        stage = self
        import collections
        buf: collections.deque = collections.deque()
        state = {"left": stage.attempts, "fallback": False, "done": False}

        def sub_elem(elem):
            if logic.is_available(out) and not buf:
                logic.push(out, elem)
            else:
                buf.append(elem)

        def sub_done(fut):
            exc = fut.exception()
            if exc is not None:
                switch(exc)
                return
            state["done"] = True
            if not buf:
                logic.complete_stage()

        def switch(ex):
            # attempts < 0 = unlimited (scaladsl recoverWithRetries(-1) /
            # recoverWith semantics)
            if state["left"] == 0:
                logic.fail_stage(ex)
                return
            if state["left"] > 0:
                state["left"] -= 1
            state["fallback"] = True
            try:
                src = stage.fn(ex)
            except Exception as e:  # noqa: BLE001
                logic.fail_stage(e)
                return
            on_elem = logic.get_async_callback(sub_elem)
            on_done = logic.get_async_callback(sub_done)
            fut = src.run_foreach(lambda e: on_elem.invoke(e),
                                  logic.materializer)
            fut.add_done_callback(lambda f: on_done.invoke(f))

        def on_push():
            logic.push(out, logic.grab(in_))

        def on_pull():
            if state["fallback"]:
                if buf:
                    logic.push(out, buf.popleft())
                if state["done"] and not buf:
                    logic.complete_stage()
            else:
                logic.pull(in_)

        logic.set_handler(in_, make_in_handler(on_push, None, switch))
        logic.set_handler(out, make_out_handler(on_pull))
        return logic


class WatchTermination(_LinearStage):
    """Pass-through whose mat Future completes (or fails) with the stream's
    end (watchTermination)."""

    def __init__(self):
        super().__init__("WatchTermination")

    def create_logic_and_mat(self):
        fut: Future = Future()
        logic, in_, out = self._logic(), self.in_, self.out

        def on_finish():
            if not fut.done():
                fut.set_result(None)
            logic.complete_stage()

        def on_failure(ex):
            if not fut.done():
                fut.set_exception(ex)
            logic.fail_stage(ex)

        def on_downstream_finish(cause=None):
            # downstream cancel IS termination: the future completes
            # (watchTermination resolves with Done on cancellation)
            if not fut.done():
                fut.set_result(None)
            logic.cancel_stage(cause)

        logic.set_handler(in_, make_in_handler(
            lambda: logic.push(out, logic.grab(in_)), on_finish, on_failure))
        logic.set_handler(out, make_out_handler(lambda: logic.pull(in_),
                                                on_downstream_finish))
        return logic, fut
