"""Operator library, fourth tranche: the long tail VERDICT r3 #5 named —
statefulMap/mapWithResource, mapAsyncPartitioned, weighted grouping/batching,
timer ops (initialDelay, backpressureTimeout, delayWith), monitor/foldWhile/
mergeLatest/watch, async sources (maybe, unfoldAsync, unfoldResourceAsync,
zipN, actorRefWithBackpressure), lazy/future/cancelled sinks, switchMap.

A copy of `akka_tpu/stream/ops4.py` at commit 05a11d4 (host code, no
jax; the port keeps its own copy of every module it needs).

Reference parity: scaladsl/Flow.scala (statefulMap, mapWithResource,
mapAsyncPartitioned, groupedWeighted, groupedWeightedWithin, batchWeighted,
initialDelay, backpressureTimeout, delayWith, monitor, foldWhile,
mergeLatest/mergeLatestWith, watch, switchMap/flatMapLatest),
scaladsl/Source.scala (maybe, unfoldAsync, unfoldResourceAsync, zipN,
zipWithN, actorRefWithBackpressure), scaladsl/Sink.scala (lazySink,
futureSink, cancelled, foreachAsync); impl/fusing/StatefulMap.scala,
MapAsyncPartitioned.scala, impl/Timers.scala, FlowMonitorImpl.scala.
"""

from __future__ import annotations

import collections
import threading
from concurrent.futures import Future
from typing import Any, Callable, List, Optional

from .ops import _LinearStage, _SinkStage, _SourceStage, _QUEUE_END, \
    make_in_handler, make_out_handler
from .ops2 import _TimerLogic
from .stage import (FanInShape, GraphStage, GraphStageLogic, Inlet, Outlet,
                    SourceShape, make_in_handler as _mk_in)


# =========================== stateful element ops ===========================

class StatefulMap(_LinearStage):
    """scaladsl statefulMap(create)(f, onComplete): per-materialization
    state threaded through f(state, elem) -> (state, out); onComplete(state)
    may emit one final element (impl/fusing/StatefulMap.scala)."""

    def __init__(self, create: Callable[[], Any],
                 fn: Callable[[Any, Any], tuple],
                 on_complete: Optional[Callable[[Any], Optional[Any]]] = None):
        super().__init__("StatefulMap")
        self.create = create
        self.fn = fn
        self.on_complete = on_complete

    def create_logic(self):
        stage = self
        logic, in_, out = self._logic(), self.in_, self.out
        state = {"s": None, "init": False}

        def _ensure():
            if not state["init"]:
                state["s"] = stage.create()
                state["init"] = True

        logic.restart_state = lambda: state.update(init=False, s=None)

        def on_push():
            _ensure()
            state["s"], emitted = stage.fn(state["s"], logic.grab(in_))
            logic.push(out, emitted)

        def on_finish():
            if stage.on_complete is not None:
                _ensure()
                final = stage.on_complete(state["s"])
                if final is not None:
                    logic.emit(out, final)
            logic.complete_stage()
        logic.set_handler(in_, make_in_handler(on_push, on_finish))
        logic.set_handler(out, make_out_handler(lambda: logic.pull(in_)))
        return logic


class MapWithResource(_LinearStage):
    """scaladsl mapWithResource(create)(f, close): a resource opened per
    materialization, used by f(resource, elem), closed on EVERY termination
    path; close may emit one final element."""

    def __init__(self, create: Callable[[], Any],
                 fn: Callable[[Any, Any], Any],
                 close: Callable[[Any], Optional[Any]]):
        super().__init__("MapWithResource")
        self.create = create
        self.fn = fn
        self.close = close

    def create_logic(self):
        stage = self
        in_, out = self.in_, self.out
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
            if state["open"]:
                stage.close(state["resource"])
            state["resource"] = stage.create()
            state["open"] = True
        logic.restart_state = _reopen

        def on_push():
            logic.push(out, stage.fn(state["resource"], logic.grab(in_)))

        def on_finish():
            if state["open"]:
                state["open"] = False
                final = stage.close(state["resource"])
                if final is not None:
                    logic.emit(out, final)
            logic.complete_stage()
        logic.set_handler(in_, make_in_handler(on_push, on_finish))
        logic.set_handler(out, make_out_handler(lambda: logic.pull(in_)))
        return logic


class MapAsyncPartitioned(_LinearStage):
    """scaladsl mapAsyncPartitioned(parallelism)(partitioner)(f): total
    concurrency `parallelism`, at most ONE future in flight per partition,
    results emitted in INPUT order (impl/fusing/MapAsyncPartitioned.scala)."""

    def __init__(self, parallelism: int, partitioner: Callable[[Any], Any],
                 fn: Callable[[Any, Any], Any]):
        super().__init__("MapAsyncPartitioned")
        self.parallelism = max(int(parallelism), 1)
        self.partitioner = partitioner
        self.fn = fn

    def create_logic(self):
        stage = self
        in_, out = self.in_, self.out
        # entries in input order: [elem, partition, started, done, result/ex]
        entries: collections.deque = collections.deque()
        state = {"in_flight": 0, "finishing": False}
        busy_partitions: set = set()

        class _L(GraphStageLogic):
            def _start_ready(self):
                # synchronous results are collected and applied AFTER the
                # scan: _on_done mutates `entries` (popleft on emit), which
                # must not happen while iterating it
                sync_done = []
                for e in entries:
                    if state["in_flight"] >= stage.parallelism:
                        break
                    if e["started"] or e["partition"] in busy_partitions:
                        continue
                    e["started"] = True
                    busy_partitions.add(e["partition"])
                    state["in_flight"] += 1
                    cb = self.get_async_callback(self._on_done)
                    try:
                        fut = stage.fn(e["elem"], e["partition"])
                    except Exception as ex:  # noqa: BLE001
                        sync_done.append((e, ex, None))
                        continue
                    if isinstance(fut, Future):
                        fut.add_done_callback(
                            lambda f, entry=e: cb.invoke(
                                (entry, f.exception(),
                                 None if f.exception() else f.result())))
                    else:
                        sync_done.append((e, None, fut))
                for triple in sync_done:
                    self._on_done(triple)

            def _on_done(self, triple):
                e, ex, val = triple
                state["in_flight"] -= 1
                busy_partitions.discard(e["partition"])
                if ex is not None:
                    self.fail_stage(ex)
                    return
                e["done"], e["result"] = True, val
                self._emit_ready()
                self._start_ready()
                self._maybe_pull()

            def _emit_ready(self):
                while entries and entries[0]["done"] and \
                        self.is_available(out):
                    self.push(out, entries.popleft()["result"])
                if state["finishing"] and not entries:
                    self.complete_stage()

            def _maybe_pull(self):
                if len(entries) < stage.parallelism and \
                        not state["finishing"] and \
                        not self.has_been_pulled(in_) and \
                        not self.is_closed(in_):
                    self.pull(in_)

        logic = _L(self._shape)

        def on_push():
            elem = logic.grab(in_)
            entries.append({"elem": elem,
                            "partition": stage.partitioner(elem),
                            "started": False, "done": False, "result": None})
            logic._start_ready()
            logic._maybe_pull()

        def on_finish():
            state["finishing"] = True
            if not entries:
                logic.complete_stage()

        def on_pull():
            logic._emit_ready()
            logic._maybe_pull()
        logic.set_handler(in_, make_in_handler(on_push, on_finish))
        logic.set_handler(out, make_out_handler(on_pull))
        return logic


# ============================ weighted grouping =============================

class GroupedWeighted(_LinearStage):
    """scaladsl groupedWeighted(minWeight)(cost): emit a group once its
    accumulated cost reaches minWeight."""

    def __init__(self, min_weight: float, cost: Callable[[Any], float]):
        super().__init__("GroupedWeighted")
        self.min_weight = min_weight
        self.cost = cost

    def create_logic(self):
        stage = self
        logic, in_, out = self._logic(), self.in_, self.out
        buf: List[Any] = []
        state = {"w": 0.0}

        def on_push():
            elem = logic.grab(in_)
            buf.append(elem)
            state["w"] += stage.cost(elem)
            if state["w"] >= stage.min_weight:
                group, buf[:] = list(buf), []
                state["w"] = 0.0
                logic.push(out, group)
            else:
                logic.pull(in_)

        def on_finish():
            if buf:
                logic.emit(out, list(buf))
            logic.complete_stage()
        logic.set_handler(in_, make_in_handler(on_push, on_finish))
        logic.set_handler(out, make_out_handler(lambda: logic.pull(in_)))
        return logic


class GroupedWeightedWithin(_LinearStage):
    """scaladsl groupedWeightedWithin(maxWeight, d)(cost): group until the
    weight cap or the time window, whichever first."""

    def __init__(self, max_weight: float, seconds: float,
                 cost: Callable[[Any], float], max_number: int = 0):
        super().__init__("GroupedWeightedWithin")
        self.max_weight = max_weight
        self.seconds = seconds
        self.cost = cost
        self.max_number = max_number  # 0 = unbounded

    def create_logic(self):
        stage = self
        logic = _TimerLogic(self._shape)
        in_, out = self.in_, self.out
        buf: List[Any] = []
        pending: List[List[Any]] = []
        state = {"w": 0.0}

        def flush():
            if buf:
                pending.append(list(buf))
                buf.clear()
                state["w"] = 0.0

        def deliver():
            if pending and logic.is_available(out):
                logic.push(out, pending.pop(0))

        logic._on_timer_fn = lambda key: (flush(), deliver())

        def pre_start():
            logic.schedule_periodically("window", stage.seconds, stage.seconds)
            logic.pull(in_)
        logic.pre_start = pre_start  # type: ignore[method-assign]

        def on_push():
            elem = logic.grab(in_)
            buf.append(elem)
            state["w"] += stage.cost(elem)
            if state["w"] >= stage.max_weight or \
                    (stage.max_number and len(buf) >= stage.max_number):
                flush()
            deliver()
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
            lambda: (deliver(),
                     logic.pull(in_)
                     if not logic.has_been_pulled(in_)
                     and not logic.is_closed(in_) and len(pending) < 2
                     else None)))
        return logic


class BatchWeighted(_LinearStage):
    """scaladsl batchWeighted(max, cost, seed)(aggregate): conflate-like
    batching that backpressures once the batch weight reaches max."""

    def __init__(self, max_weight: float, cost: Callable[[Any], float],
                 seed: Callable[[Any], Any],
                 aggregate: Callable[[Any, Any], Any]):
        super().__init__("BatchWeighted")
        self.max_weight = max_weight
        self.cost = cost
        self.seed = seed
        self.aggregate = aggregate

    def create_logic(self):
        stage = self
        logic, in_, out = self._logic(), self.in_, self.out
        state = {"agg": None, "has": False, "w": 0.0, "finishing": False}

        def on_push():
            elem = logic.grab(in_)
            if not state["has"]:
                state["agg"], state["has"] = stage.seed(elem), True
                state["w"] = stage.cost(elem)
            else:
                state["agg"] = stage.aggregate(state["agg"], elem)
                state["w"] += stage.cost(elem)
            if logic.is_available(out):
                logic.push(out, state["agg"])
                state["has"], state["agg"], state["w"] = False, None, 0.0
            if state["w"] < stage.max_weight and not logic.is_closed(in_) \
                    and not logic.has_been_pulled(in_):
                logic.pull(in_)

        def on_finish():
            if state["has"]:
                logic.emit(out, state["agg"])
            logic.complete_stage()

        def on_pull():
            if state["has"]:
                logic.push(out, state["agg"])
                state["has"], state["agg"], state["w"] = False, None, 0.0
            if not logic.is_closed(in_) and not logic.has_been_pulled(in_):
                logic.pull(in_)
        logic.set_handler(in_, make_in_handler(on_push, on_finish))
        logic.set_handler(out, make_out_handler(on_pull))
        return logic


# ================================ timer ops =================================

class InitialDelay(_LinearStage):
    """scaladsl initialDelay(d): hold the FIRST element for d seconds."""

    def __init__(self, seconds: float):
        super().__init__("InitialDelay")
        self.seconds = seconds

    def create_logic(self):
        stage = self
        logic = _TimerLogic(self._shape)
        in_, out = self.in_, self.out
        state = {"open": False, "held": None, "finishing": False}

        def on_timer(key):
            state["open"] = True
            if state["held"] is not None:
                (elem,) = state["held"]
                state["held"] = None
                logic.push(out, elem)
                if state["finishing"]:
                    logic.complete_stage()
        logic._on_timer_fn = on_timer

        def pre_start():
            logic.schedule_once("gate", stage.seconds)
        logic.pre_start = pre_start  # type: ignore[method-assign]

        def on_push():
            elem = logic.grab(in_)
            if state["open"]:
                logic.push(out, elem)
            else:
                state["held"] = (elem,)

        def on_finish():
            if state["held"] is not None:
                state["finishing"] = True
            else:
                logic.complete_stage()
        logic.set_handler(in_, make_in_handler(on_push, on_finish))
        logic.set_handler(out, make_out_handler(
            lambda: logic.pull(in_) if not logic.has_been_pulled(in_)
            and not logic.is_closed(in_) else None))
        return logic


class BackpressureTimeoutException(TimeoutError):
    pass


class BackpressureTimeout(_LinearStage):
    """scaladsl backpressureTimeout(d): fail if downstream leaves a pushed
    element un-consumed (no fresh pull) for longer than d."""

    def __init__(self, seconds: float):
        super().__init__("BackpressureTimeout")
        self.seconds = seconds

    def create_logic(self):
        stage = self
        logic = _TimerLogic(self._shape)
        in_, out = self.in_, self.out
        state = {"waiting": False}

        def on_timer(key):
            if state["waiting"]:
                logic.fail_stage(BackpressureTimeoutException(
                    f"no downstream demand for {stage.seconds}s"))
        logic._on_timer_fn = on_timer

        def on_push():
            logic.push(out, logic.grab(in_))
            state["waiting"] = True
            logic.schedule_once("bp", stage.seconds)

        def on_pull():
            state["waiting"] = False
            logic.cancel_timer("bp")
            if not logic.has_been_pulled(in_) and not logic.is_closed(in_):
                logic.pull(in_)
        logic.set_handler(in_, make_in_handler(on_push))
        logic.set_handler(out, make_out_handler(on_pull))
        return logic


class DelayWith(_LinearStage):
    """scaladsl delayWith(strategyFactory): per-element delay from a
    DelayStrategy — here a per-materialization factory returning
    fn(elem) -> seconds (reference DelayStrategy.linearIncreasingDelay
    etc. are plain closures over this shape)."""

    def __init__(self, strategy_factory: Callable[[], Callable[[Any], float]],
                 buffer_size: int = 16):
        super().__init__("DelayWith")
        self.strategy_factory = strategy_factory
        self.buffer_size = buffer_size

    def create_logic(self):
        import time as _time
        stage = self
        logic = _TimerLogic(self._shape)
        in_, out = self.in_, self.out
        strategy = {"fn": None}
        buf: collections.deque = collections.deque()  # (ready_time, elem)
        state = {"finishing": False, "armed": False}

        def _arm():
            # arm only while the head is NOT yet due: a due-but-unpushable
            # head (downstream hasn't pulled) must wait for on_pull, not
            # spin a zero-delay timer loop
            if buf and not state["armed"]:
                delay = buf[0][0] - _time.monotonic()
                if delay > 0:
                    state["armed"] = True
                    logic.schedule_once("ready", delay)

        def _deliver():
            now = _time.monotonic()
            if buf and buf[0][0] <= now and logic.is_available(out):
                logic.push(out, buf.popleft()[1])
            if state["finishing"] and not buf:
                logic.complete_stage()
                return
            _arm()
            if len(buf) < stage.buffer_size and not logic.is_closed(in_) \
                    and not logic.has_been_pulled(in_):
                logic.pull(in_)

        def on_timer(key):
            state["armed"] = False
            _deliver()
        logic._on_timer_fn = on_timer

        def pre_start():
            strategy["fn"] = stage.strategy_factory()
            logic.pull(in_)
        logic.pre_start = pre_start  # type: ignore[method-assign]

        def on_push():
            elem = logic.grab(in_)
            buf.append((_time.monotonic() + strategy["fn"](elem), elem))
            _deliver()

        def on_finish():
            if buf:
                state["finishing"] = True
            else:
                logic.complete_stage()
        logic.set_handler(in_, make_in_handler(on_push, on_finish))
        logic.set_handler(out, make_out_handler(_deliver))
        return logic


# ========================= monitor / foldWhile / watch ======================

class FlowMonitor:
    """Mat value of .monitor(): the stream's last state
    (reference: akka.stream.FlowMonitor / FlowMonitorState)."""

    def __init__(self):
        self._state = ("initialized",)
        self._lock = threading.Lock()

    def _set(self, *state):
        with self._lock:
            self._state = state

    @property
    def state(self):
        """("initialized",) | ("received", elem) | ("failed", ex) |
        ("finished",)"""
        with self._lock:
            return self._state


class MonitorStage(_LinearStage):
    def __init__(self):
        super().__init__("Monitor")

    def create_logic_and_mat(self):
        mon = FlowMonitor()
        logic, in_, out = self._logic(), self.in_, self.out

        def on_push():
            elem = logic.grab(in_)
            mon._set("received", elem)
            logic.push(out, elem)

        def on_finish():
            mon._set("finished")
            logic.complete_stage()

        def on_failure(ex):
            mon._set("failed", ex)
            logic.fail_stage(ex)
        logic.set_handler(in_, make_in_handler(on_push, on_finish, on_failure))
        logic.set_handler(out, make_out_handler(lambda: logic.pull(in_)))
        return logic, mon


class FoldWhile(_LinearStage):
    """scaladsl foldWhile(zero)(pred)(f): fold while pred(acc) holds; emit
    the aggregate (and complete, cancelling upstream) once it does not."""

    def __init__(self, zero, pred: Callable[[Any], bool],
                 fn: Callable[[Any, Any], Any]):
        super().__init__("FoldWhile")
        self.zero = zero
        self.pred = pred
        self.fn = fn

    def create_logic(self):
        stage = self
        logic, in_, out = self._logic(), self.in_, self.out
        state = {"acc": self.zero, "done": False}
        logic.restart_state = lambda: state.update(acc=stage.zero, done=False)

        def _finish():
            state["done"] = True
            logic.emit(out, state["acc"])
            logic.complete_stage()

        def on_push():
            state["acc"] = stage.fn(state["acc"], logic.grab(in_))
            if not stage.pred(state["acc"]):
                _finish()
            else:
                logic.pull(in_)

        def on_finish():
            if not state["done"]:
                _finish()
        logic.set_handler(in_, make_in_handler(on_push, on_finish))
        logic.set_handler(out, make_out_handler(
            lambda: logic.pull(in_) if not logic.has_been_pulled(in_)
            and not logic.is_closed(in_) else None))
        return logic


class WatchedActorTerminatedException(RuntimeError):
    pass


class WatchStage(_LinearStage):
    """scaladsl watch(ref): pass elements through; fail the stream with
    WatchedActorTerminatedException when the watched actor terminates."""

    def __init__(self, ref):
        super().__init__("Watch")
        self.ref = ref

    def create_logic(self):
        from ..actor.actor import Actor
        from ..actor.messages import Terminated
        from ..actor.props import Props
        stage = self
        in_, out = self.in_, self.out
        state = {"watcher": None}

        class _Watcher(Actor):
            def __init__(self, target, cb):
                super().__init__()
                self._target = target
                self._cb = cb

            def pre_start(self):
                self.context.watch(self._target)

            def receive(self, message):
                if isinstance(message, Terminated):
                    self._cb.invoke(message)
                    self.context.stop(self.self_ref)

        class _L(GraphStageLogic):
            def pre_start(self):
                cb = self.get_async_callback(self._on_terminated)
                state["watcher"] = self.materializer.system.actor_of(
                    Props.create(_Watcher, stage.ref, cb))

            def _on_terminated(self, _t):
                self.fail_stage(WatchedActorTerminatedException(
                    f"watched actor {stage.ref} terminated"))

            def post_stop(self):
                w = state["watcher"]
                if w is not None:
                    self.materializer.system.stop(w)

        logic = _L(self._shape)
        logic.set_handler(in_, make_in_handler(
            lambda: logic.push(out, logic.grab(in_))))
        logic.set_handler(out, make_out_handler(lambda: logic.pull(in_)))
        return logic


# ============================== async sources ===============================

class MaybePromise:
    """Mat value of Source.maybe: complete with an element, or None to
    complete empty, or fail (reference: Promise[Option[T]])."""

    def __init__(self):
        self._cb = None
        self._lock = threading.Lock()
        self._early = None  # ("ok", v) | ("fail", ex)

    def _bind(self, cb):
        with self._lock:
            self._cb = cb
            early = self._early
        if early is not None:
            cb.invoke(early)

    def _send(self, item):
        with self._lock:
            if self._early is not None:
                return  # already completed
            if self._cb is None:
                self._early = item
                return
            self._early = item
        self._cb.invoke(item)

    def success(self, value: Optional[Any]) -> None:
        self._send(("ok", value))

    def failure(self, ex: BaseException) -> None:
        self._send(("fail", ex))


class MaybeSource(_SourceStage):
    def __init__(self):
        super().__init__("MaybeSource")

    def create_logic_and_mat(self):
        stage = self
        promise = MaybePromise()
        state = {"value": None, "done": False}

        class _L(GraphStageLogic):
            def pre_start(self):
                self.set_keep_going(True)  # stay alive while unfulfilled
                promise._bind(self.get_async_callback(self._on_value))

            def _on_value(self, item):
                kind, v = item
                state["done"] = True
                self.set_keep_going(False)
                if kind == "fail":
                    self.fail(stage.out, v)
                elif v is None:
                    self.complete(stage.out)
                else:
                    state["value"] = v
                    if self.is_available(stage.out):
                        self.push(stage.out, v)
                        self.complete(stage.out)

        logic = _L(self._shape)

        def on_pull():
            if state["done"] and state["value"] is not None:
                logic.push(stage.out, state["value"])
                logic.complete(stage.out)

        def on_cancel(cause=None):
            # downstream gave up before fulfilment: drop keep-going or the
            # island actor never shuts down (leaks one actor per run)
            state["done"] = True
            logic.set_keep_going(False)
            logic.cancel_stage(cause)
        logic.set_handler(stage.out, make_out_handler(on_pull, on_cancel))
        return logic, promise


class UnfoldAsync(_SourceStage):
    """scaladsl unfoldAsync: fn(state) -> Future[None | (state, elem)]."""

    def __init__(self, zero, fn):
        super().__init__("UnfoldAsync")
        self.zero = zero
        self.fn = fn

    def create_logic(self):
        stage = self
        out = self.out
        state = {"s": self.zero, "busy": False}

        class _L(GraphStageLogic):
            def _step(self):
                state["busy"] = True
                cb = self.get_async_callback(self._on_done)
                try:
                    fut = stage.fn(state["s"])
                except Exception as e:  # noqa: BLE001
                    self.fail(out, e)
                    return
                if isinstance(fut, Future):
                    fut.add_done_callback(
                        lambda f: cb.invoke((f.exception(),
                                             None if f.exception()
                                             else f.result())))
                else:
                    self._on_done((None, fut))

            def _on_done(self, pair):
                ex, nxt = pair
                state["busy"] = False
                if ex is not None:
                    self.fail(out, ex)
                elif nxt is None:
                    self.complete(out)
                else:
                    state["s"], elem = nxt
                    self.push(out, elem)

        logic = _L(self._shape)
        logic.set_handler(out, make_out_handler(
            lambda: logic._step() if not state["busy"] else None))
        return logic


class UnfoldResourceAsync(_SourceStage):
    """scaladsl unfoldResourceAsync: create/read/close all return Futures
    (read resolves to None at the end)."""

    def __init__(self, create, read, close):
        super().__init__("UnfoldResourceAsync")
        self.create = create
        self.read = read
        self.close = close

    def create_logic(self):
        stage = self
        out = self.out
        state = {"resource": None, "open": False, "busy": False,
                 "pending_read": False}

        def _as_future(v):
            if isinstance(v, Future):
                return v
            f = Future()
            f.set_result(v)
            return f

        class _L(GraphStageLogic):
            def pre_start(self):
                state["busy"] = True
                cb = self.get_async_callback(self._on_created)
                _as_future(stage.create()).add_done_callback(
                    lambda f: cb.invoke((f.exception(),
                                         None if f.exception()
                                         else f.result())))

            def _on_created(self, pair):
                ex, res = pair
                state["busy"] = False
                if ex is not None:
                    self.fail(out, ex)
                    return
                state["resource"], state["open"] = res, True
                if state["pending_read"]:
                    state["pending_read"] = False
                    self._read()

            def _read(self):
                state["busy"] = True
                cb = self.get_async_callback(self._on_read)
                try:
                    fut = _as_future(stage.read(state["resource"]))
                except Exception as e:  # noqa: BLE001
                    self.fail(out, e)
                    return
                fut.add_done_callback(
                    lambda f: cb.invoke((f.exception(),
                                         None if f.exception()
                                         else f.result())))

            def _on_read(self, pair):
                ex, v = pair
                state["busy"] = False
                if ex is not None:
                    self.fail(out, ex)
                elif v is None:
                    self.complete(out)
                else:
                    self.push(out, v)

            def post_stop(self):
                if state["open"]:
                    state["open"] = False
                    stage.close(state["resource"])

        logic = _L(self._shape)

        def on_pull():
            if not state["open"]:
                # create() still in flight: remember the demand
                state["pending_read"] = True
            elif not state["busy"]:
                logic._read()
        logic.set_handler(out, make_out_handler(on_pull))
        return logic


class ZipNStage(GraphStage):
    """scaladsl Source.zipN / zipWithN: n inputs -> fn(list of heads)."""

    def __init__(self, n: int, fn: Optional[Callable[[List[Any]], Any]] = None):
        self.name = "ZipN"
        self.fn = fn or (lambda xs: list(xs))
        self.ins = [Inlet(f"ZipN.in{i}") for i in range(n)]
        self.out = Outlet("ZipN.out")
        self._shape = FanInShape(self.ins, self.out)

    @property
    def shape(self):
        return self._shape

    def create_logic(self):
        stage = self
        ins, out = self.ins, self.out
        heads = {i: None for i in range(len(ins))}
        logic = GraphStageLogic(self._shape)

        def _emit_if_ready():
            if not logic.is_available(out):
                return
            if any(h is None for h in heads.values()):
                for i, inlet in enumerate(ins):
                    if heads[i] is None:
                        if logic.is_closed(inlet):
                            logic.complete_stage()
                            return
                        if not logic.has_been_pulled(inlet):
                            logic.pull(inlet)
                return
            vals = [heads[i][0] for i in range(len(ins))]
            for i in range(len(ins)):
                heads[i] = None
            logic.push(out, stage.fn(vals))

        def mk_push(i, inlet):
            def on_push():
                heads[i] = (logic.grab(inlet),)
                _emit_if_ready()
            return on_push

        def mk_finish(i):
            def on_finish():
                if heads[i] is None:
                    logic.complete_stage()  # can never zip again
            return on_finish

        for i, inlet in enumerate(ins):
            logic.set_handler(inlet, _mk_in(mk_push(i, inlet), mk_finish(i)))
        logic.set_handler(out, make_out_handler(_emit_if_ready))
        return logic


class MergeLatestStage(GraphStage):
    """scaladsl mergeLatest: once every input has emitted, emit the list of
    latest values each time ANY input emits."""

    def __init__(self, n: int, fn: Optional[Callable[[List[Any]], Any]] = None):
        self.name = "MergeLatest"
        self.fn = fn or (lambda xs: list(xs))
        self.ins = [Inlet(f"MergeLatest.in{i}") for i in range(n)]
        self.out = Outlet("MergeLatest.out")
        self._shape = FanInShape(self.ins, self.out)

    @property
    def shape(self):
        return self._shape

    def create_logic(self):
        stage = self
        ins, out = self.ins, self.out
        latest = {i: None for i in range(len(ins))}
        pending: collections.deque = collections.deque()
        logic = GraphStageLogic(self._shape)

        def _repull():
            # backpressure: hold inlets once a couple of combined rows are
            # queued; resume pulling as downstream drains (the reference
            # MergeLatest backpressures its inlets)
            if len(pending) < 2:
                for inlet in ins:
                    if not logic.is_closed(inlet) and \
                            not logic.has_been_pulled(inlet) and \
                            not logic.is_available(inlet):
                        logic.pull(inlet)

        def _deliver():
            if pending and logic.is_available(out):
                logic.push(out, pending.popleft())
            if not pending and all(logic.is_closed(i) for i in ins):
                logic.complete_stage()
                return
            _repull()

        def mk_push(i, inlet):
            def on_push():
                latest[i] = (logic.grab(inlet),)
                if all(v is not None for v in latest.values()):
                    pending.append(stage.fn(
                        [latest[j][0] for j in range(len(ins))]))
                _deliver()
            return on_push

        def on_finish():
            if all(logic.is_closed(i) for i in ins) and not pending:
                logic.complete_stage()

        for i, inlet in enumerate(ins):
            logic.set_handler(inlet, _mk_in(mk_push(i, inlet), on_finish))

        def pre_start():
            for inlet in ins:
                logic.pull(inlet)
        logic.pre_start = pre_start  # type: ignore[method-assign]
        logic.set_handler(out, make_out_handler(_deliver))
        return logic


class ActorRefBackpressureSource(_SourceStage):
    """scaladsl Source.actorRefWithBackpressure(ack): the mat ActorRef
    replies `ack` to the SENDER once each element is accepted into the
    stream, so producers can send-one-await-ack."""

    def __init__(self, ack_message: Any):
        super().__init__("ActorRefBackpressureSource")
        self.ack_message = ack_message

    def create_logic_and_mat(self):
        from ..actor.actor import Actor
        from ..actor.messages import Status
        from ..actor.props import Props
        stage = self
        state = {"ref": None, "completing": False}
        held: collections.deque = collections.deque()  # (msg, sender) FIFO
        mat_holder = {}

        class _Fwd(Actor):
            def __init__(self, cb):
                super().__init__()
                self._cb = cb

            def receive(self, message):
                self._cb.invoke((message, self.context.sender))

        class _L(GraphStageLogic):
            def pre_start(self):
                cb = self.get_async_callback(self._on_msg)
                state["ref"] = self.materializer.system.actor_of(
                    Props.create(_Fwd, cb))
                mat_holder["ref"].set_result(state["ref"])

            def _on_msg(self, pair):
                msg, sender = pair
                if isinstance(msg, Status.Success):
                    state["completing"] = True
                    if not held:
                        self.complete(stage.out)
                    return
                if isinstance(msg, Status.Failure):
                    self.fail_stage(msg.cause if isinstance(
                        msg.cause, BaseException) else
                        RuntimeError(str(msg.cause)))
                    return
                if self.is_available(stage.out) and not held:
                    self.push(stage.out, msg)
                    self._ack(sender)
                else:
                    # queue every unacked message (one per waiting sender —
                    # each well-behaved producer awaits its ack; a single
                    # slot here would silently drop a concurrent sender's
                    # element and deadlock it)
                    held.append((msg, sender))

            def _ack(self, sender):
                if sender is not None:
                    sender.tell(stage.ack_message, state["ref"])

            def _drain(self):
                if held and self.is_available(stage.out):
                    msg, sender = held.popleft()
                    self.push(stage.out, msg)
                    self._ack(sender)
                    if state["completing"] and not held:
                        self.complete(stage.out)

            def post_stop(self):
                # the forwarder outlives no materialization (WatchStage
                # stops its helper the same way); without this every run
                # leaked one live actor
                if state["ref"] is not None:
                    self.materializer.system.stop(state["ref"])

        logic = _L(self._shape)
        fut: Future = Future()
        mat_holder["ref"] = fut
        logic.set_handler(stage.out, make_out_handler(logic._drain))
        return logic, fut


# ================================= sinks ====================================

class ActorRefBackpressureSink(_SinkStage):
    """scaladsl Sink.actorRefWithBackpressure: `on_init` then each element
    goes to `ref` with an ack-forwarder as sender; the next element is
    pulled only after `ack_message` comes back, so the target actor paces
    the stream. `on_complete`/`on_failure(ex)` close the conversation."""

    def __init__(self, ref: Any, on_init: Any, ack_message: Any,
                 on_complete: Any, on_failure=None):
        super().__init__("ActorRefBackpressureSink")
        self.ref = ref
        self.on_init = on_init
        self.ack_message = ack_message
        self.on_complete = on_complete
        self.on_failure = on_failure

    def create_logic(self):
        from ..actor.actor import Actor
        from ..actor.props import Props
        stage = self
        in_ = self.in_
        st = {"fwd": None, "awaiting": 0, "finishing": False}

        class _Fwd(Actor):
            def __init__(self, cb):
                super().__init__()
                self._cb = cb

            def receive(self, message):
                self._cb.invoke(message)

        class _L(GraphStageLogic):
            def pre_start(self):
                cb = self.get_async_callback(self._on_reply)
                st["fwd"] = self.materializer.system.actor_of(
                    Props.create(_Fwd, cb))
                st["awaiting"] = 1  # the on_init ack gates the first pull
                stage.ref.tell(stage.on_init, st["fwd"])

            def _on_reply(self, msg):
                if msg != stage.ack_message:
                    return  # unrelated chatter to the forwarder
                st["awaiting"] -= 1
                if st["awaiting"] > 0:
                    return
                if st["finishing"]:
                    self._close()
                elif not self.has_been_pulled(in_) and \
                        not self.is_closed(in_):
                    self.pull(in_)

            def _close(self):
                stage.ref.tell(stage.on_complete, st["fwd"])
                self.set_keep_going(False)
                self.complete_stage()

            def post_stop(self):
                if st["fwd"] is not None:
                    self.materializer.system.stop(st["fwd"])

        logic = _L(self._shape)

        def on_push():
            st["awaiting"] += 1
            stage.ref.tell(logic.grab(in_), st["fwd"])

        def on_finish():
            # on_complete only after every sent element was acked
            # (reference: the sink completes when the actor has consumed
            # the whole stream, not merely received it)
            if st["awaiting"] > 0:
                st["finishing"] = True
                logic.set_keep_going(True)  # outlive the closed inlet
            else:
                logic._close()

        def on_failure(ex):
            if stage.on_failure is not None:
                stage.ref.tell(stage.on_failure(ex), st["fwd"])
            logic.fail_stage(ex)
        logic.set_handler(in_, make_in_handler(on_push, on_finish, on_failure))
        return logic

class CancelledSink(_SinkStage):
    """scaladsl Sink.cancelled: cancel upstream immediately."""

    def __init__(self):
        super().__init__("CancelledSink")

    def create_logic(self):
        in_ = self.in_

        class _L(GraphStageLogic):
            def pre_start(self):
                self.cancel(in_)
        logic = _L(self._shape)
        logic.set_handler(in_, make_in_handler(lambda: None))
        return logic


class NeverMaterializedException(RuntimeError):
    """The lazy/future sink's inner sink was never materialized
    (reference: akka.stream.NeverMaterializedException)."""


class LazySink(_SinkStage):
    """scaladsl Sink.lazySink: defer building+materializing the real sink
    until the first element arrives (sub-materialized through the restart
    bridge machinery; the first element is delivered to the inner sink).
    Mat: Future resolving to the INNER sink's mat value once it
    materializes; fails with NeverMaterializedException if it never does."""

    def __init__(self, factory: Callable[[], Any], trigger: Optional[Future] = None):
        super().__init__("LazySink" if trigger is None else "FutureSink")
        self.factory = factory
        self.trigger = trigger  # None = first element; Future = when done

    def create_logic_and_mat(self):
        from .restart import _BridgeHandle, _BridgeSource
        stage = self
        in_ = self.in_
        mat_fut: Future = Future()
        st = {"handle": None, "demand": 0, "stash": None,
              "finishing": False, "failed": None}

        class _L(GraphStageLogic):
            def pre_start(self):
                self.set_keep_going(True)
                if stage.trigger is not None:
                    cb = self.get_async_callback(self._on_trigger)
                    stage.trigger.add_done_callback(lambda f: cb.invoke(f))
                else:
                    self.pull(in_)

            def _on_trigger(self, f):
                ex = f.exception()
                if ex is not None:
                    self.set_keep_going(False)
                    self.fail_stage(ex)
                    return
                self._start_inner()
                if not self.has_been_pulled(in_) and not self.is_closed(in_):
                    self.pull(in_)

            def _start_inner(self):
                from .dsl import Keep, Source
                handle = _BridgeHandle(
                    self.get_async_callback(self._on_inner), 1)
                st["handle"] = handle
                try:
                    inner_mat = Source.from_graph(
                        lambda: _BridgeSource(handle)).to_mat(
                        stage.factory(), Keep.right).run(self.materializer)
                except Exception as ex:  # noqa: BLE001
                    if not mat_fut.done():
                        mat_fut.set_exception(ex)
                    raise
                if not mat_fut.done():
                    mat_fut.set_result(inner_mat)

            def _on_inner(self, pair):
                _gen, ev = pair
                if ev[0] == "demand":
                    st["demand"] += 1
                    if st["stash"] is not None:
                        elem, st["stash"] = st["stash"], None
                        st["demand"] -= 1
                        st["handle"].to_inner(("elem", elem))
                        if st["finishing"]:
                            self._finish_inner()
                    elif st["finishing"]:
                        self._finish_inner()
                    elif not self.has_been_pulled(in_) and \
                            not self.is_closed(in_):
                        self.pull(in_)
                elif ev[0] == "cancel":
                    # inner sink cancelled: cancel the wrap
                    self.set_keep_going(False)
                    self.complete_stage()

            def _finish_inner(self):
                st["handle"].to_inner(("complete",))
                self.set_keep_going(False)
                self.complete_stage()

            def post_stop(self):
                if st["handle"] is not None and st["failed"] is None and \
                        not st["finishing"]:
                    st["handle"].to_inner(("complete",))
                if not mat_fut.done():
                    mat_fut.set_exception(NeverMaterializedException(
                        "inner sink was never materialized"))

        logic = _L(self._shape)

        def on_push():
            elem = logic.grab(in_)
            if st["handle"] is None and stage.trigger is None:
                st["stash"] = elem
                logic._start_inner()
            elif st["handle"] is not None and st["demand"] > 0:
                st["demand"] -= 1
                st["handle"].to_inner(("elem", elem))
            else:
                st["stash"] = elem
            if st["demand"] > 0 and not logic.is_closed(in_):
                logic.pull(in_)

        def on_finish():
            if st["handle"] is None:
                # no element ever arrived: the inner sink is never built
                logic.set_keep_going(False)
                logic.complete_stage()
            elif st["stash"] is None:
                logic._finish_inner()
            else:
                st["finishing"] = True

        def on_failure(ex):
            st["failed"] = ex
            if st["handle"] is not None:
                st["handle"].to_inner(("fail", ex))
            if not mat_fut.done():
                mat_fut.set_exception(ex)
            logic.set_keep_going(False)
            logic.fail_stage(ex)
        logic.set_handler(in_, make_in_handler(on_push, on_finish, on_failure))
        return logic, mat_fut


# ============================== switchMap ===================================

class SwitchMap(_LinearStage):
    """scaladsl switchMap (flatMapLatest): each element maps to a Source;
    a NEW element cancels the current inner source and switches to the new
    one (uses SinkQueue.cancel)."""

    def __init__(self, fn):
        super().__init__("SwitchMap")
        self.fn = fn

    def create_logic(self):
        stage = self
        in_, out = self.in_, self.out
        st = {"queue": None, "gen": 0, "pulling": False, "finishing": False}

        class _L(GraphStageLogic):
            def _switch_to(self, elem):
                from .dsl import Keep, Sink
                if st["queue"] is not None:
                    st["queue"].cancel()
                st["gen"] += 1
                st["pulling"] = False
                st["queue"] = stage.fn(elem).to_mat(
                    Sink.queue(), Keep.right).run(self.materializer)
                if self.is_available(out):
                    self._request()
                if not self.has_been_pulled(in_) and not self.is_closed(in_):
                    self.pull(in_)

            def _request(self):
                if st["pulling"] or st["queue"] is None:
                    return
                st["pulling"] = True
                gen = st["gen"]
                cb = self.get_async_callback(self._on_sub)
                st["queue"].pull().add_done_callback(
                    lambda f: cb.invoke((gen, f)))

            def _on_sub(self, pair):
                gen, f = pair
                if gen != st["gen"]:
                    return  # stale inner
                st["pulling"] = False
                ex = f.exception()
                if ex is not None:
                    self.fail_stage(ex)
                    return
                item = f.result()
                if item is _QUEUE_END:
                    st["queue"] = None
                    if st["finishing"]:
                        self.complete_stage()
                    elif not self.has_been_pulled(in_) and \
                            not self.is_closed(in_):
                        self.pull(in_)
                    return
                self.push(out, item)

            def post_stop(self):
                if st["queue"] is not None:
                    st["queue"].cancel()

        logic = _L(self._shape)

        def on_push():
            logic._switch_to(logic.grab(in_))

        def on_finish():
            if st["queue"] is None:
                logic.complete_stage()
            else:
                st["finishing"] = True

        def on_pull():
            if st["queue"] is not None:
                logic._request()
            elif not logic.has_been_pulled(in_) and not logic.is_closed(in_):
                logic.pull(in_)
        logic.set_handler(in_, make_in_handler(on_push, on_finish))
        logic.set_handler(out, make_out_handler(on_pull))
        return logic
