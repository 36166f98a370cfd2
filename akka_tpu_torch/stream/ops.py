"""Operator stage library.

A copy of `akka_tpu/stream/ops.py` at commit 05a11d4 (host code, no
jax; the port keeps its own copy of every module it needs).

Reference parity: akka-stream/src/main/scala/akka/stream/impl/fusing/
Ops.scala (map/filter/take/drop/scan/fold/grouped/sliding/conflate/batch/
expand/recover/log...), Throttle.scala (token bucket), StreamOfStreams.scala
(flatMapConcat via sub-materialization), impl/fusing/GraphStages.scala
(tick source), impl/QueueSource.scala / QueueSink.scala, impl/ActorRefSource
/SinkStage, scaladsl/Merge/Concat/Zip/Broadcast/Balance/Partition/Interleave
(stream/scaladsl/Graph.scala).

Every class is a fresh-per-materialization GraphStage (ports are allocated
in __init__); the DSL instantiates via factories.
"""

from __future__ import annotations

import collections
import threading
from concurrent.futures import Future
from typing import Any, Callable, List, Optional

from .stage import (FanInShape, FanOutShape, FlowShape, GraphStage,
                    GraphStageLogic, Inlet, Outlet, SinkShape, SourceShape,
                    make_in_handler, make_out_handler)


class NoSuchElementException(RuntimeError):
    pass


# =============================== sources ====================================

class _SourceStage(GraphStage):
    def __init__(self, name: str):
        self.name = name
        self.out = Outlet(f"{name}.out")
        self._shape = SourceShape(self.out)

    @property
    def shape(self):
        return self._shape


class IterableSource(_SourceStage):
    def __init__(self, iterable):
        super().__init__("IterableSource")
        self.iterable = iterable

    def create_logic(self):
        out = self.out
        holder = {}
        logic = GraphStageLogic(self._shape)

        def on_pull():
            it = holder.get("it")
            if it is None:
                it = holder["it"] = iter(self.iterable)
                try:
                    holder["next"] = next(it)
                except StopIteration:
                    logic.complete(out)
                    return
                except Exception as e:  # noqa: BLE001
                    logic.fail(out, e)
                    return
            if "err" in holder:
                logic.fail(out, holder.pop("err"))
                return
            if "next" not in holder:
                logic.complete(out)
                return
            elem = holder.pop("next")
            # one-element lookahead so exhaustion is known NOW and
            # completion rides WITH the last element — a consumer with
            # exact demand must not need a bonus pull to learn the stream
            # ended (reference: Source.fromIterator pushes then checks
            # hasNext; reactive-streams 1.05 completion-without-demand)
            done = False
            try:
                holder["next"] = next(it)
            except StopIteration:
                done = True
            except Exception as e:  # noqa: BLE001
                holder["err"] = e
            logic.push(out, elem)
            if done:
                logic.complete(out)
        logic.set_handler(out, make_out_handler(on_pull))
        return logic


class FailedSource(_SourceStage):
    def __init__(self, ex: BaseException):
        super().__init__("FailedSource")
        self.ex = ex

    def create_logic(self):
        logic = GraphStageLogic(self._shape)
        out, ex = self.out, self.ex
        logic.set_handler(out, make_out_handler(
            lambda: logic.fail(out, ex)))
        return logic


class RepeatSource(_SourceStage):
    def __init__(self, elem):
        super().__init__("RepeatSource")
        self.elem = elem

    def create_logic(self):
        logic = GraphStageLogic(self._shape)
        out, elem = self.out, self.elem
        logic.set_handler(out, make_out_handler(lambda: logic.push(out, elem)))
        return logic


class CycleSource(_SourceStage):
    def __init__(self, factory):
        super().__init__("CycleSource")
        self.factory = factory

    def create_logic(self):
        logic = GraphStageLogic(self._shape)
        out, factory = self.out, self.factory
        state = {"it": None}

        def on_pull():
            for _ in range(2):
                if state["it"] is None:
                    state["it"] = iter(factory())
                try:
                    logic.push(out, next(state["it"]))
                    return
                except StopIteration:
                    state["it"] = None
            logic.fail(out, ValueError("empty cycle source"))
        logic.set_handler(out, make_out_handler(on_pull))
        return logic


class UnfoldSource(_SourceStage):
    def __init__(self, zero, fn):
        super().__init__("UnfoldSource")
        self.zero = zero
        self.fn = fn

    def create_logic(self):
        logic = GraphStageLogic(self._shape)
        out, fn = self.out, self.fn
        state = {"s": self.zero}

        def on_pull():
            nxt = fn(state["s"])
            if nxt is None:
                logic.complete(out)
            else:
                state["s"], elem = nxt
                logic.push(out, elem)
        logic.set_handler(out, make_out_handler(on_pull))
        return logic


class TickCancellable:
    def __init__(self):
        self._cb = None
        self._cancelled = threading.Event()

    def cancel(self) -> None:
        self._cancelled.set()
        if self._cb is not None:
            self._cb.invoke(None)

    @property
    def is_cancelled(self) -> bool:
        return self._cancelled.is_set()


class TickSource(_SourceStage):
    """Emits `tick` every `interval`; ticks with no demand are DROPPED
    (reference: Source.tick)."""

    def __init__(self, initial_delay: float, interval: float, tick):
        super().__init__("TickSource")
        self.initial_delay = initial_delay
        self.interval = interval
        self.tick = tick

    def create_logic_and_mat(self):
        stage = self
        cancellable = TickCancellable()

        class _L(GraphStageLogic):
            def pre_start(self):
                cancellable._cb = self.get_async_callback(
                    lambda _: self.complete_stage())
                self.schedule_periodically("tick", stage.initial_delay,
                                           stage.interval)

            def on_timer(self, key):
                if cancellable.is_cancelled:
                    self.complete_stage()
                elif self.is_available(stage.out):
                    self.push(stage.out, stage.tick)

        logic = _L(self._shape)
        logic.set_handler(stage.out, make_out_handler(lambda: None))
        return logic, cancellable


class SourceQueue:
    """Mat value of Source.queue (reference: SourceQueueWithComplete)."""

    def __init__(self):
        self._offer_cb = None
        self._done_cb = None
        self._lock = threading.Lock()
        self._early: List = []  # offers before materialization finished

    def _bind(self, offer_cb, done_cb):
        with self._lock:
            self._offer_cb, self._done_cb = offer_cb, done_cb
            early, self._early = self._early, []
        for item in early:
            self._dispatch(item)

    def _dispatch(self, item):
        kind = item[0]
        if kind == "offer":
            self._offer_cb.invoke((item[1], item[2]))
        else:
            self._done_cb.invoke(item)

    def _set_closed(self) -> None:
        with self._lock:
            self._closed = True

    def offer(self, elem) -> Future:
        fut: Future = Future()
        with self._lock:
            if getattr(self, "_closed", False):
                fut.set_result(False)  # stream gone: offer rejected
                return fut
            if self._offer_cb is None:
                self._early.append(("offer", elem, fut))
                return fut
        self._dispatch(("offer", elem, fut))
        return fut

    def complete(self) -> None:
        with self._lock:
            if self._done_cb is None:
                self._early.append(("complete", None))
                return
        self._dispatch(("complete", None))

    def fail(self, ex: BaseException) -> None:
        with self._lock:
            if self._done_cb is None:
                self._early.append(("fail", ex))
                return
        self._dispatch(("fail", ex))


class QueueSource(_SourceStage):
    def __init__(self, buffer_size: int):
        super().__init__("QueueSource")
        self.buffer_size = buffer_size

    def create_logic_and_mat(self):
        stage = self
        queue_mat = SourceQueue()
        buf: collections.deque = collections.deque()
        state = {"completing": False}

        class _L(GraphStageLogic):
            def pre_start(self):
                queue_mat._bind(
                    self.get_async_callback(self._on_offer),
                    self.get_async_callback(self._on_done))

            def _on_offer(self, pair):
                elem, fut = pair
                if state["completing"]:
                    fut.set_result(False)
                    return
                if self.is_available(stage.out) and not buf:
                    self.push(stage.out, elem)
                    fut.set_result(True)
                elif len(buf) < stage.buffer_size:
                    buf.append(elem)
                    fut.set_result(True)
                else:
                    fut.set_result(False)  # backpressured: dropped

            def _on_done(self, item):
                if item[0] == "fail":
                    self.fail_stage(item[1])
                    return
                state["completing"] = True
                if not buf:
                    self.complete(stage.out)

            def post_stop(self):
                queue_mat._set_closed()

        logic = _L(self._shape)

        def on_pull():
            if buf:
                logic.push(stage.out, buf.popleft())
            if state["completing"] and not buf:
                logic.complete(stage.out)
        logic.set_handler(stage.out, make_out_handler(on_pull))
        return logic, queue_mat


class FutureSource(_SourceStage):
    def __init__(self, fut: Future):
        super().__init__("FutureSource")
        self.fut = fut

    def create_logic(self):
        stage = self

        class _L(GraphStageLogic):
            def pre_start(self):
                cb = self.get_async_callback(self._done)
                stage.fut.add_done_callback(lambda f: cb.invoke(f))

            def _done(self, f):
                ex = f.exception()
                if ex is not None:
                    self.fail_stage(ex)
                else:
                    self.emit(stage.out, f.result())
                    self.complete(stage.out)

        logic = _L(self._shape)
        logic.set_handler(stage.out, make_out_handler(lambda: None))
        return logic


class ActorRefSource(_SourceStage):
    """Mat: an ActorRef; messages become elements, Status.Success completes,
    Status.Failure fails (reference: Source.actorRef)."""

    def __init__(self, buffer_size: int):
        super().__init__("ActorRefSource")
        self.buffer_size = buffer_size

    def create_logic_and_mat(self):
        from ..actor.messages import Status
        from ..actor.props import Props
        stage = self
        buf: collections.deque = collections.deque()
        state = {"completing": False, "ref": None}

        class _L(GraphStageLogic):
            def pre_start(self):
                cb = self.get_async_callback(self._on_msg)
                system = self.materializer.system

                def receive(_ctx, msg):
                    cb.invoke(msg)
                state["ref"] = system.actor_of(Props.from_receive(receive))

            def _on_msg(self, msg):
                if isinstance(msg, Status.Success):
                    state["completing"] = True
                    if not buf:
                        self.complete(stage.out)
                elif isinstance(msg, Status.Failure):
                    self.fail_stage(msg.cause if isinstance(
                        msg.cause, BaseException) else
                        RuntimeError(str(msg.cause)))
                elif state["completing"]:
                    pass  # dropped after completion
                elif self.is_available(stage.out) and not buf:
                    self.push(stage.out, msg)
                elif len(buf) < stage.buffer_size:
                    buf.append(msg)
                # else: overflow -> dropped (reference default dropTail-ish)

            def post_stop(self):
                if state["ref"] is not None:
                    self.materializer.system.stop(state["ref"])

        logic = _L(self._shape)

        def on_pull():
            if buf:
                logic.push(stage.out, buf.popleft())
            if state["completing"] and not buf:
                logic.complete(stage.out)
        logic.set_handler(stage.out, make_out_handler(on_pull))

        class _LazyRef:
            def tell(self, msg, sender=None):
                state["ref"].tell(msg, sender)

            @property
            def ref(self):
                return state["ref"]
        return logic, _LazyRef()


# =============================== linear ops =================================

class _LinearStage(GraphStage):
    def __init__(self, name: str):
        self.name = name
        self.in_ = Inlet(f"{name}.in")
        self.out = Outlet(f"{name}.out")
        self._shape = FlowShape(self.in_, self.out)

    @property
    def shape(self):
        return self._shape

    def _logic(self):
        return GraphStageLogic(self._shape)


class Map(_LinearStage):
    def __init__(self, fn):
        super().__init__("Map")
        self.fn = fn

    def create_logic(self):
        logic, in_, out, fn = self._logic(), self.in_, self.out, self.fn
        logic.set_handler(in_, make_in_handler(
            lambda: logic.push(out, fn(logic.grab(in_)))))
        logic.set_handler(out, make_out_handler(lambda: logic.pull(in_)))
        return logic


class MapConcat(_LinearStage):
    def __init__(self, fn):
        super().__init__("MapConcat")
        self.fn = fn

    def create_logic(self):
        logic, in_, out, fn = self._logic(), self.in_, self.out, self.fn

        def on_push():
            elems = list(fn(logic.grab(in_)))
            if elems:
                logic.emit_multiple(out, elems)
            else:
                logic.pull(in_)
        logic.set_handler(in_, make_in_handler(on_push))
        logic.set_handler(out, make_out_handler(lambda: logic.pull(in_)))
        return logic


class StatefulMapConcat(_LinearStage):
    def __init__(self, factory):
        super().__init__("StatefulMapConcat")
        self.factory = factory

    def create_logic(self):
        logic, in_, out = self._logic(), self.in_, self.out
        fn = self.factory()

        def on_push():
            elems = list(fn(logic.grab(in_)))
            if elems:
                logic.emit_multiple(out, elems)
            else:
                logic.pull(in_)
        logic.set_handler(in_, make_in_handler(on_push))
        logic.set_handler(out, make_out_handler(lambda: logic.pull(in_)))
        return logic


class Filter(_LinearStage):
    def __init__(self, pred):
        super().__init__("Filter")
        self.pred = pred

    def create_logic(self):
        logic, in_, out, pred = self._logic(), self.in_, self.out, self.pred

        def on_push():
            elem = logic.grab(in_)
            if pred(elem):
                logic.push(out, elem)
            else:
                logic.pull(in_)
        logic.set_handler(in_, make_in_handler(on_push))
        logic.set_handler(out, make_out_handler(lambda: logic.pull(in_)))
        return logic


class Collect(_LinearStage):
    def __init__(self, fn):
        super().__init__("Collect")
        self.fn = fn

    def create_logic(self):
        logic, in_, out, fn = self._logic(), self.in_, self.out, self.fn

        def on_push():
            mapped = fn(logic.grab(in_))
            if mapped is not None:
                logic.push(out, mapped)
            else:
                logic.pull(in_)
        logic.set_handler(in_, make_in_handler(on_push))
        logic.set_handler(out, make_out_handler(lambda: logic.pull(in_)))
        return logic


class Take(_LinearStage):
    def __init__(self, n: int):
        super().__init__("Take")
        self.n = n

    def create_logic(self):
        logic, in_, out = self._logic(), self.in_, self.out
        left = {"n": self.n}

        def on_push():
            elem = logic.grab(in_)
            if left["n"] > 0:
                left["n"] -= 1
                logic.push(out, elem)
            if left["n"] <= 0:
                logic.complete_stage()

        def on_pull():
            if left["n"] <= 0:
                logic.complete_stage()
            else:
                logic.pull(in_)
        logic.set_handler(in_, make_in_handler(on_push))
        logic.set_handler(out, make_out_handler(on_pull))
        return logic


class TakeWhile(_LinearStage):
    def __init__(self, pred, inclusive: bool):
        super().__init__("TakeWhile")
        self.pred = pred
        self.inclusive = inclusive

    def create_logic(self):
        logic, in_, out = self._logic(), self.in_, self.out
        pred, inclusive = self.pred, self.inclusive

        def on_push():
            elem = logic.grab(in_)
            if pred(elem):
                logic.push(out, elem)
            else:
                if inclusive:
                    logic.push(out, elem)
                logic.complete_stage()
        logic.set_handler(in_, make_in_handler(on_push))
        logic.set_handler(out, make_out_handler(lambda: logic.pull(in_)))
        return logic


class Drop(_LinearStage):
    def __init__(self, n: int):
        super().__init__("Drop")
        self.n = n

    def create_logic(self):
        logic, in_, out = self._logic(), self.in_, self.out
        left = {"n": self.n}

        def on_push():
            elem = logic.grab(in_)
            if left["n"] > 0:
                left["n"] -= 1
                logic.pull(in_)
            else:
                logic.push(out, elem)
        logic.set_handler(in_, make_in_handler(on_push))
        logic.set_handler(out, make_out_handler(lambda: logic.pull(in_)))
        return logic


class DropWhile(_LinearStage):
    def __init__(self, pred):
        super().__init__("DropWhile")
        self.pred = pred

    def create_logic(self):
        logic, in_, out, pred = self._logic(), self.in_, self.out, self.pred
        state = {"dropping": True}

        def on_push():
            elem = logic.grab(in_)
            if state["dropping"] and pred(elem):
                logic.pull(in_)
            else:
                state["dropping"] = False
                logic.push(out, elem)
        logic.set_handler(in_, make_in_handler(on_push))
        logic.set_handler(out, make_out_handler(lambda: logic.pull(in_)))
        return logic


class Scan(_LinearStage):
    """Emits zero first, then each fold step (reference: Ops.scala Scan)."""

    def __init__(self, zero, fn):
        super().__init__("Scan")
        self.zero = zero
        self.fn = fn

    def create_logic(self):
        logic, in_, out, fn = self._logic(), self.in_, self.out, self.fn
        state = {"acc": self.zero, "sent_zero": False}
        # Supervision.restart resets the aggregate to zero (Ops.scala Scan
        # restart semantics); resume keeps the accumulated value
        logic.restart_state = lambda: state.update(acc=self.zero)

        def on_pull():
            if not state["sent_zero"]:
                state["sent_zero"] = True
                logic.push(out, state["acc"])
            else:
                logic.pull(in_)

        def on_push():
            state["acc"] = fn(state["acc"], logic.grab(in_))
            logic.push(out, state["acc"])

        def on_finish():
            if not state["sent_zero"]:
                logic.emit(out, state["acc"])
            logic.complete_stage()
        logic.set_handler(in_, make_in_handler(on_push, on_finish))
        logic.set_handler(out, make_out_handler(on_pull))
        return logic


class Fold(_LinearStage):
    def __init__(self, zero, fn):
        super().__init__("Fold")
        self.zero = zero
        self.fn = fn

    def create_logic(self):
        logic, in_, out, fn = self._logic(), self.in_, self.out, self.fn
        state = {"acc": self.zero}
        logic.restart_state = lambda: state.update(acc=self.zero)

        def on_push():
            state["acc"] = fn(state["acc"], logic.grab(in_))
            logic.pull(in_)

        def on_finish():
            logic.emit(out, state["acc"])
            logic.complete(out)
        logic.set_handler(in_, make_in_handler(on_push, on_finish))
        logic.set_handler(out, make_out_handler(
            lambda: logic.pull(in_) if not logic.has_been_pulled(in_)
            and not logic.is_closed(in_) else None))
        return logic


class Reduce(_LinearStage):
    def __init__(self, fn):
        super().__init__("Reduce")
        self.fn = fn

    def create_logic(self):
        logic, in_, out, fn = self._logic(), self.in_, self.out, self.fn
        state = {"acc": None, "has": False}

        def on_push():
            elem = logic.grab(in_)
            state["acc"] = elem if not state["has"] else fn(state["acc"], elem)
            state["has"] = True
            logic.pull(in_)

        def on_finish():
            if not state["has"]:
                logic.fail(out, NoSuchElementException("reduce of empty stream"))
            else:
                logic.emit(out, state["acc"])
                logic.complete(out)
        logic.set_handler(in_, make_in_handler(on_push, on_finish))
        logic.set_handler(out, make_out_handler(
            lambda: logic.pull(in_) if not logic.has_been_pulled(in_)
            and not logic.is_closed(in_) else None))
        return logic


class Grouped(_LinearStage):
    def __init__(self, n: int):
        super().__init__("Grouped")
        self.n = n

    def create_logic(self):
        logic, in_, out, n = self._logic(), self.in_, self.out, self.n
        buf: List = []

        def on_push():
            buf.append(logic.grab(in_))
            if len(buf) >= n:
                group, buf[:] = list(buf), []
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


class Sliding(_LinearStage):
    def __init__(self, n: int, step: int):
        super().__init__("Sliding")
        self.n = n
        self.step = step

    def create_logic(self):
        logic, in_, out = self._logic(), self.in_, self.out
        n, step = self.n, self.step
        buf: List = []
        state = {"emitted": False}

        def on_push():
            buf.append(logic.grab(in_))
            if len(buf) >= n:
                logic.push(out, list(buf[:n]))
                state["emitted"] = True
                del buf[:step]
            else:
                logic.pull(in_)

        def on_finish():
            if buf and (not state["emitted"] or len(buf) > max(0, n - step)):
                logic.emit(out, list(buf))
            logic.complete_stage()
        logic.set_handler(in_, make_in_handler(on_push, on_finish))
        logic.set_handler(out, make_out_handler(lambda: logic.pull(in_)))
        return logic


class Intersperse(_LinearStage):
    def __init__(self, sep, start=None, end=None):
        super().__init__("Intersperse")
        self.sep = sep
        self.start = start
        self.end = end

    def create_logic(self):
        logic, in_, out = self._logic(), self.in_, self.out
        sep, start, end = self.sep, self.start, self.end
        state = {"first": True}

        def on_push():
            elem = logic.grab(in_)
            if state["first"]:
                state["first"] = False
                if start is not None:
                    logic.emit_multiple(out, [start, elem])
                else:
                    logic.push(out, elem)
            else:
                logic.emit_multiple(out, [sep, elem])

        def on_finish():
            if end is not None:
                logic.emit(out, end)
            logic.complete_stage()
        logic.set_handler(in_, make_in_handler(on_push, on_finish))
        logic.set_handler(out, make_out_handler(lambda: logic.pull(in_)))
        return logic


class Buffer(_LinearStage):
    """(reference: Ops.scala Buffer; strategies: backpressure, drop_head,
    drop_tail, drop_new, drop_buffer, fail)"""

    def __init__(self, size: int, strategy: str):
        super().__init__("Buffer")
        self.size = size
        self.strategy = strategy

    def create_logic(self):
        logic, in_, out = self._logic(), self.in_, self.out
        size, strategy = self.size, self.strategy
        buf: collections.deque = collections.deque()
        done = {"finishing": False}

        class _L(GraphStageLogic):
            def pre_start(self):
                self.pull(in_)
        logic = _L(self._shape)

        def on_push():
            elem = logic.grab(in_)
            if logic.is_available(out) and not buf:
                # fast path only with an EMPTY buffer — pushing past
                # buffered elements would reorder the stream
                logic.push(out, elem)
                logic.pull(in_)
                return
            if len(buf) < size:
                buf.append(elem)
            elif strategy == "drop_head":
                buf.popleft(); buf.append(elem)
            elif strategy == "drop_tail":
                buf.pop(); buf.append(elem)
            elif strategy == "drop_new":
                pass
            elif strategy == "drop_buffer":
                buf.clear(); buf.append(elem)
            elif strategy == "fail":
                logic.fail_stage(BufferOverflowException(
                    f"buffer full ({size})"))
                return
            else:  # backpressure at capacity: the element MUST still be
                # kept — it was already pulled in-flight when the buffer
                # filled; only the NEXT pull is withheld
                buf.append(elem)
            # keep pulling unless backpressuring at capacity
            if not (strategy == "backpressure" and len(buf) >= size):
                logic.pull(in_)

        def on_pull():
            if buf:
                logic.push(out, buf.popleft())
            if done["finishing"] and not buf:
                logic.complete_stage()
                return
            if (not logic.has_been_pulled(in_) and not logic.is_closed(in_)
                    and len(buf) < size):
                logic.pull(in_)

        def on_finish():
            if buf:
                done["finishing"] = True
            else:
                logic.complete_stage()
        logic.set_handler(in_, make_in_handler(on_push, on_finish))
        logic.set_handler(out, make_out_handler(on_pull))
        return logic


class BufferOverflowException(RuntimeError):
    pass


class Conflate(_LinearStage):
    """Shrinks a fast upstream for a slow downstream (reference: Ops.scala
    Batch with seed/aggregate in conflate mode — never backpressures)."""

    def __init__(self, seed, aggregate):
        super().__init__("Conflate")
        self.seed = seed
        self.aggregate = aggregate

    def create_logic(self):
        in_, out = self.in_, self.out
        seed, aggregate = self.seed, self.aggregate
        state = {"agg": None, "has": False, "finishing": False}

        class _L(GraphStageLogic):
            def pre_start(self):
                self.pull(in_)
        logic = _L(self._shape)

        def on_push():
            elem = logic.grab(in_)
            if state["has"]:
                state["agg"] = aggregate(state["agg"], elem)
            else:
                state["agg"], state["has"] = seed(elem), True
            if logic.is_available(out):
                logic.push(out, state["agg"])
                state["agg"], state["has"] = None, False
            logic.pull(in_)

        def on_pull():
            if state["has"]:
                logic.push(out, state["agg"])
                state["agg"], state["has"] = None, False
            if state["finishing"] and not state["has"]:
                logic.complete_stage()

        def on_finish():
            if state["has"]:
                state["finishing"] = True
                if logic.is_available(out):
                    logic.push(out, state["agg"])
                    logic.complete_stage()
            else:
                logic.complete_stage()
        logic.set_handler(in_, make_in_handler(on_push, on_finish))
        logic.set_handler(out, make_out_handler(on_pull))
        return logic


class Batch(_LinearStage):
    """Like conflate but backpressures once `max_n` elements are batched."""

    def __init__(self, max_n: int, seed, aggregate):
        super().__init__("Batch")
        self.max_n = max_n
        self.seed = seed
        self.aggregate = aggregate

    def create_logic(self):
        in_, out = self.in_, self.out
        max_n, seed, aggregate = self.max_n, self.seed, self.aggregate
        state = {"agg": None, "count": 0, "finishing": False}

        class _L(GraphStageLogic):
            def pre_start(self):
                self.pull(in_)
        logic = _L(self._shape)

        def on_push():
            elem = logic.grab(in_)
            if state["count"]:
                state["agg"] = aggregate(state["agg"], elem)
            else:
                state["agg"] = seed(elem)
            state["count"] += 1
            if logic.is_available(out):
                logic.push(out, state["agg"])
                state["agg"], state["count"] = None, 0
            if state["count"] < max_n:
                logic.pull(in_)

        def on_pull():
            if state["count"]:
                logic.push(out, state["agg"])
                state["agg"], state["count"] = None, 0
                if state["finishing"]:
                    logic.complete_stage()
                elif not logic.has_been_pulled(in_) and not logic.is_closed(in_):
                    logic.pull(in_)
            elif state["finishing"]:
                logic.complete_stage()

        def on_finish():
            if state["count"]:
                state["finishing"] = True
            else:
                logic.complete_stage()
        logic.set_handler(in_, make_in_handler(on_push, on_finish))
        logic.set_handler(out, make_out_handler(on_pull))
        return logic


class Expand(_LinearStage):
    """Fills a fast downstream by extrapolating (reference: Ops.scala Expand)."""

    def __init__(self, extrapolate):
        super().__init__("Expand")
        self.extrapolate = extrapolate

    def create_logic(self):
        in_, out, extrapolate = self.in_, self.out, self.extrapolate
        state = {"it": None}

        class _L(GraphStageLogic):
            def pre_start(self):
                self.pull(in_)
        logic = _L(self._shape)

        def on_push():
            state["it"] = iter(extrapolate(logic.grab(in_)))
            if logic.is_available(out):
                _push_next()

        def _push_next():
            try:
                logic.push(out, next(state["it"]))
            except StopIteration:
                state["it"] = None
            if not logic.has_been_pulled(in_) and not logic.is_closed(in_):
                logic.pull(in_)

        def on_pull():
            if state["it"] is not None:
                _push_next()
            elif logic.is_closed(in_):
                logic.complete_stage()

        def on_finish():
            logic.complete_stage()
        logic.set_handler(in_, make_in_handler(on_push, on_finish))
        logic.set_handler(out, make_out_handler(on_pull))
        return logic


class MapAsync(_LinearStage):
    """fn returns a concurrent.futures.Future (or a plain value). Up to
    `parallelism` in flight; ordered variant preserves upstream order
    (reference: Ops.scala MapAsync / MapAsyncUnordered)."""

    def __init__(self, parallelism: int, fn, ordered: bool):
        super().__init__("MapAsync")
        self.parallelism = parallelism
        self.fn = fn
        self.ordered = ordered

    def create_logic(self):
        in_, out = self.in_, self.out
        parallelism, fn, ordered = self.parallelism, self.fn, self.ordered
        in_flight: List[dict] = []  # slots: {"done": bool, "val":, "ex":}
        state = {"finishing": False}

        class _L(GraphStageLogic):
            def pre_start(self):
                self.pull(in_)
        logic = _L(self._shape)

        def _drain():
            while in_flight:
                idx = 0 if ordered else next(
                    (i for i, s in enumerate(in_flight) if s["done"]), None)
                if idx is None:
                    break
                slot = in_flight[idx]
                if not slot["done"]:
                    break
                if slot["ex"] is not None:
                    logic.fail_stage(slot["ex"])
                    return
                if not logic.is_available(out):
                    break
                in_flight.pop(idx)
                logic.push(out, slot["val"])
            if state["finishing"] and not in_flight:
                logic.complete_stage()
                return
            if (len(in_flight) < parallelism and not state["finishing"]
                    and not logic.has_been_pulled(in_)
                    and not logic.is_closed(in_)):
                logic.pull(in_)

        def on_push():
            elem = logic.grab(in_)
            slot = {"done": False, "val": None, "ex": None}
            in_flight.append(slot)
            cb = logic.get_async_callback(lambda res: _complete(slot, res))
            try:
                fut = fn(elem)
            except Exception as e:  # noqa: BLE001
                slot["done"], slot["ex"] = True, e
                _drain()
                return
            if isinstance(fut, Future):
                fut.add_done_callback(
                    lambda f: cb.invoke((f.exception(), None)
                                        if f.exception() is not None
                                        else (None, f.result())))
            else:
                slot["done"], slot["val"] = True, fut
                _drain()
                return
            if len(in_flight) < parallelism:
                logic.pull(in_)

        def _complete(slot, res):
            ex, val = res
            slot["done"], slot["ex"], slot["val"] = True, ex, val
            _drain()

        def on_pull():
            _drain()

        def on_finish():
            if in_flight:
                state["finishing"] = True
            else:
                logic.complete_stage()
        logic.set_handler(in_, make_in_handler(on_push, on_finish))
        logic.set_handler(out, make_out_handler(on_pull))
        return logic


class Throttle(_LinearStage):
    """Token bucket (reference: impl/Throttle.scala)."""

    def __init__(self, elements: int, per: float, burst: int):
        super().__init__("Throttle")
        self.elements = elements
        self.per = per
        self.burst = max(1, burst)

    def create_logic(self):
        in_, out = self.in_, self.out
        interval = self.per / max(1, self.elements)
        burst = self.burst
        state = {"tokens": burst, "pending": None, "has_pending": False,
                 "finishing": False}

        class _L(GraphStageLogic):
            def pre_start(self):
                self.schedule_periodically("token", interval, interval)

            def on_timer(self, key):
                state["tokens"] = min(burst, state["tokens"] + 1)
                if state["has_pending"] and state["tokens"] > 0 and \
                        self.is_available(out):
                    state["tokens"] -= 1
                    elem = state["pending"]
                    state["pending"], state["has_pending"] = None, False
                    self.push(out, elem)
                    if state["finishing"]:
                        self.complete_stage()
                    else:
                        self.pull(in_)
        logic = _L(self._shape)

        def on_push():
            elem = logic.grab(in_)
            if state["tokens"] > 0 and logic.is_available(out):
                state["tokens"] -= 1
                logic.push(out, elem)
                logic.pull(in_)
            else:
                state["pending"], state["has_pending"] = elem, True

        def on_pull():
            if state["has_pending"] and state["tokens"] > 0:
                state["tokens"] -= 1
                elem = state["pending"]
                state["pending"], state["has_pending"] = None, False
                logic.push(out, elem)
                if state["finishing"]:
                    logic.complete_stage()
                else:
                    logic.pull(in_)
            elif not logic.has_been_pulled(in_) and not logic.is_closed(in_) \
                    and not state["has_pending"]:
                logic.pull(in_)

        def on_finish():
            if state["has_pending"]:
                state["finishing"] = True
            else:
                logic.complete_stage()
        logic.set_handler(in_, make_in_handler(on_push, on_finish))
        logic.set_handler(out, make_out_handler(on_pull))
        return logic


class Delay(_LinearStage):
    def __init__(self, of: float):
        super().__init__("Delay")
        self.of = of

    def create_logic(self):
        import time as _time
        in_, out, of = self.in_, self.out, self.of
        buf: collections.deque = collections.deque()  # (deadline, elem)
        state = {"finishing": False, "timer_set": False}

        class _L(GraphStageLogic):
            def pre_start(self):
                self.pull(in_)

            def on_timer(self, key):
                state["timer_set"] = False
                self._flush()

            def _flush(self):
                now = _time.monotonic()
                while buf and buf[0][0] <= now and self.is_available(out):
                    self.push(out, buf.popleft()[1])
                    if not self.has_been_pulled(in_) and \
                            not self.is_closed(in_):
                        self.pull(in_)
                if buf and not state["timer_set"]:
                    state["timer_set"] = True
                    self.schedule_once("delay",
                                       max(0.001, buf[0][0] - now))
                if state["finishing"] and not buf:
                    self.complete_stage()
        logic = _L(self._shape)

        def on_push():
            import time as _t
            buf.append((_t.monotonic() + of, logic.grab(in_)))
            logic._flush()
            if not state["timer_set"] and buf:
                state["timer_set"] = True
                logic.schedule_once("delay", of)

        def on_pull():
            logic._flush()

        def on_finish():
            if buf:
                state["finishing"] = True
            else:
                logic.complete_stage()
        logic.set_handler(in_, make_in_handler(on_push, on_finish))
        logic.set_handler(out, make_out_handler(on_pull))
        return logic


class Recover(_LinearStage):
    def __init__(self, fn):
        super().__init__("Recover")
        self.fn = fn

    def create_logic(self):
        logic, in_, out, fn = self._logic(), self.in_, self.out, self.fn

        def on_failure(ex):
            try:
                elem = fn(ex)
            except Exception as e:  # noqa: BLE001
                logic.fail_stage(e)
                return
            logic.emit(out, elem)
            logic.complete(out)
        logic.set_handler(in_, make_in_handler(
            lambda: logic.push(out, logic.grab(in_)),
            on_upstream_failure=on_failure))
        logic.set_handler(out, make_out_handler(
            lambda: logic.pull(in_) if not logic.is_closed(in_) else None))
        return logic


class Log(_LinearStage):
    def __init__(self, log_name: str, extract):
        super().__init__("Log")
        self.log_name = log_name
        self.extract = extract

    def create_logic(self):
        logic, in_, out = self._logic(), self.in_, self.out
        log_name, extract = self.log_name, self.extract

        def _log(kind: str, msg: str):
            log = logic.materializer.system.log if logic.materializer else None
            if log is None:
                return
            # Attributes.log_levels picks the level per event kind
            # (reference: ActorAttributes.logLevels honored by Ops.scala Log)
            levels = ("debug", "debug", "error")
            if logic.attributes is not None:
                levels = logic.attributes.get("log_levels", levels)
            level = dict(zip(("element", "finish", "failure"), levels))[kind]
            getattr(log, level, log.debug)(msg)

        def on_push():
            elem = logic.grab(in_)
            _log("element", f"[{log_name}] element: {extract(elem)}")
            logic.push(out, elem)

        def on_finish():
            _log("finish", f"[{log_name}] upstream finished")
            logic.complete_stage()

        def on_failure(ex):
            _log("failure", f"[{log_name}] upstream failed: {ex!r}")
            logic.fail_stage(ex)
        logic.set_handler(in_, make_in_handler(on_push, on_finish, on_failure))
        logic.set_handler(out, make_out_handler(lambda: logic.pull(in_)))
        return logic


class WireTap(_LinearStage):
    def __init__(self, fn):
        super().__init__("WireTap")
        self.fn = fn

    def create_logic(self):
        logic, in_, out, fn = self._logic(), self.in_, self.out, self.fn

        def on_push():
            elem = logic.grab(in_)
            try:
                fn(elem)
            except Exception:  # noqa: BLE001 — taps must not break the stream
                pass
            logic.push(out, elem)
        logic.set_handler(in_, make_in_handler(on_push))
        logic.set_handler(out, make_out_handler(lambda: logic.pull(in_)))
        return logic


class FlatMapConcat(_LinearStage):
    """Each element maps to a Source; sources run one after another via
    sub-materialization + queue bridge (reference: StreamOfStreams.scala)."""

    def __init__(self, fn):
        super().__init__("FlatMapConcat")
        self.fn = fn

    def create_logic(self):
        in_, out, fn = self.in_, self.out, self.fn
        state = {"sub": None, "finishing": False}

        class _L(GraphStageLogic):
            def _start_sub(self, elem):
                from .dsl import Keep, Sink
                source = fn(elem)
                mat = self.materializer
                queue = source.to_mat(Sink.queue(), Keep.right).run(mat)
                state["sub"] = queue
                self._pull_sub()

            def _pull_sub(self):
                cb = self.get_async_callback(self._sub_event)
                state["sub"].pull().add_done_callback(
                    lambda f: cb.invoke(f))

            def _sub_event(self, f):
                ex = f.exception()
                if ex is not None:
                    self.fail_stage(ex)
                    return
                item = f.result()
                if item is _QUEUE_END:
                    state["sub"] = None
                    if state["finishing"]:
                        self.complete_stage()
                    elif not self.is_closed(in_):
                        self.pull(in_)
                    else:
                        self.complete_stage()
                else:
                    self.emit(out, item, and_then=self._pull_sub)
        logic = _L(self._shape)

        def on_push():
            logic._start_sub(logic.grab(in_))

        def on_pull():
            if state["sub"] is None and not logic.has_been_pulled(in_) \
                    and not logic.is_closed(in_):
                logic.pull(in_)

        def on_finish():
            if state["sub"] is not None:
                state["finishing"] = True
            else:
                logic.complete_stage()
        logic.set_handler(in_, make_in_handler(on_push, on_finish))
        logic.set_handler(out, make_out_handler(on_pull))
        return logic


# =============================== fan stages =================================

class MergeStage(GraphStage):
    def __init__(self, n: int):
        self.name = "Merge"
        self.ins = [Inlet(f"Merge.in{i}") for i in range(n)]
        self.out = Outlet("Merge.out")
        self._shape = FanInShape(self.ins, self.out)

    @property
    def shape(self):
        return self._shape

    def create_logic(self):
        ins, out = self.ins, self.out
        # at most ONE buffered element per inlet (reference Merge holds one
        # pending per input; re-pull only after that element is consumed)
        buf: collections.deque = collections.deque()  # (elem, inlet)
        logic = GraphStageLogic(self._shape)

        def mk_push(inlet):
            def on_push():
                elem = logic.grab(inlet)
                if logic.is_available(out) and not buf:
                    logic.push(out, elem)
                    logic.pull(inlet)
                else:
                    buf.append((elem, inlet))  # backpressure this inlet
            return on_push

        def mk_finish(inlet):
            def on_finish():
                if all(logic.is_closed(i) for i in ins) and not buf:
                    logic.complete(out)
            return on_finish

        for inlet in ins:
            logic.set_handler(inlet, make_in_handler(mk_push(inlet),
                                                     mk_finish(inlet)))

        def on_pull():
            if buf:
                elem, inlet = buf.popleft()
                logic.push(out, elem)
                if not logic.is_closed(inlet):
                    logic.pull(inlet)
                if not buf and all(logic.is_closed(i) for i in ins):
                    logic.complete(out)
                return
            for inlet in ins:
                if not logic.has_been_pulled(inlet) and \
                        not logic.is_closed(inlet):
                    logic.pull(inlet)
        logic.set_handler(out, make_out_handler(on_pull))
        return logic


class ConcatStage(GraphStage):
    def __init__(self, n: int):
        self.name = "Concat"
        self.ins = [Inlet(f"Concat.in{i}") for i in range(n)]
        self.out = Outlet("Concat.out")
        self._shape = FanInShape(self.ins, self.out)

    @property
    def shape(self):
        return self._shape

    def create_logic(self):
        ins, out = self.ins, self.out
        state = {"active": 0}
        logic = GraphStageLogic(self._shape)

        def mk_push(i, inlet):
            def on_push():
                logic.push(out, logic.grab(inlet))
            return on_push

        def mk_finish(i, inlet):
            def on_finish():
                if state["active"] == i:
                    state["active"] += 1
                    if state["active"] >= len(ins):
                        logic.complete(out)
                    elif logic.is_available(out) or True:
                        nxt = ins[state["active"]]
                        if logic.is_closed(nxt):
                            mk_finish(state["active"], nxt)()
                        elif logic.is_available(out) and \
                                not logic.has_been_pulled(nxt):
                            logic.pull(nxt)
            return on_finish

        for i, inlet in enumerate(ins):
            logic.set_handler(inlet, make_in_handler(mk_push(i, inlet),
                                                     mk_finish(i, inlet)))

        def on_pull():
            inlet = ins[state["active"]]
            if not logic.has_been_pulled(inlet) and not logic.is_closed(inlet):
                logic.pull(inlet)
        logic.set_handler(out, make_out_handler(on_pull))
        return logic


class OrElseStage(GraphStage):
    def __init__(self):
        self.name = "OrElse"
        self.ins = [Inlet("OrElse.primary"), Inlet("OrElse.secondary")]
        self.out = Outlet("OrElse.out")
        self._shape = FanInShape(self.ins, self.out)

    @property
    def shape(self):
        return self._shape

    def create_logic(self):
        primary, secondary = self.ins
        out = self.out
        state = {"primary_emitted": False, "use_secondary": False}
        logic = GraphStageLogic(self._shape)

        def primary_push():
            state["primary_emitted"] = True
            if not logic.is_closed(secondary):
                logic.cancel(secondary)
            logic.push(out, logic.grab(primary))

        def primary_finish():
            if state["primary_emitted"]:
                logic.complete_stage()
            else:
                state["use_secondary"] = True
                if logic.is_available(out) and \
                        not logic.has_been_pulled(secondary) and \
                        not logic.is_closed(secondary):
                    logic.pull(secondary)
                elif logic.is_closed(secondary):
                    logic.complete(out)

        def secondary_push():
            logic.push(out, logic.grab(secondary))

        def secondary_finish():
            if state["use_secondary"]:
                logic.complete(out)

        logic.set_handler(primary, make_in_handler(primary_push,
                                                   primary_finish))
        logic.set_handler(secondary, make_in_handler(secondary_push,
                                                     secondary_finish))

        def on_pull():
            inlet = secondary if state["use_secondary"] else primary
            if logic.is_closed(inlet):
                logic.complete(out)
            elif not logic.has_been_pulled(inlet):
                logic.pull(inlet)
        logic.set_handler(out, make_out_handler(on_pull))
        return logic


class ZipWithStage(GraphStage):
    def __init__(self, fn):
        self.name = "ZipWith"
        self.fn = fn
        self.ins = [Inlet("Zip.in0"), Inlet("Zip.in1")]
        self.out = Outlet("Zip.out")
        self._shape = FanInShape(self.ins, self.out)

    @property
    def shape(self):
        return self._shape

    def create_logic(self):
        i0, i1 = self.ins
        out, fn = self.out, self.fn
        logic = GraphStageLogic(self._shape)

        def try_push():
            if logic.is_available(i0) and logic.is_available(i1):
                a, b = logic.grab(i0), logic.grab(i1)
                logic.push(out, fn(a, b))
                if logic.is_closed(i0) or logic.is_closed(i1):
                    logic.complete_stage()

        def mk_finish(inlet):
            def on_finish():
                if not logic.is_available(inlet):
                    logic.complete_stage()
            return on_finish

        logic.set_handler(i0, make_in_handler(try_push, mk_finish(i0)))
        logic.set_handler(i1, make_in_handler(try_push, mk_finish(i1)))

        def on_pull():
            for inlet in (i0, i1):
                if not logic.has_been_pulled(inlet) and \
                        not logic.is_closed(inlet) and \
                        not logic.is_available(inlet):
                    logic.pull(inlet)
        logic.set_handler(out, make_out_handler(on_pull))
        return logic


class InterleaveStage(GraphStage):
    """N-way round-robin interleave: `segment` elements from each input in
    turn (reference Interleave supports any input count — interleaveAll
    must yield round-robin order ACROSS all sources, which chained 2-way
    interleaves would not)."""

    def __init__(self, segment_size: int, n: int = 2):
        self.name = "Interleave"
        self.segment = max(1, segment_size)
        self.ins = [Inlet(f"Ilv.in{i}") for i in range(n)]
        self.out = Outlet("Ilv.out")
        self._shape = FanInShape(self.ins, self.out)

    @property
    def shape(self):
        return self._shape

    def create_logic(self):
        ins, out, segment = self.ins, self.out, self.segment
        state = {"cur": 0, "count": 0}
        logic = GraphStageLogic(self._shape)

        def switch():
            state["count"] = 0
            for step in range(1, len(ins) + 1):
                nxt = (state["cur"] + step) % len(ins)
                if not logic.is_closed(ins[nxt]):
                    state["cur"] = nxt
                    return

        def mk_push(i, inlet):
            def on_push():
                logic.push(out, logic.grab(inlet))
                state["count"] += 1
                if state["count"] >= segment:
                    switch()
            return on_push

        def mk_finish(i, inlet):
            def on_finish():
                if all(logic.is_closed(x) for x in ins):
                    logic.complete(out)
                elif state["cur"] == i:
                    switch()
                    if logic.is_available(out):
                        nxt = ins[state["cur"]]
                        if not logic.has_been_pulled(nxt) and \
                                not logic.is_closed(nxt):
                            logic.pull(nxt)
            return on_finish

        for i, inlet in enumerate(ins):
            logic.set_handler(inlet, make_in_handler(mk_push(i, inlet),
                                                     mk_finish(i, inlet)))

        def on_pull():
            inlet = ins[state["cur"]]
            if logic.is_closed(inlet):
                switch()
                inlet = ins[state["cur"]]
            if logic.is_closed(inlet):
                logic.complete(out)
            elif not logic.has_been_pulled(inlet):
                logic.pull(inlet)
        logic.set_handler(out, make_out_handler(on_pull))
        return logic


class BroadcastStage(GraphStage):
    def __init__(self, n: int, eager_cancel: bool = False):
        self.name = "Broadcast"
        self.eager_cancel = eager_cancel
        self.in_ = Inlet("Bcast.in")
        self.outs = [Outlet(f"Bcast.out{i}") for i in range(n)]
        self._shape = FanOutShape(self.in_, self.outs)

    @property
    def shape(self):
        return self._shape

    def create_logic(self):
        in_, outs, eager = self.in_, self.outs, self.eager_cancel
        logic = GraphStageLogic(self._shape)

        def _ready() -> bool:
            """Pull upstream only when every OPEN output has demand —
            cancellation of one output must re-evaluate, not freeze, the
            wait condition."""
            open_outs = [o for o in outs if not logic.is_closed(o)]
            return bool(open_outs) and all(logic.is_available(o)
                                           for o in open_outs)

        def _maybe_pull():
            if _ready() and not logic.has_been_pulled(in_) \
                    and not logic.is_closed(in_):
                logic.pull(in_)

        def on_push():
            elem = logic.grab(in_)
            for o in outs:
                if not logic.is_closed(o):
                    logic.push(o, elem)

        def on_finish():
            logic.complete_stage()

        logic.set_handler(in_, make_in_handler(on_push, on_finish))

        def mk_pull(o):
            return lambda: _maybe_pull()

        def mk_cancel(o):
            def on_cancel(cause=None):
                if eager:
                    logic.complete_stage()
                    return
                if all(logic.is_closed(x) for x in outs):
                    logic.cancel(in_)
                else:
                    _maybe_pull()
            return on_cancel

        for o in outs:
            logic.set_handler(o, make_out_handler(mk_pull(o), mk_cancel(o)))
        return logic


class BalanceStage(GraphStage):
    def __init__(self, n: int):
        self.name = "Balance"
        self.in_ = Inlet("Balance.in")
        self.outs = [Outlet(f"Balance.out{i}") for i in range(n)]
        self._shape = FanOutShape(self.in_, self.outs)

    @property
    def shape(self):
        return self._shape

    def create_logic(self):
        in_, outs = self.in_, self.outs
        logic = GraphStageLogic(self._shape)

        def on_push():
            elem = logic.grab(in_)
            for o in outs:
                if logic.is_available(o):
                    logic.push(o, elem)
                    return
            # no one pulled meanwhile (shouldn't happen): drop

        def on_finish():
            logic.complete_stage()
        logic.set_handler(in_, make_in_handler(on_push, on_finish))

        def mk_pull(o):
            def on_pull():
                if not logic.has_been_pulled(in_) and not logic.is_closed(in_):
                    logic.pull(in_)
            return on_pull

        def mk_cancel(o):
            def on_cancel(cause=None):
                if all(logic.is_closed(x) for x in outs):
                    logic.cancel(in_)
            return on_cancel
        for o in outs:
            logic.set_handler(o, make_out_handler(mk_pull(o), mk_cancel(o)))
        return logic


class PartitionStage(GraphStage):
    def __init__(self, n: int, partitioner):
        self.name = "Partition"
        self.partitioner = partitioner
        self.in_ = Inlet("Partition.in")
        self.outs = [Outlet(f"Partition.out{i}") for i in range(n)]
        self._shape = FanOutShape(self.in_, self.outs)

    @property
    def shape(self):
        return self._shape

    def create_logic(self):
        in_, outs, partitioner = self.in_, self.outs, self.partitioner
        logic = GraphStageLogic(self._shape)
        waiting = {"elem": None, "target": None}

        def on_push():
            elem = logic.grab(in_)
            i = partitioner(elem)
            o = outs[i]
            if logic.is_closed(o):
                logic.pull(in_)  # partition target gone: drop
            elif logic.is_available(o):
                logic.push(o, elem)
            else:
                waiting["elem"], waiting["target"] = elem, o

        def on_finish():
            logic.complete_stage()
        logic.set_handler(in_, make_in_handler(on_push, on_finish))

        def mk_pull(o):
            def on_pull():
                if waiting["target"] is o:
                    elem = waiting["elem"]
                    waiting["elem"] = waiting["target"] = None
                    logic.push(o, elem)
                elif waiting["target"] is None and \
                        not logic.has_been_pulled(in_) and \
                        not logic.is_closed(in_):
                    logic.pull(in_)
            return on_pull

        def mk_cancel(o):
            def on_cancel(cause=None):
                if all(logic.is_closed(x) for x in outs):
                    logic.cancel(in_)
            return on_cancel
        for o in outs:
            logic.set_handler(o, make_out_handler(mk_pull(o), mk_cancel(o)))
        return logic


# =============================== sinks ======================================

class _SinkStage(GraphStage):
    def __init__(self, name: str):
        self.name = name
        self.in_ = Inlet(f"{name}.in")
        self._shape = SinkShape(self.in_)

    @property
    def shape(self):
        return self._shape


class _PullAllLogic(GraphStageLogic):
    def __init__(self, shape, inlet):
        super().__init__(shape)
        self._inlet = inlet

    def pre_start(self):
        self.pull(self._inlet)


def _sink_logic(stage: "_SinkStage", on_elem, fut: Future,
                result_fn=lambda: None,
                empty_error: Optional[Callable[[], BaseException]] = None,
                cleanup_fn=None):
    logic = _PullAllLogic(stage._shape, stage.in_)
    in_ = stage.in_

    def _cleanup():
        if cleanup_fn is not None:
            try:
                cleanup_fn()
            except Exception:  # noqa: BLE001 — cleanup must not mask the error
                pass

    def on_push():
        try:
            on_elem(logic.grab(in_))
        except Exception as e:  # noqa: BLE001
            if not fut.done():
                fut.set_exception(e)
            _cleanup()
            logic.cancel_stage(e)
            return
        logic.pull(in_)

    def on_finish():
        if not fut.done():
            err = empty_error() if empty_error is not None else None
            if err is not None:
                fut.set_exception(err)
            else:
                fut.set_result(result_fn())
        logic.complete_stage()

    def on_failure(ex):
        if not fut.done():
            fut.set_exception(ex)
        _cleanup()
        logic.fail_stage(ex)
    logic.set_handler(in_, make_in_handler(on_push, on_finish, on_failure))
    return logic


class IgnoreSink(_SinkStage):
    def __init__(self):
        super().__init__("IgnoreSink")

    def create_logic_and_mat(self):
        fut: Future = Future()
        return _sink_logic(self, lambda e: None, fut,
                           result_fn=lambda: None), fut


class ForeachSink(_SinkStage):
    def __init__(self, fn):
        super().__init__("ForeachSink")
        self.fn = fn

    def create_logic_and_mat(self):
        fut: Future = Future()
        return _sink_logic(self, self.fn, fut, result_fn=lambda: None), fut


class SeqSink(_SinkStage):
    def __init__(self):
        super().__init__("SeqSink")

    def create_logic_and_mat(self):
        fut: Future = Future()
        acc: List = []
        return _sink_logic(self, acc.append, fut,
                           result_fn=lambda: list(acc)), fut


class FoldSink(_SinkStage):
    def __init__(self, zero, fn):
        super().__init__("FoldSink")
        self.zero = zero
        self.fn = fn

    def create_logic_and_mat(self):
        fut: Future = Future()
        state = {"acc": self.zero}
        fn = self.fn

        def on_elem(e):
            state["acc"] = fn(state["acc"], e)
        return _sink_logic(self, on_elem, fut,
                           result_fn=lambda: state["acc"]), fut


class ReduceSink(_SinkStage):
    def __init__(self, fn):
        super().__init__("ReduceSink")
        self.fn = fn

    def create_logic_and_mat(self):
        fut: Future = Future()
        state = {"acc": None, "has": False}
        fn = self.fn

        def on_elem(e):
            state["acc"] = e if not state["has"] else fn(state["acc"], e)
            state["has"] = True

        def empty_error():
            return None if state["has"] else \
                NoSuchElementException("reduce of empty stream")
        return _sink_logic(self, on_elem, fut,
                           result_fn=lambda: state["acc"],
                           empty_error=empty_error), fut


class HeadSink(_SinkStage):
    def __init__(self, require: bool):
        super().__init__("HeadSink")
        self.require = require

    def create_logic_and_mat(self):
        fut: Future = Future()
        stage = self
        logic = _PullAllLogic(self._shape, self.in_)
        in_ = self.in_

        def on_push():
            elem = logic.grab(in_)
            if not fut.done():
                fut.set_result(elem)
            logic.cancel(in_)

        def on_finish():
            if not fut.done():
                if stage.require:
                    fut.set_exception(NoSuchElementException("empty stream"))
                else:
                    fut.set_result(None)

        def on_failure(ex):
            if not fut.done():
                fut.set_exception(ex)
            logic.fail_stage(ex)
        logic.set_handler(in_, make_in_handler(on_push, on_finish, on_failure))
        return logic, fut


class LastSink(_SinkStage):
    def __init__(self, require: bool):
        super().__init__("LastSink")
        self.require = require

    def create_logic_and_mat(self):
        fut: Future = Future()
        state = {"last": None, "has": False}
        require = self.require

        def on_elem(e):
            state["last"], state["has"] = e, True

        def empty_err():
            return NoSuchElementException("empty stream") \
                if require and not state["has"] else None
        logic = _PullAllLogic(self._shape, self.in_)
        in_ = self.in_

        def on_push():
            on_elem(logic.grab(in_))
            logic.pull(in_)

        def on_finish():
            if not fut.done():
                if not state["has"] and require:
                    fut.set_exception(NoSuchElementException("empty stream"))
                else:
                    fut.set_result(state["last"])

        def on_failure(ex):
            if not fut.done():
                fut.set_exception(ex)
            logic.fail_stage(ex)
        logic.set_handler(in_, make_in_handler(on_push, on_finish, on_failure))
        return logic, fut


class OnCompleteSink(_SinkStage):
    def __init__(self, fn):
        super().__init__("OnCompleteSink")
        self.fn = fn

    def create_logic_and_mat(self):
        fn = self.fn
        logic = _PullAllLogic(self._shape, self.in_)
        in_ = self.in_

        def on_push():
            logic.grab(in_)
            logic.pull(in_)
        logic.set_handler(in_, make_in_handler(
            on_push,
            on_upstream_finish=lambda: (fn(None), logic.complete_stage()),
            on_upstream_failure=lambda ex: (fn(ex), logic.fail_stage(ex))))
        return logic, None


_QUEUE_END = object()


class SinkQueue:
    """Mat value of Sink.queue: pull() -> Future[elem | QUEUE_END];
    cancel() tears the upstream down (reference SinkQueueWithCancel)."""

    def __init__(self):
        self._cb = None
        self._cancel_cb = None
        self._lock = threading.Lock()
        self._early: List[Future] = []
        self._early_cancel = False
        self._terminal = None  # ("complete",) | ("fail", ex) once drained
        # every unresolved pull future: a pull dispatched into the stage's
        # interpreter just before it shuts down would otherwise be dropped
        # with the mailbox and never resolve — _set_terminal sweeps these
        self._outstanding: List[Future] = []

    def _bind(self, cb, cancel_cb=None):
        with self._lock:
            self._cb, self._cancel_cb = cb, cancel_cb
            early, self._early = self._early, []
            do_cancel = self._early_cancel
        for fut in early:
            self._cb.invoke(fut)
        if do_cancel and cancel_cb is not None:
            cancel_cb.invoke(None)

    def cancel(self) -> None:
        with self._lock:
            if self._terminal is not None:
                return
            cb = self._cancel_cb
            if cb is None:
                self._early_cancel = True
                return
        cb.invoke(None)

    def _set_terminal(self, done) -> None:
        with self._lock:
            self._terminal = done
            swept = [f for f in self._outstanding if not f.done()]
            self._outstanding = []
        for fut in swept:
            if fut.done():
                continue
            if done[0] == "complete":
                fut.set_result(_QUEUE_END)
            else:
                fut.set_exception(done[1])

    def pull(self) -> Future:
        fut: Future = Future()
        with self._lock:
            if self._terminal is not None:
                # stage may already be gone: answer from the cached terminal
                if self._terminal[0] == "complete":
                    fut.set_result(_QUEUE_END)
                else:
                    fut.set_exception(self._terminal[1])
                return fut
            # prune resolved futures so a long-lived consumer doesn't pin
            # one Future (and its element) per pull for the stream's life
            self._outstanding = [f for f in self._outstanding
                                 if not f.done()]
            self._outstanding.append(fut)
            if self._cb is None:
                self._early.append(fut)
                return fut
        self._cb.invoke(fut)
        return fut


class QueueSink(_SinkStage):
    def __init__(self, buffer_size: int):
        super().__init__("QueueSink")
        self.buffer_size = buffer_size

    def create_logic_and_mat(self):
        stage = self
        in_ = self.in_
        mat = SinkQueue()
        buf: collections.deque = collections.deque()
        waiters: collections.deque = collections.deque()
        state = {"done": None}  # None | ("complete",) | ("fail", ex)

        class _L(GraphStageLogic):
            def pre_start(self):
                # stay alive after upstream completes until the buffer is
                # pulled dry (reference: QueueSink setKeepGoing(true))
                self.set_keep_going(True)
                mat._bind(self.get_async_callback(self._on_pull_req),
                          self.get_async_callback(self._on_cancel_req))
                self.pull(in_)

            def _on_cancel_req(self, _):
                if state["done"] is None:
                    state["done"] = ("complete",)
                buf.clear()
                while waiters:
                    waiters.popleft().set_result(_QUEUE_END)
                if not self.is_closed(in_):
                    self.cancel(in_)
                self._finish_drained()

            def _on_pull_req(self, fut: Future):
                if fut.done():
                    return  # already swept by _set_terminal
                if buf:
                    fut.set_result(buf.popleft())
                    if not buf and state["done"] is not None:
                        self._finish_drained()
                    if not self.has_been_pulled(in_) and \
                            not self.is_closed(in_):
                        self.pull(in_)
                elif state["done"] is not None:
                    if state["done"][0] == "complete":
                        fut.set_result(_QUEUE_END)
                    else:
                        fut.set_exception(state["done"][1])
                    self._finish_drained()
                else:
                    waiters.append(fut)

            def _finish_drained(self):
                mat._set_terminal(state["done"])
                self.set_keep_going(False)
        logic = _L(self._shape)

        def on_push():
            elem = logic.grab(in_)
            if waiters:
                waiters.popleft().set_result(elem)
                logic.pull(in_)
            else:
                buf.append(elem)
                if len(buf) < stage.buffer_size:
                    logic.pull(in_)

        def on_finish():
            state["done"] = ("complete",)
            while waiters:
                waiters.popleft().set_result(_QUEUE_END)
            if not buf:
                logic._finish_drained()

        def on_failure(ex):
            state["done"] = ("fail", ex)
            while waiters:
                waiters.popleft().set_exception(ex)
            if not buf:
                logic._finish_drained()
        logic.set_handler(in_, make_in_handler(on_push, on_finish, on_failure))
        return logic, mat


class ActorRefSink(_SinkStage):
    def __init__(self, ref, on_complete_message, on_failure_message=None):
        super().__init__("ActorRefSink")
        self.ref = ref
        self.on_complete_message = on_complete_message
        self.on_failure_message = on_failure_message

    def create_logic_and_mat(self):
        stage = self
        in_ = self.in_
        logic = _PullAllLogic(self._shape, in_)

        def on_push():
            stage.ref.tell(logic.grab(in_), None)
            logic.pull(in_)

        def on_finish():
            stage.ref.tell(stage.on_complete_message, None)
            logic.complete_stage()

        def on_failure(ex):
            if stage.on_failure_message is not None:
                stage.ref.tell(stage.on_failure_message(ex), None)
            logic.fail_stage(ex)
        logic.set_handler(in_, make_in_handler(on_push, on_finish, on_failure))
        return logic, None
