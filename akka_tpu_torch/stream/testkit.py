"""Stream testkit: manually driven sources and asserting sinks.

A copy of `akka_tpu/stream/testkit.py` at commit 05a11d4 (host code, no
jax; the port keeps its own copy of every module it needs).

Reference parity: akka-stream-testkit/src/main/scala/akka/stream/testkit/
scaladsl/TestSource.scala & TestSink.scala and StreamTestKit.scala probes —
TestPublisher.Probe (sendNext/sendComplete/sendError, expectRequest) and
TestSubscriber.Probe (request/expectNext/expectComplete/expectError/
expectNoMessage).
"""

from __future__ import annotations

import collections
import queue as _queue
import threading
from typing import Any, List, Optional

from .stage import (GraphStage, GraphStageLogic, Inlet, Outlet, SinkShape,
                    SourceShape, make_in_handler, make_out_handler)


class AssertionFailure(AssertionError):
    pass


class SourceProbe:
    """Mat value of TestSource.probe: drive the stream by hand."""

    def __init__(self):
        self._cb = None
        self._lock = threading.Lock()
        self._early: List = []
        self._demand = 0
        self._demand_cv = threading.Condition()
        self._cancelled = threading.Event()

    def _bind(self, cb):
        with self._lock:
            self._cb = cb
            early, self._early = self._early, []
        for item in early:
            cb.invoke(item)

    def _send(self, item):
        with self._lock:
            if self._cb is None:
                self._early.append(item)
                return
        self._cb.invoke(item)

    def send_next(self, elem) -> "SourceProbe":
        self._send(("next", elem))
        return self

    def send_complete(self) -> "SourceProbe":
        self._send(("complete", None))
        return self

    def send_error(self, ex: BaseException) -> "SourceProbe":
        self._send(("error", ex))
        return self

    # -- driven by the stage --------------------------------------------------
    def _on_pull(self):
        with self._demand_cv:
            self._demand += 1
            self._demand_cv.notify_all()

    def _on_cancel(self):
        self._cancelled.set()
        with self._demand_cv:
            self._demand_cv.notify_all()

    def expect_request(self, timeout: float = 3.0) -> int:
        with self._demand_cv:
            if self._demand == 0:
                self._demand_cv.wait(timeout)
            if self._demand == 0:
                raise AssertionFailure("no demand within timeout")
            d, self._demand = self._demand, 0
            return d

    def expect_cancellation(self, timeout: float = 3.0) -> None:
        if not self._cancelled.wait(timeout):
            raise AssertionFailure("no cancellation within timeout")


class _TestSourceStage(GraphStage):
    def __init__(self):
        self.name = "TestSource"
        self.out = Outlet("TestSource.out")
        self._shape = SourceShape(self.out)

    @property
    def shape(self):
        return self._shape

    def create_logic_and_mat(self):
        out = self.out
        probe = SourceProbe()
        buf: collections.deque = collections.deque()
        state = {"done": None}

        class _L(GraphStageLogic):
            def pre_start(self):
                probe._bind(self.get_async_callback(self._on_cmd))

            def _on_cmd(self, item):
                kind, payload = item
                if kind == "next":
                    if self.is_available(out) and not buf:
                        self.push(out, payload)
                    else:
                        buf.append(payload)
                elif kind == "complete":
                    state["done"] = ("complete", None)
                    if not buf:
                        self.complete(out)
                else:
                    self.fail(out, payload)
        logic = _L(self._shape)

        def on_pull():
            if buf:
                logic.push(out, buf.popleft())
                if state["done"] and not buf:
                    logic.complete(out)
            else:
                probe._on_pull()
                if state["done"]:
                    logic.complete(out)

        def on_cancel(cause=None):
            probe._on_cancel()
            logic.cancel_stage(cause)
        logic.set_handler(out, make_out_handler(on_pull, on_cancel))
        return logic, probe


class SinkProbe:
    """Mat value of TestSink.probe: assert on received elements."""

    def __init__(self):
        self._cb = None
        self._lock = threading.Lock()
        self._early: List[int] = []
        self._events: _queue.Queue = _queue.Queue()

    def _bind(self, cb):
        with self._lock:
            self._cb = cb
            early, self._early = self._early, []
        for n in early:
            cb.invoke(n)

    def request(self, n: int) -> "SinkProbe":
        with self._lock:
            if self._cb is None:
                self._early.append(n)
                return self
        self._cb.invoke(n)
        return self

    # -- events from the stage ------------------------------------------------
    def _event(self, ev) -> None:
        self._events.put(ev)

    def _next_event(self, timeout: float):
        try:
            return self._events.get(timeout=timeout)
        except _queue.Empty:
            raise AssertionFailure(
                f"no stream event within {timeout}s") from None

    def expect_next(self, expected: Any = None, timeout: float = 3.0) -> Any:
        ev = self._next_event(timeout)
        if ev[0] != "next":
            raise AssertionFailure(f"expected element, got {ev}")
        if expected is not None and ev[1] != expected:
            raise AssertionFailure(f"expected {expected!r}, got {ev[1]!r}")
        return ev[1]

    def request_next(self, expected: Any = None, timeout: float = 3.0) -> Any:
        self.request(1)
        return self.expect_next(expected, timeout)

    def expect_next_n(self, elems, timeout: float = 3.0) -> "SinkProbe":
        for e in elems:
            self.expect_next(e, timeout)
        return self

    def expect_complete(self, timeout: float = 3.0) -> "SinkProbe":
        ev = self._next_event(timeout)
        if ev[0] != "complete":
            raise AssertionFailure(f"expected completion, got {ev}")
        return self

    def expect_error(self, timeout: float = 3.0) -> BaseException:
        ev = self._next_event(timeout)
        if ev[0] != "error":
            raise AssertionFailure(f"expected error, got {ev}")
        return ev[1]

    def expect_subscription_and_complete(self, timeout: float = 3.0
                                         ) -> "SinkProbe":
        return self.expect_complete(timeout)

    def expect_no_message(self, timeout: float = 0.2) -> "SinkProbe":
        try:
            ev = self._events.get(timeout=timeout)
        except _queue.Empty:
            return self
        raise AssertionFailure(f"expected silence, got {ev}")

    def cancel(self) -> "SinkProbe":
        with self._lock:
            cb = self._cb
        if cb is not None:
            cb.invoke("cancel")
        return self


_MISSING = object()


class _TestSinkStage(GraphStage):
    def __init__(self):
        self.name = "TestSink"
        self.in_ = Inlet("TestSink.in")
        self._shape = SinkShape(self.in_)

    @property
    def shape(self):
        return self._shape

    def create_logic_and_mat(self):
        in_ = self.in_
        probe = SinkProbe()
        state = {"demand": 0}

        class _L(GraphStageLogic):
            def pre_start(self):
                probe._bind(self.get_async_callback(self._on_request))

            def _on_request(self, n):
                if n == "cancel":
                    self.cancel(in_)
                    return
                state["demand"] += n
                if not self.has_been_pulled(in_) and not self.is_closed(in_) \
                        and state["demand"] > 0:
                    self.pull(in_)
        logic = _L(self._shape)

        def on_push():
            elem = logic.grab(in_)
            state["demand"] -= 1
            probe._event(("next", elem))
            if state["demand"] > 0:
                logic.pull(in_)

        def on_finish():
            probe._event(("complete", None))
            logic.complete_stage()

        def on_failure(ex):
            probe._event(("error", ex))
            logic.fail_stage(ex)
        logic.set_handler(in_, make_in_handler(on_push, on_finish, on_failure))
        return logic, probe


class TestSource:
    @staticmethod
    def probe():
        from .dsl import Source
        return Source.from_graph(_TestSourceStage)


class TestSink:
    @staticmethod
    def probe():
        from .dsl import Sink
        return Sink.from_graph(_TestSinkStage)
