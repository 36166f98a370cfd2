"""RestartSource / RestartFlow / RestartSink: self-healing stream sections.

A copy of `akka_tpu/stream/restart.py` at commit 05a11d4 (host code, no
jax; the port keeps its own copy of every module it needs).

Reference parity: akka-stream/src/main/scala/akka/stream/scaladsl/
RestartSource.scala:20 (withBackoff / onFailuresWithBackoff), RestartFlow
.scala, RestartSink.scala and impl RestartWithBackoffLogic: the wrapped
blueprint is MATERIALIZED ANEW after failure (and, for withBackoff, after
completion), with exponential backoff between attempts; elements in flight
when the inner stream dies are lost (the reference documents the wrap as
at-most-once across restarts); the restart counter resets once the stream
has run longer than `max_restarts_within`.

Implementation: the outer stage sub-materializes the factory's blueprint on
the SAME materializer (exactly how flatMapConcat runs its inner sources)
and bridges elements/demand through async callbacks:
- RestartSource: inner runs `factory().to(Sink.queue())`; the outer pulls
  one element per downstream demand; a failed pull future triggers backoff.
- RestartSink:   inner runs `_BridgeSource().to(factory())`; the bridge
  signals per-element demand back to the outer, so backpressure crosses
  the restart boundary without a lossy buffer.
- RestartFlow:   both bridges around `factory()`.

Backoff timers ride the stream's TimerGraphStageLogic support, so Restart
stages need an actor-hosted materializer (the default).
"""

from __future__ import annotations

import random
import time
from typing import Any, Callable, Optional

from .ops import _QUEUE_END, _SinkStage, _SourceStage
from .stage import (FlowShape, GraphStage, GraphStageLogic, Inlet, Outlet,
                    make_in_handler, make_out_handler)


class RestartSettings:
    """(reference: akka.stream.RestartSettings)"""

    def __init__(self, min_backoff: float = 1.0, max_backoff: float = 30.0,
                 random_factor: float = 0.2, max_restarts: int = -1,
                 max_restarts_within: Optional[float] = None):
        self.min_backoff = float(min_backoff)
        self.max_backoff = float(max_backoff)
        self.random_factor = float(random_factor)
        self.max_restarts = int(max_restarts)
        # the reference defaults the counting window to min_backoff
        self.max_restarts_within = (float(max_restarts_within)
                                    if max_restarts_within is not None
                                    else self.min_backoff)

    def delay_for(self, restart_count: int) -> float:
        base = min(self.max_backoff,
                   self.min_backoff * (2.0 ** max(restart_count - 1, 0)))
        return base * (1.0 + random.random() * self.random_factor)


class _BackoffState:
    """Shared restart bookkeeping (RestartWithBackoffLogic counter/deadline)."""

    def __init__(self, settings: RestartSettings):
        self.settings = settings
        self.count = 0
        self.window_start: Optional[float] = None

    def next_delay(self) -> Optional[float]:
        """None = budget exhausted (propagate the failure)."""
        now = time.monotonic()
        if self.window_start is None or \
                now - self.window_start > self.settings.max_restarts_within:
            self.window_start = now
            self.count = 0
        self.count += 1
        if 0 <= self.settings.max_restarts < self.count:
            return None
        return self.settings.delay_for(self.count)


class _BridgeHandle:
    """Outer-side handle to an inner _BridgeSource: send elements/completion
    in; receive demand/cancel out (both directions through interpreter
    async callbacks, so each side runs in its own island actor safely)."""

    def __init__(self, outer_cb, gen: int):
        self._outer_cb = outer_cb      # AsyncCallback on the OUTER logic
        self.gen = gen
        self._inner_cb = None
        self._pending = []
        import threading
        self._lock = threading.Lock()

    # inner side
    def _bind(self, inner_cb) -> None:
        with self._lock:
            self._inner_cb = inner_cb
            pending, self._pending = self._pending, []
        for ev in pending:
            inner_cb.invoke(ev)

    def to_outer(self, ev) -> None:
        self._outer_cb.invoke((self.gen, ev))

    # outer side
    def to_inner(self, ev) -> None:
        with self._lock:
            if self._inner_cb is None:
                self._pending.append(ev)
                return
        self._inner_cb.invoke(ev)


class _BridgeSource(_SourceStage):
    """Head of an inner materialization: pulls become ("demand") events to
    the outer stage, elements/completion/failure arrive as events."""

    def __init__(self, handle: _BridgeHandle):
        super().__init__("RestartBridgeSource")
        self.handle = handle

    def create_logic(self):
        out, handle = self.out, self.handle
        logic = GraphStageLogic(self._shape)

        def on_ev(ev):
            kind = ev[0]
            if kind == "elem":
                logic.push(out, ev[1])
            elif kind == "complete":
                logic.complete(out)
            elif kind == "fail":
                logic.fail(out, ev[1])

        def on_pull():
            handle.to_outer(("demand",))

        def on_cancel(cause=None):
            handle.to_outer(("cancel",))

        orig_pre = logic.pre_start

        def pre_start():
            orig_pre()
            handle._bind(logic.get_async_callback(on_ev))
        logic.pre_start = pre_start
        logic.set_handler(out, make_out_handler(on_pull, on_cancel))
        return logic


class _RestartWithBackoffSource(_SourceStage):
    """RestartSource.withBackoff / onFailuresWithBackoff (RestartSource
    .scala:20). Inner = factory().to(Sink.queue()); one outstanding pull."""

    def __init__(self, factory: Callable[[], Any], settings: RestartSettings,
                 only_on_failures: bool):
        super().__init__("RestartWithBackoffSource")
        self.factory = factory
        self.settings = settings
        self.only_on_failures = only_on_failures

    def create_logic(self):
        stage = self
        out = self.out
        st = {"queue": None, "gen": 0, "pulling": False, "want": False,
              "stopped": False}
        backoff = _BackoffState(self.settings)

        class _L(GraphStageLogic):
            def pre_start(self):
                self._start_inner()

            def _start_inner(self):
                from .dsl import Keep, Sink
                st["gen"] += 1
                st["queue"] = stage.factory().to_mat(
                    Sink.queue(), Keep.right).run(self.materializer)
                if st["want"] and not st["pulling"]:
                    self._request()

            def _request(self):
                st["pulling"] = True
                gen = st["gen"]
                cb = self.get_async_callback(self._on_inner)
                st["queue"].pull().add_done_callback(
                    lambda f: cb.invoke((gen, f)))

            def _on_inner(self, pair):
                gen, f = pair
                if gen != st["gen"] or st["stopped"]:
                    return  # stale run
                st["pulling"] = False
                ex = f.exception()
                if ex is not None:
                    self._terminated(ex)
                    return
                item = f.result()
                if item is _QUEUE_END:
                    if stage.only_on_failures:
                        st["stopped"] = True
                        self.complete(out)
                    else:
                        self._terminated(None)
                    return
                st["want"] = False
                self.push(out, item)

            def _terminated(self, ex):
                st["queue"] = None
                delay = backoff.next_delay()
                if delay is None:  # restart budget exhausted: propagate
                    st["stopped"] = True
                    if ex is not None:
                        self.fail(out, ex)
                    else:
                        self.complete(out)
                    return
                self.schedule_once("restart", delay)

            def on_timer(self, key):
                if key == "restart" and not st["stopped"]:
                    self._start_inner()

            def post_stop(self):
                q = st["queue"]
                if q is not None:
                    q.cancel()

        logic = _L(self._shape)

        def on_pull():
            st["want"] = True
            if st["queue"] is not None and not st["pulling"]:
                logic._request()

        def on_cancel(cause=None):
            st["stopped"] = True
            q = st["queue"]
            if q is not None:
                q.cancel()
            logic.complete(out)
        logic.set_handler(out, make_out_handler(on_pull, on_cancel))
        return logic


class _RestartWithBackoffSink(_SinkStage):
    """RestartSink.withBackoff (RestartSink.scala): inner =
    _BridgeSource().to(factory()); inner cancellation (a sink failing
    cancels its upstream) triggers a backoff restart. The element in
    flight at the instant of failure may be lost (reference contract);
    an element waiting for demand is retained across restarts."""

    def __init__(self, factory: Callable[[], Any],
                 settings: RestartSettings):
        super().__init__("RestartWithBackoffSink")
        self.factory = factory
        self.settings = settings

    def create_logic(self):
        stage = self
        in_ = self.in_
        st = {"handle": None, "gen": 0, "demand": 0, "stash": None,
              "stopped": False, "finishing": False}
        backoff = _BackoffState(self.settings)

        class _L(GraphStageLogic):
            def pre_start(self):
                self.set_keep_going(True)  # survive upstream completion
                self._start_inner()

            def _start_inner(self):
                from .dsl import Keep, Sink, Source
                st["gen"] += 1
                st["demand"] = 0
                handle = _BridgeHandle(
                    self.get_async_callback(self._on_inner), st["gen"])
                st["handle"] = handle
                Source.from_graph(lambda: _BridgeSource(handle)).to_mat(
                    stage.factory(), Keep.none).run(self.materializer)

            def _on_inner(self, pair):
                gen, ev = pair
                if gen != st["gen"] or st["stopped"]:
                    return
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
                    # inner sink failed/cancelled: restart with backoff
                    st["handle"] = None
                    delay = backoff.next_delay()
                    if delay is None:
                        st["stopped"] = True
                        self.set_keep_going(False)
                        self.complete_stage()
                        return
                    self.schedule_once("restart", delay)

            def _finish_inner(self):
                st["handle"].to_inner(("complete",))
                st["stopped"] = True
                self.set_keep_going(False)
                self.complete_stage()

            def on_timer(self, key):
                if key == "restart" and not st["stopped"]:
                    self._start_inner()

            def post_stop(self):
                h = st["handle"]
                if h is not None and not st["stopped"]:
                    h.to_inner(("complete",))

        logic = _L(self._shape)

        def on_push():
            elem = logic.grab(in_)
            if st["handle"] is not None and st["demand"] > 0:
                st["demand"] -= 1
                st["handle"].to_inner(("elem", elem))
            else:
                st["stash"] = elem  # retained across the restart
            if st["demand"] > 0 and not logic.is_closed(in_):
                logic.pull(in_)

        def on_finish():
            if st["stash"] is None and st["handle"] is not None:
                logic._finish_inner()
            else:
                st["finishing"] = True  # flush the stash first

        def on_failure(ex):
            h = st["handle"]
            st["stopped"] = True
            if h is not None:
                h.to_inner(("fail", ex))
            logic.set_keep_going(False)
            logic.fail_stage(ex)
        logic.set_handler(in_, make_in_handler(on_push, on_finish, on_failure))
        return logic


class _RestartWithBackoffFlow(GraphStage):
    """RestartFlow.withBackoff / onFailuresWithBackoff (RestartFlow.scala):
    inner = _BridgeSource().via(factory()).to(Sink.queue()); failure on
    EITHER side (flow failing downstream, or flow cancelling upstream)
    triggers the same backoff restart."""

    def __init__(self, factory: Callable[[], Any], settings: RestartSettings,
                 only_on_failures: bool):
        self.name = "RestartWithBackoffFlow"
        self.factory = factory
        self.settings = settings
        self.only_on_failures = only_on_failures
        self.in_ = Inlet("RestartFlow.in")
        self.out = Outlet("RestartFlow.out")
        self._shape = FlowShape(self.in_, self.out)

    @property
    def shape(self):
        return self._shape

    def create_logic(self):
        stage = self
        in_, out = self.in_, self.out
        st = {"handle": None, "queue": None, "gen": 0, "demand": 0,
              "stash": None, "pulling": False, "want": False,
              "stopped": False, "finishing": False, "restarting": False}
        backoff = _BackoffState(self.settings)

        class _L(GraphStageLogic):
            def pre_start(self):
                self._start_inner()

            def _start_inner(self):
                from .dsl import Keep, Sink, Source
                st["gen"] += 1
                st["demand"] = 0
                st["pulling"] = False
                st["restarting"] = False
                handle = _BridgeHandle(
                    self.get_async_callback(self._on_demand), st["gen"])
                st["handle"] = handle
                st["queue"] = Source.from_graph(
                    lambda: _BridgeSource(handle)).via(stage.factory()) \
                    .to_mat(Sink.queue(), Keep.right).run(self.materializer)
                if st["finishing"] and st["stash"] is None:
                    handle.to_inner(("complete",))
                if st["want"]:
                    self._request()

            # ---- upstream side (elements INTO the inner flow) ----
            def _on_demand(self, pair):
                gen, ev = pair
                if gen != st["gen"] or st["stopped"]:
                    return
                if ev[0] == "demand":
                    st["demand"] += 1
                    if st["stash"] is not None:
                        elem, st["stash"] = st["stash"], None
                        st["demand"] -= 1
                        st["handle"].to_inner(("elem", elem))
                        if st["finishing"]:
                            st["handle"].to_inner(("complete",))
                    elif st["finishing"]:
                        pass  # already sent complete at start_inner
                    elif not self.has_been_pulled(in_) and \
                            not self.is_closed(in_):
                        self.pull(in_)
                elif ev[0] == "cancel":
                    # the inner flow cancelled its upstream without failing
                    # downstream (e.g. a take()): treat like termination
                    self._maybe_restart(None)

            # ---- downstream side (elements OUT of the inner flow) ----
            def _request(self):
                if st["pulling"] or st["queue"] is None:
                    return
                st["pulling"] = True
                gen = st["gen"]
                cb = self.get_async_callback(self._on_out)
                st["queue"].pull().add_done_callback(
                    lambda f: cb.invoke((gen, f)))

            def _on_out(self, pair):
                gen, f = pair
                if gen != st["gen"] or st["stopped"]:
                    return
                st["pulling"] = False
                ex = f.exception()
                if ex is not None:
                    self._maybe_restart(ex)
                    return
                item = f.result()
                if item is _QUEUE_END:
                    if st["finishing"]:
                        # inner flow drained after upstream completion:
                        # the wrap is done
                        st["stopped"] = True
                        self.complete(out)
                    elif stage.only_on_failures:
                        st["stopped"] = True
                        self.complete_stage()
                    else:
                        self._maybe_restart(None)
                    return
                st["want"] = False
                self.push(out, item)

            def _maybe_restart(self, ex):
                # the inner death surfaces on BOTH sides (queue pull future
                # failure AND the bridge's cancel event): restart once
                if st["stopped"] or st["restarting"]:
                    return
                st["restarting"] = True
                st["queue"] = None
                st["handle"] = None
                delay = backoff.next_delay()
                if delay is None:
                    st["stopped"] = True
                    if ex is not None:
                        self.fail_stage(ex)
                    else:
                        self.complete_stage()
                    return
                self.schedule_once("restart", delay)

            def on_timer(self, key):
                if key == "restart" and not st["stopped"]:
                    self._start_inner()

            def post_stop(self):
                q = st["queue"]
                if q is not None:
                    q.cancel()
                h = st["handle"]
                if h is not None and not st["stopped"]:
                    h.to_inner(("complete",))

        logic = _L(self._shape)

        def on_push():
            elem = logic.grab(in_)
            if st["handle"] is not None and st["demand"] > 0:
                st["demand"] -= 1
                st["handle"].to_inner(("elem", elem))
            else:
                st["stash"] = elem
            if st["demand"] > 0 and not logic.is_closed(in_):
                logic.pull(in_)

        def on_finish():
            st["finishing"] = True
            if st["stash"] is None and st["handle"] is not None:
                st["handle"].to_inner(("complete",))
            # keep the stage alive: the inner flow may still emit

        def on_failure(ex):
            st["stopped"] = True
            h = st["handle"]
            if h is not None:
                h.to_inner(("fail", ex))
            logic.fail_stage(ex)

        def on_pull():
            st["want"] = True
            logic._request()

        def on_cancel(cause=None):
            st["stopped"] = True
            q = st["queue"]
            if q is not None:
                q.cancel()
            logic.complete_stage()
        logic.set_handler(in_, make_in_handler(on_push, on_finish, on_failure))
        logic.set_handler(out, make_out_handler(on_pull, on_cancel))
        return logic


class RestartSource:
    """(reference: scaladsl/RestartSource.scala:20)"""

    @staticmethod
    def with_backoff(settings: RestartSettings,
                     factory: Callable[[], Any]):
        """Restart the source on failure AND completion, backing off
        exponentially. factory: () -> Source."""
        from .dsl import Source
        return Source.from_graph(
            lambda: _RestartWithBackoffSource(factory, settings,
                                              only_on_failures=False))

    @staticmethod
    def on_failures_with_backoff(settings: RestartSettings,
                                 factory: Callable[[], Any]):
        """Restart only on failure; completion completes the wrap."""
        from .dsl import Source
        return Source.from_graph(
            lambda: _RestartWithBackoffSource(factory, settings,
                                              only_on_failures=True))


class RestartFlow:
    """(reference: scaladsl/RestartFlow.scala)"""

    @staticmethod
    def with_backoff(settings: RestartSettings, factory: Callable[[], Any]):
        from .dsl import Flow
        return Flow.from_graph(
            lambda: _RestartWithBackoffFlow(factory, settings,
                                            only_on_failures=False))

    @staticmethod
    def on_failures_with_backoff(settings: RestartSettings,
                                 factory: Callable[[], Any]):
        from .dsl import Flow
        return Flow.from_graph(
            lambda: _RestartWithBackoffFlow(factory, settings,
                                            only_on_failures=True))


class RestartSink:
    """(reference: scaladsl/RestartSink.scala)"""

    @staticmethod
    def with_backoff(settings: RestartSettings, factory: Callable[[], Any]):
        from .dsl import Sink
        return Sink.from_graph(
            lambda: _RestartWithBackoffSink(factory, settings))
