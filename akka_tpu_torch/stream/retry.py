"""RetryFlow: retry-with-backoff around a request/response flow.

A copy of `akka_tpu/stream/retry.py` at commit 43876c4 (host code, no
jax; the port keeps its own copy of every module it needs). The backoff's
jitter comes from a `random.Random` that each stage owns, seeded by
`seed=` (the reference draws from the module-level `random`).

Reference parity: akka-stream/src/main/scala/akka/stream/scaladsl/
RetryFlow.scala:12 (withBackoff / withBackoffAndContext) and impl/
RetryFlowCoordinator.scala: the wrapped flow is materialized ONCE and kept
running; at most ONE element is in flight at a time (the coordinator's
contract — it makes retry bookkeeping unambiguous); for every response the
user's `decide_retry(last_sent_in, out) -> Optional[new_in]` chooses
whether to re-inject a (possibly modified) element after an exponential
backoff or emit the response downstream. After `max_retries` re-injections
the latest response is emitted regardless. The inner flow must be 1:1
(one response per request); early completion/cancellation of the inner
flow while unfinished business remains fails the stage, as the reference
coordinator does.
"""

from __future__ import annotations

import random
from typing import Any, Callable, Optional

from .ops import _QUEUE_END
from .restart import _BridgeHandle, _BridgeSource
from .stage import (FlowShape, GraphStage, GraphStageLogic, Inlet, Outlet,
                    make_in_handler, make_out_handler)


class _RetryFlowStage(GraphStage):
    def __init__(self, min_backoff: float, max_backoff: float,
                 random_factor: float, max_retries: int, flow: Any,
                 decide_retry: Callable[[Any, Any], Optional[Any]],
                 seed: Optional[int] = None):
        self.name = "RetryFlow"
        self.rng = random.Random(seed)
        self.min_backoff = float(min_backoff)
        self.max_backoff = float(max_backoff)
        self.random_factor = float(random_factor)
        self.max_retries = int(max_retries)
        self.flow = flow
        self.decide_retry = decide_retry
        self.in_ = Inlet("RetryFlow.in")
        self.out = Outlet("RetryFlow.out")
        self._shape = FlowShape(self.in_, self.out)

    @property
    def shape(self):
        return self._shape

    def delay_for(self, retry_no: int) -> float:
        base = min(self.max_backoff,
                   self.min_backoff * (2.0 ** max(retry_no - 1, 0)))
        return base * (1.0 + self.rng.random() * self.random_factor)

    def create_logic(self):  # noqa: C901
        stage = self
        in_, out = self.in_, self.out
        NO_STASH = object()  # sentinel: None is a legal stream element
        # at most one element in progress: attempt_in is the input of the
        # in-flight attempt (what decide_retry sees as `in`), retries the
        # number of re-injections already performed for it
        st = {"handle": None, "queue": None, "demand": 0,
              "send_stash": NO_STASH, "attempt_in": None, "in_flight": False,
              "retries": 0, "pulling": False, "finishing": False,
              "stopped": False}

        class _L(GraphStageLogic):
            def pre_start(self):
                from .dsl import Keep, Sink, Source
                handle = _BridgeHandle(
                    self.get_async_callback(self._on_bridge), 1)
                st["handle"] = handle
                st["queue"] = Source.from_graph(
                    lambda: _BridgeSource(handle)).via(stage.flow) \
                    .to_mat(Sink.queue(), Keep.right).run(self.materializer)

            # ---- feeding the inner flow ----
            def _send(self, elem):
                st["attempt_in"] = elem
                st["in_flight"] = True
                if st["demand"] > 0:
                    st["demand"] -= 1
                    st["handle"].to_inner(("elem", elem))
                else:
                    st["send_stash"] = elem
                self._request()

            def _on_bridge(self, pair):
                _gen, ev = pair
                if st["stopped"]:
                    return
                if ev[0] == "demand":
                    st["demand"] += 1
                    if st["send_stash"] is not NO_STASH:
                        elem, st["send_stash"] = st["send_stash"], NO_STASH
                        st["demand"] -= 1
                        st["handle"].to_inner(("elem", elem))
                elif ev[0] == "cancel":
                    # the inner flow cancelled its input: the terminal
                    # outcome (failure with the real error, or a clean
                    # completion = contract violation) arrives on the
                    # queue side — make sure we are reading it
                    self._request()

            # ---- reading the inner flow's responses ----
            def _request(self):
                if st["pulling"] or st["queue"] is None:
                    return
                st["pulling"] = True
                cb = self.get_async_callback(self._on_response)
                st["queue"].pull().add_done_callback(cb.invoke)

            def _on_response(self, f):
                if st["stopped"]:
                    return
                st["pulling"] = False
                ex = f.exception()
                if ex is not None:
                    st["stopped"] = True
                    self.fail_stage(ex)
                    return
                item = f.result()
                if item is _QUEUE_END:
                    if st["in_flight"]:
                        self._illegal("inner flow completed with an "
                                      "element in flight")
                    elif st["finishing"]:
                        st["stopped"] = True
                        self.complete_stage()
                    else:
                        self._illegal("inner flow completed while upstream "
                                      "is still running")
                    return
                if not st["in_flight"]:
                    self._illegal("inner flow emitted without a request")
                    return
                retry_with = None
                try:
                    retry_with = stage.decide_retry(st["attempt_in"], item)
                except Exception as e:  # noqa: BLE001 — user decision fn
                    st["stopped"] = True
                    self.fail_stage(e)
                    return
                if retry_with is None or st["retries"] >= stage.max_retries:
                    st["in_flight"] = False
                    st["attempt_in"] = None
                    st["retries"] = 0
                    self.push(out, item)
                    if st["finishing"]:
                        st["handle"].to_inner(("complete",))
                        self._request()  # drain to _QUEUE_END -> complete
                    return
                st["retries"] += 1
                st["retry_with"] = retry_with
                self.schedule_once("retry", stage.delay_for(st["retries"]))

            def on_timer(self, key):
                if st["stopped"] or key != "retry":
                    return
                self._send(st.pop("retry_with"))

            def _illegal(self, what: str):
                st["stopped"] = True
                self.fail_stage(RuntimeError(
                    f"RetryFlow inner flow violated its contract: {what}"))

            def post_stop(self):
                q = st["queue"]
                if q is not None:
                    q.cancel()

        logic = _L(self._shape)

        def on_push():
            logic._send(logic.grab(in_))

        def on_finish():
            st["finishing"] = True
            if not st["in_flight"] and st["handle"] is not None:
                st["handle"].to_inner(("complete",))
                logic._request()

        def on_failure(ex):
            st["stopped"] = True
            h = st["handle"]
            if h is not None:
                h.to_inner(("fail", ex))
            logic.fail_stage(ex)

        def on_pull():
            if not st["in_flight"] and not logic.has_been_pulled(in_) and \
                    not logic.is_closed(in_):
                logic.pull(in_)

        def on_cancel(cause=None):
            st["stopped"] = True
            q = st["queue"]
            if q is not None:
                q.cancel()
            logic.complete_stage()
        logic.set_handler(in_, make_in_handler(on_push, on_finish, on_failure))
        logic.set_handler(out, make_out_handler(on_pull, on_cancel))
        return logic


class RetryFlow:
    """(reference: scaladsl/RetryFlow.scala:12)"""

    @staticmethod
    def with_backoff(min_backoff: float, max_backoff: float,
                     random_factor: float, max_retries: int, flow: Any,
                     decide_retry: Callable[[Any, Any], Optional[Any]],
                     seed: Optional[int] = None):
        """Flow[In, Out] wrapping `flow`; `decide_retry(in, out)` returns
        None to emit `out`, or a new `in` to re-inject after backoff.
        `seed` seeds each materialization's jitter."""
        from .dsl import Flow
        return Flow.from_graph(lambda: _RetryFlowStage(
            min_backoff, max_backoff, random_factor, max_retries, flow,
            decide_retry, seed))

    @staticmethod
    def with_backoff_and_context(min_backoff: float, max_backoff: float,
                                 random_factor: float, max_retries: int,
                                 flow_with_context: Any,
                                 decide_retry: Callable[[Any, Any],
                                                        Optional[Any]],
                                 seed: Optional[int] = None):
        """FlowWithContext variant: the inner flow and decide_retry see
        (data, ctx) pairs (reference: RetryFlow.withBackoffAndContext)."""
        from .context import FlowWithContext
        inner = flow_with_context.as_flow() \
            if isinstance(flow_with_context, FlowWithContext) \
            else flow_with_context
        return FlowWithContext.from_tuples(RetryFlow.with_backoff(
            min_backoff, max_backoff, random_factor, max_retries, inner,
            decide_retry, seed))
