"""GraphInterpreter: the push/pull execution engine + its host actor.

A copy of `akka_tpu/stream/interpreter.py` at commit 05a11d4 (host code, no
jax; the port keeps its own copy of every module it needs).

Reference parity: akka-stream/src/main/scala/akka/stream/impl/fusing/
GraphInterpreter.scala — per-connection port-state machine (state docs
:154-198), bounded `execute(eventLimit)` event loop (:348), `processEvent`
dispatch to onPush/onPull/onUpstreamFinish/onDownstreamFinish (:485);
ActorGraphInterpreter.scala — the interpreter runs inside one actor per
fused island, external/async events arrive as actor messages.

Connection states here: "idle" → pull() → "pulled" → push() → "pushed" →
grab()+next pull → "idle"; closed flags per side with completion/failure/
cancellation propagation events. Failures tear the stream down along the
graph exactly like the reference (fail downstream, cancel upstream).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..actor.actor import Actor
from .stage import GraphStageLogic, Inlet, Outlet

# consecutive supervised on_pull failures on one connection before the
# resume/restart directive is escalated to a stage failure. The bound is a
# last-resort guard against a HOT livelock (a source whose on_pull throws
# deterministically forever under a resuming decider); it is set far above
# any plausible run of legitimately skipped bad records, and retries are
# rescheduled through the host actor mailbox (not the in-loop queue) so
# even a long run of failures stays fair to async events and cancellation
MAX_PULL_RETRIES = 10_000


class Connection:
    __slots__ = ("id", "out_logic", "outlet", "in_logic", "inlet", "state",
                 "element", "out_closed", "in_closed", "failure",
                 "pending_complete", "pending_fail", "pull_retries")

    def __init__(self, cid: int, out_logic: GraphStageLogic, outlet: Outlet,
                 in_logic: GraphStageLogic, inlet: Inlet):
        self.id = cid
        self.out_logic = out_logic
        self.outlet = outlet
        self.in_logic = in_logic
        self.inlet = inlet
        self.state = "idle"         # idle | pulled | pushed | grabbed
        self.element: Any = None
        self.out_closed = False
        self.in_closed = False
        self.failure: Optional[BaseException] = None
        self.pending_complete = False  # complete after in-flight push lands
        self.pending_fail: Optional[BaseException] = None
        self.pull_retries = 0  # consecutive supervised on_pull failures


@dataclass(frozen=True)
class _AsyncEvent:
    logic: Any
    handler: Callable[[Any], None]
    event: Any


@dataclass(frozen=True)
class _TimerEvent:
    logic: Any
    key: Any
    gen: int


class GraphInterpreter:
    """One per materialized (fused) graph."""

    def __init__(self, logics: List[GraphStageLogic],
                 connections: List[Connection], materializer=None,
                 on_shutdown: Optional[Callable[[], None]] = None):
        self.logics = logics
        self.connections = connections
        self.materializer = materializer
        self.on_shutdown = on_shutdown
        self.queue: List[Tuple[str, Connection]] = []
        self.by_inlet: Dict[int, Connection] = {}
        self.by_outlet: Dict[int, Connection] = {}
        self._running = False
        self._shutdown = False
        self._timer_gen: Dict[Tuple[int, Any], int] = {}
        self._timer_tasks: Dict[Tuple[int, Any], Any] = {}
        self._scheduler = None  # set by host (actor) for timers
        self._self_ref = None   # host actor ref for async events
        for c in connections:
            self.by_inlet[c.inlet.id] = c
            self.by_outlet[c.outlet.id] = c
        for lg in logics:
            lg.interpreter = self

    # -- startup --------------------------------------------------------------
    def init(self) -> None:
        for lg in self.logics:
            lg.pre_start()
        self.execute()

    # -- port ops (called from logics) ---------------------------------------
    def pull(self, logic: GraphStageLogic, inlet: Inlet) -> None:
        """tryPull semantics: a pull while already pulled, or while a push
        event is still in flight, is a no-op (the reference's strict pull
        throws there and operators call tryPull; ours only ever means try)."""
        c = self.by_inlet[inlet.id]
        if c.in_closed or (c.out_closed and c.state != "pushed"):
            return
        if c.state in ("pulled", "pushed"):
            return
        c.state = "pulled"
        c.element = None
        self.queue.append(("pull", c))

    def push(self, logic: GraphStageLogic, outlet: Outlet, elem: Any) -> None:
        c = self.by_outlet[outlet.id]
        if c.in_closed:
            return  # downstream cancelled: drop
        if c.out_closed:
            raise IllegalStateException(f"cannot push closed port {outlet}")
        if c.state != "pulled":
            raise IllegalStateException(
                f"cannot push port {outlet} that was not pulled "
                f"(state {c.state})")
        c.state = "pushed"
        c.element = elem
        self.queue.append(("push", c))

    def grab(self, logic: GraphStageLogic, inlet: Inlet) -> Any:
        c = self.by_inlet[inlet.id]
        if c.state != "pushed":
            raise IllegalStateException(
                f"cannot grab port {inlet} in state {c.state}")
        elem, c.element = c.element, None
        c.state = "grabbed"
        return elem

    def is_available(self, logic: GraphStageLogic, port) -> bool:
        if isinstance(port, Inlet):
            c = self.by_inlet.get(port.id)
            return c is not None and c.state == "pushed"
        c = self.by_outlet.get(port.id)
        return c is not None and c.state == "pulled" and not c.out_closed

    def has_been_pulled(self, logic: GraphStageLogic, inlet: Inlet) -> bool:
        c = self.by_inlet[inlet.id]
        return c.state == "pulled"

    def is_port_closed(self, logic: GraphStageLogic, port) -> bool:
        if isinstance(port, Inlet):
            c = self.by_inlet.get(port.id)
            return c is None or c.in_closed
        c = self.by_outlet.get(port.id)
        return c is None or c.out_closed

    def complete(self, logic: GraphStageLogic, outlet: Outlet) -> None:
        c = self.by_outlet[outlet.id]
        if c.out_closed:
            return
        if c.state == "pushed":
            # let the in-flight element land first (reference: Pushing|InClosed)
            c.pending_complete = True
            c.out_closed = True
            return
        c.out_closed = True
        self.queue.append(("complete", c))

    def fail(self, logic: GraphStageLogic, outlet: Outlet,
             ex: BaseException) -> None:
        c = self.by_outlet[outlet.id]
        if c.out_closed:
            return
        c.out_closed = True
        c.failure = ex
        self.queue.append(("fail", c))

    def cancel(self, logic: GraphStageLogic, inlet: Inlet,
               cause: Optional[BaseException] = None) -> None:
        c = self.by_inlet[inlet.id]
        if c.in_closed:
            return
        c.in_closed = True
        c.element = None
        self.queue.append(("cancel", c))

    # -- async/timers ---------------------------------------------------------
    def enqueue_async(self, logic, handler, event) -> None:
        """May be called from ANY thread: routes through the host actor's
        mailbox when hosted, else runs inline (unhosted/synchronous mode)."""
        if self._self_ref is not None:
            self._self_ref.tell(_AsyncEvent(logic, handler, event), None)
        else:
            self._dispatch_async(_AsyncEvent(logic, handler, event))

    def _dispatch_async(self, ev: _AsyncEvent) -> None:
        if self._shutdown:
            return
        try:
            ev.handler(ev.event)
        except Exception as e:  # noqa: BLE001
            ev.logic.fail_stage(e)
        self.execute()
        # a handler may have dropped the last keep-going flag with no new
        # events queued — re-check shutdown
        if not self.queue and not self._shutdown and self._all_closed():
            self._do_shutdown()

    def schedule_timer(self, logic, key, delay: float,
                       repeat: Optional[float]) -> None:
        if self._scheduler is None or self._self_ref is None:
            raise RuntimeError("timers need an actor-hosted stream")
        tk = (id(logic), key)
        gen = self._timer_gen.get(tk, 0) + 1
        self._timer_gen[tk] = gen
        old = self._timer_tasks.pop(tk, None)
        if old is not None:
            old.cancel()
        ev = _TimerEvent(logic, key, gen)
        if repeat is None:
            task = self._scheduler.schedule_tell_once(delay, self._self_ref, ev)
        else:
            task = self._scheduler.schedule_tell_with_fixed_delay(
                delay, repeat, self._self_ref, ev)
        self._timer_tasks[tk] = task

    def cancel_timer(self, logic, key) -> None:
        tk = (id(logic), key)
        self._timer_gen[tk] = self._timer_gen.get(tk, 0) + 1
        task = self._timer_tasks.pop(tk, None)
        if task is not None:
            task.cancel()

    def _dispatch_timer(self, ev: _TimerEvent) -> None:
        if self._shutdown:
            return
        if self._timer_gen.get((id(ev.logic), ev.key), 0) != ev.gen:
            return  # cancelled/superseded
        try:
            ev.logic.on_timer(ev.key)
        except Exception as e:  # noqa: BLE001
            ev.logic.fail_stage(e)
        self.execute()

    # -- the event loop (reference: execute :348 / processEvent :485) --------
    def execute(self, event_limit: int = 1_000_000) -> None:
        if self._running:
            return  # re-entrant calls drain via the outer loop
        self._running = True
        try:
            n = 0
            while self.queue and n < event_limit:
                kind, c = self.queue.pop(0)
                self._process(kind, c)
                n += 1
        finally:
            self._running = False
        if not self.queue and not self._shutdown and self._all_closed():
            self._do_shutdown()

    def _process(self, kind: str, c: Connection) -> None:  # noqa: C901
        try:
            if kind == "pull":
                if c.out_closed or c.state != "pulled":
                    return
                if c.out_logic._drain_emit(c.outlet):
                    return
                c.out_logic.out_handler(c.outlet).on_pull()
                c.pull_retries = 0
            elif kind == "push":
                if c.in_closed:
                    c.state = "idle"
                    c.element = None
                    return
                c.in_logic.in_handler(c.inlet).on_push()
                # element never grabbed + port now idle is fine: next pull
                # resets state
                if c.state == "grabbed":
                    c.state = "idle"
                if c.pending_complete and not c.in_closed:
                    c.pending_complete = False
                    self.queue.append(("complete", c))
            elif kind == "complete":
                if c.in_closed:
                    return
                if c.state == "pushed":
                    # element still in flight: retry after it lands
                    c.pending_complete = True
                    return
                c.in_closed = True
                c.in_logic.in_handler(c.inlet).on_upstream_finish()
            elif kind == "fail":
                if c.in_closed:
                    return
                c.in_closed = True
                c.in_logic.in_handler(c.inlet).on_upstream_failure(c.failure)
            elif kind == "cancel":
                if c.out_closed:
                    return
                c.out_closed = True
                c.out_logic.out_handler(c.outlet).on_downstream_finish(None)
        except Exception as e:  # noqa: BLE001 — operator threw
            # consult the stage's supervision decider (Attributes
            # supervisionStrategy; Supervision.scala). Element-processing
            # events (push = user fn on an element; pull = source producing
            # one) may resume/restart; lifecycle events always stop.
            failing = c.in_logic if kind in ("push", "complete", "fail") \
                else c.out_logic
            if kind in ("push", "pull") and self._supervise(kind, c, failing, e):
                return
            failing.fail_stage(e)

    def _supervise(self, kind: str, c: Connection, failing, ex) -> bool:
        """Apply the failing stage's supervision decider. Returns True if
        the failure was absorbed (element dropped, stream kept running)."""
        from .attributes import Supervision, effective_decider_of
        try:
            directive = effective_decider_of(failing)(ex)
        except Exception:  # noqa: BLE001 — a throwing decider means stop
            return False
        if directive not in (Supervision.resume, Supervision.restart):
            return False
        if directive == Supervision.restart and \
                failing.restart_state is not None:
            try:
                failing.restart_state()
            except Exception:  # noqa: BLE001 — reset failed: tear down
                return False
        if kind == "push":
            # drop the element; restore the port and the demand so the
            # stream keeps flowing (reference Ops.scala collectors pull
            # after a supervised drop)
            if c.state in ("pushed", "grabbed"):
                c.state = "idle"
                c.element = None
            if c.pending_complete and not c.in_closed:
                # the dropped element was the last one and upstream already
                # completed behind it: deliver the deferred completion (the
                # happy-path re-queue in _process was skipped by the throw)
                c.pending_complete = False
                self.queue.append(("complete", c))
            elif not c.in_closed and not c.out_closed:
                self.pull(failing, c.inlet)
            return True
        # pull: producing the element failed; leave the port pulled and
        # retry (unfoldResource-with-resume semantics: read() is retried).
        # Bounded + mailbox-rescheduled: a source whose on_pull throws
        # deterministically forever under a resuming decider would
        # otherwise spin the event loop hot (the reference cannot reach
        # this state; it does not supervise source pulls, so any bound is
        # stricter than parity requires)
        c.pull_retries += 1
        if c.pull_retries >= MAX_PULL_RETRIES:
            return False

        def requeue(_):
            if c.state == "pulled" and not c.out_closed:
                self.queue.append(("pull", c))
        if self._self_ref is not None:
            # hosted: bounce through the mailbox so async events, timers
            # and cancellations interleave with the retry storm
            self.enqueue_async(failing, requeue, None)
        elif c.state == "pulled" and not c.out_closed:
            self.queue.append(("pull", c))
        return True

    def _all_closed(self) -> bool:
        if any(lg._keep_going for lg in self.logics):
            return False  # setKeepGoing: stage alive past port closure
        return all(c.in_closed and c.out_closed for c in self.connections) \
            if self.connections else True

    def _do_shutdown(self) -> None:
        self._shutdown = True
        for task in self._timer_tasks.values():
            task.cancel()
        self._timer_tasks.clear()
        for lg in self.logics:
            try:
                lg.post_stop()
            except Exception:  # noqa: BLE001
                pass
        if self.on_shutdown is not None:
            self.on_shutdown()

    @property
    def is_completed(self) -> bool:
        return self._shutdown


class IllegalStateException(RuntimeError):
    pass


class ActorGraphInterpreter(Actor):
    """Hosts one interpreter inside an actor: async callbacks, timers, and
    external inputs arrive through the mailbox (reference:
    impl/fusing/ActorGraphInterpreter.scala)."""

    def __init__(self, interpreter: GraphInterpreter):
        super().__init__()
        self.interpreter = interpreter
        interpreter._scheduler = self.context.system.scheduler
        interpreter._self_ref = self.context.self_ref

    def pre_start(self) -> None:
        self.interpreter.init()
        self._maybe_stop()

    def receive(self, message: Any) -> Any:
        if isinstance(message, _AsyncEvent):
            self.interpreter._dispatch_async(message)
        elif isinstance(message, _TimerEvent):
            self.interpreter._dispatch_timer(message)
        else:
            return NotImplemented
        self._maybe_stop()

    def _maybe_stop(self) -> None:
        if self.interpreter.is_completed:
            self.context.stop(self.self_ref)
