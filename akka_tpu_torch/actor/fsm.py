"""FSM DSL for classic actors.

A copy of `akka_tpu/actor/fsm.py` at commit 5d9b7cd (host code, no jax; the
port keeps its own copy of every module it needs).

Reference parity: akka-actor/src/main/scala/akka/actor/FSM.scala (:375) —
startWith/when (:310-315), goto/stay/using, onTransition, whenUnhandled,
state timeouts, named timers, stop with reason.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from .actor import Actor


@dataclass(frozen=True)
class Event:
    event: Any
    state_data: Any


class StateTimeout:
    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "StateTimeout"


STATE_TIMEOUT = StateTimeout()


@dataclass(frozen=True)
class CurrentState:
    fsm_ref: Any
    state: Any


@dataclass(frozen=True)
class Transition:
    fsm_ref: Any
    from_state: Any
    to_state: Any


class SubscribeTransitionCallBack:
    def __init__(self, ref):
        self.ref = ref


class _State:
    __slots__ = ("state_name", "state_data", "timeout", "stop_reason", "replies")

    def __init__(self, state_name, state_data, timeout=None, stop_reason=None,
                 replies=None):
        self.state_name = state_name
        self.state_data = state_data
        self.timeout = timeout
        self.stop_reason = stop_reason
        self.replies = replies or []

    def using(self, data) -> "_State":
        return _State(self.state_name, data, self.timeout, self.stop_reason,
                      list(self.replies))

    def for_max(self, timeout: float) -> "_State":
        return _State(self.state_name, self.state_data, timeout,
                      self.stop_reason, list(self.replies))

    def replying(self, msg) -> "_State":
        s = _State(self.state_name, self.state_data, self.timeout,
                   self.stop_reason, list(self.replies))
        s.replies.append(msg)
        return s


class FSM(Actor):
    """Subclass, then in __init__ call when(...) for each state and
    start_with(initial, data)."""

    def __init__(self):
        super().__init__()
        self._handlers: Dict[Any, Callable[[Event], _State]] = {}
        self._unhandled_handler: Optional[Callable[[Event], _State]] = None
        self._transition_handlers: List[Callable[[Any, Any], None]] = []
        self._transition_subscribers: List[Any] = []
        self._timers: Dict[str, Any] = {}
        self._state_timeout_task = None
        self.current_state: Optional[_State] = None
        self._state_timeouts: Dict[Any, Optional[float]] = {}

    # -- DSL -----------------------------------------------------------------
    def when(self, state_name: Any, handler: Callable[[Event], _State],
             state_timeout: Optional[float] = None) -> None:
        self._handlers[state_name] = handler
        self._state_timeouts[state_name] = state_timeout

    def when_unhandled(self, handler: Callable[[Event], _State]) -> None:
        self._unhandled_handler = handler

    def on_transition(self, handler: Callable[[Any, Any], None]) -> None:
        self._transition_handlers.append(handler)

    def start_with(self, state_name: Any, state_data: Any,
                   timeout: Optional[float] = None) -> None:
        self.current_state = _State(state_name, state_data,
                                    timeout or self._state_timeouts.get(state_name))

    def goto(self, state_name: Any) -> _State:
        return _State(state_name, self.current_state.state_data,
                      self._state_timeouts.get(state_name))

    def stay(self) -> _State:
        return _State(self.current_state.state_name, self.current_state.state_data)

    def stop(self, reason: Any = "normal") -> _State:
        s = self.stay()
        s.stop_reason = reason
        return s

    @property
    def state_name(self) -> Any:
        return self.current_state.state_name

    @property
    def state_data(self) -> Any:
        return self.current_state.state_data

    # -- timers (reference: FSM setTimer/cancelTimer) ------------------------
    def set_timer(self, name: str, msg: Any, delay: float, repeat: bool = False) -> None:
        self.cancel_timer(name)
        sched = self.context.system.scheduler
        if repeat:
            task = sched.schedule_tell_with_fixed_delay(delay, delay, self.self_ref,
                                                        msg, self.self_ref)
        else:
            task = sched.schedule_tell_once(delay, self.self_ref, msg, self.self_ref)
        self._timers[name] = task

    def cancel_timer(self, name: str) -> None:
        t = self._timers.pop(name, None)
        if t is not None:
            t.cancel()

    def is_timer_active(self, name: str) -> bool:
        t = self._timers.get(name)
        return t is not None and not t.is_cancelled

    # -- engine --------------------------------------------------------------
    def initialize(self) -> None:
        self._arm_state_timeout()

    def receive(self, message: Any):
        if isinstance(message, SubscribeTransitionCallBack):
            self._transition_subscribers.append(message.ref)
            message.ref.tell(CurrentState(self.self_ref, self.state_name), self.self_ref)
            return None
        handler = self._handlers.get(self.state_name)
        if handler is None:
            return NotImplemented
        event = Event(message, self.current_state.state_data)
        next_state = handler(event)
        if next_state is None and self._unhandled_handler is not None:
            next_state = self._unhandled_handler(event)
        if next_state is None:
            return NotImplemented
        self._apply_state(next_state)
        return None

    def _apply_state(self, next_state: _State) -> None:
        for reply in next_state.replies:
            self.sender.tell(reply, self.self_ref)
        if next_state.stop_reason is not None:
            self._cancel_state_timeout()
            self.on_termination(next_state.stop_reason)
            self.context.stop()
            return
        prev = self.current_state.state_name
        self.current_state = next_state
        if next_state.state_name != prev:
            for h in self._transition_handlers:
                h(prev, next_state.state_name)
            for sub in self._transition_subscribers:
                sub.tell(Transition(self.self_ref, prev, next_state.state_name),
                         self.self_ref)
        self._arm_state_timeout()

    def _arm_state_timeout(self) -> None:
        self._cancel_state_timeout()
        timeout = (self.current_state.timeout
                   if self.current_state.timeout is not None
                   else self._state_timeouts.get(self.state_name))
        if timeout:
            self._state_timeout_task = self.context.system.scheduler.schedule_tell_once(
                timeout, self.self_ref, STATE_TIMEOUT, self.self_ref)

    def _cancel_state_timeout(self) -> None:
        if self._state_timeout_task is not None:
            self._state_timeout_task.cancel()
            self._state_timeout_task = None

    def on_termination(self, reason: Any) -> None:
        pass

    def post_stop(self) -> None:
        self._cancel_state_timeout()
        for t in self._timers.values():
            t.cancel()
        self._timers.clear()
        super().post_stop()
