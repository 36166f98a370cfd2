"""Behaviors factory DSL + typed supervision.

A copy of `akka_tpu/typed/behaviors.py` at commit 1001e26 (host code, no
jax; the port keeps its own copy of every module it needs).

Reference parity: akka-actor-typed/src/main/scala/akka/actor/typed/scaladsl/Behaviors.scala
and typed/internal/Supervision.scala (:60 AbstractSupervisor, :188 RestartSupervisor) —
restart / resume / stop / restart-with-backoff as behavior decorators.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Type

from .behavior import (SAME, STOPPED, UNHANDLED, EMPTY, IGNORE, Behavior,
                       BehaviorInterceptor, DeferredBehavior, InterceptedBehavior,
                       PreRestart, ReceiveBehavior, Signal, StoppedBehavior,
                       canonicalize, interpret_message, interpret_signal, start,
                       is_alive)


class Behaviors:
    same: Behavior = SAME
    unhandled: Behavior = UNHANDLED
    empty: Behavior = EMPTY
    ignore: Behavior = IGNORE

    @staticmethod
    def receive(on_message: Callable[[Any, Any], Behavior],
                on_signal: Optional[Callable[[Any, Signal], Behavior]] = None) -> Behavior:
        return ReceiveBehavior(on_message, on_signal)

    @staticmethod
    def receive_message(on_message: Callable[[Any], Behavior]) -> Behavior:
        return ReceiveBehavior(lambda _ctx, msg: on_message(msg))

    @staticmethod
    def receive_signal(on_signal: Callable[[Any, Signal], Behavior]) -> Behavior:
        return ReceiveBehavior(lambda _ctx, _msg: UNHANDLED, on_signal)

    @staticmethod
    def setup(factory: Callable[[Any], Behavior]) -> Behavior:
        return DeferredBehavior(factory)

    @staticmethod
    def stopped(post_stop: Optional[Callable[[], None]] = None) -> Behavior:
        return StoppedBehavior(post_stop) if post_stop else STOPPED

    @staticmethod
    def supervise(behavior: Behavior) -> "Supervise":
        return Supervise(behavior)

    @staticmethod
    def with_timers(factory: Callable[["TimerScheduler"], Behavior]) -> Behavior:
        def _setup(ctx):
            timers = TimerScheduler(ctx)
            # registered so the adapter / supervisor cancels them on
            # stop/restart (the reference cancels on PostStop/PreRestart)
            if not hasattr(ctx, "_timer_schedulers"):
                ctx._timer_schedulers = []
            ctx._timer_schedulers.append(timers)
            return factory(timers)
        return DeferredBehavior(_setup)

    @staticmethod
    def monitor(monitor_ref, behavior: Behavior) -> Behavior:
        """Forward every message to `monitor_ref` before processing
        (reference: Behaviors.monitor)."""

        class _Monitor(BehaviorInterceptor):
            def around_receive(self, ctx, msg, target):
                monitor_ref.tell(msg)
                return target(ctx, msg)

        return InterceptedBehavior(_Monitor(), behavior)

    @staticmethod
    def with_stash(capacity: int, factory: Callable[["StashBuffer"], Behavior]) -> Behavior:
        def _setup(ctx):
            return factory(StashBuffer(ctx, capacity))
        return DeferredBehavior(_setup)

    @staticmethod
    def intercept(interceptor_factory: Callable[[], BehaviorInterceptor],
                  behavior: Behavior) -> Behavior:
        return InterceptedBehavior(interceptor_factory(), behavior)


# -- typed supervision (reference: typed/internal/Supervision.scala) ---------


@dataclass(frozen=True)
class SupervisorStrategy:
    kind: str = "restart"           # restart | resume | stop | backoff
    max_restarts: int = -1
    within: float = float("inf")
    min_backoff: float = 0.2
    max_backoff: float = 30.0
    random_factor: float = 0.2
    stop_children: bool = True

    @staticmethod
    def restart(max_restarts: int = -1, within: float = float("inf")) -> "SupervisorStrategy":
        return SupervisorStrategy("restart", max_restarts, within)

    @staticmethod
    def resume() -> "SupervisorStrategy":
        return SupervisorStrategy("resume")

    @staticmethod
    def stop() -> "SupervisorStrategy":
        return SupervisorStrategy("stop")

    @staticmethod
    def restart_with_backoff(min_backoff: float, max_backoff: float,
                             random_factor: float = 0.2) -> "SupervisorStrategy":
        return SupervisorStrategy("backoff", min_backoff=min_backoff,
                                  max_backoff=max_backoff, random_factor=random_factor)


@dataclass(frozen=True)
class _ScheduledRestart:
    generation: int


class _Supervisor(BehaviorInterceptor):
    """(reference: typed/internal/Supervision.scala:60,188)"""

    def __init__(self, initial: Behavior, strategy: SupervisorStrategy,
                 exc_type: Type[BaseException] = Exception):
        self.initial = initial
        self.strategy = strategy
        self.exc_type = exc_type
        self._restarts: list[float] = []
        self._backoff_count = 0
        self._generation = 0

    def is_same(self, other: BehaviorInterceptor) -> bool:
        return isinstance(other, _Supervisor) and other.exc_type is self.exc_type

    def around_start(self, ctx, target):
        try:
            return target(ctx)
        except self.exc_type as e:
            return self._handle(ctx, e)

    def around_receive(self, ctx, msg, target):
        if isinstance(msg, _ScheduledRestart):
            if msg.generation == self._generation:
                return start(self.initial, ctx)
            return SAME
        try:
            return target(ctx, msg)
        except self.exc_type as e:
            return self._handle(ctx, e)

    def around_signal(self, ctx, signal, target):
        try:
            return target(ctx, signal)
        except self.exc_type as e:
            return self._handle(ctx, e)

    def _handle(self, ctx, exc: BaseException) -> Behavior:
        from .behavior import FailedBehavior
        s = self.strategy
        ctx.log.error(f"supervised behavior failed: {exc!r} -> {s.kind}", exc)
        if s.kind == "resume":
            return SAME
        if s.kind == "stop":
            return FailedBehavior(exc)
        if s.kind == "restart":
            now = time.monotonic()
            if s.within != float("inf"):
                self._restarts = [t for t in self._restarts if now - t < s.within]
            if s.max_restarts >= 0 and len(self._restarts) >= s.max_restarts:
                return FailedBehavior(exc)
            self._restarts.append(now)
            self._signal_restart(ctx)
            self._stop_children(ctx)
            return start(self.initial, ctx)
        if s.kind == "backoff":
            delay = min(s.min_backoff * (2 ** self._backoff_count), s.max_backoff)
            delay *= 1.0 + random.random() * s.random_factor
            self._backoff_count += 1
            self._generation += 1
            self._signal_restart(ctx)
            self._stop_children(ctx)
            gen = self._generation
            ctx.schedule_once(delay, ctx.self, _ScheduledRestart(gen))
            # while backing off, messages are dropped (the reference dead-letters)
            return Behaviors.ignore
        return FailedBehavior(exc)

    def _stop_children(self, ctx) -> None:
        if not self.strategy.stop_children:
            return
        cell = getattr(ctx, "_cell", None)
        for child in list(ctx.children):
            ctx.stop(child)
            # free the name immediately so a re-run setup can respawn it: the
            # old incarnation keeps terminating under a distinct uid (diverges
            # from the reference, which reserves the name until termination)
            if cell is not None:
                cell._children.pop(child.path.name, None)
                cell._child_stats.pop(child.path.name, None)

    def _signal_restart(self, ctx) -> None:
        """Deliver PreRestart to the NESTED behavior (not through this
        interceptor — a raising PreRestart handler must not recurse into
        _handle and burn the restart budget)."""
        try:
            cur = getattr(ctx, "_current_behavior", None)
            while isinstance(cur, InterceptedBehavior):
                if cur.interceptor is self:
                    cur = cur.nested
                    break
                cur = cur.nested
            if cur is not None and is_alive(cur):
                interpret_signal(cur, ctx, PreRestart)
        except Exception:  # noqa: BLE001
            pass
        # cancel this incarnation's timers (with_timers registers on the ctx)
        for ts in getattr(ctx, "_timer_schedulers", []):
            ts.cancel_all()


class Supervise:
    def __init__(self, behavior: Behavior):
        self.behavior = behavior

    def on_failure(self, strategy: SupervisorStrategy,
                   exc_type: Type[BaseException] = Exception) -> Behavior:
        # deferred so each spawned actor gets a FRESH supervisor instance —
        # the interceptor holds per-actor state (_restarts/_generation)
        behavior = self.behavior
        return DeferredBehavior(lambda _ctx: InterceptedBehavior(
            _Supervisor(behavior, strategy, exc_type), behavior))


# -- timers (reference: typed/scaladsl/TimerScheduler, TimerSchedulerImpl) ----


class TimerScheduler:
    def __init__(self, ctx):
        self._ctx = ctx
        self._timers: dict = {}

    def start_single_timer(self, key: Any, msg: Any, delay: float) -> None:
        self.cancel(key)
        task = self._ctx.schedule_once(delay, self._ctx.self, msg)
        self._timers[key] = task

    def start_timer_with_fixed_delay(self, key: Any, msg: Any, delay: float,
                                     initial_delay: Optional[float] = None) -> None:
        self.cancel(key)
        task = self._ctx.system.scheduler.schedule_tell_with_fixed_delay(
            initial_delay if initial_delay is not None else delay, delay,
            self._ctx.self, msg)
        self._timers[key] = task

    start_timer_at_fixed_rate = start_timer_with_fixed_delay

    def is_timer_active(self, key: Any) -> bool:
        t = self._timers.get(key)
        return t is not None and not t.is_cancelled

    def cancel(self, key: Any) -> None:
        t = self._timers.pop(key, None)
        if t is not None:
            t.cancel()

    def cancel_all(self) -> None:
        for t in self._timers.values():
            t.cancel()
        self._timers.clear()


# -- stash buffer (reference: typed/internal/StashBufferImpl.scala) ----------


class StashException(Exception):
    pass


class StashBuffer:
    def __init__(self, ctx, capacity: int):
        self._ctx = ctx
        self.capacity = capacity
        self._buf: list = []

    def stash(self, msg: Any) -> None:
        if len(self._buf) >= self.capacity:
            raise StashException(f"stash buffer full ({self.capacity})")
        self._buf.append(msg)

    @property
    def is_empty(self) -> bool:
        return not self._buf

    @property
    def is_full(self) -> bool:
        return len(self._buf) >= self.capacity

    @property
    def size(self) -> int:
        return len(self._buf)

    def unstash_all(self, behavior: Behavior) -> Behavior:
        """Process all stashed messages through `behavior` synchronously
        (reference: StashBufferImpl.unstashAll)."""
        b = start(behavior, self._ctx)
        msgs, self._buf = self._buf, []
        for i, m in enumerate(msgs):
            if not is_alive(b):
                # dead-letter the rest (mirrors classic Stash.post_stop)
                from ..actor.messages import DeadLetter
                dl = self._ctx.system.dead_letters
                for rest in msgs[i:]:
                    dl.tell(DeadLetter(rest, self._ctx.self, self._ctx.self), None)
                break
            nxt = interpret_message(b, self._ctx, m)
            b = canonicalize(nxt, b, self._ctx)
        return b

    def foreach(self, fn: Callable[[Any], None]) -> None:
        for m in self._buf:
            fn(m)
