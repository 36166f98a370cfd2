"""Hashed-wheel timer scheduler.

A copy of `akka_tpu/actor/scheduler.py` at commit 5d9b7cd (host code, no
jax; the port keeps its own copy of every module it needs).

Reference parity: akka-actor/src/main/scala/akka/actor/LightArrayRevolverScheduler.scala
(:40) — a wheel of `ticks-per-wheel` buckets revolved every `tick-duration`
(:47-51); `schedule` (:102) quantizes timers to ticks. Timers drive receive
timeouts, ask timeouts, cluster ticks and user schedules.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Optional


class Cancellable:
    __slots__ = ("_cancelled", "_lock")

    def __init__(self) -> None:
        self._cancelled = False
        self._lock = threading.Lock()

    def cancel(self) -> bool:
        with self._lock:
            if self._cancelled:
                return False
            self._cancelled = True
            return True

    @property
    def is_cancelled(self) -> bool:
        return self._cancelled


class _TimerTask(Cancellable):
    __slots__ = ("fn", "rounds", "repeat_delay", "fixed_rate", "period_start")

    def __init__(self, fn: Callable[[], None], rounds: int,
                 repeat_delay: float = 0.0, fixed_rate: bool = False):
        super().__init__()
        self.fn = fn
        self.rounds = rounds
        self.repeat_delay = repeat_delay
        self.fixed_rate = fixed_rate


class Scheduler:
    """Wheel-based scheduler on a daemon thread."""

    def __init__(self, tick_duration: float = 0.01, ticks_per_wheel: int = 512,
                 name: str = "akka-tpu-scheduler"):
        self.tick_duration = max(tick_duration, 0.001)
        self.wheel_size = self._next_pow2(ticks_per_wheel)
        self._wheel: list[list[_TimerTask]] = [[] for _ in range(self.wheel_size)]
        self._lock = threading.Lock()
        self._tick = 0
        self._stopped = threading.Event()
        self._start_time = time.monotonic()
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._thread.start()

    @staticmethod
    def _next_pow2(n: int) -> int:
        p = 1
        while p < n:
            p <<= 1
        return p

    # -- public API ---------------------------------------------------------
    def schedule_once(self, delay: float, fn: Callable[[], None]) -> Cancellable:
        return self._schedule(delay, fn, repeat_delay=0.0)

    def schedule_with_fixed_delay(self, initial_delay: float, delay: float,
                                  fn: Callable[[], None]) -> Cancellable:
        return self._schedule(initial_delay, fn, repeat_delay=delay, fixed_rate=False)

    def schedule_at_fixed_rate(self, initial_delay: float, interval: float,
                               fn: Callable[[], None]) -> Cancellable:
        return self._schedule(initial_delay, fn, repeat_delay=interval, fixed_rate=True)

    def schedule_tell_once(self, delay: float, receiver, message: Any, sender=None) -> Cancellable:
        return self.schedule_once(delay, lambda: receiver.tell(message, sender))

    def schedule_tell_with_fixed_delay(self, initial_delay: float, delay: float,
                                       receiver, message: Any, sender=None) -> Cancellable:
        return self.schedule_with_fixed_delay(
            initial_delay, delay, lambda: receiver.tell(message, sender))

    # -- internals ----------------------------------------------------------
    def _schedule(self, delay: float, fn, repeat_delay: float, fixed_rate: bool = False) -> Cancellable:
        if self._stopped.is_set():
            raise RuntimeError("scheduler has been shut down")
        delay = max(delay, 0.0)
        task = _TimerTask(fn, 0, repeat_delay, fixed_rate)
        self._place(task, delay)
        return task

    def _place(self, task: _TimerTask, delay: float) -> None:
        ticks = max(int(delay / self.tick_duration + 0.999999), 1)
        with self._lock:
            slot = (self._tick + ticks) & (self.wheel_size - 1)
            # the slot is first reached after ((ticks-1) % wheel)+1 ticks, so a
            # delay of exactly one wheel period needs 0 extra revolutions
            task.rounds = (ticks - 1) // self.wheel_size
            self._wheel[slot].append(task)

    def _run(self) -> None:
        next_deadline = time.monotonic() + self.tick_duration
        while not self._stopped.is_set():
            now = time.monotonic()
            sleep = next_deadline - now
            if sleep > 0:
                self._stopped.wait(sleep)
                if self._stopped.is_set():
                    break
            next_deadline += self.tick_duration
            self._advance()

    def _advance(self) -> None:
        with self._lock:
            self._tick = (self._tick + 1) & (self.wheel_size - 1)
            bucket = self._wheel[self._tick]
            due, remaining = [], []
            for task in bucket:
                if task.is_cancelled:
                    continue
                if task.rounds > 0:
                    task.rounds -= 1
                    remaining.append(task)
                else:
                    due.append(task)
            self._wheel[self._tick] = remaining
        for task in due:
            try:
                task.fn()
            except Exception:  # noqa: BLE001 — scheduler must keep ticking
                pass
            if task.repeat_delay > 0 and not task.is_cancelled:
                self._place(task, task.repeat_delay)

    def shutdown(self) -> None:
        self._stopped.set()


class ExplicitlyTriggeredScheduler(Scheduler):
    """Virtual-time scheduler for tests — advances only via time_passes()
    (reference: akka-testkit ExplicitlyTriggeredScheduler.scala; typed
    ManualTime)."""

    def __init__(self, tick_duration: float = 0.01, ticks_per_wheel: int = 512):
        self._entries: list[tuple[float, _TimerTask]] = []
        self._now = 0.0
        self._elock = threading.Lock()
        self.tick_duration = tick_duration
        self._stopped = threading.Event()

    def _schedule(self, delay: float, fn, repeat_delay: float, fixed_rate: bool = False) -> Cancellable:
        task = _TimerTask(fn, 0, repeat_delay, fixed_rate)
        with self._elock:
            self._entries.append((self._now + max(delay, 0.0), task))
        return task

    def time_passes(self, amount: float) -> None:
        target = self._now + amount
        while True:
            with self._elock:
                due = sorted((t, task) for t, task in self._entries
                             if t <= target and not task.is_cancelled)
                if not due:
                    self._now = target
                    self._entries = [(t, task) for t, task in self._entries
                                     if not task.is_cancelled]
                    return
                t, task = due[0]
                self._entries.remove((t, task))
                self._now = max(self._now, t)
            try:
                task.fn()
            except Exception:  # noqa: BLE001
                pass
            if task.repeat_delay > 0 and not task.is_cancelled:
                with self._elock:
                    self._entries.append((self._now + task.repeat_delay, task))

    @property
    def current_time(self) -> float:
        return self._now

    def shutdown(self) -> None:
        self._stopped.set()
