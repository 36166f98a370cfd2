"""BackoffSupervisor + retry + gracefulStop.

A copy of `akka_tpu/pattern/backoff.py` at commit 1001e26 (host code, no
jax; the port keeps its own copy of every module it needs).

Reference parity: akka-actor/src/main/scala/akka/pattern/BackoffSupervisor.scala
(exponential backoff respawn of a child on failure or stop),
pattern/RetrySupport.scala (retry), AskSupport.gracefulStop.
"""

from __future__ import annotations

import random
import threading
from concurrent.futures import Future
from typing import Any, Callable, Optional

from ..actor.actor import Actor
from ..actor.messages import PoisonPill, Terminated
from ..actor.props import Props
from ..actor.ref import ActorRef
from ..actor.supervision import OneForOneStrategy, Stop, default_decider


def backoff_delay(restart_count: int, min_backoff: float, max_backoff: float,
                  random_factor: float = 0.0) -> float:
    """Exponential backoff delay (BackoffSupervisor.scala calculateDelay):
    min_backoff * 2^restart_count capped at max_backoff, plus optional
    random jitter. Shared by BackoffSupervisor and the batched runtime's
    checkpoint-failure pacing (random_factor=0 there: deterministic)."""
    delay = min(min_backoff * (2 ** restart_count), max_backoff)
    if random_factor:
        delay *= 1.0 + random.random() * random_factor
    return delay


class GetCurrentChild:
    pass


class CurrentChild:
    def __init__(self, ref: Optional[ActorRef]):
        self.ref = ref


class GetRestartCount:
    pass


class RestartCount:
    def __init__(self, count: int):
        self.count = count


class _StartChild:
    pass


class BackoffSupervisor(Actor):
    """Spawns `child_props` as a child; when the child stops (on-stop mode) or
    fails (on-failure mode via supervision Stop), re-spawns it after an
    exponentially growing delay."""

    def __init__(self, child_props: Props, child_name: str, min_backoff: float,
                 max_backoff: float, random_factor: float = 0.2,
                 mode: str = "on-stop"):
        super().__init__()
        self.child_props = child_props
        self.child_name = child_name
        self.min_backoff = min_backoff
        self.max_backoff = max_backoff
        self.random_factor = random_factor
        self.mode = mode
        self.child: Optional[ActorRef] = None
        self.restart_count = 0
        self._forward_buffer: list = []

    @staticmethod
    def props(child_props: Props, child_name: str, min_backoff: float,
              max_backoff: float, random_factor: float = 0.2,
              mode: str = "on-stop") -> Props:
        return Props.create(BackoffSupervisor, child_props, child_name,
                            min_backoff, max_backoff, random_factor, mode)

    @property
    def supervisor_strategy(self):
        # child failures become stops, which trigger the backoff respawn
        return OneForOneStrategy(decider=lambda e: Stop if isinstance(e, Exception)
                                 else default_decider(e))

    def pre_start(self) -> None:
        self._start_child()

    def _start_child(self) -> None:
        self.child = self.context.actor_of(self.child_props, self.child_name)
        self.context.watch(self.child)
        for msg, sender in self._forward_buffer:
            self.child.tell(msg, sender)
        self._forward_buffer.clear()

    def receive(self, message: Any):
        if isinstance(message, Terminated) and self.child is not None \
                and message.actor == self.child:
            self.child = None
            delay = backoff_delay(self.restart_count, self.min_backoff,
                                  self.max_backoff, self.random_factor)
            self.restart_count += 1
            self.context.system.scheduler.schedule_tell_once(
                delay, self.self_ref, _StartChild(), self.self_ref)
        elif isinstance(message, _StartChild):
            self._start_child()
        elif isinstance(message, GetCurrentChild):
            self.sender.tell(CurrentChild(self.child), self.self_ref)
        elif isinstance(message, GetRestartCount):
            self.sender.tell(RestartCount(self.restart_count), self.self_ref)
        else:
            if self.child is not None:
                self.child.forward(message, self.context)
            else:
                self._forward_buffer.append((message, self.sender))
        return None


def retry(attempt: Callable[[], Future], attempts: int, delay: float,
          scheduler, backoff: float = 1.0) -> Future:
    """Retry an async op with (optionally growing) delay between attempts
    (reference: pattern/RetrySupport.scala)."""
    out: Future = Future()

    def try_once(remaining: int, current_delay: float):
        try:
            fut = attempt()
        except Exception as e:  # noqa: BLE001
            _handle_failure(e, remaining, current_delay)
            return

        def _done(f: Future):
            exc = f.exception()
            if exc is None:
                if not out.done():
                    out.set_result(f.result())
            else:
                _handle_failure(exc, remaining, current_delay)

        fut.add_done_callback(_done)

    def _handle_failure(exc, remaining, current_delay):
        if remaining <= 1:
            if not out.done():
                out.set_exception(exc)
        else:
            scheduler.schedule_once(
                current_delay,
                lambda: try_once(remaining - 1, current_delay * backoff))

    try_once(attempts, delay)
    return out


def graceful_stop(target: ActorRef, timeout: float, system,
                  stop_message: Any = PoisonPill) -> Future:
    """Stop an actor and complete when its termination is observed
    (reference: pattern/GracefulStopSupport.scala)."""
    fut: Future = Future()

    def handler(msg, sender):
        if isinstance(msg, Terminated) and not fut.done():
            fut.set_result(True)

    probe = system.provider.create_function_ref(handler)
    probe.watch(target)
    target.tell(stop_message, probe)

    def _timeout():
        if not fut.done():
            fut.set_exception(TimeoutError(
                f"{target} did not terminate within {timeout}s"))
        system.provider.stop_function_ref(probe)

    system.scheduler.schedule_once(timeout, _timeout)
    return fut
