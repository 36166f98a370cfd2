"""Supervision strategies: 'let it crash' fault handling.

A copy of `akka_tpu/actor/supervision.py` at commit 5d9b7cd (host code, no
jax; the port keeps its own copy of every module it needs).

Reference parity: akka-actor/src/main/scala/akka/actor/FaultHandling.scala —
SupervisorStrategy with directives Resume/Restart/Stop/Escalate, the default
decider, OneForOneStrategy / AllForOneStrategy with maxNrOfRetries inside
withinTimeRange, and StoppingSupervisorStrategy. Applied from the cell's
failure path (actor/dungeon/FaultHandling.scala via ActorCell.systemInvoke:511-519).
"""

from __future__ import annotations

import time
from enum import Enum
from typing import Any, Callable, Optional

from .messages import (ActorInitializationException, ActorKilledException,
                       DeathPactException)


class Directive(Enum):
    """Resume/Restart/Stop/Escalate (FaultHandling.scala). Shared with the
    batched device runtime: a BatchedBehavior's LaneSupervisor
    (batched/supervision.py) maps each Directive to a lane code and applies
    it as masked column ops inside the jitted step — same semantics,
    step-count time base instead of wall clock (docs/SUPERVISION.md)."""

    RESUME = "resume"
    RESTART = "restart"
    STOP = "stop"
    ESCALATE = "escalate"


Resume = Directive.RESUME
Restart = Directive.RESTART
Stop = Directive.STOP
Escalate = Directive.ESCALATE

Decider = Callable[[BaseException], Directive]


def default_decider(cause: BaseException) -> Directive:
    """Reference: SupervisorStrategy.defaultDecider — init/kill/deathpact stop,
    any other Exception restarts; Errors escalate."""
    if isinstance(cause, (ActorInitializationException, ActorKilledException, DeathPactException)):
        return Stop
    if isinstance(cause, Exception):
        return Restart
    return Escalate


def stopping_decider(cause: BaseException) -> Directive:
    return Stop if isinstance(cause, Exception) else Escalate


class ChildRestartStats:
    """Per-child restart-frequency window (reference: actor/FaultHandling.scala
    ChildRestartStats.requestRestartPermission)."""

    __slots__ = ("child", "max_retries", "within", "_restarts")

    def __init__(self, child):
        self.child = child
        self._restarts: list[float] = []

    def request_restart_permission(self, max_retries: int, within: float) -> bool:
        if max_retries == 0:
            return False
        now = time.monotonic()
        if within > 0:
            self._restarts = [t for t in self._restarts if now - t < within]
        if max_retries < 0 or len(self._restarts) < max_retries:
            self._restarts.append(now)
            return True
        return False


class SupervisorStrategy:
    def __init__(self, max_nr_of_retries: int = -1, within_time_range: float = float("inf"),
                 decider: Decider = default_decider, logging_enabled: bool = True):
        self.max_nr_of_retries = max_nr_of_retries
        self.within_time_range = within_time_range
        self.decider = decider
        self.logging_enabled = logging_enabled

    # -- template methods ---------------------------------------------------
    def handle_failure(self, cell, child, cause: BaseException, stats: ChildRestartStats,
                       all_stats: list) -> bool:
        """Returns False if the failure should escalate to our own supervisor
        (reference: SupervisorStrategy.handleFailure)."""
        directive = self.decider(cause)
        if directive is Resume:
            self.log_failure(cell, child, cause, directive)
            self.resume_child(child, cause)
            return True
        if directive is Restart:
            self.log_failure(cell, child, cause, directive)
            self.process_failure(cell, restart=True, child=child, cause=cause,
                                 stats=stats, all_stats=all_stats)
            return True
        if directive is Stop:
            self.log_failure(cell, child, cause, directive)
            self.process_failure(cell, restart=False, child=child, cause=cause,
                                 stats=stats, all_stats=all_stats)
            return True
        return False  # Escalate

    def process_failure(self, cell, restart: bool, child, cause, stats, all_stats) -> None:
        raise NotImplementedError

    def handle_child_terminated(self, cell, child, children) -> None:
        pass

    def resume_child(self, child, cause) -> None:
        child.resume(caused_by_failure=cause)

    def restart_child(self, child, cause, suspend_first: bool) -> None:
        if suspend_first:
            child.suspend()
        child.restart(cause)

    def log_failure(self, cell, child, cause, directive: Directive) -> None:
        if self.logging_enabled:
            from ..event.logging import Error, Warning as LogWarning
            if directive is Resume:
                cell.system.event_stream.publish(
                    LogWarning(str(child.path), type(cause).__name__, str(cause)))
            else:
                cell.system.event_stream.publish(
                    Error(str(child.path), type(cause).__name__,
                          f"{cause!r} -> {directive.value}", cause=cause))


class OneForOneStrategy(SupervisorStrategy):
    """Apply the directive to the failing child only."""

    def process_failure(self, cell, restart, child, cause, stats, all_stats) -> None:
        if restart and stats.request_restart_permission(self.max_nr_of_retries, self.within_time_range):
            self.restart_child(child, cause, suspend_first=False)
        else:
            child.stop()


class AllForOneStrategy(SupervisorStrategy):
    """Apply the directive to all children (reference: AllForOneStrategy)."""

    def process_failure(self, cell, restart, child, cause, stats, all_stats) -> None:
        if all_stats:
            if restart and all(s.request_restart_permission(self.max_nr_of_retries, self.within_time_range)
                               for s in all_stats):
                for s in all_stats:
                    self.restart_child(s.child, cause, suspend_first=(s.child != child))
            else:
                for s in all_stats:
                    s.child.stop()


def default_strategy() -> SupervisorStrategy:
    return OneForOneStrategy(decider=default_decider)


def stopping_strategy() -> SupervisorStrategy:
    return OneForOneStrategy(decider=stopping_decider)
