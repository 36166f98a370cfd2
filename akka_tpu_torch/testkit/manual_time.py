"""ManualTime: install the virtual-time scheduler into a live system.

A copy of `akka_tpu/testkit/manual_time.py` at commit 5834bbc (host
code, no jax; the port keeps its own copy of every module it needs).

Reference parity: akka-actor-testkit-typed ManualTime / akka-testkit
ExplicitlyTriggeredScheduler.scala — the scheduler itself lives in
akka_tpu_torch.actor.scheduler.ExplicitlyTriggeredScheduler; this helper
swaps it into a freshly created ActorSystem (the reference does it via
config).
"""

from __future__ import annotations

from ..actor.scheduler import ExplicitlyTriggeredScheduler

ManualTimeScheduler = ExplicitlyTriggeredScheduler


def install_manual_time(system) -> ExplicitlyTriggeredScheduler:
    """Replace a live system's scheduler with virtual time. Call right after
    ActorSystem.create, before any actor schedules a timer."""
    old = system.scheduler
    manual = ExplicitlyTriggeredScheduler()
    system.scheduler = manual
    old.shutdown()
    return manual
