"""Elastic mesh autoscaler: widen under mailbox pressure, narrow when quiet.

Port of `akka_tpu/batched/autoscale.py` (commit 94ce108). A host-side
control plane over the signals the runtime already exports:

  AutoscalePolicy   a pure hysteresis decision function (no torch, no
                    devices): widen after `widen_after` consecutive
                    pressured polls, narrow after `narrow_after`
                    consecutive quiet polls, with a post-re-shard cooldown.
                    Pressure = any of event/pressure.py's vocabulary above
                    its threshold: `mailbox_overflow` / `exchange_dropped`
                    growth deltas, `ask_pool_occupancy`, and the metric
                    slab's `mailbox_occupancy_p90` when compiled in.

  MeshAutoscaler    binds a policy to a MeshSentinel and a pool of shard
                    slots (parallel/mesh.py): polls one PressureReader
                    (the class gateway admission sheds with), clamps the
                    policy's width to a feasible one (divides capacity,
                    fits the pool) and executes it through
                    sentinel.scale_to. Every decision lands in the flight
                    recorder's `autoscale_decision` events and the
                    MetricsRegistry's counters and collector.

`device_pool=None` is a fixed pool of DEFAULT_POOL_SLOTS (8, the
reference's tier-1 mesh) slots on the sentinel's card, or as many as the
sentinel already holds if that is more. A pool over several ranks raises
NotImplementedError naming ROADMAP A10.3, one over several cards the
one-process-per-card rule. Wiring:
`sentinel.attach_autoscaler(a)` polls once per step() pump round;
`autoscaler_from_config(sentinel, config)` builds the stack behind
`akka.autoscale.*` (None when disabled).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

from ..event.pressure import PressureReader, system_pressure_sources
from ..parallel.mesh import (DEFAULT_POOL_SLOTS, check_one_card,
                             shard_slots)

__all__ = ["AutoscaleDecision", "AutoscalePolicy", "MeshAutoscaler",
           "autoscaler_from_config"]

# priority order when several signals are pressured at once: the one that
# means mail is being LOST outranks the ones that mean mail is queuing
_SIGNAL_PRIORITY = ("mailbox_overflow", "exchange_dropped",
                    "ask_pool_occupancy", "mailbox_occupancy_p90")


@dataclass
class AutoscaleDecision:
    """What the policy wants: `direction` is "widen" or "narrow",
    `to_shards` the DESIRED width (MeshAutoscaler clamps it to a
    feasible one), `signal`/`value` name the trigger (narrow reports the
    quiet window)."""

    direction: str
    to_shards: int
    signal: str
    value: float


class AutoscalePolicy:
    """Hysteresis controller: observe() one pressure reading per pump
    round, get None or an AutoscaleDecision. Widen doubles the width,
    narrow halves it: the same geometric ladder the failover path
    degrades along, so grow and shrink traverse the same mesh widths."""

    def __init__(self, min_shards: int = 1,
                 max_shards: int = 0,
                 widen_after: int = 3,
                 narrow_after: int = 16,
                 cooldown_polls: int = 8,
                 thresholds: Optional[Dict[str, float]] = None):
        if widen_after < 1 or narrow_after < 1:
            raise ValueError("hysteresis windows must be >= 1 poll")
        self.min_shards = max(1, int(min_shards))
        self.max_shards = int(max_shards)  # 0 = no cap (pool-bounded)
        self.widen_after = int(widen_after)
        self.narrow_after = int(narrow_after)
        self.cooldown_polls = int(cooldown_polls)
        # growth-delta thresholds are per-poll counts; occupancies are
        # levels in [0, 1] / bucket bounds. float("inf") disables a signal.
        self.thresholds: Dict[str, float] = {
            "mailbox_overflow": 1.0,
            "exchange_dropped": 1.0,
            "ask_pool_occupancy": 0.9,
            "mailbox_occupancy_p90": float("inf"),
        }
        if thresholds:
            self.thresholds.update(thresholds)
        self.pressured_polls = 0
        self.quiet_polls = 0
        self._cooldown = 0

    def pressured_signal(self, pressure: Dict[str, float]) \
            -> Optional[tuple]:
        """(name, value) of the highest-priority signal above threshold,
        else None."""
        for name in _SIGNAL_PRIORITY:
            v = pressure.get(name)
            if v is not None and v > self.thresholds.get(name,
                                                         float("inf")):
                return name, float(v)
        for name, v in pressure.items():  # caller-defined extra signals
            if name not in _SIGNAL_PRIORITY and \
                    v > self.thresholds.get(name, float("inf")):
                return name, float(v)
        return None

    def observe(self, pressure: Dict[str, float],
                current_shards: int) -> Optional[AutoscaleDecision]:
        if self._cooldown > 0:
            # the previous re-shard's effect is still settling: keep the
            # baselines moving (the reader already read) but decide nothing
            self._cooldown -= 1
            return None
        hit = self.pressured_signal(pressure)
        if hit is not None:
            self.quiet_polls = 0
            self.pressured_polls += 1
            cap = self.max_shards if self.max_shards > 0 else (1 << 30)
            if self.pressured_polls >= self.widen_after \
                    and current_shards < cap:
                return AutoscaleDecision(
                    "widen", min(cap, current_shards * 2), hit[0], hit[1])
            return None
        self.pressured_polls = 0
        self.quiet_polls += 1
        if self.quiet_polls >= self.narrow_after \
                and current_shards > self.min_shards:
            return AutoscaleDecision(
                "narrow", max(self.min_shards, current_shards // 2),
                "quiet", float(self.quiet_polls))
        return None

    def note_resharded(self) -> None:
        """A re-shard happened (ours or anyone's): reset both windows and
        arm the cooldown."""
        self.pressured_polls = 0
        self.quiet_polls = 0
        self._cooldown = self.cooldown_polls


class MeshAutoscaler:
    """Binds an AutoscalePolicy to a MeshSentinel and a pool of shard
    slots (`device_pool`; None: see the module docstring).

    poll() is the whole control loop: one PressureReader read, one policy
    observe, and — when it decides — one sentinel.scale_to onto a feasible
    width. Attach with sentinel.attach_autoscaler(self) to poll once per
    step() pump round, or call poll() from your own loop or timer."""

    def __init__(self, sentinel, policy: Optional[AutoscalePolicy] = None,
                 device_pool: Optional[Sequence[Any]] = None,
                 metrics_registry=None):
        self.sentinel = sentinel
        self.policy = policy or AutoscalePolicy()
        if device_pool is None:
            device_pool = shard_slots(
                max(DEFAULT_POOL_SLOTS, len(sentinel.devices)),
                sentinel.device)
        self.device_pool: List[Any] = list(device_pool)
        check_one_card(self.device_pool, "MeshAutoscaler")
        ask_stats = (self._ask_pool_stats
                     if getattr(sentinel, "promise_rows_n", 0) > 0 else None)
        self.reader = PressureReader(
            system_pressure_sources(sentinel, ask_pool_stats=ask_stats))
        self.polls = 0
        self.skipped_infeasible = 0
        self.failed = 0
        self.last: Optional[Dict[str, Any]] = None
        self._registry = metrics_registry
        self._widen_ctr = self._narrow_ctr = None
        if metrics_registry is not None:
            metrics_registry.register_collector("autoscale", self._collect)
            self._widen_ctr = metrics_registry.counter(
                "autoscale_widen_total", "mesh scale-out re-shards")
            self._narrow_ctr = metrics_registry.counter(
                "autoscale_narrow_total", "mesh scale-in re-shards")

    def _ask_pool_stats(self) -> Dict[str, float]:
        s = self.sentinel
        n = max(1, s.promise_rows_n)
        return {"occupancy": 1.0 - len(s._promise_free) / n}

    # ---------------------------------------------------------- control loop
    def _feasible_width(self, desired: int, direction: str) -> Optional[int]:
        """Closest width toward `desired` that divides capacity and fits
        the pool; None when nothing feasible exists in that direction."""
        cap = self.sentinel.capacity
        current = len(self.sentinel.devices)
        limit = len(self.device_pool)
        if direction == "widen":
            candidates = range(min(desired, limit), current, -1)
        else:
            candidates = range(desired, current)
        for w in candidates:
            if w >= 1 and cap % w == 0:
                return w
        return None

    def _target_devices(self, width: int) -> List[Any]:
        current = list(self.sentinel.devices)
        if width <= len(current):
            return current[:width]
        spare = [d for d in self.device_pool if d not in current]
        return current + spare[: width - len(current)]

    def poll(self) -> Optional[Dict[str, Any]]:
        """One control tick. Returns the sentinel's reshard record when a
        re-shard was executed, else None."""
        if self.sentinel.halted is not None:
            return None
        self.polls += 1
        pressure = self.reader.read()
        decision = self.policy.observe(pressure,
                                       len(self.sentinel.devices))
        if decision is None:
            return None
        width = self._feasible_width(decision.to_shards, decision.direction)
        if width is None or width == len(self.sentinel.devices):
            # e.g. pool exhausted, or no divisor between here and there:
            # arm the cooldown so the trigger doesn't re-fire every poll
            self.skipped_infeasible += 1
            self.policy.note_resharded()
            return None
        try:
            rec = self.sentinel.scale_to(
                self._target_devices(width), trigger="autoscale",
                signal=decision.signal, value=decision.value)
        except (RuntimeError, ValueError):
            # breaker open / anti-thrash window / width raced a failover —
            # the sentinel already bounded the damage; try again later
            self.failed += 1
            self.policy.note_resharded()
            return None
        self.policy.note_resharded()
        # the new mesh's counters were conserved into shard 0 (or reset):
        # drop baselines so the first post-re-shard poll reads quiet
        self.reader.rebaseline()
        if rec is None:
            return None
        self.last = dict(rec, decision_direction=decision.direction)
        if decision.direction == "widen" and self._widen_ctr is not None:
            self._widen_ctr.inc()
        elif decision.direction == "narrow" and self._narrow_ctr is not None:
            self._narrow_ctr.inc()
        fr = getattr(self.sentinel, "flight_recorder", None)
        if fr is not None:
            fr.autoscale_decision(
                "sentinel", direction=decision.direction,
                signal=decision.signal, value=decision.value,
                from_shards=rec["from_shards"], to_shards=rec["to_shards"],
                pause_ms=rec["pause_s"] * 1e3)
        return rec

    # ------------------------------------------------------------- telemetry
    def stats(self) -> Dict[str, Any]:
        """Stable summary for the gateway SLO artifact (`autoscale` field)
        and the bench rows."""
        widen = sum(1 for r in self.sentinel.reshard_stats
                    if r["trigger"] == "autoscale"
                    and r["direction"] == "grow")
        narrow = sum(1 for r in self.sentinel.reshard_stats
                     if r["trigger"] == "autoscale"
                     and r["direction"] == "shrink")
        last = self.last or {}
        return {
            "polls": self.polls,
            "widened": widen,
            "narrowed": narrow,
            "skipped_infeasible": self.skipped_infeasible,
            "failed": self.failed,
            "current_shards": len(self.sentinel.devices),
            "pressured_polls": self.policy.pressured_polls,
            "quiet_polls": self.policy.quiet_polls,
            "last_direction": last.get("decision_direction", ""),
            "last_signal": last.get("signal", ""),
            "last_pause_ms": round(last.get("pause_s", 0.0) * 1e3, 3),
        }

    def _collect(self) -> Dict[str, float]:
        return {k: float(v) for k, v in self.stats().items()
                if isinstance(v, (int, float))}


def autoscaler_from_config(sentinel, config,
                           device_pool: Optional[Sequence[Any]] = None,
                           metrics_registry=None) -> Optional[MeshAutoscaler]:
    """Build (and attach) the autoscaler behind `akka.autoscale.*`; None
    when `akka.autoscale.enabled` is off. See config.reference_config for
    the key set."""
    if config is None or not config.get_bool("akka.autoscale.enabled", False):
        return None
    g = lambda k, d: config.get_int(f"akka.autoscale.{k}", d)  # noqa: E731
    thresholds = {
        "mailbox_overflow": config.get_float(
            "akka.autoscale.overflow-threshold", 1.0),
        "exchange_dropped": config.get_float(
            "akka.autoscale.dropped-threshold", 1.0),
        "ask_pool_occupancy": config.get_float(
            "akka.autoscale.ask-occupancy-threshold", 0.9),
        "mailbox_occupancy_p90": config.get_float(
            "akka.autoscale.occupancy-p90-threshold", float("inf")),
    }
    policy = AutoscalePolicy(
        min_shards=g("min-shards", 1), max_shards=g("max-shards", 0),
        widen_after=g("widen-after-polls", 3),
        narrow_after=g("narrow-after-polls", 16),
        cooldown_polls=g("cooldown-polls", 8),
        thresholds=thresholds)
    a = MeshAutoscaler(sentinel, policy, device_pool=device_pool,
                       metrics_registry=metrics_registry)
    if hasattr(sentinel, "attach_autoscaler"):
        sentinel.attach_autoscaler(a)
    return a
