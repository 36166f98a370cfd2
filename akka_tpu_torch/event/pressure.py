"""Shared mailbox-pressure signal reading for admission AND autoscaling.

Port of `akka_tpu/event/pressure.py`, reading the port's
`ShardedBatchedSystem` (`mailbox_overflow`, `dropped_per_shard`,
`read_metrics`). Each counter read copies a device scalar to the host,
so it waits for the steps already enqueued.

The runtime's overload signals are CUMULATIVE device counters (per-shard
`mailbox_overflow` / exchange `dropped` in the packed attention word): the
meaningful quantity is their GROWTH since the previous poll — device mail
being lost right now — not the lifetime total, or a long-dead spike sheds
(or widens the mesh) forever. That delta bookkeeping used to live as a
closure inside gateway/admission.py; once the mesh autoscaler started
polling the same counters the two copies could drift (different `last`
baselines reading different deltas off one counter stream). This module is
the single owner of that bookkeeping:

  * PressureReader — one object per CONSUMER (admission controller,
    autoscaler): each holds its own last-seen baselines, so two consumers
    polling at different cadences both see correct per-interval deltas.
  * Signal names are the stable vocabulary both layers share:
    "mailbox_overflow", "exchange_dropped", "ask_pool_occupancy", and the
    optional "mailbox_occupancy_p90" histogram-lane signal.

A re-shard (failover or autoscale) RESETS the cumulative counters on the
new mesh (conserved into shard 0 by `_restore_resharded`, possibly lower
after row-0 conservation of a torn snapshot); a naive delta would then go
hugely negative and mask real pressure for one poll. `read()` clamps
deltas at 0 and re-baselines, so the first post-re-shard poll reads quiet,
not negative.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional

import numpy as np

__all__ = ["PressureReader", "system_pressure_sources"]


class PressureReader:
    """Growth-delta + occupancy reader over a dict of cumulative/level
    sources. `sources` maps signal name -> zero-arg callable; names listed
    in `cumulative` report max(0, value - last) per read() and re-baseline,
    all others report the level as-is. One reader per consumer — baselines
    are consumer-local state."""

    CUMULATIVE = ("mailbox_overflow", "exchange_dropped")

    def __init__(self, sources: Dict[str, Callable[[], float]],
                 cumulative: Optional[tuple] = None):
        self.sources = dict(sources)
        self.cumulative = tuple(cumulative if cumulative is not None
                                else self.CUMULATIVE)
        self._last: Dict[str, float] = {}
        self._lock = threading.Lock()

    def read(self) -> Dict[str, float]:
        """Poll every source once; returns {name: delta-or-level}. A dead
        source is skipped (a wedged device read must not take down the
        caller's control loop)."""
        out: Dict[str, float] = {}
        with self._lock:
            for name, fn in self.sources.items():
                try:
                    v = float(fn())
                except Exception:  # noqa: BLE001 — dead signal, skip
                    continue
                if name in self.cumulative:
                    last = self._last.get(name)
                    self._last[name] = v
                    # clamp at 0: counters reset on re-shard (conserved into
                    # shard 0, or zeroed); first poll after is quiet
                    out[name] = max(0.0, v - last) if last is not None else 0.0
                else:
                    out[name] = v
        return out

    def rebaseline(self) -> None:
        """Drop the counter baselines (next read() reports 0 for every
        cumulative signal). Call after a re-shard if the consumer wants a
        guaranteed-quiet first poll regardless of counter direction."""
        with self._lock:
            self._last.clear()

    def signals(self) -> Dict[str, Callable[[], float]]:
        """Per-signal zero-arg callables over this reader's shared
        baselines — the AdmissionController `pressure_signals` shape. All
        callables poll ONLY their own signal (one device read each), not
        the whole source dict."""

        def one(name: str) -> Callable[[], float]:
            def poll() -> float:
                fn = self.sources[name]
                v = float(fn())
                if name not in self.cumulative:
                    return v
                with self._lock:
                    last = self._last.get(name)
                    self._last[name] = v
                return max(0.0, v - last) if last is not None else 0.0
            return poll

        return {name: one(name) for name in self.sources}


def system_pressure_sources(system, ask_pool_stats: Optional[Callable[[], Dict[str, Any]]] = None,
                            occupancy_quantile: float = 0.9,
                            open_wave_depth: Optional[Callable[[], float]] = None) -> Dict[str, Callable[[], float]]:
    """Standard source dict for a (Sharded)BatchedSystem:

    | signal                 | source                                      |
    |------------------------|---------------------------------------------|
    | mailbox_overflow       | attention-word mailbox_overflow (cumulative)|
    | exchange_dropped       | attention-word dropped (cumulative)         |
    | ask_pool_occupancy     | promise-slot occupancy (level, 0..1)        |
    | mailbox_occupancy_p90  | metric-slab occupancy-lane p90 (level)      |
    | open_wave_depth        | scheduler open waves / pipeline_depth       |

    `system` may be a live object whose `.system` is swapped under it by a
    re-shard (MeshSentinel, DeviceShardRegion): sources resolve attributes
    at poll time, never capture slabs. The histogram signal only appears
    when the system compiles the metric slab in (`metrics_on`).

    `open_wave_depth` is the continuous-wave
    pipeline's fullness, a LEVEL in 0..1: 1.0 means `pipeline_depth`
    waves are already open and the next window will block on a wave
    slot, so an admission threshold below 1.0 sheds BEFORE the promise
    pool backs the whole ingest path up. Pass the scheduler's
    `open_wave_depth` bound method (AskBatcher.open_wave_depth)."""
    sys_of = (lambda: system.system) if hasattr(system, "system") \
        else (lambda: system)

    sources: Dict[str, Callable[[], float]] = {
        "mailbox_overflow": lambda: float(sys_of().mailbox_overflow),
        "exchange_dropped": lambda: float(np.sum(sys_of().dropped_per_shard)),
    }
    if ask_pool_stats is not None:
        sources["ask_pool_occupancy"] = \
            lambda: float(ask_pool_stats()["occupancy"])
    if open_wave_depth is not None:
        sources["open_wave_depth"] = \
            lambda: float(open_wave_depth())
    if getattr(sys_of(), "metrics_on", False):
        from ..batched.metrics_slab import HIST_NAMES, bucket_percentile

        def occ_p90() -> float:
            lane = sys_of().read_metrics()[HIST_NAMES[0]]
            return bucket_percentile(lane, occupancy_quantile)

        sources["mailbox_occupancy_p90"] = occ_p90
    return sources
