"""SLO tracking for the serving gateway, on the unified telemetry plane.

A copy of `akka_tpu/gateway/slo.py` (host code).

The tracker is a thin, hot-path-cheap layer over the existing
MetricsRegistry (event/metrics.py): per-outcome counters (ok / reject /
timeout / error, globally and per tenant), a log-bucket latency histogram
for p50/p99 against configured targets, and an error budget — all
step-stamped on the shared `ATT_STEP` axis via `registry.set_step`, so a
latency regression lines up against the same device step as the pipeline
and sentinel collectors.

`artifact()` is the stable JSON schema the bench, the watchdog row and
the chaos integration test all emit/assert (docs/SERVING_GATEWAY.md):

    {"requests", "ok", "rejects", "timeouts", "errors",
     "p50_ms", "p99_ms", "target_p50_ms", "target_p99_ms",
     "p50_met", "p99_met", "reject_rate",
     "slo_target", "error_budget_total", "error_budget_spent",
     "error_budget_remaining", "step", "per_tenant": {tenant: {...}}}
"""

from __future__ import annotations

import math
import threading
from collections import deque
from typing import Any, Dict, Optional

__all__ = ["SloTracker"]

_OUTCOMES = ("ok", "reject", "timeout", "error")


class SloTracker:
    """record(tenant, outcome, latency_s) on every request; artifact()
    for the SLO report. Registered as the "gateway" collector when a
    registry is supplied (gauges: akka_gateway_requests, _p99_ms, ...).

    The error budget follows the SRE convention: with `slo_target`
    success (default 99%), budget = (1 - slo_target) of requests may go
    bad (timeout/error — REJECTS ARE NOT SLO VIOLATIONS: shed load is the
    mechanism protecting the SLO, and it is reported separately as
    reject_rate)."""

    def __init__(self, registry=None,
                 target_p50_ms: float = 50.0,
                 target_p99_ms: float = 250.0,
                 slo_target: float = 0.99,
                 window: int = 8192):
        self.registry = registry
        self.target_p50_ms = float(target_p50_ms)
        self.target_p99_ms = float(target_p99_ms)
        self.slo_target = float(slo_target)
        self._lock = threading.Lock()
        self._counts = {o: 0 for o in _OUTCOMES}
        self._per_tenant: Dict[str, Dict[str, int]] = {}
        # sliding latency window (ms) + sorted-snapshot cache keyed on the
        # append counter, the pipeline_stats idiom: percentile pulls at
        # exposition time must not re-sort an unchanged window
        self._lat_ms: deque = deque(maxlen=int(window))
        self._lat_seq = 0
        self._lat_sorted = (-1, [])
        # replicated-read split: replica-served and
        # authoritative latencies in their own windows so artifact() can
        # report both percentile families; `_lat_ms` stays ALL admitted
        # traffic — existing consumers see identical numbers
        self._lat_rep: deque = deque(maxlen=int(window))
        self._lat_auth: deque = deque(maxlen=int(window))
        self._hist = None
        self._batcher = None
        self._aggregator = None
        self._autoscaler = None
        self._replica_cache = None
        if registry is not None:
            registry.register_collector("gateway", self._collect)
            self._hist = registry.histogram(
                "gateway_ask_latency_ms",
                "gateway request latency (admitted asks), milliseconds")

    def attach_batcher(self, batcher) -> None:
        """Carry the ask-batching summary (AskBatcher.stats: batches,
        asks, mean_batch_size, ...) in artifact() as `ask_batch`, so the
        bench rows, the watchdog row and the example's slo.json all show
        how much coalescing the traffic actually got. The size/window
        histograms live on the MetricsRegistry; this is the stable-schema
        summary next to the latency numbers it explains."""
        self._batcher = batcher

    def attach_aggregator(self, aggregator) -> None:
        """Carry the cross-connection ingest summary
        (IngestAggregator.stats: windows, frames, mean_window_size, ...)
        in artifact() as `ingest_window`, next to `ask_batch` — the two
        coalescing layers an operator reads together: how many frames
        shared one decode/admission round, and how many asks shared one
        device round. Size/wait histograms live on the MetricsRegistry
        (docs/OBSERVABILITY.md); this is the stable-schema summary."""
        self._aggregator = aggregator

    def attach_replica_cache(self, cache) -> None:
        """Carry the replicated-read summary (ReadReplicaCache.stats:
        promotions, replica_served, fall-throughs, staleness_bound_held)
        in artifact() as `replica_reads`, WITH the replicated-vs-
        authoritative percentile split — the number the hot-key
        read-storm bench leg asserts. Same stable-schema-summary
        contract as `ask_batch`."""
        self._replica_cache = cache

    def attach_autoscaler(self, autoscaler) -> None:
        """Carry the elastic-mesh summary (MeshAutoscaler.stats: widened/
        narrowed counts, current width, last trigger signal and pause) in
        artifact() as `autoscale` — an operator reading slo.json sees
        WHETHER the mesh moved under the latency numbers, and what it cost.
        Same stable-schema-summary contract as `ask_batch`."""
        self._autoscaler = autoscaler

    # -------------------------------------------------------------- record
    def record(self, tenant: str, outcome: str,
               latency_s: Optional[float] = None) -> None:
        if outcome not in _OUTCOMES:
            raise ValueError(f"unknown outcome {outcome!r}")
        with self._lock:
            self._counts[outcome] += 1
            per = self._per_tenant.get(tenant)
            if per is None:
                per = self._per_tenant[tenant] = {o: 0 for o in _OUTCOMES}
            per[outcome] += 1
            if latency_s is not None:
                self._lat_ms.append(latency_s * 1e3)
                self._lat_auth.append(latency_s * 1e3)
                self._lat_seq += 1
        if self._hist is not None and latency_s is not None:
            step = self.registry.step if self.registry is not None else None
            self._hist.observe(latency_s * 1e3, step=step)

    def record_many(self, tenant: str, outcomes, latencies_s=None,
                    replica_flags=None) -> None:
        """Wave recording for the batch-decoded ingress path: all of one
        tenant's outcomes from a reply wave under ONE lock acquisition,
        with the latency histogram fed in one vectorized observe.
        `outcomes` is a sequence of outcome names; `latencies_s` (same
        length or None) carries per-request latencies, None entries
        skipped — counter parity with N record() calls is exact.
        `replica_flags` (same length or None) marks replica-
        served requests so their latencies land in the split windows;
        omitted ⇒ everything counts authoritative."""
        counts: Dict[str, int] = {}
        for o in outcomes:
            if o not in _OUTCOMES:
                raise ValueError(f"unknown outcome {o!r}")
            counts[o] = counts.get(o, 0) + 1
        if not counts:
            return
        lats = [s for s in (latencies_s or ()) if s is not None]
        rep_lats: list = []
        auth_lats: list = []
        if latencies_s is not None:
            flags = replica_flags or (False,) * len(outcomes)
            for s, f in zip(latencies_s, flags):
                if s is None:
                    continue
                (rep_lats if f else auth_lats).append(s * 1e3)
        with self._lock:
            per = self._per_tenant.get(tenant)
            if per is None:
                per = self._per_tenant[tenant] = {o: 0 for o in _OUTCOMES}
            for o, c in counts.items():
                self._counts[o] += c
                per[o] += c
            if lats:
                self._lat_ms.extend(s * 1e3 for s in lats)
                self._lat_seq += len(lats)
                self._lat_rep.extend(rep_lats)
                self._lat_auth.extend(auth_lats)
        if self._hist is not None and lats:
            step = self.registry.step if self.registry is not None else None
            self._hist.observe_many([s * 1e3 for s in lats], step=step)

    # ---------------------------------------------------------- percentiles
    def percentile(self, q: float) -> float:
        """Nearest-rank percentile (ms) over the sliding window."""
        with self._lock:
            seq, d = self._lat_sorted
            if seq != self._lat_seq:
                d = sorted(self._lat_ms)
                self._lat_sorted = (self._lat_seq, d)
        if not d:
            return 0.0
        return d[max(math.ceil(q * len(d)) - 1, 0)]

    def _split_percentiles(self) -> Dict[str, float]:
        """p50/p99 of the replica-served and authoritative windows (the
        replicated-read split). Sorted on demand — this is exposition-
        time only (artifact/bench), never the hot path."""
        with self._lock:
            rep = sorted(self._lat_rep)
            auth = sorted(self._lat_auth)

        def pick(d, q):
            return d[max(math.ceil(q * len(d)) - 1, 0)] if d else 0.0
        return {"replica_p50_ms": round(pick(rep, 0.50), 3),
                "replica_p99_ms": round(pick(rep, 0.99), 3),
                "auth_p50_ms": round(pick(auth, 0.50), 3),
                "auth_p99_ms": round(pick(auth, 0.99), 3),
                "replica_lat_n": len(rep), "auth_lat_n": len(auth)}

    # -------------------------------------------------------------- report
    def artifact(self) -> Dict[str, Any]:
        with self._lock:
            counts = dict(self._counts)
            per_tenant = {t: dict(c) for t, c in self._per_tenant.items()}
        total = sum(counts.values())
        bad = counts["timeout"] + counts["error"]
        served = counts["ok"] + bad  # admitted traffic (SLO denominator)
        budget_total = (1.0 - self.slo_target) * served
        p50, p99 = self.percentile(0.50), self.percentile(0.99)
        step = self.registry.step if self.registry is not None else 0
        batch = ({"ask_batch": self._batcher.stats()}
                 if self._batcher is not None else {})
        ingest = ({"ingest_window": self._aggregator.stats()}
                  if self._aggregator is not None else {})
        scale = ({"autoscale": self._autoscaler.stats()}
                 if self._autoscaler is not None else {})
        replica = {}
        if self._replica_cache is not None:
            replica = {"replica_reads": {**self._replica_cache.stats(),
                                         **self._split_percentiles()}}
        return {
            **batch,
            **ingest,
            **scale,
            **replica,
            "requests": total,
            "ok": counts["ok"],
            "rejects": counts["reject"],
            "timeouts": counts["timeout"],
            "errors": counts["error"],
            "p50_ms": round(p50, 3),
            "p99_ms": round(p99, 3),
            "target_p50_ms": self.target_p50_ms,
            "target_p99_ms": self.target_p99_ms,
            "p50_met": int(p50 <= self.target_p50_ms),
            "p99_met": int(p99 <= self.target_p99_ms),
            "reject_rate": round(counts["reject"] / total, 4) if total else 0.0,
            "slo_target": self.slo_target,
            "error_budget_total": round(budget_total, 3),
            "error_budget_spent": bad,
            "error_budget_remaining": round(budget_total - bad, 3),
            "step": int(step),
            "per_tenant": per_tenant,
        }

    def _collect(self) -> Dict[str, float]:
        """Numeric slice of artifact() for the registry (per_tenant and
        target echoes stay in the JSON artifact)."""
        art = self.artifact()
        return {k: float(v) for k, v in art.items()
                if isinstance(v, (int, float))}
