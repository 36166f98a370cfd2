"""Detection-only shard sentinel: SentinelHalted and ShardProgressMonitor.

Port of the part of `akka_tpu/batched/sentinel.py` (commit 5d9b7cd,
:91-190) that the bridge's pump feeds: every drained attention word's
ATT_PROGRESS lane heartbeats a phi-accrual detector per shard
(remote/failure_detector.py), so a hung or preempted device surfaces as a
`device_suspected` flight-recorder event. The self-healing `MeshSentinel`
(eviction and failover over a mesh) is not ported (ROADMAP A10).
"""

from __future__ import annotations

import time as _time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..remote.failure_detector import (DeadlineFailureDetector,
                                       FailureDetectorRegistry,
                                       PhiAccrualFailureDetector)
from .supervision import ATT_PROGRESS, ATT_WORDS


class SentinelHalted(RuntimeError):
    """Terminal degraded state: the failover breaker tripped (or a rebuild
    was impossible) and the sentinel stopped stepping instead of flapping
    through an eviction storm. The journal and snapshots are intact — a
    human (or a supervisor tier above) decides what runs next."""


class ShardProgressMonitor:
    """Per-shard failure detection over host-observed attention words.

    Feed every drained [n_shards, ATT_WORDS] fetch to observe(): a shard
    whose ATT_PROGRESS lane advanced heartbeats its phi-accrual detector;
    a frozen lane accrues phi with the injected clock until the threshold
    trips. check_deadline() is the whole-mesh fallback for total drain
    silence (hung dispatch): when no observation at all arrived within
    the deadline, the stalest shard — lowest progress, then lowest index —
    is the suspect, because per-shard phi cannot localize a fault that
    produces no words. Shared by the MeshSentinel (acts on suspicion) and
    the bridge pump (detection-only telemetry on a single device)."""

    def __init__(self, threshold: float = 8.0,
                 heartbeat_interval: float = 0.1,
                 acceptable_pause: float = 1.0,
                 clock=_time.monotonic):
        self.clock = clock
        self.threshold = float(threshold)
        self.heartbeat_interval = float(heartbeat_interval)
        self.acceptable_pause = float(acceptable_pause)
        est = max(self.heartbeat_interval, 1e-6)
        self._phi = FailureDetectorRegistry(
            lambda: PhiAccrualFailureDetector(
                threshold=self.threshold,
                acceptable_heartbeat_pause=self.acceptable_pause,
                first_heartbeat_estimate=est,
                min_std_deviation=est / 4.0,
                clock=clock))
        self._deadline = DeadlineFailureDetector(
            acceptable_heartbeat_pause=self.acceptable_pause,
            heartbeat_interval=self.heartbeat_interval, clock=clock)
        self._progress: Dict[int, int] = {}   # shard -> last seen lane value
        self._suspected: set = set()
        self.drains = 0

    def observe(self, att) -> List[Tuple[int, float, str]]:
        """One drained attention fetch. Returns newly suspected shards as
        (shard, phi, detector) triples, at most once per shard until
        unsuspect()/reset()."""
        att = np.asarray(att).reshape(-1, ATT_WORDS)
        self.drains += 1
        self._deadline.heartbeat()
        for s in range(att.shape[0]):
            prog = int(att[s, ATT_PROGRESS])
            last = self._progress.get(s)
            if last is None or prog > last:
                self._progress[s] = prog
                self._phi.heartbeat(s)
        newly = []
        for s in range(att.shape[0]):
            if s in self._suspected:
                continue
            if self._phi.is_monitoring(s) and not self._phi.is_available(s):
                self._suspected.add(s)
                newly.append((s, self._phi.phi(s), "phi-accrual"))
        return newly

    def check_deadline(self) -> Optional[Tuple[int, float, str]]:
        """Whole-mesh drain-silence check (the hung-dispatch lane). Returns
        one (shard, phi, "deadline") suspect or None."""
        if not self._deadline.is_monitoring or self._deadline.is_available:
            return None
        if not self._progress:
            return None
        stale = min(self._progress, key=lambda s: (self._progress[s], s))
        if stale in self._suspected:
            return None
        self._suspected.add(stale)
        return (stale, float("inf"), "deadline")

    def phi(self, shard: int) -> float:
        return self._phi.phi(shard)

    def suspected(self) -> set:
        return set(self._suspected)

    def unsuspect(self, shards) -> None:
        """Withdraw suspicion (detection suspended during the post-failover
        backoff window) — the shard re-trips on a later observation if its
        lane is still frozen."""
        for s in shards:
            self._suspected.discard(s)

    def reset(self) -> None:
        """Forget everything — shard indices renumber after a failover."""
        self._phi.reset()
        self._deadline = DeadlineFailureDetector(
            acceptable_heartbeat_pause=self.acceptable_pause,
            heartbeat_interval=self.heartbeat_interval, clock=self.clock)
        self._progress.clear()
        self._suspected.clear()
