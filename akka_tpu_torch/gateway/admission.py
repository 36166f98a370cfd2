"""Admission control for the serving gateway: token buckets + load shed.

Port of `akka_tpu/gateway/admission.py` (host code; `AskPoolExhausted`
comes from the port's `batched/bridge.py`).

Two layers, both returning TYPED decisions (shed load is backpressure the
client can act on — retry_after, reason — never a silent drop):

1. Per-tenant token buckets (rate + burst): the fairness layer. One tenant
   flooding the front door cannot starve the others; its excess is shed
   with reason "rate_limited" while everyone else stays under SLO.

2. Pressure-driven shedding: the protection layer. The runtime already
   exposes every signal an overload shows up in FIRST — per-shard
   `mailbox_overflow`/`dropped` counters in the packed attention word
   (device mail being lost), bridge `pipeline_stats` (dispatch backlog),
   and ask-pool occupancy (promise rows claimed by in-flight asks, the
   typed `AskPoolExhausted` fast-fail when fully drained). The controller
   polls them at `check_interval` (they are device/stats reads — never
   per-request) and sheds with reason "overloaded:<signal>" while any
   holds, plus a cooldown so recovery is hysteretic, not flappy.

Reference shape: stream-level backpressure ends at the TCP edge; from
there on, the gateway converts queue growth into explicit rejects the way
Akka HTTP's `ServiceUnavailable` + Retry-After does, driven by the same
kind of signals a mailbox-size-based `MailboxPressure` custom dispatcher
would read.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from operator import itemgetter
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..batched.bridge import AskPoolExhausted

__all__ = ["TokenBucket", "VectorTenantTable", "Reject",
           "AdmissionController", "region_pressure_signals",
           "handle_pressure_signals", "AskPoolExhausted"]


class TokenBucket:
    """Classic token bucket: `rate` tokens/s refill, `burst` capacity.
    Lazy refill on acquire; monotonic clock injectable for tests."""

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] = time.monotonic):
        self.rate = float(rate)
        self.burst = float(burst)
        self.clock = clock
        self._tokens = float(burst)
        self._last = clock()
        self._lock = threading.Lock()

    def try_acquire(self, n: float = 1.0) -> bool:
        with self._lock:
            now = self.clock()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._last) * self.rate)
            self._last = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def acquire_upto(self, n: int) -> int:
        """Vectorized charge: take as many whole tokens as available, up
        to `n`, in ONE refill+debit. Returns the count taken — exactly
        the number `n` sequential try_acquire() calls would have granted
        at this instant (fractional tokens never admit)."""
        with self._lock:
            now = self.clock()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._last) * self.rate)
            self._last = now
            k = int(min(self._tokens, float(n)))
            if k > 0:
                self._tokens -= k
            return k

    def retry_after(self, n: float = 1.0) -> float:
        """Seconds until `n` tokens will be available (0 if now)."""
        with self._lock:
            missing = n - self._tokens
        return max(0.0, missing / self.rate) if self.rate > 0 else 60.0


class VectorTenantTable:
    """Columnar tenant admission state: the token
    buckets of every RESIDENT tenant live as numpy columns — `tokens[f8]`,
    `last_refill[f8]`, `last_used[f8]` — indexed by an interned
    tenant-id -> slot table, so a whole ingest window's admission charge
    is ONE vectorized refill+debit

        tok = minimum(burst, tokens[slots] + (now - last[slots]) * rate)
        k   = minimum(floor(tok), n)          # fractional tokens never admit
        tokens[slots] = tok - k

    instead of a per-tenant walk over locked `TokenBucket` objects.

    Grant parity with sequential `TokenBucket.acquire_upto` is exact and
    bit-equal (asserted by tests/test_vector_admission.py): for integer
    `n` and `tok >= 0`, `min(floor(tok), n) == int(min(tok, float(n)))`,
    the refill expression is the same IEEE-754 arithmetic elementwise, and
    a fresh tenant interned at charge time starts at `tokens == burst`
    exactly as a just-constructed bucket refills to.

    Residency: columns grow by doubling up to `max_resident` slots; past
    that, interning a new tenant SPILLS the least-recently-used resident —
    its raw `(tokens, last_refill)` floats move to a plain dict — and a
    returning spilled tenant REHYDRATES those exact floats, so an
    LRU round trip is bit-invisible to grants. Cold-tenant state is two
    floats in a dict, not a lock + bucket object.

    Not internally locked: the AdmissionController serializes access
    under its own lock (the table replaces per-bucket locks, it does not
    add a second layer)."""

    def __init__(self, rate: float, burst: float,
                 max_resident: int = 1 << 17, init_capacity: int = 1024):
        self.rate = float(rate)
        self.burst = float(burst)
        self.max_resident = max(1, int(max_resident))
        cap = max(1, min(int(init_capacity), self.max_resident))
        self._cap = cap
        self._tokens = np.zeros(cap, np.float64)
        self._last = np.zeros(cap, np.float64)
        # +inf on free slots keeps them out of the LRU argmin
        self._last_used = np.full(cap, np.inf, np.float64)
        self._slot_of: Dict[str, int] = {}
        self._tenant_of: List[Optional[str]] = [None] * cap
        self._free: List[int] = list(range(cap - 1, -1, -1))
        self._spilled: Dict[str, Tuple[float, float]] = {}
        self.spills = 0
        self.rehydrates = 0
        self.vector_charges = 0

    # ------------------------------------------------------------ residency
    @property
    def resident(self) -> int:
        return len(self._slot_of)

    @property
    def tenant_count(self) -> int:
        return len(self._slot_of) + len(self._spilled)

    def _grow(self) -> None:
        new_cap = min(self.max_resident, self._cap * 2)
        grown = new_cap - self._cap
        self._tokens = np.concatenate(
            [self._tokens, np.zeros(grown, np.float64)])
        self._last = np.concatenate(
            [self._last, np.zeros(grown, np.float64)])
        self._last_used = np.concatenate(
            [self._last_used, np.full(grown, np.inf, np.float64)])
        self._tenant_of.extend([None] * grown)
        self._free.extend(range(new_cap - 1, self._cap - 1, -1))
        self._cap = new_cap

    def _evict_lru(self) -> int:
        s = int(np.argmin(self._last_used[:self._cap]))
        tenant = self._tenant_of[s]
        # spill the RAW floats: rehydration must be bit-invisible
        self._spilled[tenant] = (float(self._tokens[s]),
                                 float(self._last[s]))
        del self._slot_of[tenant]
        self._tenant_of[s] = None
        self._last_used[s] = np.inf
        self.spills += 1
        return s

    def _intern(self, tenant: str, now: float) -> int:
        s = self._slot_of.get(tenant)
        if s is not None:
            return s
        if not self._free:
            if self._cap < self.max_resident:
                self._grow()
            else:
                self._free.append(self._evict_lru())
        s = self._free.pop()
        self._slot_of[tenant] = s
        self._tenant_of[s] = tenant
        spilled = self._spilled.pop(tenant, None)
        if spilled is not None:
            self._tokens[s], self._last[s] = spilled
            self.rehydrates += 1
        else:
            # a fresh TokenBucket(rate, burst) refills to exactly burst
            # on its first acquire — start there, baselined at `now`
            self._tokens[s] = self.burst
            self._last[s] = now
        self._last_used[s] = now
        return s

    def _slots_for(self, tenants: Sequence[str], now: float) -> np.ndarray:
        """Slot indices for a window's tenant list, interning (and
        spilling/rehydrating) as needed. All-resident windows resolve in
        ONE itemgetter call — no per-tenant Python-object walk."""
        m = len(tenants)
        try:
            got = itemgetter(*tenants)(self._slot_of)
        except KeyError:
            if m > self.max_resident:
                raise ValueError(
                    f"window charges {m} tenants but max_resident is "
                    f"{self.max_resident}: every window tenant must be "
                    "resident for the vectorized charge")
            # slow path: some window tenant needs interning. Pin each
            # resolved slot at last_used=inf until the whole window is
            # mapped — a later intern's LRU eviction must never reclaim
            # a slot this window already holds an index to.
            slots = np.empty(m, np.int64)
            for j, t in enumerate(tenants):
                s = self._slot_of.get(t)
                if s is None:
                    s = self._intern(t, now)
                self._last_used[s] = np.inf
                slots[j] = s
            self._last_used[slots] = now  # the charge re-stamps anyway
            return slots
        if m == 1:
            return np.asarray([got], np.int64)
        return np.fromiter(got, np.int64, m)

    # -------------------------------------------------------------- charge
    def charge_groups(self, tenants: Sequence[str], counts: Sequence[int],
                      now: float) -> Tuple[np.ndarray, np.ndarray]:
        """ONE vectorized refill+debit for a window: `tenants` must be
        unique (they are dict keys upstream). Returns aligned
        `(granted[i8], retry_after[f8])` — granted is exactly what
        sequential `acquire_upto` calls would give each tenant, and
        retry_after is the post-debit time until 1 token, matching
        `TokenBucket.retry_after()` after the charge."""
        slots = self._slots_for(tenants, now)
        n = np.asarray(counts, np.float64)
        tok = np.minimum(self.burst,
                         self._tokens[slots]
                         + (now - self._last[slots]) * self.rate)
        k = np.minimum(np.floor(tok), n)
        self._tokens[slots] = tok - k
        self._last[slots] = now
        self._last_used[slots] = now
        self.vector_charges += 1
        if self.rate > 0:
            retry = np.maximum(0.0, (1.0 - (tok - k)) / self.rate)
        else:
            retry = np.full(len(slots), 60.0)
        return k.astype(np.int64), retry

    def acquire_upto(self, tenant: str, n: int, now: float) -> int:
        """Scalar twin of `charge_groups` for the single-request admit
        path — same arithmetic, plain-float fast path."""
        s = self._intern(tenant, now)
        tok = min(self.burst, float(self._tokens[s])
                  + (now - float(self._last[s])) * self.rate)
        k = int(min(tok, float(n)))
        self._tokens[s] = tok - k if k > 0 else tok
        self._last[s] = now
        self._last_used[s] = now
        return k

    def retry_after(self, tenant: str, n: float = 1.0) -> float:
        """Post-charge seconds until `n` tokens (no refill — call right
        after the charge, mirroring TokenBucket.retry_after)."""
        if self.rate <= 0:
            return 60.0
        s = self._slot_of.get(tenant)
        if s is not None:
            tokens = float(self._tokens[s])
        else:
            tokens = self._spilled.get(tenant, (self.burst, 0.0))[0]
        return max(0.0, (n - tokens) / self.rate)

    def stats(self) -> Dict[str, float]:
        return {"resident_tenants": float(len(self._slot_of)),
                "spilled_tenants": float(len(self._spilled)),
                "capacity": float(self._cap),
                "spills": float(self.spills),
                "rehydrates": float(self.rehydrates),
                "vector_charges": float(self.vector_charges)}


@dataclass
class Reject:
    """Typed shed decision: the wire reply carries both fields, so shed
    load is visible backpressure (reason + when to come back), never a
    timeout the client must discover."""

    reason: str
    retry_after_s: float = 0.0


class AdmissionController:
    """admit(tenant) -> None (admitted) | Reject(reason, retry_after).

    `pressure_signals` maps signal name -> zero-arg callable returning a
    float; a signal above its threshold (same key in `thresholds`) sheds
    ALL tenants with reason "overloaded:<name>" until it drops AND the
    `cooldown_s` hysteresis window passes. Signals are polled at most
    every `check_interval_s` — admission itself is lock + dict work.
    """

    def __init__(self, rate: float = 100.0, burst: float = 50.0,
                 pressure_signals: Optional[Dict[str, Callable[[], float]]]
                 = None,
                 thresholds: Optional[Dict[str, float]] = None,
                 check_interval_s: float = 0.05,
                 cooldown_s: float = 0.25,
                 clock: Callable[[], float] = time.monotonic,
                 metrics_registry=None, max_resident: int = 1 << 17):
        self.rate = float(rate)
        self.burst = float(burst)
        self.clock = clock
        self.pressure_signals = dict(pressure_signals or {})
        self.thresholds = dict(thresholds or {})
        self.check_interval_s = float(check_interval_s)
        self.cooldown_s = float(cooldown_s)
        # columnar tenant store: per-tenant TokenBucket
        # objects replaced by numpy columns + LRU spill past
        # max_resident; serialized under self._lock (the table carries
        # no lock of its own)
        self.table = VectorTenantTable(self.rate, self.burst,
                                       max_resident=max_resident)
        self._lock = threading.Lock()
        self._next_check = 0.0
        self._overload_until = 0.0
        self._overload_reason: Optional[str] = None
        self._last_values: Dict[str, float] = {}
        self.admitted = 0
        self.rejected = 0
        self.rejected_by_reason: Dict[str, int] = {}
        self._registry = metrics_registry
        if metrics_registry is not None:
            metrics_registry.register_collector("gateway_admission",
                                                self.stats)

    # ------------------------------------------------------------- signals
    def _poll_pressure(self, now: float) -> None:
        self._next_check = now + self.check_interval_s
        for name, fn in self.pressure_signals.items():
            try:
                v = float(fn())
            except Exception:  # a dead signal must not take down ingress
                continue
            self._last_values[name] = v
            if v > self.thresholds.get(name, float("inf")):
                self._overload_until = now + self.cooldown_s
                self._overload_reason = name

    def note_ask_pool_exhausted(self) -> None:
        """The backend fast-failed with AskPoolExhausted: treat it as an
        instantly-observed pressure signal (no poll latency) and shed for
        a cooldown window."""
        now = self.clock()
        with self._lock:
            self._overload_until = max(self._overload_until,
                                       now + self.cooldown_s)
            self._overload_reason = "ask_pool_exhausted"

    # -------------------------------------------------------------- admit
    def admit(self, tenant: str) -> Optional[Reject]:
        now = self.clock()
        with self._lock:
            if now >= self._next_check and self.pressure_signals:
                self._poll_pressure(now)
            if now < self._overload_until:
                self.rejected += 1
                reason = f"overloaded:{self._overload_reason}"
                self.rejected_by_reason[reason] = \
                    self.rejected_by_reason.get(reason, 0) + 1
                return Reject(reason, round(self._overload_until - now, 3))
            if self.table.acquire_upto(tenant, 1, now) == 1:
                self.admitted += 1
                return None
            self.rejected += 1
            self.rejected_by_reason["rate_limited"] = \
                self.rejected_by_reason.get("rate_limited", 0) + 1
            return Reject("rate_limited",
                          round(self.table.retry_after(tenant), 3))

    def admit_batch(self, tenant: str, n: int):
        """Vectorized per-tenant charge for a decoded binary window:
        admit the first `k` of `n` same-tenant requests with ONE bucket
        refill+debit instead of `n` lock round-trips. Returns
        `(k, reject)` where `reject` (a Reject, or None when k == n)
        carries the typed reason/retry for the `n - k` shed members.

        Counter/outcome parity with `n` sequential admit() calls is
        exact under a frozen clock: buckets are per-tenant, so charging
        a tenant's window in one debit grants the same k as charging its
        members one by one (fractional tokens never admit either way).
        Pressure is polled once per window instead of once per request —
        strictly fewer polls, same signals."""
        n = int(n)
        if n <= 0:
            return 0, None
        now = self.clock()
        with self._lock:
            if now >= self._next_check and self.pressure_signals:
                self._poll_pressure(now)
            if now < self._overload_until:
                self.rejected += n
                reason = f"overloaded:{self._overload_reason}"
                self.rejected_by_reason[reason] = \
                    self.rejected_by_reason.get(reason, 0) + n
                return 0, Reject(reason, round(self._overload_until - now, 3))
            k = self.table.acquire_upto(tenant, n, now)
            rej = None if k == n else Reject(
                "rate_limited", round(self.table.retry_after(tenant), 3))
            self.admitted += k
            if k < n:
                self.rejected += n - k
                self.rejected_by_reason["rate_limited"] = \
                    self.rejected_by_reason.get("rate_limited", 0) + (n - k)
        return k, rej

    def admit_groups(self, counts: Dict[str, int]):
        """Window-level charge for a cross-connection ingest window
       : `counts` maps tenant -> request count;
        pressure is polled ONCE for the whole window, then EVERY tenant
        in the window is charged by ONE vectorized refill+debit on the
        columnar table — zero per-tenant Python-object walks for
        resident tenants. Returns `{tenant: (k, reject_or_None)}` —
        per-tenant outcome parity with one admit_batch call per tenant
        is exact (slots are independent columns; the poll is shared, and
        strictly fewer polls can only see the same-or-fresher
        signals)."""
        out: Dict[str, Any] = {}
        if not counts:
            return out
        now = self.clock()
        with self._lock:
            if now >= self._next_check and self.pressure_signals:
                self._poll_pressure(now)
            if now < self._overload_until:
                reason = f"overloaded:{self._overload_reason}"
                rej = Reject(reason, round(self._overload_until - now, 3))
                for tenant, n in counts.items():
                    n = int(n)
                    self.rejected += n
                    self.rejected_by_reason[reason] = \
                        self.rejected_by_reason.get(reason, 0) + n
                    out[tenant] = (0, rej)
                return out
            tenants = list(counts.keys())
            ns = [int(counts[t]) for t in tenants]
            ks, retry = self.table.charge_groups(tenants, ns, now)
            granted = int(ks.sum())
            shed = sum(ns) - granted
            self.admitted += granted
            if shed > 0:
                self.rejected += shed
                self.rejected_by_reason["rate_limited"] = \
                    self.rejected_by_reason.get("rate_limited", 0) + shed
            for j, tenant in enumerate(tenants):
                k, n = int(ks[j]), ns[j]
                out[tenant] = (k, None) if k == n else \
                    (k, Reject("rate_limited", round(float(retry[j]), 3)))
        return out

    # -------------------------------------------------------------- stats
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            overloaded = self.clock() < self._overload_until
            tstats = self.table.stats()
            return {"admitted": self.admitted,
                    "rejected": self.rejected,
                    "overloaded": int(overloaded),
                    "tenants": self.table.tenant_count,
                    "resident_tenants": int(tstats["resident_tenants"]),
                    "spilled_tenants": int(tstats["spilled_tenants"]),
                    "tenant_spills": int(tstats["spills"]),
                    "tenant_rehydrates": int(tstats["rehydrates"]),
                    **{f"signal_{k}": v
                       for k, v in self._last_values.items()}}


# -------------------------------------------------- runtime pressure wiring
def region_pressure_signals(region, batcher=None) \
        -> Dict[str, Callable[[], float]]:
    """Admission signals for a DeviceShardRegion backend.

    | signal             | source                                   |
    |--------------------|------------------------------------------|
    | mailbox_overflow   | attention word mailbox_overflow (total)  |
    | exchange_dropped   | attention word dropped (total)           |
    | ask_pool_occupancy | region promise-slot occupancy            |
    | open_wave_depth    | batcher open waves / pipeline_depth      |

    `batcher`: the backend's AskBatcher, when it
    has one — its `open_wave_depth` level sheds BEFORE the promise pool
    fills, because a full wave pipeline is the leading edge of the same
    overload ask_pool_occupancy reports one window later.

    Overflow counters are CUMULATIVE: the signal is their GROWTH since
    the previous poll (device mail being lost right now), so thresholds
    compare against a per-interval delta, and a long-dead spike does not
    shed forever.

    The delta/clamp bookkeeping lives in event/pressure.PressureReader —
    the SAME class the mesh autoscaler polls, so admission shedding and
    autoscaling can never disagree about what "pressure" means. Each
    caller gets its OWN reader (own baselines): the two consumers poll at
    different cadences and must not steal each other's deltas."""
    from ..event.pressure import PressureReader, system_pressure_sources
    return PressureReader(system_pressure_sources(
        region, ask_pool_stats=region.ask_pool_stats,
        open_wave_depth=(batcher.open_wave_depth
                         if batcher is not None else None))).signals()


def handle_pressure_signals(handle) -> Dict[str, Callable[[], float]]:
    """Admission signals for a BatchedRuntimeHandle backend: pipeline
    backlog (programs enqueued minus drained, vs configured depth) and
    ask-pool occupancy."""

    def backlog() -> float:
        st = handle.pipeline_stats()
        depth = max(1, int(st.get("depth", 1)))
        return (st.get("steps", 0) - st.get("drains", 0)) / depth

    return {"pipeline_backlog": backlog,
            "ask_pool_occupancy":
                lambda: float(handle.ask_pool_stats()["occupancy"])}
