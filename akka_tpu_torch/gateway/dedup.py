"""Journaled reply-cache dedup: exactly-once effects for retried asks.

A copy of `akka_tpu/gateway/dedup.py` (host code). `load(entries)` works
alone; rehydrating the table from the entity journal waits for ROADMAP A8.

The serving path is durable (entity journal, commit-before-ack) and
retry-capable (`GatewayClient.request_retry`), but the two composed
wrong: a reply lost AFTER the wave group-commits — connection death
post-commit, or kill -9 between the fsync and the ack hitting the wire
— made the client resend and the entity double-apply. This module is
the server half of the fix: a `ReplyCacheTable` in the
`VectorTenantTable` style (gateway/admission.py) remembers the reply of
every resolved request id, so a duplicate id short-circuits with the
cached reply and never re-enters the ask wave.

Layout: cached replies of every RESIDENT key live as numpy columns —
`id[i8]`, `status[u1]`, `value[f8]`, `reason slot[i4]`, resolve
`ord[i8]`, `last_used[f8]` — indexed by an interned (tenant, id) → slot
table, so a whole ingest window's dedup check gathers its columns in
one fancy-index pass after ONE dict resolve. Reference shape: Akka 2.6
reliable delivery's ConsumerController seq-nr dedup, ported onto the
columnar window machinery.

Three bounds keep the table honest:

- **Per-tenant window** (`window`, default 4096 ids): each tenant's
  remembered ids form an insertion-ordered window; recording past it
  FORGETS the oldest id entirely. A retry of a forgotten id re-applies
  — the documented at-least-once degradation, priced per tenant so one
  chatty tenant cannot evict another's dedup frontier.
- **LRU residency spill** (`max_resident` slots): past it, the
  least-recently-used resident row spills its RAW scalars to a dict and
  a later hit rehydrates them bit-identically (the admission table's
  spill contract) — a spilled id still dedups, it just pays a dict
  lookup.
- **Pending TTL**: a key staged into an in-flight wave is `pending`;
  a duplicate arriving while its first attempt is still in flight gets
  a typed `duplicate_inflight` shed (retry_after, never a second
  application — the cross-wave row-ownership race the tentpole closes).
  A pending entry older than `pending_ttl_s` is presumed leaked by a
  crashed serve path and degrades to a miss.

What gets recorded: ok replies (the journaled exactly-once frontier —
they ride the entity journal's group commit via `append_wave(replies=)`
and are rehydrated on restore) and ask timeouts (ambiguous: the apply
may have landed without latching a reply, so the cached timeout keeps
the id at-most-once; after a crash the unjournaled apply rolls back and
the lost cache entry correctly lets the retry re-apply). Sheds and
typed faults are never recorded — nothing applied, the client retries
fresh.

Not internally locked: the GatewayServer serializes begin/record under
its own dedup lock, exactly as the AdmissionController serializes the
tenant table (the table replaces per-key state, it does not add a
second lock layer).
"""

from __future__ import annotations

import time
from collections import deque
from typing import (Any, Callable, Deque, Dict, List, Optional, Sequence,
                    Tuple)

import numpy as np

__all__ = ["ReplyCacheTable", "DUPLICATE_INFLIGHT"]

# typed shed reason for a duplicate whose first attempt is still in an
# open wave — the client backs off retry_after_ms and resends SAME id
DUPLICATE_INFLIGHT = "duplicate_inflight"

Key = Tuple[str, int]


class ReplyCacheTable:
    """Columnar reply cache keyed by (tenant, request id). See module
    docstring for the contract; `begin` is the one-per-window dedup
    check, `record`/`release` the resolve-boundary writebacks, `load`
    the journal-restore rehydrate."""

    def __init__(self, window: int = 4096, max_resident: int = 1 << 17,
                 init_capacity: int = 1024, pending_ttl_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.window = max(1, int(window))
        self.max_resident = max(1, int(max_resident))
        self.pending_ttl_s = float(pending_ttl_s)
        self.clock = clock
        cap = max(1, min(int(init_capacity), self.max_resident))
        self._cap = cap
        self._ids = np.zeros(cap, np.int64)
        self._status = np.zeros(cap, np.uint8)
        self._value = np.zeros(cap, np.float64)
        self._reason = np.zeros(cap, np.int32)
        self._ord = np.zeros(cap, np.int64)
        # +inf on free slots keeps them out of the LRU argmin
        self._last_used = np.full(cap, np.inf, np.float64)
        self._slot_of: Dict[Key, int] = {}
        self._key_of: List[Optional[Key]] = [None] * cap
        self._free: List[int] = list(range(cap - 1, -1, -1))
        # spilled rows keep their RAW scalars: rehydration is bit-exact
        self._spilled: Dict[Key, Tuple[int, float, bytes, int]] = {}
        # interned reason byte strings; slot 0 is the empty reason
        self._reasons: List[bytes] = [b""]
        self._reason_slot: Dict[bytes, int] = {b"": 0}
        # per-tenant insertion-ordered id windows (the dedup frontier)
        self._order: Dict[str, Deque[int]] = {}
        # keys staged into an in-flight wave -> stage timestamp
        self._pending: Dict[Key, float] = {}
        self._next_ord = 0
        self.hits = 0
        self.misses = 0
        self.alias_hits = 0
        self.inflight_sheds = 0
        self.spills = 0
        self.rehydrates = 0
        self.window_evictions = 0
        self.pending_expired = 0
        self.records = 0
        self.loads = 0

    # ------------------------------------------------------------ residency
    @property
    def resident(self) -> int:
        return len(self._slot_of)

    @property
    def cached(self) -> int:
        return len(self._slot_of) + len(self._spilled)

    def _grow(self) -> None:
        new_cap = min(self.max_resident, self._cap * 2)
        grown = new_cap - self._cap
        self._ids = np.concatenate(
            [self._ids, np.zeros(grown, np.int64)])
        self._status = np.concatenate(
            [self._status, np.zeros(grown, np.uint8)])
        self._value = np.concatenate(
            [self._value, np.zeros(grown, np.float64)])
        self._reason = np.concatenate(
            [self._reason, np.zeros(grown, np.int32)])
        self._ord = np.concatenate(
            [self._ord, np.zeros(grown, np.int64)])
        self._last_used = np.concatenate(
            [self._last_used, np.full(grown, np.inf, np.float64)])
        self._key_of.extend([None] * grown)
        self._free.extend(range(new_cap - 1, self._cap - 1, -1))
        self._cap = new_cap

    def _evict_lru(self) -> int:
        s = int(np.argmin(self._last_used[:self._cap]))
        key = self._key_of[s]
        self._spilled[key] = (int(self._status[s]), float(self._value[s]),
                              self._reasons[int(self._reason[s])],
                              int(self._ord[s]))
        del self._slot_of[key]
        self._key_of[s] = None
        self._last_used[s] = np.inf
        self.spills += 1
        return s

    def _intern_reason(self, reason: bytes) -> int:
        s = self._reason_slot.get(reason)
        if s is None:
            s = len(self._reasons)
            self._reasons.append(reason)
            self._reason_slot[reason] = s
        return s

    def _intern(self, key: Key, now: float) -> int:
        s = self._slot_of.get(key)
        if s is not None:
            return s
        if not self._free:
            if self._cap < self.max_resident:
                self._grow()
            else:
                self._free.append(self._evict_lru())
        s = self._free.pop()
        self._slot_of[key] = s
        self._key_of[s] = key
        self._last_used[s] = now
        return s

    def _drop(self, key: Key) -> None:
        """Forget a key entirely (window eviction): resident slot back
        to the free list, spilled entry deleted."""
        s = self._slot_of.pop(key, None)
        if s is not None:
            self._key_of[s] = None
            self._last_used[s] = np.inf
            self._free.append(s)
        else:
            self._spilled.pop(key, None)

    # --------------------------------------------------------------- check
    def begin(self, keys: Sequence[Optional[Key]]
              ) -> List[Tuple[Any, ...]]:
        """THE per-window dedup check: one verdict per key, aligned.
        Non-dedupable rows (key None — non-integer JSON ids) get
        ("skip",). Verdicts:

          ("miss",)                  first sighting — the key is now
                                     PENDING and must be resolved with
                                     record() or release()
          ("hit", status, value, reason)   cached reply, replay it
          ("alias", j)               duplicate of this window's row j —
                                     copy row j's resolved reply
          ("inflight",)              first attempt still in an open
                                     wave — typed duplicate_inflight

        Resident hits gather their columns in one fancy-index pass;
        spilled hits rehydrate their raw scalars first (bit-exact)."""
        now = self.clock()
        n = len(keys)
        out: List[Tuple[Any, ...]] = [("skip",)] * n
        seen: Dict[Key, int] = {}
        probe_rows: List[int] = []
        probe_slots: List[int] = []
        for j, key in enumerate(keys):
            if key is None:
                continue
            first = seen.get(key)
            if first is not None:
                out[j] = ("alias", first)
                self.alias_hits += 1
                continue
            ts = self._pending.get(key)
            if ts is not None:
                if now - ts <= self.pending_ttl_s:
                    out[j] = ("inflight",)
                    self.inflight_sheds += 1
                    continue
                # a serve path that crashed mid-wave leaked the key:
                # presume dead and let the retry through
                del self._pending[key]
                self.pending_expired += 1
            s = self._slot_of.get(key)
            if s is not None:
                probe_rows.append(j)
                probe_slots.append(s)
                self._last_used[s] = now
                continue
            spilled = self._spilled.pop(key, None)
            if spilled is not None:
                # rehydrate the raw scalars into a fresh slot so the
                # next hit rides the columnar path
                status, value, reason, ordn = spilled
                s = self._intern(key, now)
                self._ids[s] = key[1]
                self._status[s] = status
                self._value[s] = value
                self._reason[s] = self._intern_reason(reason)
                self._ord[s] = ordn
                self.rehydrates += 1
                self.hits += 1
                out[j] = ("hit", status, value, reason)
                continue
            out[j] = ("miss",)
            seen[key] = j
            self._pending[key] = now
            self.misses += 1
        if probe_rows:
            slots = np.asarray(probe_slots, np.int64)
            statuses = self._status[slots]
            values = self._value[slots]
            reasons = self._reason[slots]
            for k, j in enumerate(probe_rows):
                out[j] = ("hit", int(statuses[k]), float(values[k]),
                          self._reasons[int(reasons[k])])
                self.hits += 1
        return out

    # -------------------------------------------------------------- resolve
    def record(self, key: Key, status: int, value: float,
               reason: bytes = b"") -> None:
        """Resolve-boundary writeback: cache the reply and clear the
        pending mark. Enforces the per-tenant window — recording id
        N+window forgets the tenant's oldest remembered id."""
        now = self.clock()
        self._pending.pop(key, None)
        fresh = key not in self._slot_of and key not in self._spilled
        s = self._intern(key, now)
        self._ids[s] = key[1]
        self._status[s] = status
        self._value[s] = value
        self._reason[s] = self._intern_reason(bytes(reason))
        self._ord[s] = self._next_ord
        self._next_ord += 1
        self.records += 1
        if fresh:
            order = self._order.get(key[0])
            if order is None:
                order = self._order[key[0]] = deque()
            order.append(key[1])
            while len(order) > self.window:
                self._drop((key[0], order.popleft()))
                self.window_evictions += 1

    def release(self, key: Key) -> None:
        """Clear a pending mark WITHOUT caching (the ask failed without
        applying — shed/fault): the retry runs fresh."""
        self._pending.pop(key, None)

    def lookup(self, key: Key) -> Optional[Tuple[int, float, bytes]]:
        """Point probe (tests / tools): (status, value, reason) or None.
        Does not touch pending state or the hit counters."""
        s = self._slot_of.get(key)
        if s is not None:
            return (int(self._status[s]), float(self._value[s]),
                    self._reasons[int(self._reason[s])])
        spilled = self._spilled.get(key)
        if spilled is not None:
            return spilled[0], spilled[1], spilled[2]
        return None

    # -------------------------------------------------------------- restore
    def load(self, entries: Sequence[Tuple[str, int, int, float]]) -> int:
        """Rehydrate the dedup frontier from the entity journal's
        replayed reply records: `(tenant, id, status, value)` tuples in
        journal order. Returns the number loaded. Window bounds apply —
        a journal longer than the window keeps only each tenant's
        newest `window` ids, exactly as the live path would have."""
        n = 0
        for tenant, rid, status, value in entries:
            self.record((str(tenant), int(rid)), int(status), float(value))
            n += 1
        self.loads += n
        self.records -= n  # loads are not live records
        return n

    # ---------------------------------------------------------------- stats
    def stats(self) -> Dict[str, float]:
        checks = self.hits + self.alias_hits + self.misses
        return {
            "hits": float(self.hits),
            "alias_hits": float(self.alias_hits),
            "misses": float(self.misses),
            "inflight_sheds": float(self.inflight_sheds),
            "spills": float(self.spills),
            "rehydrates": float(self.rehydrates),
            "window_evictions": float(self.window_evictions),
            "pending_expired": float(self.pending_expired),
            "records": float(self.records),
            "loads": float(self.loads),
            "resident": float(len(self._slot_of)),
            "spilled": float(len(self._spilled)),
            "pending": float(len(self._pending)),
            "window": float(self.window),
            "hit_ratio": ((self.hits + self.alias_hits) / checks)
            if checks else 0.0,
        }
