"""Replicated read path for hot entities.

Port of `akka_tpu/gateway/replica.py`, the local mode and the ddata feed
(a `system` with a cluster and its replicator). One change: a `system`
the feed cannot run on (no cluster, no replicator) raises ValueError; the
reference falls back silently to the local mode.

A gateway "get" is `add(0)` riding the full admission → ask-wave →
device-step → readback pipeline — the cheapest traffic served the most
expensive way. This module is the classic read-mostly scaling move:
writes KEEP their linearized wave path, but every wave's post-wave
totals are published (one batched publish per wave, not per request)
into a ddata-replicated `PNCounterMap`, and "get"s for entities promoted
hot are answered from the local replica BEFORE the ask wave under a
bounded-staleness contract.

The contract, precisely:

- **Publish**: after each ask wave, the authoritative post-wave total of
  every ok outcome is published with the current device step on the
  shared ATT_STEP axis (`system._host_step` via `step_fn`). Entities the
  wave touched get a fresh stamp whether the request was a get or an
  add — fall-throughs therefore re-arm the replica (self-healing).
- **Serve**: a replica read is served ONLY if the entity is hot
  (hit-count promotion within a window, TTL demotion) AND
  `step_fn() - published_step <= max_step_lag`. Any write that advances
  device steps without a publish for this entity pushes it past the
  bound and the read falls through to the authoritative wave — the
  bound cannot be exceeded by construction, only fallen through.
- **Replication**: totals travel as fixed-point integers (`scale`) in a
  PNCounterMap whose 1-entry updates gossip O(entry) via the op-based
  ORMap delta algebra (crdt.py); remote gateway nodes feed their cache
  through a replicator subscription. Writes linearize through the
  owning region's wave path, so publishes are effectively single-writer
  per entity; concurrent multi-gateway publishes of one entity can
  transiently deviate between publishes and are re-converged by the
  next publish (covered by the staleness fall-through).

Sheds and admission are charged identically to wave-served requests —
the replica branch runs strictly AFTER the admission charge.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["ReadReplicaCache", "REPLICA_KEY_ID"]

REPLICA_KEY_ID = "gw-replica-totals"

_STEP_PREFIX = "s:"  # map key of an entity's publish step


class ReadReplicaCache:
    """Hot-entity read replica over a ddata-replicated PNCounterMap.

    `step_fn` reads the shared ATT_STEP axis (the region system's
    `_host_step`). Without `system` the cache runs local-only: same
    promotion/staleness contract, no cross-node feed — the single-gateway
    fast path. A `system` without a cluster's replicator raises
    ValueError."""

    def __init__(self, step_fn: Callable[[], int], system=None,
                 key_id: str = REPLICA_KEY_ID,
                 hot_hits: int = 4, hot_window_s: float = 1.0,
                 hot_ttl_s: float = 5.0, max_step_lag: int = 64,
                 scale: float = 1e6, registry=None):
        self.step_fn = step_fn
        self.max_step_lag = int(max_step_lag)
        self.hot_hits = int(hot_hits)
        self.hot_window_s = float(hot_window_s)
        self.hot_ttl_s = float(hot_ttl_s)
        self.scale = float(scale)
        self._lock = threading.Lock()
        # entity -> (total, publish step): the local replica view. On the
        # publishing node it is updated synchronously at the wave
        # boundary; on peers it is fed by the replicator subscription.
        self._replica: Dict[str, Tuple[float, int]] = {}
        # promotion state: entity -> [hits_in_window, window_t0, last_hit]
        self._hits: Dict[str, List[float]] = {}
        self._hot: Dict[str, float] = {}  # entity -> last hit wall time
        self._stats = {"gets": 0, "replica_served": 0, "fallthrough_stale": 0,
                       "fallthrough_cold": 0, "promotions": 0, "demotions": 0,
                       "publishes": 0, "published_entities": 0,
                       "max_served_lag": 0, "staleness_violations": 0,
                       "restore_republishes": 0}
        self._h_lag = None
        if registry is not None:
            self._h_lag = registry.histogram(
                "gateway_replica_step_lag",
                "step lag of replica-served reads (ATT_STEP axis)")
        self._registry = registry
        # -- optional ddata feed ------------------------------------------
        self._replicator = None
        self._node_id = None
        self._key = None
        self._subscriber = None
        if system is not None:
            self._wire_ddata(system, key_id)

    def _wire_ddata(self, system, key_id: str) -> None:
        from ..cluster.cluster import Cluster
        from ..ddata import DistributedData, Key, Subscribe
        from ..ddata.replicator import unique_node_id
        try:
            dd = DistributedData.get(system)
            node_id = unique_node_id(Cluster.get(system).self_unique_address)
        except Exception as e:  # noqa: BLE001 — named in the refusal
            raise ValueError(
                "ReadReplicaCache(system=...) feeds the cache through the "
                "cluster's ddata replicator, which this system cannot run "
                f"({e!r}); build it without `system` for the local mode"
            ) from e
        self._replicator = dd.replicator
        self._key = Key(key_id)
        self._node_id = node_id
        from ..actor.props import Props
        cache = self

        from ..actor.actor import Actor
        from ..ddata import Changed

        class _ReplicaFeed(Actor):
            def receive(self, msg):
                if isinstance(msg, Changed):
                    cache._ingest_map(msg.data)
                return True

        self._subscriber = system.system_actor_of(
            Props(factory=_ReplicaFeed), f"gwReplicaFeed-{id(self):x}")
        self._replicator.tell(
            Subscribe(self._key, self._subscriber), self._subscriber)

    # ------------------------------------------------------------- feed side
    def _ingest_map(self, data) -> None:
        """Replicated map -> local replica view. Steps are monotonic per
        entity, so a stale notification can never roll a stamp back."""
        try:
            entries = dict(data.entries)  # each value computed once
        except Exception:
            return
        with self._lock:
            for k, v in entries.items():
                if k.startswith(_STEP_PREFIX) or v is None:
                    continue
                step = entries.get(_STEP_PREFIX + k)
                if step is None:
                    continue
                cur = self._replica.get(k)
                if cur is None or int(step) >= cur[1]:
                    self._replica[k] = (float(v) / self.scale, int(step))

    def publish_wave(self, totals: Dict[str, float]) -> None:
        """ONE batched publish per ask wave: the authoritative post-wave
        totals of the wave's ok outcomes, stamped with the current device
        step. Local view updates synchronously; the replicated map gets a
        single Update whose op delta carries only the touched entries."""
        if not totals:
            return
        step = int(self.step_fn())
        with self._lock:
            for e, total in totals.items():
                self._replica[e] = (float(total), step)
            self._stats["publishes"] += 1
            self._stats["published_entities"] += len(totals)
        if self._replicator is not None:
            self._publish_ddata(totals, step)

    def _publish_ddata(self, totals: Dict[str, float], step: int) -> None:
        from ..ddata import PNCounterMap, Update, WriteLocal
        node, scale = self._node_id, self.scale

        def modify(m):
            # every change of the wave in one copy of the map (the
            # reference increments entry by entry, copying the map each
            # time)
            changes = []
            for e, total in totals.items():
                fp = int(round(total * scale))
                cur = int(m.get(e) or 0)
                if fp != cur:
                    changes.append((e, fp - cur))
                sk = _STEP_PREFIX + e
                cs = int(m.get(sk) or 0)
                if step > cs:
                    changes.append((sk, step - cs))
            return m.increment_many(node, changes) if changes else m

        self._replicator.tell(
            Update(self._key, PNCounterMap.empty(), WriteLocal(),
                   modify=modify), self._subscriber)

    def republish_restored(self,
                           totals: Optional[Dict[str, float]]) -> None:
        """Durable-restore seam: after a restart or in-process failover
        replays the entity journal, the device rows hold the acked
        frontier — but this cache (and the replicated map feeding peer
        gateways) can still hold pre-crash post-wave totals whose step
        stamps read as FRESH against the restored `_host_step`, because
        the restored step lands near the crash frontier. Entries the
        journal covers are re-published at the NEW step (overwriting the
        stale stamp locally and in the replicated map); entries it does
        not cover are dropped, since they can only describe pre-crash
        unacked state — those reads fall through to the wave."""
        totals = dict(totals) if totals else {}
        with self._lock:
            for e in [e for e in self._replica if e not in totals]:
                del self._replica[e]
            self._stats["restore_republishes"] += 1
        if totals:
            self.publish_wave(totals)

    # ------------------------------------------------------------- read side
    def try_read(self, entity: str) -> Optional[Tuple[float, int]]:
        """Replica answer for a get, or None to fall through to the
        authoritative wave. Returns (total, step_lag) only when the
        entity is hot AND fresh within `max_step_lag` — the bound is
        enforced here, so a served read can never exceed it."""
        now = time.monotonic()
        with self._lock:
            self._stats["gets"] += 1
            hot = self._note_hit_locked(entity, now)
            if not hot:
                return None
            rec = self._replica.get(entity)
            if rec is None:
                self._stats["fallthrough_cold"] += 1
                return None
            total, pub_step = rec
            lag = int(self.step_fn()) - pub_step
            if lag < 0 or lag > self.max_step_lag:
                self._stats["fallthrough_stale"] += 1
                return None
            self._stats["replica_served"] += 1
            if lag > self._stats["max_served_lag"]:
                self._stats["max_served_lag"] = lag
            if lag > self.max_step_lag:  # unreachable by construction
                self._stats["staleness_violations"] += 1
        if self._h_lag is not None:
            self._h_lag.observe(
                float(lag),
                step=self._registry.step if self._registry else None)
        return total, lag

    def _note_hit_locked(self, entity: str, now: float) -> bool:
        """Hit-count promotion with TTL demotion. Returns hotness AFTER
        this hit."""
        last = self._hot.get(entity)
        if last is not None:
            if now - last > self.hot_ttl_s:
                del self._hot[entity]
                self._stats["demotions"] += 1
            else:
                self._hot[entity] = now
                return True
        rec = self._hits.get(entity)
        if rec is None or now - rec[1] > self.hot_window_s:
            rec = self._hits[entity] = [1.0, now, now]
        else:
            rec[0] += 1
            rec[2] = now
        if rec[0] >= self.hot_hits:
            del self._hits[entity]
            self._hot[entity] = now
            self._stats["promotions"] += 1
            return True
        return False

    def is_hot(self, entity: str) -> bool:
        with self._lock:
            last = self._hot.get(entity)
            return last is not None and \
                time.monotonic() - last <= self.hot_ttl_s

    # --------------------------------------------------------------- report
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out = dict(self._stats)
            out["hot_entities"] = len(self._hot)
            out["replica_entries"] = len(self._replica)
            out["max_step_lag"] = self.max_step_lag
            out["replicated"] = self._replicator is not None
            out["staleness_bound_held"] = \
                int(out["staleness_violations"] == 0)
        return out
