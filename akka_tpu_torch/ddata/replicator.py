"""Replicator: per-node actor replicating CRDTs with tunable consistency.

A copy of `akka_tpu/ddata/replicator.py` at commit c056b95 (host code, no
jax; the port keeps its own copy of every module it needs). Its changes: a
durable store without `durable.lmdb.dir` roots under
`tempfile.gettempdir()`, not `/tmp`; a gossip tick sends its status to
one random peer, not two; a digest sorts canonical forms in their natural
order where they compare, not by repr; anti-entropy re-ships a key that
both sides hold only once it has settled on both (no change within the
last `_SETTLE_S` seconds or `_COST_FACTOR` times its last digest's time,
`_settled`), and at most once per `_RESHIP_S` (or `_COST_FACTOR` times
the last re-ship's send time) to one peer. A status lists every key (a
hot one without its digest), so a key the peer lacks, and a key whose
delta stream from the sender has a gap at the peer, are shipped at the
next status whatever their heat.

Reference parity: akka-distributed-data/src/main/scala/akka/cluster/ddata/
Replicator.scala — Get/Update/Subscribe/Delete with consistency levels
(ReadLocal/ReadFrom/ReadMajority/ReadAll and the Write* mirror, :430-495),
periodic gossip of Status digests + Gossip payloads, delta propagation
(:877,1072-1079 / DeltaPropagationSelector.scala), deleted-key tombstones,
and pruning of removed nodes' contributions (PruningState.scala, simplified
here to leader-driven collapse without the two-phase performed/obsoleted
handshake).

Wire protocol between replicators (one per node, same actor path):
- _Status(digests)        gossip tick: my {key -> digest or None if hot}
- _Gossip(entries, reply) entries the peer lacked / had stale
- _DeltaPropagation({key -> delta}) cheap incremental updates
- _Read(key) / _ReadResult(envelope)      read-consistency fan-out
- _Write(key, envelope) / _WriteAck       write-consistency fan-out
"""

from __future__ import annotations

import hashlib
import os
import pickle
import random
import tempfile
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from ..actor.actor import Actor
from ..actor.messages import Terminated as ActorTerminated
from ..actor.props import Props
from ..actor.ref import ActorRef
from ..actor.system import ActorSystem, ExtensionId
from ..cluster.cluster import Cluster
from ..cluster.events import MemberEvent, MemberRemoved, MemberUp
from ..cluster.member import MemberStatus
from .crdt import DeltaReplicatedData, RemovedNodePruning, ReplicatedData
from .durable import DurableStore


# -- keys -------------------------------------------------------------------

@dataclass(frozen=True)
class Key:
    """Typed key (reference: Key.scala; GCounterKey etc. are just ids here)."""
    id: str

    def __str__(self):
        return self.id


def unique_node_id(ua) -> str:
    """CRDT node id for a cluster member incarnation: "addr#uid"."""
    return f"{ua.address_str}#{ua.uid}"


# -- consistency levels (reference: Replicator.scala:430-495) ---------------

@dataclass(frozen=True)
class ReadLocal:
    timeout: float = 0.0


@dataclass(frozen=True)
class ReadFrom:
    n: int
    timeout: float = 5.0


@dataclass(frozen=True)
class ReadMajority:
    timeout: float = 5.0
    min_cap: int = 0


@dataclass(frozen=True)
class ReadAll:
    timeout: float = 5.0


@dataclass(frozen=True)
class WriteLocal:
    timeout: float = 0.0


@dataclass(frozen=True)
class WriteTo:
    n: int
    timeout: float = 5.0


@dataclass(frozen=True)
class WriteMajority:
    timeout: float = 5.0
    min_cap: int = 0


@dataclass(frozen=True)
class WriteAll:
    timeout: float = 5.0


# -- user API messages ------------------------------------------------------

@dataclass(frozen=True)
class Get:
    key: Key
    consistency: Any = ReadLocal()
    request: Any = None


@dataclass(frozen=True)
class GetSuccess:
    key: Key
    data: ReplicatedData
    request: Any = None

    def get(self, key: Key) -> ReplicatedData:
        return self.data


@dataclass(frozen=True)
class NotFound:
    key: Key
    request: Any = None


@dataclass(frozen=True)
class GetFailure:
    """Read consistency not met within timeout."""
    key: Key
    request: Any = None


@dataclass(frozen=True)
class GetDataDeleted:
    key: Key
    request: Any = None


@dataclass(frozen=True)
class Update:
    key: Key
    initial: Optional[ReplicatedData]
    consistency: Any
    modify: Callable[[ReplicatedData], ReplicatedData]
    request: Any = None


@dataclass(frozen=True)
class UpdateSuccess:
    key: Key
    request: Any = None


@dataclass(frozen=True)
class UpdateTimeout:
    key: Key
    request: Any = None


@dataclass(frozen=True)
class ModifyFailure:
    key: Key
    error: str
    request: Any = None


@dataclass(frozen=True)
class UpdateDataDeleted:
    key: Key
    request: Any = None


@dataclass(frozen=True)
class Delete:
    key: Key
    consistency: Any = WriteLocal()
    request: Any = None


@dataclass(frozen=True)
class DeleteSuccess:
    key: Key
    request: Any = None


@dataclass(frozen=True)
class ReplicationDeleteFailure:
    key: Key
    request: Any = None


@dataclass(frozen=True)
class DataDeleted:
    key: Key
    request: Any = None


@dataclass(frozen=True)
class Subscribe:
    key: Key
    subscriber: ActorRef


@dataclass(frozen=True)
class Unsubscribe:
    key: Key
    subscriber: ActorRef


@dataclass(frozen=True)
class Changed:
    key: Key
    data: ReplicatedData

    def get(self, key: Key) -> ReplicatedData:
        return self.data


@dataclass(frozen=True)
class Deleted:
    key: Key


@dataclass(frozen=True)
class GetKeyIds:
    pass


@dataclass(frozen=True)
class GetKeyIdsResult:
    key_ids: frozenset


@dataclass(frozen=True)
class GetReplicaCount:
    pass


@dataclass(frozen=True)
class ReplicaCount:
    n: int


# -- internal wire messages -------------------------------------------------

DELETED = "__deleted__"  # tombstone sentinel in the data map


@dataclass(frozen=True)
class _Status:
    # every key the sender holds: its digest, or None while the key is hot
    # at the sender (its deltas carry it; see Replicator._settled)
    digests: Dict[str, Optional[bytes]]
    from_addr: str
    origin_uid: str = ""   # sender replicator incarnation (cursor scope)


@dataclass(frozen=True)
class _Gossip:
    entries: Dict[str, Any]   # key -> data-or-DELETED (pickled-safe CRDTs)
    want_keys: Tuple[str, ...]  # keys the sender lacks and wants back
    from_addr: str
    tombstones: Dict[str, Tuple[str, ...]] = field(default_factory=dict)
    # sender's per-key delta sequence at send time: a full state entry
    # covers every op up to this seq, so the receiver resyncs its
    # (origin, key) delta cursor and resumes op-based deltas after a gap
    # (reference: delta versions riding the gossiped DataEnvelope)
    delta_seq: Dict[str, int] = field(default_factory=dict)
    origin_uid: str = ""   # sender replicator incarnation (cursor scope)


@dataclass(frozen=True)
class _DeltaPropagation:
    """deltas: key -> (seq, delta). Op-based deltas are only safe under
    CAUSAL delivery — the per-(origin, key) sequence number lets receivers
    detect a gap (dropped tick, late join) and fall back to full-state
    gossip instead of applying an op whose causal context they miss
    (reference: DeltaPropagationSelector seqNr discipline; applying a
    gapped ORSet op poisons the vvector and deletes the missed elements
    cluster-wide)."""
    deltas: Dict[str, Any]
    from_addr: str
    origin_uid: str = ""   # sender replicator incarnation (cursor scope)


@dataclass(frozen=True)
class _Read:
    key: str
    req_id: str


@dataclass(frozen=True)
class _ReadResult:
    req_id: str
    data: Any  # data | DELETED | None


@dataclass(frozen=True)
class _Write:
    key: str
    data: Any  # data | DELETED
    req_id: str


@dataclass(frozen=True)
class _WriteAck:
    req_id: str


@dataclass(frozen=True)
class _Pruned:
    """Leader pruned `removed`'s contributions out of `key` (simplified
    PruningPerformed dissemination)."""
    key: str
    removed: Tuple[str, ...]
    data: Any
    from_addr: str


@dataclass(frozen=True)
class _GossipTick:
    pass


@dataclass(frozen=True)
class _NotifyTick:
    pass


@dataclass(frozen=True)
class _DeltaTick:
    pass


@dataclass(frozen=True)
class _PruneTick:
    pass


@dataclass(frozen=True)
class _ReqTimeout:
    req_id: str


@dataclass(frozen=True)
class ReplicatorSettings:
    """(reference: ReplicatorSettings.scala)"""
    role: Optional[str] = None
    gossip_interval: float = 2.0
    notify_subscribers_interval: float = 0.5
    delta_propagation_interval: float = 0.2
    pruning_interval: float = 30.0
    max_pruning_dissemination: float = 60.0
    durable_keys: Tuple[str, ...] = ()
    durable_store_dir: Optional[str] = None

    @staticmethod
    def from_config(cfg) -> "ReplicatorSettings":
        return ReplicatorSettings(
            role=cfg.get_string("role", "") or None,
            gossip_interval=cfg.get_duration("gossip-interval", "2s"),
            notify_subscribers_interval=cfg.get_duration(
                "notify-subscribers-interval", "0.5s"),
            delta_propagation_interval=cfg.get_duration(
                "delta-crdt.delta-propagation-interval", "0.2s"),
            pruning_interval=cfg.get_duration("pruning-interval", "30s"),
            durable_keys=tuple(cfg.get("durable.keys", []) or []),
            durable_store_dir=cfg.get_string("durable.lmdb.dir", "") or None)


class _PendingReq:
    """In-flight read/write consistency round."""

    __slots__ = ("kind", "key", "replyto", "request", "needed", "acks",
                 "acc", "local", "timer")

    def __init__(self, kind, key, replyto, request, needed, local):
        self.kind = kind          # "read" | "write" | "delete"
        self.key = key
        self.replyto = replyto
        self.request = request
        self.needed = needed      # remote acks still required
        self.acks = 0
        self.acc = local          # merged data (reads)
        self.local = local
        self.timer = None


# seconds a key must rest before anti-entropy compares it by digest (at
# least one gossip interval, and _COST_FACTOR times what its digest last
# took)
_SETTLE_S = 2.0
# seconds between two re-ships of keys both sides hold to one peer (at
# least _COST_FACTOR times what the last one took to send), and before a
# want of one key from one peer that was not answered is asked again
_RESHIP_S = 1.0
# anti-entropy spends at most about 1/_COST_FACTOR of a replicator's time
# on one key's digest, or on re-shipping full states to one peer
_COST_FACTOR = 8.0


class Replicator(Actor):
    """One per node (reference: Replicator.scala actor)."""

    def __init__(self, settings: Optional[ReplicatorSettings] = None):
        super().__init__()
        self.settings = settings or ReplicatorSettings()
        self.cluster = Cluster.get(self.context.system)
        self.self_addr = str(self.context.system.provider.default_address)
        # CRDT node id: "addr#uid" so a restarted node (same host:port, new
        # incarnation) is a distinct contributor and is never hit by the old
        # incarnation's pruning tombstone (reference: SelfUniqueAddress)
        self.self_unique = unique_node_id(self.cluster.self_unique_address)
        # key -> data | DELETED sentinel
        self.data: Dict[str, Any] = {}
        self.subscribers: Dict[str, Set[ActorRef]] = {}
        self.changed_keys: Set[str] = set()
        self.pending: Dict[str, _PendingReq] = {}
        self.deltas: Dict[str, Any] = {}  # key -> accumulated delta for peers
        self.delta_seq: Dict[str, int] = {}        # key -> my last sent seq
        # delta cursors key on the origin's INCARNATION, not its bare
        # address: a restarted origin's fresh seq stream (1, 2, ...) would
        # otherwise be swallowed as duplicates by the old cursor and its
        # first genuinely-applied op would smuggle the unseen events'
        # vvector in — precisely the poisoning the gap guard prevents
        self._delta_incarnation = uuid.uuid4().hex
        self._delta_seen: Dict[Tuple[str, str, str], int] = {}
        self._delta_gapped: set = set()   # (origin, origin_uid, key)
        self._origin_uid: Dict[str, str] = {}  # origin addr -> last uid
        # key -> {pruned node id -> prune time}; incoming merges are cleaned
        # against these so stale gossip can't resurrect a removed node's
        # entries (reference: PruningState tombstones); expired after
        # max_pruning_dissemination since uid-based ids can't recur
        self.pruned: Dict[str, Dict[str, float]] = {}
        # unique ids of members the cluster REMOVED (only these are ever
        # pruned — application-chosen logical CRDT node ids never are)
        self.removed_nodes: Set[str] = set()
        self._digest_cache: Dict[str, bytes] = {}
        # key -> monotonic time of its last change: anti-entropy skips a
        # key that changed within the last gossip interval (see _settled)
        self._changed_at: Dict[str, float] = {}
        self._digest_s: Dict[str, float] = {}     # key -> last digest's s
        # peer -> the monotonic time before which no key both hold is
        # re-shipped to it
        self._ship_after: Dict[str, float] = {}
        # (peer, key) -> monotonic time of our last want of it from peer
        self._wanted_at: Dict[Tuple[str, str], float] = {}
        # gossip-size observability: payload bytes per propagation tick and
        # the op-delta-vs-full-state ratio, step-stamped on the shared
        # ATT_STEP axis so the O(entry) claim is visible in the metrics
        # plane (docs/OBSERVABILITY.md)
        reg = getattr(self.context.system, "metrics_registry", None)
        self._metrics = reg
        self._h_gossip_bytes = reg.histogram(
            "ddata_gossip_payload_bytes",
            "bytes per outbound replication payload (delta tick or "
            "full-state gossip)") if reg is not None else None
        self._h_delta_vs_full = reg.histogram(
            "ddata_delta_vs_full",
            "per-key op-delta size as a fraction of the full-state size, "
            "observed per delta-propagation tick") if reg is not None else None
        self._cluster_listener = lambda e: self.self_ref.tell(e)
        self._tasks: List[Any] = []
        self.durable = None
        if self.settings.durable_keys:
            self.durable = DurableStore(
                self.settings.durable_store_dir
                or os.path.join(
                    tempfile.gettempdir(),
                    f"akka-tpu-ddata-{self.context.system.name}-"
                    f"{self.self_addr.replace('/', '_').replace(':', '_')}"))
            for k, v in self.durable.load_all().items():
                self.data[k] = v

    # -- lifecycle -----------------------------------------------------------
    def pre_start(self) -> None:
        sched = self.context.system.scheduler
        s = self.settings
        self._tasks = [
            sched.schedule_tell_with_fixed_delay(
                s.gossip_interval, s.gossip_interval, self.self_ref, _GossipTick()),
            sched.schedule_tell_with_fixed_delay(
                s.delta_propagation_interval, s.delta_propagation_interval,
                self.self_ref, _DeltaTick()),
            sched.schedule_tell_with_fixed_delay(
                s.pruning_interval, s.pruning_interval, self.self_ref, _PruneTick()),
            sched.schedule_tell_with_fixed_delay(
                s.notify_subscribers_interval, s.notify_subscribers_interval,
                self.self_ref, _NotifyTick()),
        ]
        self.cluster.subscribe(self._cluster_listener, MemberEvent,
                               initial_state=False)

    def post_stop(self) -> None:
        self.cluster.unsubscribe(self._cluster_listener)
        for t in self._tasks:
            t.cancel()

    # -- membership helpers --------------------------------------------------
    def _nodes(self) -> List[str]:
        """Other Up nodes carrying the configured role."""
        out = []
        for m in self.cluster.state.members:
            if m.status not in (MemberStatus.UP, MemberStatus.WEAKLY_UP):
                continue
            if self.settings.role and self.settings.role not in m.roles:
                continue
            a = str(m.address)
            if a != self.self_addr:
                out.append(a)
        return out

    def _replicator_at(self, addr: str) -> ActorRef:
        rel = self.context.self_ref.path.to_string_without_address()
        return self.context.system.provider.resolve_actor_ref(f"{addr}{rel}")

    def _required_acks(self, consistency, n_nodes_total: int) -> int:
        """Remote acks needed beyond the local write/read."""
        if isinstance(consistency, (ReadLocal, WriteLocal)):
            return 0
        if isinstance(consistency, ReadFrom):
            return max(0, min(consistency.n - 1, n_nodes_total - 1))
        if isinstance(consistency, WriteTo):
            return max(0, min(consistency.n - 1, n_nodes_total - 1))
        if isinstance(consistency, (ReadMajority, WriteMajority)):
            majority = n_nodes_total // 2 + 1
            cap = getattr(consistency, "min_cap", 0)
            return max(0, min(max(majority, cap), n_nodes_total) - 1)
        if isinstance(consistency, (ReadAll, WriteAll)):
            return n_nodes_total - 1
        raise ValueError(f"unknown consistency {consistency!r}")

    # -- digest/gossip helpers ----------------------------------------------
    @classmethod
    def _canon(cls, obj: Any) -> Any:
        """Canonicalize nested state so semantically equal replicas hash
        equal regardless of dict/set insertion order (merge(a,b) and
        merge(b,a) build dicts in different orders)."""
        if isinstance(obj, dict):
            return ("d",) + cls._ordered(
                [(cls._canon(k), cls._canon(v)) for k, v in obj.items()])
        if isinstance(obj, (set, frozenset)):
            return ("s",) + cls._ordered([cls._canon(e) for e in obj])
        if isinstance(obj, (list, tuple)):
            return ("l",) + tuple(cls._canon(e) for e in obj)
        if isinstance(obj, (str, int, float, bool, bytes, type(None))):
            return obj
        from ..actor.ref import ActorRef
        if isinstance(obj, ActorRef):
            # by serialized full-address path: the SAME logical ref is a
            # LocalActorRef on its home node and a RemoteActorRef on peers
            # — attribute-walking would never hash equal across them
            from ..serialization.codec import ref_wire_path
            return ("r", ref_wire_path(obj))
        # CRDTs / VersionVector: class name + attrs, skipping delta caches
        attrs = {}
        for slot in getattr(type(obj), "__slots__", ()) or ():
            if slot.startswith("_"):
                continue
            attrs[slot] = getattr(obj, slot, None)
        for k, v in getattr(obj, "__dict__", {}).items():
            if not k.startswith("_"):
                attrs[k] = v
        if attrs:
            return (type(obj).__name__,) + cls._canon(attrs)
        return repr(obj)

    @staticmethod
    def _ordered(items: list) -> tuple:
        """Canonical forms in their natural order, or by repr where they do
        not compare (a port change: the reference sorts by repr always,
        which spent most of a small CRDT's digest on building reprs; port
        nodes compare digests only with port nodes)."""
        try:
            return tuple(sorted(items))
        except TypeError:
            return tuple(sorted(items, key=repr))

    @classmethod
    def _digest(cls, data: Any) -> bytes:
        # digest the canonical form with the FIXED wire codec, not pickle:
        # these bytes are compared across nodes, so the encoding must be
        # stable across Python versions (pickle's isn't)
        from ..serialization.codec import dumps as _wire_dumps
        return hashlib.sha1(_wire_dumps(cls._canon(data))).digest()

    def _digest_for(self, key: str) -> bytes:
        """Per-key digest, cached until the next _set_data (the reference
        Replicator caches digests the same way — steady-state gossip must
        not re-hash the whole data map). Digests are COMPARED across nodes,
        so embedded ActorRefs must hash by full-address path — install the
        transport context like any other wire encode."""
        d = self._digest_cache.get(key)
        if d is None:
            from ..serialization.serialization import transport_information
            provider = getattr(self.context.system, "provider", None)
            t0 = time.monotonic()
            with transport_information(provider):
                d = self._digest_cache[key] = self._digest(self.data[key])
            self._digest_s[key] = time.monotonic() - t0
        return d

    def _set_data(self, key: str, value: Any, notify: bool = True) -> None:
        old = self.data.get(key)
        self.data[key] = value
        self._digest_cache.pop(key, None)
        self._changed_at[key] = time.monotonic()
        if self.durable is not None and self._is_durable(key):
            self.durable.store(key, value)
        if notify and old is not value:
            self.changed_keys.add(key)  # flushed on _NotifyTick

    def _is_durable(self, key: str) -> bool:
        for pat in self.settings.durable_keys:
            if pat == key or (pat.endswith("*") and key.startswith(pat[:-1])):
                return True
        return False

    def _flush_changes(self) -> None:
        for key in list(self.changed_keys):
            subs = self.subscribers.get(key)
            cur = self.data.get(key)
            if subs and cur is not None:
                msg = Deleted(Key(key)) if cur == DELETED else Changed(Key(key), cur)
                for ref in list(subs):
                    ref.tell(msg, self.self_ref)
        self.changed_keys.clear()

    def _merge_in(self, key: str, incoming: Any) -> None:
        cur = self.data.get(key)
        if incoming == DELETED or cur == DELETED:
            merged = DELETED
        else:
            incoming = self._cleanup_pruned(key, incoming)
            if cur is None:
                merged = incoming
            else:
                merged = self._cleanup_pruned(key, cur).merge(incoming)
        if merged != cur:
            self._set_data(key, merged)
            if merged == DELETED:
                # remote delete (a _Write/_Gossip carried the tombstone):
                # drop the key's delta bookkeeping exactly as the local
                # Delete path does — dead keys must not pin cursors, and
                # a pending accumulated delta for them is never sent
                self.deltas.pop(key, None)
                self.delta_seq.pop(key, None)
                self._drop_delta_cursors(key=key)

    def _cleanup_pruned(self, key: str, value: Any) -> Any:
        """Drop tombstoned nodes' residual entries from stale incoming state
        so pruning can't be undone by old gossip."""
        removed = self.pruned.get(key)
        if removed and isinstance(value, RemovedNodePruning):
            for node in removed:
                value = value.prune_cleanup(node)
        return value

    # -- receive -------------------------------------------------------------
    def receive(self, message: Any) -> Any:  # noqa: C901
        if isinstance(message, Get):
            self._handle_get(message)
        elif isinstance(message, Update):
            self._handle_update(message)
        elif isinstance(message, Delete):
            self._handle_delete(message)
        elif isinstance(message, Subscribe):
            self.subscribers.setdefault(message.key.id, set()).add(message.subscriber)
            self.context.watch(message.subscriber)
            cur = self.data.get(message.key.id)
            if cur == DELETED:
                message.subscriber.tell(Deleted(message.key), self.self_ref)
            elif cur is not None:
                message.subscriber.tell(Changed(message.key, cur), self.self_ref)
        elif isinstance(message, Unsubscribe):
            self.subscribers.get(message.key.id, set()).discard(message.subscriber)
            if not any(message.subscriber in subs
                       for subs in self.subscribers.values()):
                self.context.unwatch(message.subscriber)
        elif isinstance(message, ActorTerminated):
            for subs in self.subscribers.values():
                subs.discard(message.actor)
        elif isinstance(message, GetKeyIds):
            ids = frozenset(k for k, v in self.data.items() if v != DELETED)
            self.sender.tell(GetKeyIdsResult(ids), self.self_ref)
        elif isinstance(message, GetReplicaCount):
            self.sender.tell(ReplicaCount(len(self._nodes()) + 1), self.self_ref)
        # -- internal ticks ---------------------------------------------------
        elif isinstance(message, _NotifyTick):
            self._flush_changes()
        elif isinstance(message, _GossipTick):
            self._gossip_tick()
        elif isinstance(message, _DeltaTick):
            self._delta_tick()
        elif isinstance(message, _PruneTick):
            self._prune_tick()
        elif isinstance(message, _ReqTimeout):
            self._req_timeout(message.req_id)
        # -- wire -------------------------------------------------------------
        elif isinstance(message, _Status):
            self._handle_status(message)
        elif isinstance(message, _Gossip):
            self._handle_gossip(message)
        elif isinstance(message, _DeltaPropagation):
            origin, uid = message.from_addr, message.origin_uid
            if self._origin_uid.get(origin) != uid:
                # new origin incarnation: its old cursors are dead weight
                # (and must never swallow the fresh stream as duplicates)
                self._drop_delta_cursors(origin=origin)
                self._origin_uid[origin] = uid
            for key, entry in message.deltas.items():
                seq, delta = entry
                ok_pair = (origin, uid, key)
                if ok_pair in self._delta_gapped:
                    continue  # full-state gossip owns this key from origin
                seen = self._delta_seen.get(ok_pair, 0)
                if seq <= seen:
                    continue  # duplicate/old tick
                if seq != seen + 1:
                    # GAP: applying an op whose causal context we miss
                    # would poison the vvector (delete the missed ops'
                    # elements everywhere). Drop, and let digest gossip
                    # carry this key until a full state resyncs the cursor
                    self._delta_gapped.add(ok_pair)
                    continue
                cur = self.data.get(key)
                if cur == DELETED:
                    continue  # no cursor bumps for dead keys
                if cur is None:
                    # first sight of the key via a delta: op-based deltas
                    # apply against their zero (ReplicatedDelta.zero);
                    # full-state deltas ARE data
                    zero = getattr(delta, "zero", None)
                    self._merge_in(key, zero().merge_delta(delta)
                                   if zero is not None else delta)
                elif isinstance(cur, DeltaReplicatedData):
                    merged = cur.merge_delta(delta)
                    if merged != cur:
                        self._set_data(key, merged)
                else:
                    self._merge_in(key, delta)
                self._delta_seen[ok_pair] = seq
        elif isinstance(message, _Read):
            self.sender.tell(_ReadResult(message.req_id,
                                         self.data.get(message.key)),
                             self.self_ref)
        elif isinstance(message, _ReadResult):
            self._handle_read_result(message)
        elif isinstance(message, _Write):
            self._merge_in(message.key, message.data)
            self.sender.tell(_WriteAck(message.req_id), self.self_ref)
        elif isinstance(message, _WriteAck):
            self._handle_write_ack(message)
        elif isinstance(message, _Pruned):
            _ts = self.pruned.setdefault(message.key, {})
            _now = time.time()
            for _n in message.removed:
                _ts.setdefault(_n, _now)
            cur = self.data.get(message.key)
            if (cur is not None and cur != DELETED
                    and isinstance(cur, RemovedNodePruning)):
                cleaned = cur
                for n in message.removed:
                    cleaned = cleaned.prune_cleanup(n)
                if cleaned != cur:
                    self._set_data(message.key, cleaned, notify=False)
            self._merge_in(message.key, message.data)
        elif isinstance(message, MemberRemoved):
            self.removed_nodes.add(unique_node_id(message.member.unique_address))
            gone = str(message.member.unique_address.address)
            self._drop_delta_cursors(origin=gone)
            self._origin_uid.pop(gone, None)
        elif isinstance(message, MemberEvent):
            pass
        else:
            return self.unhandled(message)

    # -- user ops ------------------------------------------------------------
    def _handle_get(self, msg: Get) -> None:
        key, replyto = msg.key.id, self.sender
        local = self.data.get(key)
        if isinstance(msg.consistency, ReadLocal) or not self._nodes():
            self._reply_get(msg.key, local, replyto, msg.request)
            return
        needed = self._required_acks(msg.consistency, len(self._nodes()) + 1)
        if needed == 0:
            self._reply_get(msg.key, local, replyto, msg.request)
            return
        req_id = uuid.uuid4().hex
        req = _PendingReq("read", msg.key, replyto, msg.request, needed, local)
        self.pending[req_id] = req
        self._start_timeout(req_id, msg.consistency.timeout)
        for addr in self._nodes():
            self._replicator_at(addr).tell(_Read(key, req_id), self.self_ref)

    def _reply_get(self, key: Key, value: Any, replyto: ActorRef, request) -> None:
        if value == DELETED:
            replyto.tell(GetDataDeleted(key, request), self.self_ref)
        elif value is None:
            replyto.tell(NotFound(key, request), self.self_ref)
        else:
            replyto.tell(GetSuccess(key, value, request), self.self_ref)

    def _handle_update(self, msg: Update) -> None:
        key, replyto = msg.key.id, self.sender
        cur = self.data.get(key)
        if cur == DELETED:
            replyto.tell(UpdateDataDeleted(msg.key, msg.request), self.self_ref)
            return
        try:
            base = cur if cur is not None else msg.initial
            if base is None:
                raise KeyError(f"no initial value for new key {key}")
            new = msg.modify(base)
        except Exception as e:  # noqa: BLE001 (reference: ModifyFailure)
            replyto.tell(ModifyFailure(msg.key, str(e), msg.request), self.self_ref)
            return
        # harvest + reset delta before storing (reference :1072-1079)
        if isinstance(new, DeltaReplicatedData) and new.delta is not None:
            d = new.delta
            acc = self.deltas.get(key)
            self.deltas[key] = d if acc is None else acc.merge(d)
            new = new.reset_delta()
        self._set_data(key, new)
        nodes = self._nodes()
        needed = self._required_acks(msg.consistency, len(nodes) + 1)
        if needed == 0:
            replyto.tell(UpdateSuccess(msg.key, msg.request), self.self_ref)
            return
        req_id = uuid.uuid4().hex
        req = _PendingReq("write", msg.key, replyto, msg.request, needed, new)
        self.pending[req_id] = req
        self._start_timeout(req_id, msg.consistency.timeout)
        for addr in nodes:
            self._replicator_at(addr).tell(_Write(key, new, req_id), self.self_ref)

    def _handle_delete(self, msg: Delete) -> None:
        key, replyto = msg.key.id, self.sender
        if self.data.get(key) == DELETED:
            replyto.tell(DataDeleted(msg.key, msg.request), self.self_ref)
            return
        self._set_data(key, DELETED)
        self.deltas.pop(key, None)
        self.delta_seq.pop(key, None)
        self._drop_delta_cursors(key=key)
        nodes = self._nodes()
        needed = self._required_acks(msg.consistency, len(nodes) + 1)
        if needed == 0:
            replyto.tell(DeleteSuccess(msg.key, msg.request), self.self_ref)
            return
        req_id = uuid.uuid4().hex
        req = _PendingReq("delete", msg.key, replyto, msg.request, needed, DELETED)
        self.pending[req_id] = req
        self._start_timeout(req_id, msg.consistency.timeout)
        for addr in nodes:
            self._replicator_at(addr).tell(_Write(key, DELETED, req_id), self.self_ref)

    def _start_timeout(self, req_id: str, timeout: float) -> None:
        self.pending[req_id].timer = \
            self.context.system.scheduler.schedule_tell_once(
                timeout, self.self_ref, _ReqTimeout(req_id))

    def _req_timeout(self, req_id: str) -> None:
        req = self.pending.pop(req_id, None)
        if req is None:
            return
        if req.kind == "read":
            # reply with best-effort merged data? reference: GetFailure
            req.replyto.tell(GetFailure(req.key, req.request), self.self_ref)
        elif req.kind == "write":
            req.replyto.tell(UpdateTimeout(req.key, req.request), self.self_ref)
        else:
            req.replyto.tell(ReplicationDeleteFailure(req.key, req.request),
                             self.self_ref)

    def _handle_read_result(self, msg: _ReadResult) -> None:
        req = self.pending.get(msg.req_id)
        if req is None:
            return
        if msg.data is not None:
            if msg.data == DELETED or req.acc == DELETED:
                req.acc = DELETED
            elif req.acc is None:
                req.acc = msg.data
            else:
                req.acc = req.acc.merge(msg.data)
        req.acks += 1
        if req.acks >= req.needed:
            self.pending.pop(msg.req_id, None)
            if req.timer:
                req.timer.cancel()
            if req.acc is not None and req.acc != req.local:
                self._merge_in(req.key.id, req.acc)  # read-repair
            self._reply_get(req.key, req.acc, req.replyto, req.request)

    def _handle_write_ack(self, msg: _WriteAck) -> None:
        req = self.pending.get(msg.req_id)
        if req is None:
            return
        req.acks += 1
        if req.acks >= req.needed:
            self.pending.pop(msg.req_id, None)
            if req.timer:
                req.timer.cancel()
            if req.kind == "delete":
                req.replyto.tell(DeleteSuccess(req.key, req.request), self.self_ref)
            else:
                req.replyto.tell(UpdateSuccess(req.key, req.request), self.self_ref)

    # -- gossip --------------------------------------------------------------
    def _settled(self, key: str, now: float) -> bool:
        """A key that changed within the last `_SETTLE_S` seconds (or
        gossip interval, if longer) is hot: its deltas carry it, and the
        digest comparison of anti-entropy (the digest in a status, the
        re-ship of a key both sides hold) waits until it settles. A port
        change: the reference digests and ships every differing key at
        every tick, and a large map that changes at every tick is then
        digested anew, and shipped whole, at each one. A key a peer lacks,
        or has a delta gap on, is shipped hot or not (_handle_status)."""
        return now - self._changed_at.get(key, 0.0) >= max(
            _SETTLE_S, self.settings.gossip_interval,
            _COST_FACTOR * self._digest_s.get(key, 0.0))

    def _gossip_tick(self) -> None:
        nodes = self._nodes()
        if not nodes or not self.data:
            return
        now = time.monotonic()
        digests = {k: self._digest_for(k) if self._settled(k, now) else None
                   for k in self.data}
        # one random peer a tick, as Akka's Replicator gossips (the
        # reference sends to two: each status is encoded per send)
        self._replicator_at(random.choice(nodes)).tell(
            _Status(digests, self.self_addr, self._delta_incarnation),
            self.self_ref)

    def _handle_status(self, msg: _Status) -> None:
        peer = msg.from_addr
        now = time.monotonic()
        # entries the peer lacks -> send ours, hot or not
        to_send = {k: v for k, v in self.data.items()
                   if k not in msg.digests}
        # entries both hold and differ on -> re-ship ours, once the key has
        # settled on both sides and the peer's re-ship interval has passed
        reship = {}
        if now >= self._ship_after.get(peer, 0.0):
            for k, d in msg.digests.items():
                if d is not None and k in self.data and \
                        self._settled(k, now) and d != self._digest_for(k):
                    reship[k] = self.data[k]
        # keys the peer has that we lack, or whose delta stream from the
        # peer has a gap here -> ask for exactly those back (a want is
        # answered at once; one not answered is asked again after
        # _RESHIP_S)
        gapped = {p[2] for p in self._delta_gapped
                  if p[0] == peer and p[1] == msg.origin_uid}
        want = [k for k in msg.digests
                if (k not in self.data or k in gapped)
                and now - self._wanted_at.get((peer, k), -_RESHIP_S)
                >= _RESHIP_S]
        for k in want:
            self._wanted_at[(peer, k)] = now
        to_send.update(reship)
        if to_send or want:
            self._observe_gossip_bytes(to_send)
            t0 = time.monotonic()
            self._replicator_at(peer).tell(
                _Gossip(to_send, want_keys=tuple(want),
                        from_addr=self.self_addr,
                        tombstones=self._tombstones_wire(),
                        delta_seq=self._delta_seq_for(to_send),
                        origin_uid=self._delta_incarnation),
                self.self_ref)
            if reship:
                t1 = time.monotonic()
                self._ship_after[peer] = t1 + max(
                    _RESHIP_S, _COST_FACTOR * (t1 - t0))

    def _handle_gossip(self, msg: _Gossip) -> None:
        now = time.time()
        for k, removed in msg.tombstones.items():
            ts = self.pruned.setdefault(k, {})
            fresh = [n for n in removed if n not in ts]
            for n in removed:
                ts.setdefault(n, now)
            cur = self.data.get(k)
            if fresh and cur is not None and cur != DELETED:
                cleaned = self._cleanup_pruned(k, cur)
                if cleaned != cur:
                    self._set_data(k, cleaned, notify=False)
        for k, v in msg.entries.items():
            self._wanted_at.pop((msg.from_addr, k), None)
            self._merge_in(k, v)
            if self.data.get(k) == DELETED:
                continue  # dead key: no cursor resync (see _merge_in prune)
            if k in msg.delta_seq and msg.origin_uid:
                # the full state covers every op of the sender up to this
                # seq: resync the delta cursor and resume op-based deltas
                # (duplicate re-application is safe — CRDT merges are
                # idempotent; only GAPS are dangerous)
                if self._origin_uid.get(msg.from_addr) != msg.origin_uid:
                    self._drop_delta_cursors(origin=msg.from_addr)
                    self._origin_uid[msg.from_addr] = msg.origin_uid
                pair = (msg.from_addr, msg.origin_uid, k)
                self._delta_seen[pair] = max(
                    self._delta_seen.get(pair, 0), msg.delta_seq[k])
                self._delta_gapped.discard(pair)
        if msg.want_keys:
            back = {k: self.data[k] for k in msg.want_keys if k in self.data}
            if back:
                self._observe_gossip_bytes(back)
                self._replicator_at(msg.from_addr).tell(
                    _Gossip(back, want_keys=(), from_addr=self.self_addr,
                            tombstones=self._tombstones_wire(),
                            delta_seq=self._delta_seq_for(back),
                            origin_uid=self._delta_incarnation),
                    self.self_ref)

    def _observe_gossip_bytes(self, entries: Dict[str, Any]) -> None:
        if self._h_gossip_bytes is None or not entries:
            return
        from ..serialization.codec import WireCodecError, dumps
        try:
            self._h_gossip_bytes.observe(float(len(dumps(entries))),
                                         step=self._metrics.step)
        except WireCodecError:
            pass

    def _delta_seq_for(self, entries: Dict[str, Any]) -> Dict[str, int]:
        return {k: self.delta_seq[k] for k in entries if k in self.delta_seq}

    def _drop_delta_cursors(self, origin: Optional[str] = None,
                            key: Optional[str] = None) -> None:
        """Prune delta bookkeeping: by origin (node removed / new
        incarnation) or by key (deleted) — the cursors must not grow with
        cluster/key churn."""
        def dead(pair) -> bool:
            return (origin is not None and pair[0] == origin) or \
                (key is not None and pair[2] == key)
        for pair in [p for p in self._delta_seen if dead(p)]:
            del self._delta_seen[pair]
        self._delta_gapped = {p for p in self._delta_gapped if not dead(p)}
        for pk in [pk for pk in self._wanted_at
                   if pk[0] == origin or pk[1] == key]:
            del self._wanted_at[pk]

    def _tombstones_wire(self) -> Dict[str, Tuple[str, ...]]:
        return {k: tuple(v) for k, v in self.pruned.items()}

    def _delta_tick(self) -> None:
        if not self.deltas:
            return
        nodes = self._nodes()
        if nodes:
            payload = {}
            for k, d in self.deltas.items():
                self.delta_seq[k] = self.delta_seq.get(k, 0) + 1
                payload[k] = (self.delta_seq[k], d)
            self._observe_delta_sizes(payload)
            for addr in nodes:
                self._replicator_at(addr).tell(
                    _DeltaPropagation(payload, self.self_addr,
                                      self._delta_incarnation), self.self_ref)
        self.deltas.clear()

    def _observe_delta_sizes(self, payload: Dict[str, Any]) -> None:
        """Per propagation tick: outbound payload bytes + each key's
        op-delta-size : full-state-size ratio (the O(entry) evidence)."""
        if self._h_gossip_bytes is None:
            return
        from ..serialization.codec import WireCodecError, dumps
        step = self._metrics.step
        try:
            self._h_gossip_bytes.observe(float(len(dumps(payload))), step=step)
            for k, (_seq, d) in payload.items():
                full = self.data.get(k)
                if full is None or full == DELETED:
                    continue
                full_n = len(dumps(full))
                if full_n:
                    self._h_delta_vs_full.observe(
                        len(dumps(d)) / full_n, step=step)
        except WireCodecError:
            pass  # unsized payloads must never break propagation

    # -- pruning (simplified leader-driven collapse) -------------------------
    def _prune_tick(self) -> None:
        self._expire_tombstones()
        state = self.cluster.state
        if state.leader is None or state.leader.address_str != self.self_addr:
            return
        if not self.removed_nodes:
            return
        now = time.time()
        for key, value in list(self.data.items()):
            if value == DELETED or not isinstance(value, RemovedNodePruning):
                continue
            # only ids of members the cluster actually removed are pruned —
            # never application-chosen logical CRDT node ids
            pruned_nodes = [n for n in self.removed_nodes
                            if value.needs_pruning_from(n)]
            if not pruned_nodes:
                continue
            for node in pruned_nodes:
                value = value.prune(node, self.self_unique)
            ts = self.pruned.setdefault(key, {})
            for node in pruned_nodes:
                ts[node] = now
            self._set_data(key, value)
            # disseminate: peers record the tombstone, clean their local
            # copy, and merge the collapsed state — stale gossip of the
            # removed node's entries is then filtered by _merge_in
            for addr in self._nodes():
                self._replicator_at(addr).tell(
                    _Pruned(key, tuple(pruned_nodes), value, self.self_addr),
                    self.self_ref)

    def _expire_tombstones(self) -> None:
        """Tombstones only need to outlive in-flight stale gossip; uid-based
        node ids cannot recur, so expiry after max_pruning_dissemination is
        safe and bounds tombstone growth (reference: PruningState obsoleting)."""
        deadline = time.time() - self.settings.max_pruning_dissemination
        for key in list(self.pruned):
            ts = self.pruned[key]
            for node in [n for n, t in ts.items() if t < deadline]:
                del ts[node]
            if not ts:
                del self.pruned[key]


# -- extension ---------------------------------------------------------------

class DistributedData(ExtensionId):
    """`DistributedData(system).replicator` (reference: DistributedData.scala)."""

    _instances: Dict[ActorSystem, "DistributedData"] = {}
    _lock = threading.Lock()

    def __init__(self, system: Optional[ActorSystem] = None):
        if system is not None:
            cfg = system.settings.config.get_config("akka.cluster.distributed-data")
            self.settings = ReplicatorSettings.from_config(cfg)
            # the id to pass as `node` to CRDT mutators (uid-qualified so a
            # restarted node is a fresh contributor, reference SelfUniqueAddress)
            self.self_unique_address = unique_node_id(
                Cluster.get(system).self_unique_address)
            self.replicator = system.system_actor_of(
                Props.create(Replicator, self.settings), "ddataReplicator")

    @staticmethod
    def get(system: ActorSystem) -> "DistributedData":
        with DistributedData._lock:
            inst = DistributedData._instances.get(system)
            if inst is None:
                inst = DistributedData._instances[system] = DistributedData(system)
                system.register_on_termination(
                    lambda: DistributedData._instances.pop(system, None))
            return inst
