"""ShardRegion + Shard: the per-node entry point of cluster sharding.

A copy of `akka_tpu/sharding/region.py` at commit 5834bbc (host
code, no jax; the port keeps its own copy of every module it needs).

Reference parity: akka-cluster-sharding/src/main/scala/akka/cluster/sharding/
ShardRegion.scala (:522 region actor; deliverMessage :1046-1089 — resolve
shard home, forward or buffer; ShardHome handling :712; buffering +
GetShardHome :968,1056) and Shard.scala (entity hosting, Passivate buffering,
remember-entities restart).

Regions address each other and the coordinator by path string; refs resolve
through the provider so the same code runs local or cross-node.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from ..actor.actor import Actor
from ..actor.messages import PoisonPill, Terminated
from ..actor.props import Props
from .messages import (BeginHandOff, BeginHandOffAck, ClusterShardingStats,
                       CurrentShardRegionState, GetClusterShardingStats,
                       GetShardHome, GetShardRegionState, GracefulShutdownReq,
                       HandOff, HostShard, Passivate, Register, RegisterAck,
                       RegisterProxy, ShardHome, ShardingEnvelope, ShardState,
                       ShardStarted, ShardStopped, StartEntity, StartEntityAck)
# the remember-entities stores (reference region.py:78-312) live in
# remember.py, beside the device region's row bookkeeping
from .remember import (DDataRememberEntitiesStore,  # noqa: F401
                       InProcRememberEntitiesStore,
                       JournalRememberEntitiesStore, RememberEntitiesStore,
                       make_remember_entities_store)


@dataclass(frozen=True)
class ClusterShardingSettings:
    """(reference: ClusterShardingSettings.scala) — tuned-down intervals for
    the host control plane."""
    number_of_shards: int = 32
    buffer_size: int = 10_000
    retry_interval: float = 0.2
    rebalance_interval: float = 1.0
    passivate_idle_after: Optional[float] = None  # seconds; None = off
    remember_entities: bool = False
    # which RememberEntitiesStore backs remember_entities (reference:
    # akka.cluster.sharding.remember-entities-store): "inproc" (tests),
    # "journal" (file-backed record log, needs remember_entities_dir), or
    # "ddata" (ORSet of ids per shard riding the op-delta replicator)
    remember_entities_store: str = "inproc"
    remember_entities_dir: Optional[str] = None
    role: Optional[str] = None


def default_extract_entity_id(message: Any) -> Optional[Tuple[str, Any]]:
    """(reference: ShardRegion.scala:42 ExtractEntityId) — understands
    ShardingEnvelope and StartEntity."""
    if isinstance(message, ShardingEnvelope):
        return message.entity_id, message.message
    if isinstance(message, StartEntity):
        return message.entity_id, message
    return None


def make_default_extract_shard_id(number_of_shards: int) -> Callable[[Any], Optional[str]]:
    from ..utils.hashing import stable_hash_str

    def extract(message: Any) -> Optional[str]:
        eid = None
        if isinstance(message, ShardingEnvelope):
            eid = message.entity_id
        elif isinstance(message, StartEntity):
            eid = message.entity_id
        if eid is None:
            return None
        # stable across processes: every node must agree on entity->shard
        return str(stable_hash_str(eid) % number_of_shards)
    return extract


@dataclass(frozen=True)
class _RetryTick:
    pass


@dataclass(frozen=True)
class _PassivateIdleTick:
    pass


@dataclass(frozen=True)
class _RememberedIds:
    """A Shard's remembered ids, read from the store without blocking: a
    Future of the set (a port addition)."""
    ids: Any


@dataclass(frozen=True)
class _StoreFailed:
    """A remember-entities write that failed after the Shard moved on (a
    port addition): the Shard raises it, as the reference's synchronous
    write would have."""
    error: BaseException


@dataclass(frozen=True)
class _StateQueryTimeout:
    qid: int


@dataclass(frozen=True)
class _ShardStateQuery:
    """Region->shard leg of a GetShardRegionState aggregation, tagged so a
    LATE reply from a timed-out query can never satisfy a newer one."""
    qid: int


@dataclass(frozen=True)
class _ShardStateReply:
    qid: int
    state: Any  # ShardState


# per-shard state aggregation deadline (reference: the 5s default ask
# timeout of ShardRegion.GetShardRegionState queries); a partial snapshot
# is sent if a shard does not answer in time
STATE_QUERY_TIMEOUT = 2.0


class Shard(Actor):
    """Hosts the entities of one shard as child actors (reference:
    sharding/Shard.scala)."""

    def __init__(self, type_name: str, shard_id: str, entity_props_factory,
                 settings: ClusterShardingSettings,
                 store: Optional[RememberEntitiesStore]):
        super().__init__()
        self.type_name = type_name
        self.shard_id = shard_id
        self.entity_props_factory = entity_props_factory
        self.settings = settings
        self.store = store if settings.remember_entities else None
        self.entities: Dict[str, Any] = {}          # id -> ref
        self.by_ref: Dict[Any, str] = {}            # ref -> id
        self.passivating: Set[str] = set()
        self.msg_buffer: Dict[str, List[tuple]] = {}  # passivating id -> msgs
        self.last_msg: Dict[str, float] = {}
        self.handoff_requester = None
        self._idle_task = None

    def pre_start(self) -> None:
        if self.store is not None:
            # the store answers through a Future (the ddata store asks the
            # replicator, which may need this dispatcher thread); one that
            # is done already is read here, in the reference's order
            ids = self.store.remembered_async(self.type_name, self.shard_id)
            if ids.done():
                self._start_remembered(ids)
            else:
                me = self.self_ref
                ids.add_done_callback(lambda f: me.tell(_RememberedIds(f)))
        if self.settings.passivate_idle_after:
            t = self.settings.passivate_idle_after / 2
            self._idle_task = self.context.system.scheduler \
                .schedule_tell_with_fixed_delay(t, t, self.self_ref,
                                                _PassivateIdleTick())

    def post_stop(self) -> None:
        if self._idle_task:
            self._idle_task.cancel()

    def _get_or_create(self, entity_id: str):
        ref = self.entities.get(entity_id)
        if ref is None:
            props = self.entity_props_factory(entity_id)
            ref = self.context.actor_of(props, entity_id)
            self.context.watch(ref)
            self.entities[entity_id] = ref
            self.by_ref[ref] = entity_id
            if self.store is not None:
                self._store("add", entity_id)
        return ref

    def _start_remembered(self, ids) -> None:
        """Start every id of `ids`, a done Future of the remembered set;
        raises the store's error."""
        if self.handoff_requester is None:
            for eid in sorted(ids.result()):
                self._get_or_create(eid)

    def _store(self, op: str, entity_id: str) -> None:
        """`op` ("add" or "remove") entity_id in the remember store without
        waiting on it. A failed write crashes the Shard, as the reference's
        synchronous one does: here where the Future is done already, else
        when it fails, through _StoreFailed."""
        done = getattr(self.store, f"{op}_async")(
            self.type_name, self.shard_id, entity_id)
        if done.done():
            done.result()
            return
        me = self.self_ref

        def failed(f):
            if f.exception() is not None:
                me.tell(_StoreFailed(f.exception()))
        done.add_done_callback(failed)

    def receive(self, message: Any) -> Any:  # noqa: C901
        if isinstance(message, tuple) and len(message) == 2 \
                and message[0] == "deliver":
            entity_id, payload = message[1]
            self._deliver(entity_id, payload)
        elif isinstance(message, StartEntity):
            self._get_or_create(message.entity_id)
            self.sender.tell(StartEntityAck(message.entity_id, self.shard_id),
                             self.self_ref)
        elif isinstance(message, Passivate):
            ref = self.sender
            eid = self.by_ref.get(ref)
            if eid is not None and eid not in self.passivating:
                self.passivating.add(eid)
                self.msg_buffer.setdefault(eid, [])
                if self.store is not None:
                    self._store("remove", eid)
                if message.stop_message == "poison-pill":
                    ref.tell(PoisonPill)
                else:
                    ref.tell(message.stop_message, self.self_ref)
        elif isinstance(message, _RememberedIds):
            self._start_remembered(message.ids)
        elif isinstance(message, _StoreFailed):
            raise message.error
        elif isinstance(message, Terminated):
            self._entity_terminated(message.actor)
        elif isinstance(message, HandOff):
            self.handoff_requester = self.sender
            if not self.entities:
                self.sender.tell(ShardStopped(self.shard_id), self.self_ref)
                self.context.stop(self.context.self_ref)
            else:
                for ref in list(self.entities.values()):
                    ref.tell(PoisonPill)
        elif isinstance(message, _PassivateIdleTick):
            deadline = time.monotonic() - (self.settings.passivate_idle_after or 0)
            for eid, last in list(self.last_msg.items()):
                if last < deadline and eid in self.entities \
                        and eid not in self.passivating:
                    self.passivating.add(eid)
                    self.msg_buffer.setdefault(eid, [])
                    if self.store is not None:
                        self._store("remove", eid)
                    self.entities[eid].tell(PoisonPill)
        elif isinstance(message, GetShardRegionState):
            self.sender.tell(ShardState(self.shard_id,
                                        tuple(sorted(self.entities))),
                             self.self_ref)
        elif isinstance(message, _ShardStateQuery):
            self.sender.tell(_ShardStateReply(
                message.qid, ShardState(self.shard_id,
                                        tuple(sorted(self.entities)))),
                self.self_ref)
        else:
            return NotImplemented

    def _deliver(self, entity_id: str, payload: Any) -> None:
        self.last_msg[entity_id] = time.monotonic()
        if entity_id in self.passivating:
            buf = self.msg_buffer.setdefault(entity_id, [])
            if len(buf) < self.settings.buffer_size:
                buf.append((payload, self.sender))
            return
        if isinstance(payload, StartEntity):
            self._get_or_create(entity_id)
            self.sender.tell(StartEntityAck(entity_id, self.shard_id),
                             self.self_ref)
            return
        self._get_or_create(entity_id).tell(payload, self.sender)

    def _entity_terminated(self, ref: Any) -> None:
        eid = self.by_ref.pop(ref, None)
        if eid is None:
            return
        self.entities.pop(eid, None)
        self.last_msg.pop(eid, None)
        was_passivating = eid in self.passivating
        self.passivating.discard(eid)
        buffered = self.msg_buffer.pop(eid, [])
        if self.handoff_requester is not None:
            if not self.entities:
                self.handoff_requester.tell(ShardStopped(self.shard_id),
                                            self.self_ref)
                self.context.stop(self.context.self_ref)
            return
        if buffered:
            # restart after passivation: redeliver buffered messages
            for payload, snd in buffered:
                self.last_msg[eid] = time.monotonic()
                self._get_or_create(eid).tell(payload, snd)
        elif not was_passivating and self.store is not None:
            # crashed / stopped on its own: remember-entities restarts it
            self._get_or_create(eid)


class ShardRegion(Actor):
    """(reference: ShardRegion.scala:522). host mode (entity_props_factory
    set) or proxy mode (None)."""

    def __init__(self, type_name: str, entity_props_factory,
                 extract_entity_id, extract_shard_id,
                 settings: ClusterShardingSettings,
                 coordinator_manager_path: str,
                 store: Optional[RememberEntitiesStore] = None):
        super().__init__()
        self.type_name = type_name
        self.entity_props_factory = entity_props_factory
        self.extract_entity_id = extract_entity_id or default_extract_entity_id
        self.extract_shard_id = extract_shard_id or \
            make_default_extract_shard_id(settings.number_of_shards)
        self.settings = settings
        self.manager_path = coordinator_manager_path
        # "ddata" needs the replicator's ActorSystem, which only exists
        # once the actor starts — defer that kind to pre_start
        self.store = store if store is not None else (
            make_remember_entities_store(settings)
            if settings.remember_entities and
            settings.remember_entities_store != "ddata" else None)
        self.coordinator = None               # direct ref once registered
        self.shard_homes: Dict[str, str] = {}  # shard -> region path
        self.shards: Dict[str, Any] = {}       # local shard id -> shard ref
        self.buffers: Dict[str, List[tuple]] = {}
        self._watched_regions: Dict[Any, str] = {}  # peer region ref -> path
        self._state_queries: Dict[int, dict] = {}   # qid -> pending agg
        self._state_query_seq = 0
        self._task = None
        from ..cluster.cluster import Cluster
        self.cluster = Cluster.get(self.context.system)

    # -- plumbing ------------------------------------------------------------
    def _self_path(self) -> str:
        addr = self.context.system.provider.default_address
        return f"{addr}{self.self_ref.path.to_string_without_address()}"

    def _ref(self, path: str):
        return self.context.system.provider.resolve_actor_ref(path)

    def _coordinator_ref(self):
        """Resolve the singleton coordinator on the current oldest node."""
        from ..cluster.member import MemberStatus
        ms = [m for m in self.cluster.state.members
              if m.status is MemberStatus.UP and
              (self.settings.role is None or self.settings.role in m.roles)]
        if not ms:
            return None
        oldest = min(ms, key=lambda m: (m.up_number, m.unique_address))
        return self._ref(f"{oldest.unique_address.address_str}"
                         f"{self.manager_path}/coordinator")

    def pre_start(self) -> None:
        if self.store is None and self.settings.remember_entities:
            self.store = make_remember_entities_store(
                self.settings, system=self.context.system)
        self._task = self.context.system.scheduler.schedule_tell_with_fixed_delay(
            0.05, self.settings.retry_interval, self.self_ref, _RetryTick())

    def post_stop(self) -> None:
        if self._task:
            self._task.cancel()

    def _register(self) -> None:
        ref = self._coordinator_ref()
        if ref is None:
            return
        msg = (Register(self._self_path()) if self.entity_props_factory
               else RegisterProxy(self._self_path()))
        ref.tell(msg, self.self_ref)

    # -- receive -------------------------------------------------------------
    def receive(self, message: Any) -> Any:  # noqa: C901
        if isinstance(message, _RetryTick):
            if self.coordinator is None:
                self._register()
            for shard_id in list(self.buffers):
                self._ask_home(shard_id)
        elif isinstance(message, RegisterAck):
            self.coordinator = self.sender
            self.context.watch(self.sender)
            for shard_id in list(self.buffers):
                self._ask_home(shard_id)
        elif isinstance(message, ShardHome):
            self.shard_homes[message.shard_id] = message.region_path
            self._watch_home(message.region_path)
            self._drain(message.shard_id)
        elif isinstance(message, HostShard):
            self._get_or_create_shard(message.shard_id)
            self.shard_homes[message.shard_id] = self._self_path()
            self.sender.tell(ShardStarted(message.shard_id), self.self_ref)
            self._drain(message.shard_id)
        elif isinstance(message, BeginHandOff):
            self.shard_homes.pop(message.shard_id, None)
            self.sender.tell(BeginHandOffAck(message.shard_id), self.self_ref)
        elif isinstance(message, HandOff):
            shard = self.shards.get(message.shard_id)
            if shard is None:
                self.sender.tell(ShardStopped(message.shard_id), self.self_ref)
            else:
                shard.tell(message, self.sender)  # shard replies ShardStopped
                self.shards.pop(message.shard_id, None)
        elif isinstance(message, Terminated):
            if self.coordinator is not None and message.actor == self.coordinator:
                self.coordinator = None
            else:
                # a peer region died: forget its shard homes so the next
                # message re-resolves via the coordinator
                path = self._watched_regions.pop(message.actor, None)
                if path is not None:
                    for sid in [s for s, h in self.shard_homes.items()
                                if h == path]:
                        del self.shard_homes[sid]
        elif isinstance(message, GetShardRegionState):
            # aggregate per-shard entity lists asynchronously (reference:
            # ShardRegion.scala replyToRegionStateQuery — ask each shard,
            # aggregate with a timeout, never block the region)
            if not self.shards:
                self.sender.tell(CurrentShardRegionState(()), self.self_ref)
            else:
                self._state_query_seq += 1
                qid = self._state_query_seq
                self._state_queries[qid] = {
                    "waiting": set(self.shards), "acc": [],
                    "reply_to": self.sender}
                for shard in self.shards.values():
                    shard.tell(_ShardStateQuery(qid), self.self_ref)
                self.context.system.scheduler.schedule_tell_once(
                    STATE_QUERY_TIMEOUT, self.self_ref,
                    _StateQueryTimeout(qid))
        elif isinstance(message, _ShardStateReply):
            # qid-tagged: a late reply from a timed-out query finds its
            # query gone and is dropped instead of satisfying a newer one
            q = self._state_queries.get(message.qid)
            if q is not None and message.state.shard_id in q["waiting"]:
                q["waiting"].discard(message.state.shard_id)
                q["acc"].append(message.state)
                if not q["waiting"]:
                    del self._state_queries[message.qid]
                    q["reply_to"].tell(
                        CurrentShardRegionState(tuple(q["acc"])),
                        self.self_ref)
        elif isinstance(message, _StateQueryTimeout):
            q = self._state_queries.pop(message.qid, None)
            if q is not None:  # partial beats nothing (reference timeout)
                q["reply_to"].tell(CurrentShardRegionState(tuple(q["acc"])),
                                   self.self_ref)
        elif isinstance(message, ShardStopped):
            pass  # late ack from a shard we already dropped
        else:
            env = self.extract_entity_id(message)
            shard_id = self.extract_shard_id(message)
            if env is None or shard_id is None:
                return NotImplemented
            self._deliver(shard_id, env[0], env[1], message)

    # -- delivery (reference: deliverMessage ShardRegion.scala:1046-1089) ----
    def _deliver(self, shard_id: str, entity_id: str, payload: Any,
                 original: Any) -> None:
        home = self.shard_homes.get(shard_id)
        if home is None:
            buf = self.buffers.setdefault(shard_id, [])
            if len(buf) >= self.settings.buffer_size:
                from ..actor.messages import DeadLetter
                self.context.system.event_stream.publish(
                    DeadLetter(payload, self.sender, self.self_ref))
                return
            buf.append((entity_id, payload, original, self.sender))
            self._ask_home(shard_id)
        elif home == self._self_path():
            shard = self._get_or_create_shard(shard_id)
            shard.tell(("deliver", (entity_id, payload)), self.sender)
        else:
            # forward the ORIGINAL message: the remote region re-extracts with
            # its own (identical) extractors (reference forwards msg verbatim)
            self._ref(home).tell(original, self.sender)

    def _watch_home(self, region_path: str) -> None:
        if region_path == self._self_path():
            return
        if region_path not in self._watched_regions.values():
            ref = self._ref(region_path)
            self.context.watch(ref)
            self._watched_regions[ref] = region_path

    def _ask_home(self, shard_id: str) -> None:
        if self.coordinator is not None:
            self.coordinator.tell(GetShardHome(shard_id), self.self_ref)

    def _drain(self, shard_id: str) -> None:
        buffered = self.buffers.pop(shard_id, [])
        for entity_id, payload, original, snd in buffered:
            home = self.shard_homes.get(shard_id)
            if home == self._self_path():
                self._get_or_create_shard(shard_id).tell(
                    ("deliver", (entity_id, payload)), snd)
            elif home is not None:
                self._ref(home).tell(original, snd)

    def _get_or_create_shard(self, shard_id: str):
        shard = self.shards.get(shard_id)
        if shard is None:
            if self.entity_props_factory is None:
                raise RuntimeError("proxy region cannot host shards")
            shard = self.context.actor_of(
                Props.create(Shard, self.type_name, shard_id,
                             self.entity_props_factory, self.settings,
                             self.store),
                f"shard-{shard_id}")
            self.shards[shard_id] = shard
        return shard
