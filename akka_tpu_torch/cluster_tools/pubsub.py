"""Distributed publish-subscribe: gossip-replicated topic/path registry.

A copy of `akka_tpu/cluster_tools/pubsub.py` at commit c056b95 (host code,
no jax; the port keeps its own copy of every module it needs).

Reference parity: akka-cluster-tools/src/main/scala/akka/cluster/pubsub/
DistributedPubSubMediator.scala (:553 mediator actor; Send/SendToAll :202-213;
publish :799; versioned per-node buckets gossiped via Status/Delta).

One mediator actor per node at /system/distributedPubSubMediator. The
registry maps  node-address -> Bucket(version, {key -> ValueHolder}) where a
key is either a registered actor path ("/user/x") or a topic ("topic:<name>").
Gossip: periodic Status(versions) to random peers; peers reply Delta with
newer buckets. Topic subscribers are local refs fanned out by each node's own
mediator on PublishLocal.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, FrozenSet, List, Optional, Set, Tuple

from ..actor.actor import Actor
from ..actor.props import Props
from ..actor.ref import ActorRef
from ..actor.system import ActorSystem, ExtensionId
from ..cluster.cluster import Cluster
from ..cluster.events import MemberEvent, MemberRemoved
from ..cluster.member import MemberStatus


# -- user API messages (reference: DistributedPubSubMediator object) ---------

@dataclass(frozen=True)
class Subscribe:
    topic: str
    ref: ActorRef
    group: Optional[str] = None


@dataclass(frozen=True)
class SubscribeAck:
    subscribe: Subscribe


@dataclass(frozen=True)
class Unsubscribe:
    topic: str
    ref: ActorRef
    group: Optional[str] = None


@dataclass(frozen=True)
class UnsubscribeAck:
    unsubscribe: Unsubscribe


@dataclass(frozen=True)
class Put:
    ref: ActorRef  # must be a local ref; registered under its path


@dataclass(frozen=True)
class Remove:
    path: str


@dataclass(frozen=True)
class Publish:
    topic: str
    message: Any
    send_one_message_to_each_group: bool = False


@dataclass(frozen=True)
class Send:
    """Send to ONE registered actor for `path` (routing: random with local
    affinity, reference :202)."""
    path: str
    message: Any
    local_affinity: bool = True


@dataclass(frozen=True)
class SendToAll:
    path: str
    message: Any
    all_but_self: bool = False


@dataclass(frozen=True)
class GetTopics:
    pass


@dataclass(frozen=True)
class CurrentTopics:
    topics: FrozenSet[str]


@dataclass(frozen=True)
class Count:
    pass


@dataclass(frozen=True)
class GetRegistryState:
    """Introspection: reply with {key: [node addresses]} for live entries."""
    pass


# -- internal gossip protocol ------------------------------------------------

@dataclass(frozen=True)
class _ValueHolder:
    version: int
    path: Optional[str]  # None => tombstone (removed registration)


@dataclass(frozen=True)
class _Bucket:
    owner: str  # node address string
    version: int
    content: Dict[str, _ValueHolder] = field(default_factory=dict)


@dataclass(frozen=True)
class _Status:
    versions: Dict[str, int]
    is_reply: bool = False


@dataclass(frozen=True)
class _Delta:
    buckets: Tuple[_Bucket, ...]


@dataclass(frozen=True)
class _GossipTick:
    pass


@dataclass(frozen=True)
class _PublishLocal:
    topic: str
    message: Any
    groups: bool = False


@dataclass(frozen=True)
class _SendLocal:
    path: str
    message: Any


class DistributedPubSubMediator(Actor):
    def __init__(self, gossip_interval: float = 0.2,
                 removed_time_to_live: float = 30.0):
        super().__init__()
        self.gossip_interval = gossip_interval
        self.removed_ttl = removed_time_to_live
        self.cluster = Cluster.get(self.context.system)
        self.self_addr = str(self.context.system.provider.default_address)
        # node addr -> bucket; ours is authoritative, others gossip-replicated
        self.registry: Dict[str, _Bucket] = {
            self.self_addr: _Bucket(self.self_addr, 0)}
        # topic -> (group or None) -> set of local subscriber refs
        self.subscribers: Dict[str, Dict[Optional[str], Set[ActorRef]]] = {}
        self.local_refs: Dict[str, ActorRef] = {}  # path -> local ref
        self._send_rr = 0
        self._task = None
        self._nodes: Set[str] = set()

    # -- lifecycle -----------------------------------------------------------
    def pre_start(self) -> None:
        self._task = self.context.system.scheduler.schedule_tell_with_fixed_delay(
            self.gossip_interval, self.gossip_interval, self.self_ref,
            _GossipTick())
        self.cluster.subscribe(lambda e: self.self_ref.tell(e), MemberEvent,
                               initial_state=False)

    def post_stop(self) -> None:
        if self._task:
            self._task.cancel()

    # -- helpers -------------------------------------------------------------
    def _my_bucket(self) -> _Bucket:
        return self.registry[self.self_addr]

    def _put_key(self, key: str, path: Optional[str]) -> None:
        b = self._my_bucket()
        v = b.version + 1
        content = dict(b.content)
        content[key] = _ValueHolder(v, path)
        self.registry[self.self_addr] = _Bucket(self.self_addr, v, content)

    def _peers(self) -> List[str]:
        ups = [str(m.address) for m in self.cluster.state.members
               if m.status in (MemberStatus.UP, MemberStatus.WEAKLY_UP)]
        return [a for a in ups if a != self.self_addr]

    def _mediator_at(self, addr: str) -> ActorRef:
        rel = self.context.self_ref.path.to_string_without_address()
        return self.context.system.provider.resolve_actor_ref(f"{addr}{rel}")

    def _live_addrs(self) -> Set[str]:
        from ..cluster.member import MemberStatus
        live = {str(m.address) for m in self.cluster.state.members
                if m.status in (MemberStatus.JOINING, MemberStatus.WEAKLY_UP,
                                MemberStatus.UP, MemberStatus.LEAVING)}
        live.add(self.self_addr)
        return live

    def _nodes_with_key(self, key: str) -> List[str]:
        live = self._live_addrs()
        out = []
        for addr, b in self.registry.items():
            if addr not in live:
                continue
            vh = b.content.get(key)
            if vh is not None and vh.path is not None:
                out.append(addr)
        return out

    # -- receive -------------------------------------------------------------
    def receive(self, message: Any) -> Any:  # noqa: C901
        if isinstance(message, Subscribe):
            groups = self.subscribers.setdefault(message.topic, {})
            groups.setdefault(message.group, set()).add(message.ref)
            self._put_key(f"topic:{message.topic}", "topic")
            message.ref.tell(SubscribeAck(message), self.self_ref)
        elif isinstance(message, Unsubscribe):
            groups = self.subscribers.get(message.topic, {})
            groups.get(message.group, set()).discard(message.ref)
            if not any(groups.values()):
                self.subscribers.pop(message.topic, None)
                self._put_key(f"topic:{message.topic}", None)
            message.ref.tell(UnsubscribeAck(message), self.self_ref)
        elif isinstance(message, Put):
            path = message.ref.path.to_string_without_address()
            self.local_refs[path] = message.ref
            self._put_key(path, path)
        elif isinstance(message, Remove):
            self.local_refs.pop(message.path, None)
            self._put_key(message.path, None)
        elif isinstance(message, Publish):
            key = f"topic:{message.topic}"
            local = _PublishLocal(message.topic, message.message,
                                  message.send_one_message_to_each_group)
            for addr in self._nodes_with_key(key):
                if addr == self.self_addr:
                    self._publish_local(local)
                else:
                    self._mediator_at(addr).tell(local, self.sender)
        elif isinstance(message, _PublishLocal):
            self._publish_local(message)
        elif isinstance(message, Send):
            nodes = self._nodes_with_key(message.path)
            if not nodes:
                self._dead_letter(message.path, message.message)
            elif message.local_affinity and self.self_addr in nodes \
                    and message.path in self.local_refs:
                self.local_refs[message.path].tell(message.message, self.sender)
            else:
                self._send_rr += 1
                addr = nodes[self._send_rr % len(nodes)]
                if addr == self.self_addr:
                    self._send_local(message.path, message.message)
                else:
                    self._mediator_at(addr).tell(
                        _SendLocal(message.path, message.message), self.sender)
        elif isinstance(message, _SendLocal):
            self._send_local(message.path, message.message)
        elif isinstance(message, SendToAll):
            for addr in self._nodes_with_key(message.path):
                if addr == self.self_addr:
                    if not message.all_but_self:
                        self._send_local(message.path, message.message)
                else:
                    self._mediator_at(addr).tell(
                        _SendLocal(message.path, message.message), self.sender)
        elif isinstance(message, GetTopics):
            topics = set()
            for addr, b in self.registry.items():
                for key, vh in b.content.items():
                    if key.startswith("topic:") and vh.path is not None:
                        topics.add(key[len("topic:"):])
            self.sender.tell(CurrentTopics(frozenset(topics)), self.self_ref)
        elif isinstance(message, GetRegistryState):
            out: Dict[str, List[str]] = {}
            for addr, b in self.registry.items():
                for key, vh in b.content.items():
                    if vh.path is not None:
                        out.setdefault(key, []).append(addr)
            self.sender.tell(out, self.self_ref)
        elif isinstance(message, Count):
            n = sum(len(refs) for groups in self.subscribers.values()
                    for refs in groups.values()) + len(self.local_refs)
            self.sender.tell(n, self.self_ref)
        elif isinstance(message, _GossipTick):
            self._gossip()
        elif isinstance(message, _Status):
            self._on_status(message)
        elif isinstance(message, _Delta):
            self._on_delta(message)
        elif isinstance(message, MemberRemoved):
            addr = str(message.member.address)
            if addr != self.self_addr:
                self.registry.pop(addr, None)
        elif isinstance(message, MemberEvent):
            pass
        else:
            return NotImplemented

    # -- local delivery ------------------------------------------------------
    def _publish_local(self, msg: _PublishLocal) -> None:
        groups = self.subscribers.get(msg.topic, {})
        if msg.groups:
            # one message per group (random member), plus all ungrouped
            for group, refs in groups.items():
                if not refs:
                    continue
                if group is None:
                    for r in refs:
                        r.tell(msg.message, self.sender)
                else:
                    random.choice(sorted(refs, key=str)).tell(
                        msg.message, self.sender)
        else:
            for refs in groups.values():
                for r in refs:
                    r.tell(msg.message, self.sender)

    def _send_local(self, path: str, message: Any) -> None:
        ref = self.local_refs.get(path)
        if ref is not None:
            ref.tell(message, self.sender)
        else:
            self._dead_letter(path, message)

    def _dead_letter(self, path: str, message: Any) -> None:
        from ..actor.messages import DeadLetter
        self.context.system.event_stream.publish(
            DeadLetter(message, self.self_ref, self.self_ref))

    # -- gossip --------------------------------------------------------------
    def _gossip(self) -> None:
        peers = self._peers()
        if not peers:
            return
        target = random.choice(peers)
        versions = {addr: b.version for addr, b in self.registry.items()}
        self._mediator_at(target).tell(_Status(versions), self.self_ref)

    def _on_status(self, status: _Status) -> None:
        # send back buckets the peer is missing / stale on
        delta = tuple(b for addr, b in self.registry.items()
                      if b.version > status.versions.get(addr, -1))
        if delta:
            self.sender.tell(_Delta(delta), self.self_ref)
        if not status.is_reply:
            mine = {addr: b.version for addr, b in self.registry.items()}
            stale = any(v > mine.get(addr, -1)
                        for addr, v in status.versions.items())
            if stale:
                self.sender.tell(_Status(mine, is_reply=True), self.self_ref)

    def _on_delta(self, delta: _Delta) -> None:
        live = self._live_addrs()
        for b in delta.buckets:
            if b.owner == self.self_addr:
                continue  # we are authoritative for our own bucket
            if b.owner not in live:
                continue  # no resurrection of removed nodes' buckets
            cur = self.registry.get(b.owner)
            if cur is None or b.version > cur.version:
                self.registry[b.owner] = b


class DistributedPubSub(ExtensionId):
    """Extension: starts the mediator at /system/distributedPubSubMediator
    (reference: DistributedPubSub extension)."""

    _lock = threading.Lock()

    def create_extension(self, system: ActorSystem):
        return _PubSubExt(system)

    @staticmethod
    def get(system: ActorSystem) -> "_PubSubExt":
        return system.register_extension(DistributedPubSub())


class _PubSubExt:
    def __init__(self, system: ActorSystem):
        interval = system.settings.config.get_duration(
            "akka.cluster.pub-sub.gossip-interval", 0.2)
        self.mediator = system.system_actor_of(
            Props.create(DistributedPubSubMediator, gossip_interval=interval),
            "distributedPubSubMediator")
