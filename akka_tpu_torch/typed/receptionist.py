"""Receptionist: typed service discovery registry.

A copy of `akka_tpu/typed/receptionist.py` at commit 1001e26 (host code, no
jax; the port keeps its own copy of every module it needs). One change:
on a system with the cluster provider, `Receptionist.get` raises
ValueError: the cluster registry replicates through ddata's replicator,
which comes with ROADMAP A12.3 (the reference would go clustered; a
registry silently kept local would not be its semantics). A system with
the remote provider keeps its registry local, as the reference's does.

Reference parity: akka-actor-typed/src/main/scala/akka/actor/typed/
receptionist/Receptionist.scala (:26-37 ServiceKey; Register/Deregister/
Find/Subscribe/Listing) with the local registry
(internal/receptionist/LocalReceptionist.scala — watch registered refs,
drop on Terminated) and the cluster implementation's semantics
(akka-cluster-typed/.../internal/receptionist/ClusterReceptionist.scala —
registry replicated as an ORMultiMap through the ddata Replicator, entries
keyed by service key, values = (node, path), pruned when members are
removed).

One receptionist actor per system at /system/receptionist; it picks the
cluster-backed registry automatically when the provider is clustered.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Dict, FrozenSet, Optional, Set

from ..actor.actor import Actor
from ..actor.messages import Terminated
from ..actor.props import Props
from ..actor.ref import ActorRef
from ..actor.system import ActorSystem


@dataclass(frozen=True)
class ServiceKey:
    """(reference: Receptionist.scala:26-37)"""
    id: str


# -- protocol ----------------------------------------------------------------

@dataclass(frozen=True)
class Register:
    key: ServiceKey
    service: ActorRef
    reply_to: Optional[ActorRef] = None


@dataclass(frozen=True)
class Registered:
    key: ServiceKey
    service: ActorRef


@dataclass(frozen=True)
class Deregister:
    key: ServiceKey
    service: ActorRef
    reply_to: Optional[ActorRef] = None


@dataclass(frozen=True)
class Deregistered:
    key: ServiceKey
    service: ActorRef


@dataclass(frozen=True)
class Find:
    key: ServiceKey
    reply_to: ActorRef


@dataclass(frozen=True)
class Subscribe:
    key: ServiceKey
    subscriber: ActorRef


@dataclass(frozen=True)
class Listing:
    key: ServiceKey
    service_instances: FrozenSet[ActorRef]

    def for_key(self, key: ServiceKey) -> FrozenSet[ActorRef]:
        return self.service_instances


@dataclass(frozen=True)
class _ReplicatorChanged:
    entries: Dict[str, FrozenSet[str]]  # key id -> paths


_DDATA_KEY = "ReceptionistKey"


class ReceptionistActor(Actor):
    """Local registry + optional ddata replication for cluster visibility."""

    def __init__(self):
        super().__init__()
        self.local: Dict[str, Set[ActorRef]] = {}      # key id -> local refs
        self.remote: Dict[str, Set[str]] = {}          # key id -> remote paths
        self.subscribers: Dict[str, Set[ActorRef]] = {}
        self.watched: Dict[ActorRef, Set[str]] = {}
        self.clustered = False
        self.self_addr = ""
        self._replicator = None
        self._node_id = ""
        provider = self.context.system.provider
        if getattr(provider, "local_address", None) is not None:
            try:
                from ..cluster.cluster import Cluster
                from ..ddata.replicator import DistributedData
                Cluster.get(self.context.system)  # asserts cluster provider
                dd = DistributedData.get(self.context.system)
                self._replicator = dd.replicator
                self._node_id = dd.self_unique_address
                self.self_addr = str(provider.default_address)
                self.clustered = True
            except Exception:  # noqa: BLE001 — not a cluster system
                self.clustered = False

    def pre_start(self) -> None:
        if self.clustered:
            from ..ddata.replicator import Subscribe as DSub, Key
            self._replicator.tell(DSub(Key(_DDATA_KEY), self.self_ref),
                                  self.self_ref)

    # -- helpers -------------------------------------------------------------
    def _all_instances(self, key_id: str) -> FrozenSet[ActorRef]:
        out = set(self.local.get(key_id, set()))
        provider = self.context.system.provider
        for path in self.remote.get(key_id, set()):
            if self.self_addr and path.startswith(self.self_addr):
                continue  # our own entries come from self.local (live refs)
            try:
                out.add(provider.resolve_actor_ref(path))
            except Exception:  # noqa: BLE001 — unresolvable stale entry
                continue
        return frozenset(out)

    def _notify(self, key_id: str) -> None:
        listing = Listing(ServiceKey(key_id), self._all_instances(key_id))
        for sub in self.subscribers.get(key_id, set()):
            sub.tell(listing, self.self_ref)

    def _ddata_update(self, fn) -> None:
        from ..ddata.crdt import ORMultiMap
        from ..ddata.replicator import Key, Update, WriteLocal
        self._replicator.tell(
            Update(Key(_DDATA_KEY), ORMultiMap.empty(), WriteLocal(), fn),
            self.self_ref)

    def _full_path(self, ref: ActorRef) -> str:
        p = ref.path.to_string_without_address()
        return f"{self.self_addr}{p}" if self.self_addr else p

    # -- receive -------------------------------------------------------------
    def receive(self, message: Any) -> Any:  # noqa: C901
        if isinstance(message, Register):
            kid = message.key.id
            self.local.setdefault(kid, set()).add(message.service)
            self.watched.setdefault(message.service, set()).add(kid)
            self.context.watch(message.service)
            if message.reply_to is not None:
                message.reply_to.tell(Registered(message.key, message.service),
                                      self.self_ref)
            if self.clustered:
                path, node = self._full_path(message.service), self._node_id
                self._ddata_update(
                    lambda m: m.add_binding(node, kid, path))
            self._notify(kid)
        elif isinstance(message, Deregister):
            kid = message.key.id
            self.local.get(kid, set()).discard(message.service)
            keys = self.watched.get(message.service)
            if keys is not None:
                keys.discard(kid)
            if message.reply_to is not None:
                message.reply_to.tell(
                    Deregistered(message.key, message.service), self.self_ref)
            if self.clustered:
                path, node = self._full_path(message.service), self._node_id
                self._ddata_update(
                    lambda m: m.remove_binding(node, kid, path))
            self._notify(kid)
        elif isinstance(message, Find):
            message.reply_to.tell(
                Listing(message.key, self._all_instances(message.key.id)),
                self.self_ref)
        elif isinstance(message, Subscribe):
            self.subscribers.setdefault(message.key.id, set()).add(
                message.subscriber)
            message.subscriber.tell(
                Listing(message.key, self._all_instances(message.key.id)),
                self.self_ref)
        elif isinstance(message, Terminated):
            keys = self.watched.pop(message.actor, set())
            for kid in keys:
                self.local.get(kid, set()).discard(message.actor)
                if self.clustered:
                    path, node = self._full_path(message.actor), self._node_id
                    self._ddata_update(
                        lambda m, k=kid, p=path: m.remove_binding(node, k, p))
                self._notify(kid)
        else:
            # ddata Changed notifications
            try:
                from ..ddata.replicator import Changed
            except Exception:  # noqa: BLE001
                return NotImplemented
            if isinstance(message, Changed) and message.key.id == _DDATA_KEY:
                new_remote: Dict[str, Set[str]] = {}
                for kid, paths in message.data.entries.items():
                    new_remote[kid] = set(paths)
                old_remote, self.remote = self.remote, new_remote
                for kid in set(new_remote) | set(old_remote):
                    if new_remote.get(kid, set()) != old_remote.get(kid, set()):
                        self._notify(kid)  # only keys whose paths changed
            else:
                return NotImplemented


class Receptionist:
    """`Receptionist.get(system).ref` — tell it Register/Find/Subscribe."""

    _instances: Dict[ActorSystem, "Receptionist"] = {}
    _lock = threading.Lock()

    @staticmethod
    def get(system) -> "Receptionist":
        classic = getattr(system, "classic", system)
        if classic.settings.provider_kind == "cluster":
            raise ValueError(
                "the receptionist of a cluster system replicates its "
                "registry through ddata's replicator, which is not ported "
                "(ROADMAP A12.3)")
        with Receptionist._lock:
            inst = Receptionist._instances.get(classic)
            if inst is None:
                inst = Receptionist._instances[classic] = Receptionist(classic)
                classic.register_on_termination(
                    lambda: Receptionist._instances.pop(classic, None))
            return inst

    def __init__(self, system: ActorSystem):
        self.system = system
        self.ref = system.system_actor_of(Props.create(ReceptionistActor),
                                          "receptionist")

    # convenience API
    def register(self, key: ServiceKey, service: ActorRef,
                 reply_to: Optional[ActorRef] = None) -> None:
        self.ref.tell(Register(key, service, reply_to), None)

    def find(self, key: ServiceKey, reply_to: ActorRef) -> None:
        self.ref.tell(Find(key, reply_to), None)

    def subscribe(self, key: ServiceKey, subscriber: ActorRef) -> None:
        self.ref.tell(Subscribe(key, subscriber), None)
