"""Typed sharding façade: EntityTypeKey / Entity / init / EntityRef.

A copy of `akka_tpu/sharding/typed.py` at commit 5834bbc (host
code, no jax; the port keeps its own copy of every module it needs).

Reference parity: akka-cluster-sharding-typed/src/main/scala/akka/cluster/
sharding/typed/scaladsl/ClusterSharding.scala (:178 init, :234 entityRefFor,
:362 ShardingEnvelope) — entities are typed Behaviors; `init(Entity(key,
ctx -> behavior))` returns an ActorRef[ShardingEnvelope].
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from ..actor.ref import ActorRef
from ..pattern.ask import ask
from ..typed.adapter import props_from_behavior
from .messages import ShardingEnvelope
from .region import ClusterShardingSettings
from .sharding import ClusterSharding as _ClassicSharding


@dataclass(frozen=True)
class EntityTypeKey:
    """(reference: scaladsl/EntityTypeKey.scala)"""
    name: str


@dataclass(frozen=True)
class EntityContext:
    entity_type_key: EntityTypeKey
    entity_id: str
    shard: Optional[ActorRef] = None


@dataclass(frozen=True)
class Entity:
    """(reference: scaladsl/Entity.scala) — behavior factory per entity."""
    type_key: EntityTypeKey
    create_behavior: Callable[[EntityContext], Any]
    settings: Optional[ClusterShardingSettings] = None
    stop_message: Any = None
    extract_entity_id: Any = None
    extract_shard_id: Any = None


class EntityRef:
    """(reference: EntityRef — tell/ask addressed by entity id)"""

    def __init__(self, region: ActorRef, type_key: EntityTypeKey,
                 entity_id: str, system):
        self.region = region
        self.type_key = type_key
        self.entity_id = entity_id
        self._system = system

    def tell(self, message: Any, sender: Optional[ActorRef] = None) -> None:
        self.region.tell(ShardingEnvelope(self.entity_id, message), sender)

    def ask(self, message: Any, timeout: float = 5.0):
        """Ask the entity. `message` may be a callable reply_to -> message
        (the typed form, `EntityRef.ask(replyTo => ...)`; a port
        addition): a typed entity sees no sender, so it answers the ask
        through the ref its message carries."""
        if callable(message) and not isinstance(message, type):
            make = message
            return ask(self.region,
                       lambda reply_to: ShardingEnvelope(self.entity_id,
                                                         make(reply_to)),
                       timeout=timeout, system=self._system)
        return ask(self.region, ShardingEnvelope(self.entity_id, message),
                   timeout=timeout, system=self._system)

    def __repr__(self) -> str:
        return f"EntityRef({self.type_key.name}/{self.entity_id})"


class ClusterShardingTyped:
    """`ClusterShardingTyped.get(system).init(Entity(...))`"""

    def __init__(self, system):
        self.system = system
        self._classic = _ClassicSharding.get(system)

    @staticmethod
    def get(system) -> "ClusterShardingTyped":
        return ClusterShardingTyped(system)

    def init(self, entity: Entity) -> ActorRef:
        key = entity.type_key

        def props_factory(entity_id: str):
            behavior = entity.create_behavior(EntityContext(key, entity_id))
            return props_from_behavior(behavior)

        return self._classic.start(
            key.name, props_factory, entity.settings,
            extract_entity_id=entity.extract_entity_id,
            extract_shard_id=entity.extract_shard_id)

    def init_device(self, spec, mesh=None, device=None):
        """Device-backed entity type: entities become rows in a
        ShardedBatchedSystem on the mesh (see sharding/device.py —
        the ClusterSharding.init analogue for BatchedBehavior entities).
        `device` (a port addition) goes to the DeviceShardRegion: CUDA by
        default, which raises without a card; "cpu" where asked for."""
        from .device import DeviceShardRegion
        region = DeviceShardRegion(spec, mesh=mesh, device=device)
        self._device_regions = getattr(self, "_device_regions", {})
        self._device_regions[spec.type_name] = region
        return region

    def device_region(self, type_name: str):
        return getattr(self, "_device_regions", {})[type_name]

    def entity_ref_for(self, type_key: EntityTypeKey,
                       entity_id: str) -> EntityRef:
        region = self._classic.shard_region(type_key.name)
        return EntityRef(region, type_key, entity_id, self.system)

    def shard_region(self, type_key: EntityTypeKey) -> ActorRef:
        return self._classic.shard_region(type_key.name)
