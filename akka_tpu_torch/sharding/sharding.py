"""ClusterSharding extension: start/proxy/region lookup.

A copy of `akka_tpu/sharding/sharding.py` at commit 5834bbc (host
code, no jax; the port keeps its own copy of every module it needs).

Reference parity: akka-cluster-sharding/src/main/scala/akka/cluster/sharding/
ClusterSharding.scala (start/startProxy/shardRegion) — per type-name it
starts (a) a ClusterSingletonManager hosting the ShardCoordinator and (b) the
local ShardRegion.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional

from ..actor.props import Props
from ..actor.system import ActorSystem, ExtensionId
from ..cluster_tools.singleton import (ClusterSingletonManager,
                                       ClusterSingletonSettings)
from .coordinator import (LeastShardAllocationStrategy, ShardAllocationStrategy,
                          ShardCoordinator)
from .region import (ClusterShardingSettings, RememberEntitiesStore,
                     ShardRegion, default_extract_entity_id,
                     make_default_extract_shard_id)


class ClusterSharding(ExtensionId):
    def create_extension(self, system: ActorSystem) -> "_ShardingExt":
        return _ShardingExt(system)

    @staticmethod
    def get(system: ActorSystem) -> "_ShardingExt":
        return system.register_extension(ClusterSharding())


class _ShardingExt:
    def __init__(self, system: ActorSystem):
        self.system = system
        self._regions: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def start(self, type_name: str,
              entity_props: "Props | Callable[[str], Props]",
              settings: Optional[ClusterShardingSettings] = None,
              extract_entity_id=None, extract_shard_id=None,
              allocation_strategy: Optional[ShardAllocationStrategy] = None,
              store: Optional[RememberEntitiesStore] = None):
        """Start a region that hosts entities (reference:
        ClusterSharding.start). `entity_props` is a Props (same for every
        entity) or a factory entity_id -> Props."""
        settings = settings or ClusterShardingSettings()
        factory = entity_props if callable(entity_props) \
            and not isinstance(entity_props, Props) else (lambda _eid: entity_props)
        return self._start(type_name, factory, settings, extract_entity_id,
                           extract_shard_id, allocation_strategy, store)

    def start_proxy(self, type_name: str,
                    settings: Optional[ClusterShardingSettings] = None,
                    extract_entity_id=None, extract_shard_id=None):
        """Region in proxy mode: routes but never hosts (reference:
        ClusterSharding.startProxy)."""
        settings = settings or ClusterShardingSettings()
        return self._start(type_name, None, settings, extract_entity_id,
                           extract_shard_id, None, None)

    def _start(self, type_name, entity_props_factory, settings,
               extract_entity_id, extract_shard_id, allocation_strategy,
               store):
        with self._lock:
            if type_name in self._regions:
                return self._regions[type_name]
            manager_name = f"sharding-{type_name}-coordinator"
            manager_path = f"/system/{manager_name}"
            # every node runs a singleton manager; the oldest hosts the
            # coordinator child named "coordinator"
            self.system.system_actor_of(
                Props.create(
                    ClusterSingletonManager,
                    Props.create(ShardCoordinator, type_name,
                                 allocation_strategy or LeastShardAllocationStrategy(),
                                 settings.rebalance_interval),
                    ClusterSingletonSettings(
                        singleton_name="coordinator", role=settings.role,
                        hand_over_retry_interval=settings.retry_interval)),
                manager_name)
            region = self.system.system_actor_of(
                Props.create(ShardRegion, type_name, entity_props_factory,
                             extract_entity_id, extract_shard_id, settings,
                             manager_path, store),
                f"sharding-{type_name}")
            self._regions[type_name] = region
            return region

    def shard_region(self, type_name: str):
        """(reference: ClusterSharding.shardRegion)"""
        with self._lock:
            if type_name not in self._regions:
                raise KeyError(f"sharding type {type_name!r} not started")
            return self._regions[type_name]
