"""Cluster sharding (port of `akka_tpu/sharding`): entities -> shards ->
regions.

The host control plane, copied from the reference at 5834bbc: the
protocol messages, the `ShardCoordinator` singleton with its allocation
strategies, `ShardRegion` and `Shard`, the `ClusterSharding` extension,
the typed facade (`ClusterShardingTyped`, `Entity`, `EntityRef`) and
`ShardedDaemonProcess`. The data plane: the device region
(`DeviceShardRegion`), its synchronous ask engine, the futures front end
(`AskBatcher`, `ContinuousWaveScheduler`) and the remember-entities
stores (in-proc, journal and ddata) with `make_remember_entities_store`.
`ClusterShardingTyped.init_device` builds a device region beside the
host regions.
"""

from .messages import (BeginHandOff, ClusterShardingStats,
                       CurrentShardRegionState, GetClusterShardingStats,
                       GetShardHome, GetShardRegionState, HandOff, HostShard,
                       Passivate, Register, RegisterAck, ShardHome,
                       ShardingEnvelope, ShardState, ShardStopped, StartEntity,
                       StartEntityAck)
from .coordinator import (LeastShardAllocationStrategy,
                          ShardAllocationStrategy, ShardCoordinator)
from .region import (ClusterShardingSettings, Shard, ShardRegion,
                     default_extract_entity_id,
                     make_default_extract_shard_id)
from .remember import (DDataRememberEntitiesStore,
                       InProcRememberEntitiesStore,
                       JournalRememberEntitiesStore, RememberEntitiesStore,
                       make_remember_entities_store)
from .sharding import ClusterSharding
from .typed import (ClusterShardingTyped, Entity, EntityContext, EntityRef,
                    EntityTypeKey)
from .daemon_process import (ShardedDaemonProcess,
                             ShardedDaemonProcessSettings)
from .ask_batch import (AskBatcher, BatchAsk, ContinuousWaveScheduler,
                        execute_ask_batch, wait_adaptive_close)
from .device import DeviceEntity, DeviceEntityRef, DeviceShardRegion

__all__ = [
    "ShardingEnvelope", "StartEntity", "StartEntityAck", "Passivate",
    "ClusterSharding", "ClusterShardingSettings", "ShardRegion", "Shard",
    "ShardCoordinator", "ShardAllocationStrategy",
    "LeastShardAllocationStrategy", "RememberEntitiesStore",
    "InProcRememberEntitiesStore", "JournalRememberEntitiesStore",
    "DDataRememberEntitiesStore", "make_remember_entities_store",
    "default_extract_entity_id",
    "make_default_extract_shard_id", "GetShardRegionState",
    "CurrentShardRegionState", "GetClusterShardingStats",
    "ClusterShardingStats", "ShardState",
    "ClusterShardingTyped", "Entity", "EntityContext", "EntityRef",
    "EntityTypeKey",
    "ShardedDaemonProcess", "ShardedDaemonProcessSettings",
    "AskBatcher", "BatchAsk", "ContinuousWaveScheduler",
    "DeviceEntity", "DeviceEntityRef", "DeviceShardRegion",
    "execute_ask_batch", "wait_adaptive_close",
]
