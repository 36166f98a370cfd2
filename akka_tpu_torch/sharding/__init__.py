"""Cluster sharding on the device (port of `akka_tpu/sharding`): the
region's data plane (`DeviceShardRegion`), its synchronous ask engine,
the futures front end (`AskBatcher`, `ContinuousWaveScheduler`) and the
remember-entities stores (the ddata store raises until its replicator
is ported). The host control plane (ShardRegion/ShardCoordinator
actors) is not ported yet (ROADMAP A12)."""

from .ask_batch import (AskBatcher, BatchAsk, ContinuousWaveScheduler,
                        execute_ask_batch, wait_adaptive_close)
from .device import DeviceEntity, DeviceEntityRef, DeviceShardRegion
from .remember import (DDataRememberEntitiesStore,
                       InProcRememberEntitiesStore,
                       JournalRememberEntitiesStore, RememberEntitiesStore)

__all__ = ["AskBatcher", "BatchAsk", "ContinuousWaveScheduler",
           "DDataRememberEntitiesStore", "DeviceEntity", "DeviceEntityRef",
           "DeviceShardRegion", "InProcRememberEntitiesStore",
           "JournalRememberEntitiesStore",
           "RememberEntitiesStore", "execute_ask_batch",
           "wait_adaptive_close"]
