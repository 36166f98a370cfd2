"""Cluster sharding on the device (port of `akka_tpu/sharding`): the
region's data plane (`DeviceShardRegion`) and its synchronous ask engine.
The host control plane (ShardRegion/ShardCoordinator actors) and the
futures front end (`AskBatcher`, `ContinuousWaveScheduler`) are not ported
yet (ROADMAP A7, A12)."""

from .ask_batch import BatchAsk, execute_ask_batch
from .device import DeviceEntity, DeviceEntityRef, DeviceShardRegion

__all__ = ["BatchAsk", "DeviceEntity", "DeviceEntityRef",
           "DeviceShardRegion", "execute_ask_batch"]
