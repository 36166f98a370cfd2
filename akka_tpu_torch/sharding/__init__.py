"""Cluster sharding on the device (port of `akka_tpu/sharding`): the
region's data plane (`DeviceShardRegion`), its synchronous ask engine and
the futures front end (`AskBatcher`, `ContinuousWaveScheduler`). The host
control plane (ShardRegion/ShardCoordinator actors) is not ported yet
(ROADMAP A12)."""

from .ask_batch import (AskBatcher, BatchAsk, ContinuousWaveScheduler,
                        execute_ask_batch, wait_adaptive_close)
from .device import DeviceEntity, DeviceEntityRef, DeviceShardRegion

__all__ = ["AskBatcher", "BatchAsk", "ContinuousWaveScheduler",
           "DeviceEntity", "DeviceEntityRef", "DeviceShardRegion",
           "execute_ask_batch", "wait_adaptive_close"]
