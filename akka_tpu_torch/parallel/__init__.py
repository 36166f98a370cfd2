"""Shard slots, meshes over them, and ranks over torch.distributed (port
of akka_tpu/parallel)."""

from .mesh import (DEFAULT_POOL_SLOTS, Mesh, Placement, ShardSlot,
                   host_device_count, initialize_distributed, make_mesh,
                   make_mesh_2d, maybe_initialize_distributed_from_config,
                   process_group, replicated_spec, shard_slots, shard_spec,
                   shutdown_distributed)
from .ranks import RankGroup

__all__ = ["DEFAULT_POOL_SLOTS", "Mesh", "Placement", "RankGroup",
           "ShardSlot", "host_device_count", "initialize_distributed",
           "make_mesh", "make_mesh_2d",
           "maybe_initialize_distributed_from_config", "process_group",
           "replicated_spec", "shard_slots", "shard_spec",
           "shutdown_distributed"]
