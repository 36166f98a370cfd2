"""Shard slots and meshes over them (port of akka_tpu/parallel)."""

from .mesh import (DEFAULT_POOL_SLOTS, Mesh, Placement, ShardSlot,
                   host_device_count, make_mesh, make_mesh_2d,
                   replicated_spec, shard_slots, shard_spec)

__all__ = ["DEFAULT_POOL_SLOTS", "Mesh", "Placement", "ShardSlot",
           "host_device_count", "make_mesh", "make_mesh_2d",
           "replicated_spec", "shard_slots", "shard_spec"]
