"""Meshes of shard slots: what a "device" is to the sharded runtime.

Port of `akka_tpu/parallel/mesh.py`. The reference lays its actor shards
over a `jax.sharding.Mesh` of devices. The port runs every shard of a
system on one card (`batched/sharded.py`), so a mesh here is an ordered
grid of **shard slots**: small hashable values, each naming its index and
the torch device it lives on. The sentinel's `devices`, the autoscaler's
`device_pool` and the region's `survivors` are lists of slots. Evicting a
slot rebuilds the system on the remaining slots, on the same card.

`shard_spec` and `replicated_spec` are placement descriptors (the
reference's `NamedSharding`s): `ShardedBatchedSystem(mesh=...)` and the
bank functions of `ddata/tensor.py` accept one where they take a mesh.

A mesh whose slots lie on more than one card (or, later, rank) can be
described, but the systems refuse it: that is ROADMAP A10.2, ranks over
`torch.distributed`, which also ports `initialize_distributed` and
`maybe_initialize_distributed_from_config`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device

# the pool of slots a sentinel or autoscaler draws from when none is
# given: the reference's tier-1 mesh of 8 (virtual) devices
DEFAULT_POOL_SLOTS = 8


def _card(device: DeviceLike) -> torch.device:
    """`device` resolved (CUDA by default, raising without a card), with a
    CUDA device's index made explicit so one card compares equal to
    itself."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return dev


@dataclass(frozen=True)
class ShardSlot:
    """One shard's place: its index in the pool and its card."""

    index: int
    device: torch.device

    def __repr__(self) -> str:
        return f"ShardSlot({self.index}, {self.device})"


def shard_slots(n: int = DEFAULT_POOL_SLOTS,
                device: DeviceLike = None) -> list:
    """Slots 0 .. n - 1 on one card (`device`, default CUDA)."""
    dev = _card(device)
    return [ShardSlot(i, dev) for i in range(int(n))]


class Mesh:
    """An ordered grid of shard slots with named axes (the reference's
    `jax.sharding.Mesh`): `shape[axis]` is an axis's size, `devices` the
    slot grid, `slots` the slots in order."""

    def __init__(self, devices, axis_names: Tuple[str, ...]):
        grid = np.empty(np.shape(devices)[:len(axis_names)], dtype=object)
        flat = [d for d in np.asarray(devices, dtype=object).reshape(-1)]
        for i, slot in enumerate(flat):
            if not isinstance(slot, ShardSlot):
                raise TypeError(f"a mesh is built from ShardSlots, got "
                                f"{slot!r}")
            grid.flat[i] = slot
        if len(set(flat)) != len(flat):
            raise ValueError(f"a slot appears twice in the mesh: {flat}")
        if not flat:
            raise ValueError("a mesh needs at least one slot")
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, grid.shape))
        self.slots: Tuple[ShardSlot, ...] = tuple(flat)
        self.size = len(flat)
        self.cards: Tuple[torch.device, ...] = tuple(
            dict.fromkeys(s.device for s in flat))

    @property
    def device(self) -> torch.device:
        """The one card the mesh's slots lie on. Raises
        NotImplementedError for a mesh over several cards (A10.2)."""
        if len(self.cards) != 1:
            raise NotImplementedError(
                f"a mesh over {len(self.cards)} cards {list(self.cards)}: "
                f"shards on more than one card or rank are ROADMAP A10.2 "
                f"(ranks over torch.distributed); build the mesh from "
                f"slots of one card")
        return self.cards[0]

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and \
            self.axis_names == other.axis_names and \
            self.devices.shape == other.devices.shape and \
            self.slots == other.slots

    def __hash__(self) -> int:
        return hash((self.axis_names, self.devices.shape, self.slots))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {list(self.slots)})"


@dataclass(frozen=True)
class Placement:
    """Where rows live on a mesh (the reference's `NamedSharding`):
    `axes == (axis,)` splits the leading axis over that mesh axis, `()`
    replicates."""

    mesh: Mesh
    axes: Tuple[str, ...]


def mesh_of(mesh_or_placement) -> Mesh:
    """The mesh of a Mesh or a Placement."""
    if isinstance(mesh_or_placement, Placement):
        return mesh_or_placement.mesh
    if isinstance(mesh_or_placement, Mesh):
        return mesh_or_placement
    raise TypeError(f"expected a Mesh or a Placement, got "
                    f"{type(mesh_or_placement).__name__}")


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "shards",
              devices: Optional[Sequence[ShardSlot]] = None,
              device: DeviceLike = None) -> Mesh:
    """1D mesh over the actor-shard axis: `devices` (slots), or the first
    `n_devices` slots of `device`'s card (default: DEFAULT_POOL_SLOTS)."""
    if devices is None:
        devices = shard_slots(n_devices if n_devices is not None
                              else DEFAULT_POOL_SLOTS, device)
    return Mesh(list(devices), (axis_name,))


def make_mesh_2d(dp: int, tp: int, axis_names=("dp", "tp"),
                 devices: Optional[Sequence[ShardSlot]] = None,
                 device: DeviceLike = None) -> Mesh:
    """2D mesh for layered parallelism (shard axis x replication axis)."""
    if devices is None:
        devices = shard_slots(dp * tp, device)
    devices = list(devices)[: dp * tp]
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(dp, tp), tuple(axis_names))


def shard_spec(mesh: Mesh, axis_name: str = "shards") -> Placement:
    """Rows split over the mesh axis (actor axis / shard axis)."""
    return Placement(mesh, (axis_name,))


def replicated_spec(mesh: Mesh) -> Placement:
    return Placement(mesh, ())


def host_device_count() -> int:
    """The cards this process sees."""
    return torch.cuda.device_count()
