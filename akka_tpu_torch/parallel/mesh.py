"""Meshes of shard slots: what a "device" is to the sharded runtime.

Port of `akka_tpu/parallel/mesh.py`. The reference lays its actor shards
over a `jax.sharding.Mesh` of devices, and `initialize_distributed` makes
`jax.devices()` span every process, so one mesh crosses hosts. Here a mesh
is an ordered grid of **shard slots**: small hashable values, each naming
its index in the mesh, the torch device it lives on and the rank that
drives it. The sentinel's `devices`, the autoscaler's `device_pool` and
the region's `survivors` are lists of slots.

A mesh without a process group is one card's: every slot is rank 0's.
A mesh may carry a process group of world size W (`make_mesh(...,
group=g)`): its slots are ordered by rank, rank r holds the contiguous
block of slots whose `rank == r`, and every rank holds as many. The group
is an explicit object (`initialize_distributed` then `process_group()`,
or a `ProcessGroupGloo` the caller built); no mesh picks up the default
group by itself. `ShardedBatchedSystem`, `DeviceShardRegion` and the bank
functions of `ddata/tensor.py` run over such a mesh as the reference's
SPMD program runs over a multi-process mesh: every rank makes the same
calls, and each keeps its own block (batched/sharded.py). The collectives
are `parallel/ranks.py`'s.

PyTorch drives one card per process, so a mesh whose *own rank's* slots
lie on more than one card raises: give each card a rank of its own. The
reference's one process over every chip of a host is not ported (ROADMAP
C). The backend follows `device=`: CUDA (the default) gives NCCL and
raises without a card, `device="cpu"` gives gloo.

`shard_spec` and `replicated_spec` are placement descriptors (the
reference's `NamedSharding`s): `ShardedBatchedSystem(mesh=...)` and the
bank functions accept one where they take a mesh.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import DeviceLike, resolve_device
from .ranks import RankGroup

# the pool of slots a sentinel or autoscaler draws from when none is
# given: the reference's tier-1 mesh of 8 (virtual) devices
DEFAULT_POOL_SLOTS = 8


def _card(device: DeviceLike, rank: int = 0) -> torch.device:
    """The card of `rank`'s slots: `device` resolved (CUDA by default,
    raising without a card). A CUDA device without an index is
    cuda:(rank % device_count), so one card compares equal to itself."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


@dataclass(frozen=True)
class ShardSlot:
    """One shard's place: its index in the mesh, its card, and the rank of
    the process group that drives it (0 on a mesh without a group)."""

    index: int
    device: torch.device
    rank: int = 0

    def __repr__(self) -> str:
        if self.rank:
            return f"ShardSlot({self.index}, {self.device}, rank={self.rank})"
        return f"ShardSlot({self.index}, {self.device})"


def shard_slots(n: int = DEFAULT_POOL_SLOTS,
                device: DeviceLike = None) -> list:
    """Slots 0 .. n - 1 on one card (`device`, default CUDA)."""
    dev = _card(device)
    return [ShardSlot(i, dev) for i in range(int(n))]


class Mesh:
    """An ordered grid of shard slots with named axes (the reference's
    `jax.sharding.Mesh`): `shape[axis]` is an axis's size, `devices` the
    slot grid, `slots` the slots in order, `cards` every card they name.
    With `group` (a torch.distributed process group), the slots are split
    over its ranks: `rank`, `world_size`, `local_slots` (this rank's) and
    `ranks` (the group's collectives, parallel/ranks.py); without it the
    mesh is one card's and `rank == 0`, `world_size == 1`."""

    def __init__(self, devices, axis_names: Tuple[str, ...], group=None):
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
        self.group = group
        self.ranks: Optional[RankGroup] = None
        ranks = [s.rank for s in flat]
        if group is None:
            if any(ranks):
                raise ValueError(
                    f"slots of ranks {sorted(set(ranks))}: a mesh over "
                    f"several ranks needs their process group "
                    f"(make_mesh(..., group=...))")
            self.rank, self.world_size = 0, 1
        else:
            self.ranks = RankGroup(group)
            self.rank, self.world_size = self.ranks.rank, self.ranks.size
            w = self.world_size
            counts = np.bincount(ranks, minlength=w)
            if min(ranks) < 0 or max(ranks) >= w or \
                    len(set(counts.tolist())) != 1:
                raise ValueError(
                    f"a mesh over a group of {w} ranks holds the same "
                    f"number of slots on every rank 0 .. {w - 1}; slot "
                    f"ranks {ranks}")
            if grid.ndim == 1 and ranks != sorted(ranks):
                raise ValueError(f"the slots of a 1-D mesh are ordered by "
                                 f"rank; slot ranks {ranks}")
        self.local_slots: Tuple[ShardSlot, ...] = tuple(
            s for s in flat if s.rank == self.rank)

    @property
    def device(self) -> torch.device:
        """This rank's card: the one its slots lie on. Raises
        NotImplementedError for a rank whose slots lie on several cards:
        the port drives one card per process."""
        cards = tuple(dict.fromkeys(s.device for s in self.local_slots))
        if len(cards) != 1:
            raise NotImplementedError(
                f"rank {self.rank}'s slots lie on {len(cards)} cards "
                f"{list(cards)}: the port drives one card per process; "
                f"give each card a rank of its own in a process group "
                f"(make_mesh(..., group=...)), as ROADMAP C's "
                f"one-process-per-card rule says")
        return cards[0]

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and \
            self.axis_names == other.axis_names and \
            self.devices.shape == other.devices.shape and \
            self.slots == other.slots and self.group is other.group

    def __hash__(self) -> int:
        return hash((self.axis_names, self.devices.shape, self.slots))

    def __repr__(self) -> str:
        ranked = f", world_size={self.world_size}" if self.group else ""
        return f"Mesh({self.shape}, {list(self.slots)}{ranked})"


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


def _world(group) -> int:
    return 1 if group is None else int(group.size())


def _split(n: int, w: int, what: str) -> int:
    if n % w:
        raise ValueError(f"{what} = {n} slots do not divide over a group "
                         f"of {w} ranks")
    return n // w


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "shards",
              devices: Optional[Sequence[ShardSlot]] = None,
              device: DeviceLike = None, group=None) -> Mesh:
    """1D mesh over the actor-shard axis: `devices` (slots), or
    `n_devices` slots (default DEFAULT_POOL_SLOTS) on `device`'s card.
    With `group`, `n_devices` counts the slots of every rank and must
    divide by its world size W: rank r holds slots [r * n / W,
    (r + 1) * n / W), on `device` if given, else on cuda:(r %
    device_count)."""
    if devices is None:
        n = int(n_devices if n_devices is not None else DEFAULT_POOL_SLOTS)
        per = _split(n, _world(group), "n_devices")
        devices = [ShardSlot(i, _card(device, i // per), i // per)
                   for i in range(n)]
    return Mesh(list(devices), (axis_name,), group)


def make_mesh_2d(dp: int, tp: int, axis_names=("dp", "tp"),
                 devices: Optional[Sequence[ShardSlot]] = None,
                 device: DeviceLike = None, group=None) -> Mesh:
    """2D mesh for layered parallelism (shard axis x replication axis).
    With `group`, the second (replica) axis is laid across its ranks:
    tp must divide by the world size W, and slot (i, j) is rank
    j // (tp / W)'s."""
    if devices is None:
        per = _split(int(tp), _world(group), "tp")
        devices = [ShardSlot(i * tp + j, _card(device, j // per), j // per)
                   for i in range(dp) for j in range(tp)]
    devices = list(devices)[: dp * tp]
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(dp, tp), tuple(axis_names), group)


def check_one_card(slots: Sequence, what: str) -> None:
    """Refuse `slots` (ShardSlots; other items are not checked) that
    `what` (failover, the autoscaler) cannot run over: slots of several
    ranks raise NotImplementedError naming ROADMAP A10.3, slots of one
    rank on several cards the one-process-per-card rule."""
    slots = [s for s in slots if isinstance(s, ShardSlot)]
    ranks = sorted({s.rank for s in slots})
    if len(ranks) > 1 or any(ranks):
        raise NotImplementedError(
            f"{what} over the slots of ranks {ranks}: failover across "
            f"ranks (the agreement on the lost-slot mask, evicting only a "
            f"live rank's slots) is ROADMAP A10.3; give it the slots of "
            f"one card")
    if slots:
        Mesh(slots, ("slots",)).device  # raises for several cards


def shard_spec(mesh: Mesh, axis_name: str = "shards") -> Placement:
    """Rows split over the mesh axis (actor axis / shard axis)."""
    return Placement(mesh, (axis_name,))


def replicated_spec(mesh: Mesh) -> Placement:
    return Placement(mesh, ())


def host_device_count() -> int:
    """The cards this process sees."""
    return torch.cuda.device_count()


_distributed_initialized = False
_distributed_lock = threading.Lock()


def _env_int(value: Optional[int], name: str) -> int:
    if value is not None:
        return int(value)
    if name not in os.environ:
        raise ValueError(f"initialize_distributed: pass the "
                         f"{'process id' if name == 'RANK' else 'process count'}"
                         f" or set {name}")
    return int(os.environ[name])


def initialize_distributed(coordinator_address: Optional[str],
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device: DeviceLike = None) -> bool:
    """Bring up this process's rank of the multi-process runtime: one
    `dist.init_process_group` over `tcp://<coordinator_address>` (torch's
    `env://` when the address is None), world size `num_processes`, rank
    `process_id` (each falls back to torch's WORLD_SIZE and RANK). The
    backend follows `device`: CUDA (the default; raises without a card)
    gives NCCL on cuda:(rank % device_count) unless `device` names a card,
    "cpu" gives gloo. `process_group()` then hands the group to
    `make_mesh(..., group=...)`. Idempotent; returns whether this call
    performed the initialization (the reference's contract)."""
    global _distributed_initialized
    with _distributed_lock:
        if _distributed_initialized or dist.is_initialized():
            return False
        rank = _env_int(process_id, "RANK")
        world = _env_int(num_processes, "WORLD_SIZE")
        dev = _card(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=("tcp://" + coordinator_address
                         if coordinator_address else "env://"),
            world_size=world, rank=rank)
        _distributed_initialized = True
        return True


def shutdown_distributed() -> bool:
    """Destroy the process group `initialize_distributed` set up (a port
    addition: a process may start its group again afterwards). Returns
    whether there was one to destroy."""
    global _distributed_initialized
    with _distributed_lock:
        if not _distributed_initialized:
            return False
        if dist.is_initialized():
            dist.destroy_process_group()
        _distributed_initialized = False
        return True


def process_group():
    """The default process group `initialize_distributed` set up, to pass
    to `make_mesh(..., group=...)`. Raises RuntimeError before it."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: initialize_distributed first")
    return dist.group.WORLD


def maybe_initialize_distributed_from_config(config) -> bool:
    """ActorSystem bootstrap hook: `akka.jax-distributed.enabled = true`
    plus coordinator-address / num-processes / process-id (the reference's
    keys; the process id and count default from torch's RANK and
    WORLD_SIZE) and `device` (a port addition: "cpu" gives gloo, the
    default CUDA gives NCCL). Returns whether it initialized."""
    if config is None or not config.get_bool("akka.jax-distributed.enabled",
                                             False):
        return False
    addr = config.get_string("akka.jax-distributed.coordinator-address", "")
    n = config.get_int("akka.jax-distributed.num-processes", 0) or None
    pid = config.get_int("akka.jax-distributed.process-id", -1)
    device = config.get_string("akka.jax-distributed.device", "") or None
    return initialize_distributed(addr or None, n,
                                  pid if pid >= 0 else None, device=device)
