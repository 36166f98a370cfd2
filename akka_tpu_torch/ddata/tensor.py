"""Tensor-native bulk CRDT kernels: the device data plane for ddata.

Port of `akka_tpu/ddata/tensor.py` (commit 001ef4f). An application with
many counters, flags or sets (one per entity, say) holds them as a bank:
one tensor with a row per key and a column per cluster node. Merging two
replicas of a bank is one elementwise op on the device.

Layouts and dtypes are the reference's (n_keys rows; n_nodes small):

- GCounterBank:  uint32[n_keys, n_nodes]      merge = max, value = row sum
- PNCounterBank: uint32[n_keys, 2, n_nodes]   [:, 0] = incs, [:, 1] = decs
- GSetBank:      bool[n_keys, n_elems]        merge = or, fixed universe
- FlagBank:      bool[n_keys]                 merge = or

torch has no uint32 arithmetic (max, scatter-add), so each function
computes on int64 values in [0, 2^32) (utils/u32.py) and returns the
reference's dtype: uint32 banks and values wrap modulo 2^32 as the
reference's uint32 ops do. Every function runs on the banks' device.

Replicas of a bank over a mesh (`replicate_bank`, `converge_over_mesh`)
are the leading axis of one tensor on the mesh's card: one replica per
slot of the mesh's replica axis (parallel/mesh.py), and converging them
is one `amax` over that axis (`any` for boolean banks), broadcast back.
When the replica axis spans the ranks of the mesh's process group, each
rank holds its own replicas (the axis's size over the world size) as the
bank's leading axis: it merges them locally with one `amax` (`any`),
then runs one `all_reduce(MAX)` over the group (uint32 banks as int64
values in [0, 2^32): gloo refuses uint32), and broadcasts the join back
over its replicas, in the reference's dtypes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.mesh import mesh_of
from ..utils.u32 import MASK32, to_int32, to_uint32, u32


def gcounter_merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise max over per-node rows (GCounter merge). Returns uint32,
    a's shape."""
    return to_uint32(torch.maximum(u32(a), u32(b)))


def gcounter_value(bank: torch.Tensor) -> torch.Tensor:
    """Per-key counter value: the sum over the node axis, uint32 (wraps
    modulo 2^32, as the reference's uint32 sum does)."""
    return to_uint32(u32(bank).sum(dim=-1) & MASK32)


def pncounter_merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise max of PN banks. Returns uint32."""
    return to_uint32(torch.maximum(u32(a), u32(b)))


def pncounter_value(bank: torch.Tensor) -> torch.Tensor:
    """Per-key value incs - decs as int32 [n_keys]: the reference's dtype
    with 64-bit types off (its default, and how the tests run it), the
    difference taken modulo 2^32."""
    s = u32(bank).sum(dim=-1) & MASK32  # [n_keys, 2]
    return to_int32((s[..., 0] - s[..., 1]) & MASK32)


def gset_merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise or of two bool banks. Returns bool."""
    return torch.logical_or(a, b)


flag_merge = gset_merge


def gcounter_increment(bank: torch.Tensor, node_slot: int,
                       key_ids: torch.Tensor,
                       amounts: torch.Tensor) -> torch.Tensor:
    """Batched local increment: bump this node's column for each key in
    `key_ids` by `amounts` (taken as uint32). Duplicate key ids
    accumulate, and a row past 2^32 - 1 wraps, as the reference's
    scatter-add does. Returns a new uint32 bank; `bank` is untouched."""
    out = u32(bank).clone()
    key_ids = torch.as_tensor(key_ids, device=out.device).to(torch.int64)
    slot = torch.full_like(key_ids, int(node_slot))
    out.index_put_((key_ids, slot), u32(amounts, device=out.device),
                   accumulate=True)
    return to_uint32(out & MASK32)


def _replicas(mesh, axis: str):
    """The mesh (of a mesh or placement) and the replicas of its `axis`
    this rank holds: all of them without a group, else the axis's size
    over the world size, the group's ranks laid along the axis."""
    m = mesh_of(mesh)
    if axis not in m.shape:
        raise ValueError(f"the mesh has no axis {axis!r} ({m.axis_names})")
    n = m.shape[axis]
    m.device  # this rank's slots lie on one card (one process per card)
    if m.group is None:
        return m, n
    ranks = np.vectorize(lambda slot: slot.rank, otypes=[np.int64])(
        np.moveaxis(m.devices, m.axis_names.index(axis), 0))
    along = ranks.reshape(n, -1)
    per = n // m.world_size
    if n % m.world_size or (along != along[:, :1]).any() or \
            (along[:, 0] != np.arange(n) // per).any():
        raise ValueError(f"the ranks of the mesh's group are not laid "
                         f"along its {axis!r} axis")
    return m, per


def converge_over_mesh(bank: torch.Tensor, mesh, axis: str = "replica",
                       op: str = "max") -> torch.Tensor:
    """All-replica merge of a replicated bank: `bank` holds this rank's
    replicas of the mesh's `axis` (every replica without a group) along
    its leading axis (as `replicate_bank` lays it out). Every replica
    becomes the join of all of them: the max over the replica axis ("or"
    for boolean banks), broadcast back; over ranks one all_reduce joins
    the ranks' local joins (every rank calls it alike). Returns a new
    bank of `bank`'s shape and dtype."""
    m, n = _replicas(mesh, axis)
    if bank.shape[0] != n:
        raise ValueError(f"bank has {bank.shape[0]} replicas, the mesh's "
                         f"{axis!r} axis {n} on this rank")
    if op == "or":
        merged = bank.to(torch.bool).any(dim=0)
        if m.ranks is not None:
            merged = m.ranks.any(merged)
    elif op == "max":
        wide = u32(bank) if bank.dtype == torch.uint32 else bank
        merged = wide.amax(dim=0)
        if m.ranks is not None:
            merged = m.ranks.all_reduce(merged, "max")
        if bank.dtype == torch.uint32:
            merged = to_uint32(merged)
    else:
        raise ValueError(f"unknown merge op {op!r} (max, or)")
    return merged.unsqueeze(0).expand_as(bank).clone()


def replicate_bank(bank: torch.Tensor, mesh,
                   axis: str = "replica") -> torch.Tensor:
    """Stack one replica of `bank` per slot of the mesh's `axis` that this
    rank holds along a new leading axis, on the mesh's card (this rank's)
    (a test and bootstrap helper: real deployments start each node with
    its own local bank)."""
    m, n = _replicas(mesh, axis)
    return bank.to(m.device).unsqueeze(0).expand(
        (n,) + tuple(bank.shape)).clone()
