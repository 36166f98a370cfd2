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

Converging replicas across devices (`converge_over_mesh`,
`replicate_bank`) takes a process group and lands with ROADMAP A10.
"""

from __future__ import annotations

import torch

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


def converge_over_mesh(bank: torch.Tensor, mesh, axis: str = "replica",
                       op: str = "max") -> torch.Tensor:
    """All-replica merge of a replicated bank over a mesh axis: one
    all-reduce over the replicas. Needs more than one device: not ported
    yet (ROADMAP A10)."""
    raise NotImplementedError(
        "converge_over_mesh needs a device mesh, which lands with "
        "ROADMAP A10")


def replicate_bank(bank: torch.Tensor, mesh,
                   axis: str = "replica") -> torch.Tensor:
    """Stack one replica of `bank` per device along `axis`. Needs more
    than one device: not ported yet (ROADMAP A10)."""
    raise NotImplementedError(
        "replicate_bank needs a device mesh, which lands with ROADMAP A10")
