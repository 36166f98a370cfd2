"""Delivery primitives: segment reductions over recipient ids.

Port of `akka_tpu/ops/segment.py`. A step's messages are SoA columns
(dst, payload, valid) and "enqueue + dequeue" becomes one segment reduction
per step: sums/maxes/counts land in per-actor rows (reduce mode), or each
actor's first S messages land in its mailbox slots in arrival order (slots
mode). Invalid or out-of-range rows fall into a drop bucket (index
n_actors), so no dynamic filtering is needed.

Kernel families behind the `backend` seam (the reference's names in
brackets):

- "ranked" ["xla"]: rank-then-scatter. One stable sort of the narrow int32
  recipient key gives each row its arrival rank within its recipient;
  every slot index, spill position and aggregation offset is closed-form
  from (rank, counts), and payload rows move by gather.
- "cuda" ["pallas"]: the ring mailbox, a hand-written CUDA kernel
  (`ops/cuda_mailbox.py`, `csrc/ring_mailbox.cu`). On a CPU tensor its plain
  PyTorch version runs instead.
- "auto" (None): on a CUDA tensor, the ring kernel wherever
  `cuda_mailbox.supported()` holds and "ranked" otherwise; on a CPU tensor,
  "ranked" (or "scatter" through `choose_reduce_kernel`), as the reference
  resolves on its CPU.

An explicit backend="cuda" outside the ring kernel's support matrix raises
ValueError naming the option: it never falls back silently. The sharded
exchange's bucketing always ranks (`exchange_uses_ranked`). The
reference's wide "reference" family, its counting/packed rank strategies,
`StaticTopology`/`deliver_static`, `route_one_hop` and `compact_messages`
are not ported yet.

Integer outputs (counts, slots, types, valid, dropped, ranks) are
bit-identical to the reference. Float sums are taken in another order
(cumsum on the host or the card, atomics in the ring kernel), so they
agree within a tolerance, not bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..utils.device import platform_of


class Delivery(NamedTuple):
    sum: torch.Tensor     # [N, P]
    max: torch.Tensor     # [N, P]
    count: torch.Tensor   # [N] int32


class SlotDelivery(NamedTuple):
    """Per-message mailbox delivery: each actor's first `slots` messages
    this step in arrival order, plus the exact commutative aggregation over
    every message consumed this step. With a spill region (spill_cap > 0),
    messages past the slot cap and all mail to suspended rows are not
    consumed: they come back compacted in the spill_* outputs for
    redelivery next step."""

    types: torch.Tensor    # [N, S] int32 message-type tags (slot invalid -> 0)
    payload: torch.Tensor  # [N, S, P]
    valid: torch.Tensor    # [N, S] bool
    count: torch.Tensor    # [N] int32 messages consumed this step
    sum: torch.Tensor      # [N, P] segment-sum over consumed messages
    max: torch.Tensor      # [N, P] segment-max over consumed (zeros unless
                           #        need_max)
    dropped: torch.Tensor  # [] int32 real losses this step
    spill_dst: torch.Tensor      # [spill_cap] int32 local rows (-1 = empty)
    spill_type: torch.Tensor     # [spill_cap]
    spill_payload: torch.Tensor  # [spill_cap, P]
    spill_valid: torch.Tensor    # [spill_cap] bool


# ---------------------------------------------------------------------------
# backend seam. The backend names the IMPLEMENTATION of the ordered kernels;
# the mode names the semantic variant callers ask for.
# ---------------------------------------------------------------------------

DELIVERY_BACKENDS = ("auto", "ranked", "cuda")
REDUCE_MODES = ("auto", "scatter", "merge", "sort")

# Below this message count the ordered reduce kernels are N-shaped while
# scatter is M-shaped (the reference's measured crossover, kept as is).
SCATTER_MAX_M = 1024


def _check_backend(backend: Optional[str]) -> str:
    """The backend's name (None -> "auto"); ValueError for any other name,
    the reference's "xla"/"reference"/"pallas" included."""
    backend = backend or "auto"
    if backend not in DELIVERY_BACKENDS:
        raise ValueError(f"unknown delivery backend {backend!r}; "
                         f"expected one of {DELIVERY_BACKENDS}")
    return backend


def _use_ring(backend: Optional[str], platform: str,
              unsupported: Optional[str]) -> bool:
    """Resolve the backend seam for one call: True runs the ring mailbox
    (kernel on a CUDA tensor, plain version on a CPU tensor)."""
    backend = _check_backend(backend)
    if backend == "cuda":
        if unsupported is not None:
            raise ValueError(
                f"delivery backend 'cuda': {unsupported} is outside the "
                f"ring-mailbox kernel's support matrix; use backend='ranked'")
        return True
    return backend == "auto" and platform == "cuda" and unsupported is None


def choose_reduce_kernel(m: int, n_actors: int, p: int,
                         platform: str = "cpu") -> str:
    """Cost model for mode="auto": scatter on the CPU and for a few rows
    (M <= SCATTER_MAX_M), where an N-shaped ordered kernel would price an
    M-shaped problem; "merge" otherwise, which the backend seam runs on the
    ring kernel on a card."""
    del n_actors, p  # kept in the signature, as in the reference
    if platform == "cpu" or m <= SCATTER_MAX_M:
        return "scatter"
    return "merge"


def _neg_inf(dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("-inf")
    return torch.iinfo(dtype).min


def _segment_max(vals: torch.Tensor, key: torch.Tensor,
                 n_segments: int) -> torch.Tensor:
    """Per-segment max of [M, P] rows over int64 keys in [0, n_segments);
    segments with no rows read the dtype's -inf."""
    out = torch.full((n_segments, vals.shape[1]), _neg_inf(vals.dtype),
                     dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, key[:, None].expand_as(vals), vals,
                               "amax", include_self=False)


def deliver(dst: torch.Tensor, payload: torch.Tensor, valid: torch.Tensor,
            n_actors: int, need_max: bool = False, mode: str = "auto",
            backend: Optional[str] = None) -> Delivery:
    """Reduce messages into per-actor inbox rows.

    dst: [M] int32 recipient ids; payload: [M, P]; valid: [M] bool.
    Invalid or out-of-range messages fall into a drop bucket.

    Modes: "scatter" (index_add_), "merge"/"sort" (the ordered kernels:
    the ring mailbox or rank-then-scatter, by backend), "auto"
    (`choose_reduce_kernel`).
    """
    if mode not in REDUCE_MODES:
        raise ValueError(f"unknown delivery mode {mode!r}; "
                         f"expected one of {REDUCE_MODES}")
    m, p = payload.shape
    platform = platform_of(dst)
    if mode == "auto":
        mode = choose_reduce_kernel(m, n_actors, p, platform)
    if mode == "scatter":
        return _deliver_scatter(dst, payload, valid, n_actors, need_max)
    from . import cuda_mailbox  # deferred: cuda_mailbox imports this module
    why = cuda_mailbox.unsupported_reason(n_actors, p, dtype=payload.dtype)
    if _use_ring(backend, platform, why):
        return cuda_mailbox.deliver_reduce(dst, payload, valid, n_actors,
                                           need_max)
    return _deliver_ranked(dst, payload, valid, n_actors, need_max,
                           style=mode)


def stable_ranks(key: torch.Tensor,
                 n_keys: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rank phase of rank-then-scatter: for each row, the number of
    EARLIER rows with the same key (its stable arrival rank within the
    recipient), plus per-key counts. Returns (rank [M] int32,
    counts [n_keys + 1] int32); keys must lie in [0, n_keys].

    One stable sort of the narrow key (the reference's "sort2" strategy,
    its pick off the CPU): a row's rank is its sorted position minus its
    segment's start, and segment bounds come from a binary search of the
    sorted keys."""
    m = key.shape[0]
    skey, order = torch.sort(key, stable=True)
    bounds = torch.searchsorted(
        skey, torch.arange(n_keys + 2, dtype=key.dtype, device=key.device))
    pos = torch.arange(m, dtype=torch.int64, device=key.device)
    rank = torch.empty((m,), dtype=torch.int64, device=key.device)
    rank.scatter_(0, order, pos - bounds[skey.long()])
    counts = (bounds[1:] - bounds[:-1]).to(torch.int32)
    return rank.to(torch.int32), counts


def exchange_uses_ranked(platform: str,
                         backend: Optional[str] = None) -> bool:
    """Kernel choice for the sharded exchange's bucketing (rank within
    each (source, destination) shard pair, then a scatter into the
    [D, D, C] exchange buffer). Every port backend ranks with
    `stable_ranks`: the ring mailbox has no exchange kernel, so "cuda"
    rides the ranked path, as the reference's "pallas" does. Raises
    ValueError for a backend the port does not have."""
    del platform  # kept in the signature, as in the reference
    _check_backend(backend)
    return True


def _sorted_sums(inv: torch.Tensor, incl: torch.Tensor, excl: torch.Tensor,
                 masked: torch.Tensor, n_actors: int) -> torch.Tensor:
    """Per-segment sums by cumsum over the (recipient, arrival) layout:
    `inv` is each row's sorted position, so one int64 scatter inverts it
    and the payload rows follow by gather. The reference's "merge" layout
    interleaves zero marker rows into the same cumsum to pin XLA's scan
    association; adding +0.0 leaves every partial sum unchanged, so both
    reference styles reduce to this one."""
    m, p = masked.shape
    g = torch.empty((m,), dtype=torch.int64, device=masked.device)
    g.scatter_(0, inv, torch.arange(m, dtype=torch.int64,
                                    device=masked.device))
    csum = torch.cat([masked.new_zeros((1, p)),
                      torch.cumsum(masked[g], dim=0)], dim=0)
    return (csum[incl[:n_actors]] - csum[excl[:n_actors]]).to(masked.dtype)


def _rank_layout(dst, valid, n_actors: int):
    """Shared rank phase of the ranked kernels: (ok, key, rank, counts_full,
    incl, excl, inv) with int64 offsets for indexing."""
    ok = valid & (dst >= 0) & (dst < n_actors)
    key = torch.where(ok, dst, n_actors).to(torch.int32)
    rank, counts_full = stable_ranks(key, n_actors)
    incl = torch.cumsum(counts_full, 0)                     # [n+1] int64
    excl = incl - counts_full
    inv = excl[key.long()] + rank
    return ok, key, rank, counts_full, incl, excl, inv


def _deliver_ranked(dst, payload, valid, n_actors: int, need_max: bool,
                    style: str = "merge") -> Delivery:
    """Rank-then-scatter segment reduction (key sort + rank, place,
    reduce). `style` keeps each reference style's empty-segment max
    convention: "merge" zeroes max <= -inf sentinels, "sort" zeroes
    count == 0 segments."""
    p = payload.shape[1]
    ok, key, _, counts_full, incl, excl, inv = _rank_layout(dst, valid,
                                                            n_actors)
    counts = counts_full[:n_actors]
    masked = torch.where(ok[:, None], payload, 0).to(payload.dtype)
    sums = _sorted_sums(inv, incl, excl, masked, n_actors)
    if need_max:
        neg_inf = _neg_inf(payload.dtype)
        maxs = _segment_max(torch.where(ok[:, None], payload, neg_inf)
                            .to(payload.dtype), key.long(),
                            n_actors + 1)[:n_actors]
        if style == "merge":
            maxs = torch.where(maxs <= neg_inf, 0, maxs)
        else:
            maxs = torch.where((counts > 0)[:, None], maxs, 0)
        maxs = maxs.to(payload.dtype)
    else:
        maxs = payload.new_zeros((n_actors, p))
    return Delivery(sum=sums, max=maxs, count=counts)


def _deliver_scatter(dst, payload, valid, n_actors: int,
                     need_max: bool) -> Delivery:
    ok = valid & (dst >= 0) & (dst < n_actors)
    safe = torch.where(ok, dst, n_actors).long()
    p = payload.shape[1]
    sums = payload.new_zeros((n_actors + 1, p)).index_add_(
        0, safe, torch.where(ok[:, None], payload, 0).to(payload.dtype))
    counts = torch.zeros((n_actors + 1,), dtype=torch.int32,
                         device=dst.device).index_add_(
        0, safe, ok.to(torch.int32))[:n_actors]
    if need_max:
        neg_inf = _neg_inf(payload.dtype)
        maxs = _segment_max(torch.where(ok[:, None], payload, neg_inf)
                            .to(payload.dtype), safe, n_actors + 1)
        maxs = torch.where((counts > 0)[:, None], maxs[:n_actors], 0) \
            .to(payload.dtype)
    else:
        maxs = payload.new_zeros((n_actors, p))
    return Delivery(sum=sums[:n_actors], max=maxs, count=counts)


def deliver_slots(dst: torch.Tensor, mtype: torch.Tensor,
                  payload: torch.Tensor, valid: torch.Tensor, n_actors: int,
                  slots: int, need_max: bool = False, spill_cap: int = 0,
                  slots_kind: Optional[torch.Tensor] = None,
                  suspended: Optional[torch.Tensor] = None,
                  backend: Optional[str] = None,
                  shards: int = 1) -> SlotDelivery:
    """Ordered per-message delivery into per-actor mailbox slots.

    dst: [M] int32; mtype: [M] int32; payload: [M, P]; valid: [M] bool.
    Arrival order IS the index order of the inputs, so per-sender FIFO
    holds within each recipient's slots.

    spill_cap == 0 (bounded mailbox): messages beyond `slots` for one actor
    are dropped and counted; slots_kind/suspended are ignored.

    spill_cap > 0 (unbounded semantics): overflow for slots-kind recipients
    (slots_kind: [N] bool) and ALL mail to suspended rows (suspended: [N]
    bool) is excluded from slots AND from the aggregation, and returned
    compacted in (recipient, seq) order in the spill_* outputs; the caller
    writes it at the FRONT of the next step's inbox. Only spill-region
    overflow is a real (counted) drop.

    shards > 1 (spill_cap > 0 only) splits the recipients into that many
    equal contiguous blocks, each compacting its own spill into its own
    spill_cap rows and counting its own overflow, exactly as one call per
    block over that block's rows would: the spill outputs are then
    [shards * spill_cap] (block-major) and `dropped` is [shards].

    The ring-mailbox kernel covers spill_cap == 0 only; "auto" sends the
    other calls to "ranked", and an explicit backend="cuda" raises.
    """
    if shards > 1 and (spill_cap == 0 or n_actors % shards):
        raise ValueError(f"shards={shards} needs spill_cap > 0 and n_actors "
                         f"({n_actors}) divisible by it")
    from . import cuda_mailbox  # deferred: cuda_mailbox imports this module
    why = cuda_mailbox.unsupported_reason(
        n_actors, payload.shape[1], slots=slots, spill_cap=spill_cap,
        slots_kind=slots_kind, suspended=suspended, dtype=payload.dtype)
    if _use_ring(backend, platform_of(dst), why):
        return cuda_mailbox.deliver_slots_ring(dst, mtype, payload, valid,
                                               n_actors, slots, need_max)
    return _deliver_slots_ranked(dst, mtype, payload, valid, n_actors, slots,
                                 need_max, spill_cap, slots_kind, suspended,
                                 shards)


def _deliver_slots_ranked(dst, mtype, payload, valid, n_actors: int,
                          slots: int, need_max: bool, spill_cap: int,
                          slots_kind, suspended,
                          shards: int = 1) -> SlotDelivery:
    """Rank-then-scatter slots delivery, in the original row order: the
    stable key sort gives (rank, counts), one int64 scatter inverts the
    sort permutation, and every mailbox and spill row is then a gather at a
    closed-form sorted position."""
    m, p = payload.shape
    dev = dst.device
    i64 = torch.int64
    ok, key, rank, counts_full, incl, excl, inv = _rank_layout(dst, valid,
                                                               n_actors)
    counts = counts_full[:n_actors]
    cdst = dst.clamp(0, n_actors - 1).long()

    if spill_cap > 0:
        susp_n = (suspended if suspended is not None
                  else torch.zeros((n_actors,), dtype=torch.bool, device=dev))
        kind_n = (slots_kind if slots_kind is not None
                  else torch.ones((n_actors,), dtype=torch.bool, device=dev))
        spill = ok & (susp_n[cdst] | (kind_n[cdst] & (rank >= slots)))
        consumed = ok & ~spill
    else:
        consumed = ok

    # --- place: invert the sort permutation, then gather mailbox rows
    s2o = torch.empty((m,), dtype=i64, device=dev)
    s2o.scatter_(0, inv, torch.arange(m, dtype=i64, device=dev))
    flat = torch.arange(n_actors * slots, dtype=i64, device=dev)
    kk, jj = flat // slots, flat % slots
    buf_v = jj < counts[kk]
    if spill_cap > 0:
        buf_v &= ~susp_n[kk]
    row = s2o[torch.clamp(excl[kk] + jj, max=m - 1)]
    buf_t = torch.where(buf_v, mtype[row], 0).to(torch.int32)
    buf_p = torch.where(buf_v[:, None], payload[row], 0).to(payload.dtype)

    # spill compaction, per block of recipients: per-key spill counts
    # prefix-summed across the block's keys invert back to (key,
    # within-rank) per spill slot with one binary search over [spill_cap]
    if spill_cap > 0:
        spc = torch.where(susp_n, counts,
                          torch.where(kind_n, (counts - slots).clamp(min=0),
                                      0)).to(i64)
        per = n_actors // shards
        sp_incl = torch.cumsum(spc.reshape(shards, per), 1)
        sp_excl = torch.cat([sp_incl.new_zeros((shards, 1)), sp_incl], 1)
        ss = torch.arange(spill_cap, dtype=i64, device=dev) \
            .expand(shards, spill_cap).contiguous()
        k_s = torch.searchsorted(sp_excl, ss, right=True) - 1
        k_c = k_s.clamp(max=per - 1)                   # [shards, cap] local
        k_g = k_c + torch.arange(shards, dtype=i64, device=dev)[:, None] * per
        r_s = ss - sp_excl.gather(1, k_c) + torch.where(susp_n[k_g], 0,
                                                        slots)
        srow = s2o[torch.clamp(excl[k_g] + r_s, max=m - 1)].reshape(-1)
        total = sp_excl[:, per:]                       # [shards, 1]
        sp_v = (ss < torch.clamp(total, max=spill_cap)).reshape(-1)
        k_g = k_g.reshape(-1)
        spill_out = (torch.where(sp_v, k_g, -1).to(torch.int32),
                     torch.where(sp_v, mtype[srow], 0).to(torch.int32),
                     torch.where(sp_v[:, None], payload[srow], 0)
                     .to(payload.dtype),
                     sp_v)
        dropped = (total[:, 0] - spill_cap).clamp(min=0)
        if shards == 1:
            dropped = dropped[0]
        a_counts = counts - spc
    else:
        dropped = (ok & (rank >= slots)).sum()
        spill_out = (torch.full((0,), -1, dtype=torch.int32, device=dev),
                     torch.zeros((0,), dtype=torch.int32, device=dev),
                     payload.new_zeros((0, p)),
                     torch.zeros((0,), dtype=torch.bool, device=dev))
        a_counts = counts

    # --- reduce: exact consumed aggregation over the same sorted layout
    sums = _sorted_sums(inv, incl, excl,
                        torch.where(consumed[:, None], payload, 0)
                        .to(payload.dtype), n_actors)
    if need_max:
        # non-consumed live rows contribute 0; the -inf sentinel marks only
        # segments with no rows at all
        neg_inf = _neg_inf(payload.dtype)
        vals = torch.where(consumed[:, None], payload, 0)
        vals = torch.where(ok[:, None], vals, neg_inf).to(payload.dtype)
        maxs = _segment_max(vals, key.long(), n_actors + 1)[:n_actors]
        maxs = torch.where(maxs <= neg_inf, 0, maxs).to(payload.dtype)
    else:
        maxs = payload.new_zeros((n_actors, p))

    return SlotDelivery(
        types=buf_t.reshape(n_actors, slots),
        payload=buf_p.reshape(n_actors, slots, p),
        valid=buf_v.reshape(n_actors, slots),
        count=a_counts.to(torch.int32),
        sum=sums,
        max=maxs,
        dropped=dropped.to(torch.int32),
        spill_dst=spill_out[0],
        spill_type=spill_out[1],
        spill_payload=spill_out[2],
        spill_valid=spill_out[3],
    )
