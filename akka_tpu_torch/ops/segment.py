"""Delivery primitives: segment reductions over recipient ids.

Port of `akka_tpu/ops/segment.py`. A step's messages are SoA columns
(dst, payload, valid) and "enqueue + dequeue" becomes one segment reduction
per step: sums/maxes/counts land in per-actor rows (reduce mode), or each
actor's first S messages land in its mailbox slots in arrival order (slots
mode). Invalid or out-of-range rows fall into a drop bucket (index
n_actors), so no dynamic filtering is needed.

Kernel families behind the `backend` seam (the reference's names in
brackets):

- "ranked" ["xla"]: in slots mode, rank-then-scatter. One stable rank of
  the narrow int32 recipient key (`stable_ranks`: a two-operand sort on a
  card, the packed sort or the counting passes on the CPU, as the
  reference picks) gives each row its arrival rank within its recipient;
  every slot index and spill position is closed-form from (rank, counts),
  payload rows move by gather, and sums land by one scatter-add. A reduce
  needs no order: counts, sums and maxes land by one scatter each
  (`_deliver_segments`, the "scatter" mode's code too), with the
  reference's empty-segment max convention of the mode asked for.
- "cuda" ["pallas"]: the ring mailbox, a hand-written CUDA kernel
  (`ops/cuda_mailbox.py`, `csrc/ring_mailbox.cu`). On a CPU tensor its plain
  PyTorch version runs instead.
- "auto" (None): on a CUDA tensor, the ring kernel wherever
  `cuda_mailbox.supported()` holds and "ranked" otherwise; on a CPU tensor,
  "ranked" (or "scatter" through `choose_reduce_kernel`), as the reference
  resolves on its CPU.

A call's backend=None reads the process default (`set_delivery_backend`).
An explicit "cuda" outside the ring kernel's support matrix raises
ValueError naming the option: it never falls back silently. The sharded
exchange's bucketing always ranks (`exchange_uses_ranked`). Compiled
routing over a fixed graph is `StaticTopology` + `deliver_static`. The
reference's wide "reference" family has no port of its own: "ranked"
computes the same function, with bit-identical integers and sums that
never cancel (a deliberate difference, ROADMAP C).

Integer outputs (counts, slots, types, valid, dropped, ranks) are
bit-identical to the reference. Sums are per-segment scatter-adds (never
differences of one running prefix sum, which lose a segment's low bits
once the running total passes 2^24 in float32: ROADMAP A14); float sums
are taken in another order than the reference's, so they agree within a
tolerance, not bit for bit. bf16 and float16 payloads accumulate in
float32 and round once; int32 sums wrap as int32 arithmetic does.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.device import platform_of, resolve_device


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
_delivery_backend = "auto"

# Below this message count the ordered reduce kernels are N-shaped while
# scatter is M-shaped (the reference's measured crossover, kept as is).
SCATTER_MAX_M = 1024


def set_delivery_backend(name: str) -> str:
    """Set the process-default delivery backend, read by every call whose
    `backend` is None; returns the previous one. The port's names only:
    the reference's "xla", "reference" and "pallas" raise ValueError.

    A system's CUDA graph keeps the backend it was captured with: set the
    default before `warmup()` (or the first `run`/`step` on a card)."""
    global _delivery_backend
    if name not in DELIVERY_BACKENDS:
        raise ValueError(f"unknown delivery backend {name!r}; "
                         f"expected one of {DELIVERY_BACKENDS}")
    prev, _delivery_backend = _delivery_backend, name
    return prev


def get_delivery_backend() -> str:
    return _delivery_backend


def _check_backend(backend: Optional[str]) -> str:
    """The backend's name (None -> the process default); ValueError for
    any other name, the reference's "xla"/"reference"/"pallas" included."""
    backend = backend or _delivery_backend
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


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulator of a payload dtype: float32 for the 16-bit floats (a
    bf16 running sum stops growing: 256 + 1 rounds to 256), the dtype
    itself otherwise."""
    if dtype in (torch.bfloat16, torch.float16):
        return torch.float32
    return dtype


# Rows a scatter drops land in this many dump rows past the segments.
_DUMP_ROWS = 1024


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] for [M, P] rows and an index of any shape, by an elementwise
    gather over a materialised [K, P] index: on a card, advanced indexing,
    index_select and a gather over an expanded index all run one thread
    block per row (PyTorch's vectorized gather), ~0.6 ms for a region's
    2.1M rows of 16 bytes."""
    flat = idx.reshape(-1).long()
    full = flat[:, None].expand(-1, x.shape[1]).contiguous()
    return torch.gather(x, 0, full).reshape(tuple(idx.shape)
                                            + (x.shape[1],))


def _spread_dead(key: torch.Tensor, n: int) -> torch.Tensor:
    """int64 keys: those in [0, n) kept, every other row sent to one of
    `_DUMP_ROWS` dump rows past n by its index. A scatter that sends
    every dropped row to one drop row serialises their atomics on it: a
    region's inbox drops ~2M rows a step."""
    dump = n + torch.arange(key.shape[0], device=key.device) % _DUMP_ROWS
    return torch.where((key >= 0) & (key < n), key.long(), dump)


def _segment_sums(vals: torch.Tensor, key: torch.Tensor,
                  n: int) -> torch.Tensor:
    """Per-segment sums [n, P] of [M, P] rows over keys, rows whose key
    lies outside [0, n) dropped, by one scatter-add: each segment adds
    only its own rows, so nothing cancels (ROADMAP A14). Accumulates in
    `_acc_dtype` and rounds once."""
    acc = _acc_dtype(vals.dtype)
    out = torch.zeros((n + _DUMP_ROWS, vals.shape[1]), dtype=acc,
                      device=vals.device)
    return out.index_add_(0, _spread_dead(key, n),
                          vals.to(acc))[:n].to(vals.dtype)


def _segment_max(vals: torch.Tensor, key: torch.Tensor,
                 n: int) -> torch.Tensor:
    """Per-segment max [n, P] of [M, P] rows over keys, rows whose key
    lies outside [0, n) dropped; segments with no rows read the dtype's
    -inf."""
    out = torch.full((n + _DUMP_ROWS, vals.shape[1]), _neg_inf(vals.dtype),
                     dtype=vals.dtype, device=vals.device)
    idx = _spread_dead(key, n)[:, None].expand_as(vals)
    return out.scatter_reduce_(0, idx, vals, "amax",
                               include_self=False)[:n]


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
        return _deliver_segments(dst, payload, valid, n_actors, need_max)
    from . import cuda_mailbox  # deferred: cuda_mailbox imports this module
    why = cuda_mailbox.unsupported_reason(n_actors, p, dtype=payload.dtype)
    if _use_ring(backend, platform, why):
        return cuda_mailbox.deliver_reduce(dst, payload, valid, n_actors,
                                           need_max)
    return _deliver_segments(dst, payload, valid, n_actors, need_max,
                             style=mode)


# ---------------------------------------------------------------------------
# rank strategies: the rank phase of rank-then-scatter
# ---------------------------------------------------------------------------

# Within-block triangle size of the packed and counting strategies: the
# [M/B, B, B] equality triangle costs M*B ops, the int32 packing needs
# (n_keys + 2) * ceil(M/B) < 2^31.
_RANK_BLOCK = 32

RANK_STRATEGIES = ("auto", "counting", "packed", "sort2")

# Key domains this small rank in ONE counting pass (the sharded exchange's
# shard ids).
_COUNT_SMALL_DOMAIN = 64

# LSD radix of the counting passes, at most 2^8, and the largest
# [blocks x radix] histogram a pass may build.
_COUNT_MAX_RADIX_BITS = 8
_COUNT_MAX_BINS = 1 << 22


def _auto_rank_strategy(m: int, n_keys: int, platform: str) -> str:
    """The reference's crossover rule, kept as is: "sort2" off the CPU;
    on the CPU counting where the packed strategy's int32 packing would
    overflow and for tiny key domains, packed otherwise."""
    if platform != "cpu":
        return "sort2"
    nb = -(-m // _RANK_BLOCK)
    if (n_keys + 2) * nb >= 2 ** 31:
        return "counting"
    if n_keys + 2 <= _COUNT_SMALL_DOMAIN:
        return "counting"
    return "packed"


def stable_ranks(key: torch.Tensor, n_keys: int,
                 platform: Optional[str] = None,
                 strategy: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """The rank phase of rank-then-scatter: for each row, the number of
    EARLIER rows with the same key (its stable arrival rank within the
    recipient), plus per-key counts. Returns (rank [M] int32,
    counts [n_keys + 1] int32); keys must lie in [0, n_keys].

    Strategies (every one bit-identical to the others and to the
    reference's of the same name):
    - sort2: one stable sort of the key; a row's rank is its sorted
      position minus its segment's start (binary search of the sorted
      keys). The pick off the CPU.
    - packed: (key, arrival block of B rows) packed into one int32 and
      sorted; cross-block ranks by binary search of the sorted packs,
      within-block ranks by a [B, B] equality triangle. Needs
      (n_keys + 2) * ceil(M/B) < 2^31, else it reroutes to counting.
    - counting: `counting_ranks`, no sort at all.
    "auto" follows `_auto_rank_strategy` for `platform` (default: the
    key's)."""
    m = key.shape[0]
    nb = -(-m // _RANK_BLOCK)
    if platform is None:
        platform = platform_of(key)
    if strategy not in RANK_STRATEGIES:
        raise ValueError(f"unknown rank strategy {strategy!r}; "
                         f"expected one of {RANK_STRATEGIES}")
    if strategy == "auto":
        strategy = _auto_rank_strategy(m, n_keys, platform)
    if strategy == "packed" and (n_keys + 2) * nb >= 2 ** 31:
        strategy = "counting"  # the int32 packing would overflow
    if strategy == "counting":
        return counting_ranks(key, n_keys)
    if strategy == "packed":
        kp, packed = _pack_keys(key, n_keys)
        psorted = torch.sort(packed).values
        rank, counts = _ranks_from_packed(psorted, packed, kp, n_keys)
        return rank[:m], counts
    return _sort2_ranks(key, n_keys)


def _sort2_ranks(key: torch.Tensor,
                 n_keys: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sort2 strategy (see `stable_ranks`)."""
    m = key.shape[0]
    skey, order = torch.sort(key, stable=True)
    bounds = torch.searchsorted(
        skey, torch.arange(n_keys + 2, dtype=key.dtype, device=key.device))
    pos = torch.arange(m, dtype=torch.int64, device=key.device)
    rank = torch.empty((m,), dtype=torch.int64, device=key.device)
    rank.scatter_(0, order, pos - bounds[skey.long()])
    counts = (bounds[1:] - bounds[:-1]).to(torch.int32)
    return rank.to(torch.int32), counts


def _pad_keys(key: torch.Tensor, n_keys: int) -> torch.Tensor:
    """Keys padded to whole blocks of B with n_keys + 1, which orders after
    every real key and the drop bucket and never perturbs counts."""
    pad = -key.shape[0] % _RANK_BLOCK
    if pad == 0:
        return key
    return torch.cat([key, key.new_full((pad,), n_keys + 1)])


def _within_block(k2: torch.Tensor) -> torch.Tensor:
    """[nb, B] keys -> each row's count of same-key rows earlier in its
    block ([nb * B] int32), by the [B, B] equality triangle."""
    b = k2.shape[1]
    tri = torch.ones((b, b), dtype=torch.bool, device=k2.device).tril(-1)
    return ((k2[:, :, None] == k2[:, None, :]) & tri) \
        .sum(2, dtype=torch.int32).reshape(-1)


def _pack_keys(key: torch.Tensor, n_keys: int):
    """Pack (key, arrival block) into one int32 sort operand. Returns
    (padded keys [nb*B], packed operand [nb*B])."""
    kp = _pad_keys(key, n_keys)
    nb = kp.shape[0] // _RANK_BLOCK
    blk = torch.arange(kp.shape[0], dtype=torch.int32,
                       device=key.device) // _RANK_BLOCK
    return kp, kp * nb + blk


def _ranks_from_packed(psorted, packed, kp, n_keys: int):
    """Cross-block same-key counts by binary search of the sorted packs,
    within-block counts by the equality triangle. Returns
    (rank [nb*B] int32, counts [n_keys + 1] int32)."""
    nb = packed.shape[0] // _RANK_BLOCK
    kb = torch.searchsorted(
        psorted, torch.arange(n_keys + 2, dtype=torch.int32,
                              device=kp.device) * nb).to(torch.int32)
    counts = kb[1:] - kb[:-1]
    before = torch.searchsorted(psorted, packed).to(torch.int32) \
        - kb[kp.long()]
    within = _within_block(kp.reshape(nb, _RANK_BLOCK))
    return before + within, counts


def _counting_pass(digit: torch.Tensor, n_digits: int, nb: int,
                   b: int) -> torch.Tensor:
    """One stable counting pass: the destination of every padded row when
    rows are ordered by `digit` (values in [0, n_digits)), arrival order
    breaking ties: (# rows with a smaller digit) + (# same-digit rows in
    earlier blocks), both from one exclusive cumsum over the digit-major
    [n_digits, nb] block histogram, + (# same-digit rows earlier in this
    block). The histogram is a scatter-add here (the reference builds it
    by compare-reduce, which XLA fuses and eager PyTorch would
    materialise); its counts are the same."""
    dev = digit.device
    blk = torch.arange(nb * b, dtype=torch.int64, device=dev) // b
    cell = digit.long() * nb + blk
    hist = torch.zeros((n_digits * nb,), dtype=torch.int32,
                       device=dev).index_add_(
        0, cell, torch.ones_like(digit, dtype=torch.int32))
    excl = torch.cumsum(hist, 0, dtype=torch.int32) - hist
    return excl[cell] + _within_block(digit.reshape(nb, b))


def counting_ranks(key: torch.Tensor, n_keys: int,
                   max_bins: int = _COUNT_MAX_BINS
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`stable_ranks` by LSD counting passes, with no sort at all. Returns
    (rank [M] int32, counts [n_keys + 1] int32); keys must lie in
    [0, n_keys]. The key domain (n_keys + 2 values with the drop bucket
    and the pad key) splits into ceil(bits / radix bits) digits of at most
    2^8 values, and more passes are taken while a pass's [blocks x radix]
    histogram would pass `max_bins`; the radix is the smallest that keeps
    that pass count. Between passes one scatter applies the pass's
    permutation to the keys (positions are a bijection), and passes
    compose by gather. No int32 packing: any (M, n_keys) that fits in
    memory is exact."""
    m = key.shape[0]
    b = _RANK_BLOCK
    kp = _pad_keys(key, n_keys)
    nb = kp.shape[0] // b
    n_vals = n_keys + 2              # real keys + drop bucket + pad key
    bitlen = max((n_vals - 1).bit_length(), 1)
    passes = -(-bitlen // _COUNT_MAX_RADIX_BITS)
    r_bits = -(-bitlen // passes)    # smallest radix with that pass count
    while nb * (1 << r_bits) > max_bins and r_bits > 1:
        passes += 1
        r_bits = -(-bitlen // passes)
    radix = 1 << r_bits
    pos = None                       # pos[i]: destination of original row i
    kcur = kp                        # keys arranged in the current order
    for p in range(passes):
        if p + 1 < passes:
            digit = (kcur >> (p * r_bits)) & (radix - 1)
            nd = radix
        else:
            digit = kcur >> (p * r_bits)
            nd = -(-n_vals // (radix ** p))  # top-digit alphabet only
        step = _counting_pass(digit, nd, nb, b)
        pos = step if pos is None else step[pos.long()]
        if p + 1 < passes:
            kcur = torch.empty_like(kcur).scatter_(0, step.long(), kcur)
    counts = torch.zeros((n_vals,), dtype=torch.int32,
                         device=key.device).index_add_(
        0, kp.long(), torch.ones_like(kp))[:n_keys + 1]
    excl = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    return pos[:m] - excl[key.long()], counts


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


# ---------------------------------------------------------------------------
# the ranked kernels
# ---------------------------------------------------------------------------

def _rank_layout(dst, valid, n_actors: int):
    """Shared rank phase of the ranked kernels: (ok, key, rank,
    counts_full, excl, inv) with int64 offsets for indexing; inv is each
    row's position in (recipient, arrival) order."""
    ok = valid & (dst >= 0) & (dst < n_actors)
    key = torch.where(ok, dst, n_actors).to(torch.int32)
    rank, counts_full = stable_ranks(key, n_actors)
    excl = torch.cumsum(counts_full, 0) - counts_full       # [n+1] int64
    inv = excl[key.long()] + rank
    return ok, key, rank, counts_full, excl, inv


def _deliver_segments(dst, payload, valid, n_actors: int, need_max: bool,
                      style: str = "scatter") -> Delivery:
    """The reduce off the ring kernel ("scatter", and "merge"/"sort" under
    the ranked backend): counts, sums and maxes by one scatter each, so
    no rank is needed. `style` keeps each reference style's empty-segment
    max convention: "merge" zeroes max <= -inf sentinels, "sort" and
    "scatter" zero count == 0 segments."""
    ok = valid & (dst >= 0) & (dst < n_actors)
    key = _spread_dead(torch.where(ok, dst, n_actors), n_actors)
    p = payload.shape[1]
    sums = _segment_sums(torch.where(ok[:, None], payload, 0)
                         .to(payload.dtype), key, n_actors)
    counts = torch.zeros((n_actors + _DUMP_ROWS,), dtype=torch.int32,
                         device=dst.device).index_add_(
        0, key, ok.to(torch.int32))[:n_actors]
    if need_max:
        neg_inf = _neg_inf(payload.dtype)
        maxs = _segment_max(torch.where(ok[:, None], payload, neg_inf)
                            .to(payload.dtype), key, n_actors)
        if style == "merge":
            maxs = torch.where(maxs <= neg_inf, 0, maxs)
        else:
            maxs = torch.where((counts > 0)[:, None], maxs, 0)
        maxs = maxs.to(payload.dtype)
    else:
        maxs = payload.new_zeros((n_actors, p))
    return Delivery(sum=sums, max=maxs, count=counts)


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
    stable key rank gives (rank, counts), one int64 scatter inverts the
    sort permutation, and every mailbox and spill row is then a gather at a
    closed-form sorted position; the consumed aggregation is one
    scatter-add."""
    m, p = payload.shape
    dev = dst.device
    i64 = torch.int64
    ok, key, rank, counts_full, excl, inv = _rank_layout(dst, valid,
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
    buf_p = torch.where(buf_v[:, None], _rows(payload, row), 0) \
        .to(payload.dtype)

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
                     torch.where(sp_v[:, None], _rows(payload, srow), 0)
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

    # --- reduce: the consumed aggregation, one scatter-add per recipient
    sums = _segment_sums(torch.where(consumed[:, None], payload, 0)
                         .to(payload.dtype), key, n_actors)
    if need_max:
        # non-consumed live rows contribute 0; the -inf sentinel marks only
        # segments with no rows at all
        neg_inf = _neg_inf(payload.dtype)
        vals = torch.where(consumed[:, None], payload, 0)
        vals = torch.where(ok[:, None], vals, neg_inf).to(payload.dtype)
        maxs = _segment_max(vals, key, n_actors)
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


# ---------------------------------------------------------------------------
# compiled routing
# ---------------------------------------------------------------------------

class StaticTopology:
    """Precompiled communication graph: delivery with no runtime rank.

    When the actor graph is fixed (ring, fan-in, trees), `from_dst_table`
    pattern-matches it on the host, as the reference does:

    - "shift": dst[i] = (i + c) mod N -> `torch.roll`
    - "mod":   dst[i] = i mod C      -> reshape [G, C] + sum over G
    - "block": dst[i] = i // G       -> reshape [C, G] + sum over G
    - "dense": small uniform fan-in  -> gather of inverse_edges [N, F]
    - "csr":   anything else         -> the static sort permutation and a
      per-segment scatter-add over its static segment ids (the reference
      takes cumsum differences there, which cancel: ROADMAP A14)

    Message values and validity stay dynamic; only the wiring is static,
    and the runtime `dst` column is not read. `inverse_edges` (dense),
    `perm` and `bounds` (csr) are int32 tensors, built on the CPU; a
    system moves them once to its own device (`to`).
    """

    def __init__(self, kind: str, n: int, k: int, shift: int = 0,
                 mod: int = 0, block: int = 0, inverse_edges=None,
                 perm=None, bounds=None):
        self.kind = kind
        self.n = n
        self.k = k
        self.shift = shift
        self.mod = mod
        self.block = block
        self.inverse_edges = inverse_edges
        self.perm = perm
        self.bounds = bounds

    def runtime_arrays(self) -> tuple:
        """The topology's device tensors, as `deliver_static` takes them."""
        if self.kind == "dense":
            return (self.inverse_edges,)
        if self.kind == "csr":
            return (self.perm, self.bounds)
        return ()

    def to(self, device) -> "StaticTopology":
        """The same topology with its tensors on `device` (self when they
        are there already)."""
        device = torch.device(device)
        moved = {f: getattr(self, f) for f in ("inverse_edges", "perm",
                                                 "bounds")}
        if all(t is None or t.device == device for t in moved.values()):
            return self
        moved = {f: None if t is None else t.to(device)
                 for f, t in moved.items()}
        return StaticTopology(self.kind, self.n, self.k, self.shift,
                              self.mod, self.block, **moved)

    @staticmethod
    def from_dst_table(dst_table,
                       dense_max_fan_in: int = 4) -> "StaticTopology":
        """dst_table: [N, K] int, the static destination of each actor's
        k-th out-slot; -1 = unused slot (the runtime valid flags gate
        anyway). A numpy build on the host."""
        dt = np.asarray(dst_table, dtype=np.int64)
        n, k = dt.shape
        flat_dst = dt.reshape(-1)
        m = n * k
        slots = np.arange(m, dtype=np.int64)
        okm = flat_dst >= 0

        if k == 1 and okm.any():
            i_ok = slots[okm]
            d_ok = flat_dst[okm]
            # shift: dst = (i + c) mod n, all slots emitting
            if okm.all():
                c = int((d_ok[0] - i_ok[0]) % n)
                if ((i_ok + c) % n == d_ok).all():
                    return StaticTopology("shift", n, k, shift=c)
            # mod: dst = i mod C (C = the largest target + 1)
            cands = np.unique(d_ok)
            c_mod = int(cands.max()) + 1
            if c_mod >= 1 and m % c_mod == 0 and (i_ok % c_mod == d_ok).all():
                return StaticTopology("mod", n, k, mod=c_mod)
            # block: dst = i // G
            if len(cands) > 0:
                g = m // (int(cands.max()) + 1)
                if g > 0 and m % g == 0 and (i_ok // g == d_ok).all():
                    return StaticTopology("block", n, k, block=g)

        order = np.argsort(flat_dst[okm], kind="stable")
        tgt = flat_dst[okm][order]
        src = slots[okm][order]
        counts = (np.bincount(tgt, minlength=n) if tgt.size
                  else np.zeros(n, np.int64))
        f = max(int(counts.max()) if counts.size else 1, 1)
        if f <= dense_max_fan_in:
            inv = np.full((n, f), -1, dtype=np.int32)
            starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
            pos = np.arange(tgt.shape[0]) - starts[tgt]
            inv[tgt, pos] = src.astype(np.int32)
            return StaticTopology("dense", n, k,
                                  inverse_edges=torch.from_numpy(inv))
        perm = np.concatenate([src, slots[~okm]]).astype(np.int32)
        bounds = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
        return StaticTopology("csr", n, k, perm=torch.from_numpy(perm),
                              bounds=torch.from_numpy(bounds))


def deliver_static(topo: StaticTopology, arrays: tuple,
                   payload: torch.Tensor, valid: torch.Tensor,
                   need_max: bool = False) -> Delivery:
    """Delivery over a static topology; `arrays` = topo.runtime_arrays(),
    on the payload's device; payload: [N*K, P] slot-indexed emissions,
    valid: [N*K] bool. Sums accumulate in `_acc_dtype` and round once."""
    p = payload.shape[1]
    n = topo.n
    dtype = payload.dtype
    acc = _acc_dtype(dtype)
    dev = payload.device

    if topo.kind == "shift":
        in_pl = torch.roll(payload, topo.shift, 0)
        in_ok = torch.roll(valid, topo.shift, 0)
        sums = torch.where(in_ok[:, None], in_pl, 0).to(dtype)
        counts = in_ok.to(torch.int32)
        maxs = sums if need_max else torch.zeros_like(sums)
        return Delivery(sum=sums, max=maxs, count=counts)

    if topo.kind in ("mod", "block"):
        if topo.kind == "mod":
            c = topo.mod
            g = payload.shape[0] // c
            pl3 = payload.reshape(g, c, p)          # sum over leading groups
            ok2 = valid.reshape(g, c)
            axis = 0
        else:
            g = topo.block
            c = payload.shape[0] // g
            pl3 = payload.reshape(c, g, p)
            ok2 = valid.reshape(c, g)
            axis = 1
        okf = ok2[..., None]
        sums_c = torch.where(okf, pl3, 0).sum(axis, dtype=acc).to(dtype)
        counts_c = ok2.sum(axis, dtype=torch.int32)
        # targets are ids [0, C): they fill the first C rows
        c_eff = min(c, n)
        sums = torch.zeros((n, p), dtype=dtype, device=dev)
        sums[:c_eff] = sums_c[:c_eff]
        counts = torch.zeros((n,), dtype=torch.int32, device=dev)
        counts[:c_eff] = counts_c[:c_eff]
        maxs = torch.zeros((n, p), dtype=dtype, device=dev)
        if need_max:
            maxs_c = torch.where(okf, pl3, _neg_inf(dtype)).amax(axis)
            maxs[:c_eff] = torch.where((counts_c > 0)[:, None], maxs_c,
                                       0)[:c_eff].to(dtype)
        return Delivery(sum=sums, max=maxs, count=counts)

    if topo.kind == "dense":
        (inv,) = arrays                          # [N, F] small F
        safe = inv.clamp(min=0).long()
        ok = (inv >= 0) & valid[safe]            # [N, F]
        okf = ok[..., None]
        gathered = _rows(payload, safe)          # [N, F, P]
        sums = torch.where(okf, gathered, 0).sum(1, dtype=acc).to(dtype)
        counts = ok.sum(1, dtype=torch.int32)
        if need_max:
            maxs = torch.where(okf, gathered, _neg_inf(dtype)).amax(1)
            maxs = torch.where((counts > 0)[:, None], maxs, 0).to(dtype)
        else:
            maxs = torch.zeros_like(sums)
        return Delivery(sum=sums, max=maxs, count=counts)

    # csr: the static permutation; sorted row r belongs to the segment
    # whose bounds hold it (rows past bounds[-1], the unused slots, to
    # the drop segment n)
    perm, bounds = arrays
    pl = perm.long()
    sv = valid[pl]
    sp = torch.where(sv[:, None], _rows(payload, pl), 0).to(dtype)
    rows = torch.arange(pl.shape[0], dtype=torch.int32, device=dev)
    seg = torch.searchsorted(bounds[1:], rows, right=True)
    sums = _segment_sums(sp, seg, n)
    counts = torch.zeros((n + 1,), dtype=torch.int32, device=dev) \
        .index_add_(0, seg, sv.to(torch.int32))[:n]
    if need_max:
        neg_inf = _neg_inf(dtype)
        maxs = _segment_max(torch.where(sv[:, None], sp, neg_inf).to(dtype),
                            seg, n)
        maxs = torch.where((counts > 0)[:, None], maxs, 0).to(dtype)
    else:
        maxs = torch.zeros_like(sums)
    return Delivery(sum=sums, max=maxs, count=counts)


# ---------------------------------------------------------------------------
# delivery helpers
# ---------------------------------------------------------------------------

def route_one_hop(dst: torch.Tensor, perm_table: torch.Tensor) -> torch.Tensor:
    """Rewrite destinations through a routing table (router logics as
    index maps: RoundRobin = iota mod n, ConsistentHash = a hash table).
    Indices follow the reference's gather: a negative index counts from
    the end, and indices past either end clamp to it."""
    size = perm_table.shape[0]
    idx = dst.long()
    idx = torch.where(idx < 0, idx + size, idx).clamp(0, size - 1)
    return perm_table[idx]


def compact_messages(dst: torch.Tensor, payload: torch.Tensor,
                     valid: torch.Tensor, capacity: int):
    """Stable-compact valid messages to the front of a fixed-size buffer.

    Returns (dst, payload, valid, dropped_count); the stable order keeps
    per-sender FIFO."""
    m = dst.shape[0]
    order = torch.sort(torch.where(valid, 0, 1).to(torch.int32),
                       stable=True).indices
    dst_s, payload_s, valid_s = dst[order], _rows(payload, order), \
        valid[order]
    if capacity >= m:
        pad = capacity - m
        return (torch.cat([dst_s, dst_s.new_full((pad,), -1)]),
                torch.cat([payload_s, payload_s.new_zeros(
                    (pad, payload.shape[1]))]),
                torch.cat([valid_s, valid_s.new_zeros((pad,))]),
                torch.zeros((), dtype=torch.int32, device=dst.device))
    n_valid = valid.sum(dtype=torch.int32)
    dropped = (n_valid - capacity).clamp(min=0)
    return (dst_s[:capacity], payload_s[:capacity], valid_s[:capacity],
            dropped)


def delivery_attribution(m: int, n_actors: int, p: int = 4, slots: int = 2,
                         repeats: int = 3, seed: int = 0,
                         device=None) -> dict:
    """The per-phase cost of the ranked slots kernel at one shape on
    `device` (default CUDA; device="cpu" on the CPU), with the
    reference's keys; values are milliseconds (CUDA events on a card,
    the host clock on the CPU), best of `repeats` after one warm call.

    Phases, the blocks of `_deliver_slots_ranked` on the card's path
    (the sort2 rank strategy):
      key_sort_ms  the stable sort of the int32 recipient key
      rank_ms      segment bounds (binary search) + the rank scatter
      place_ms     the inverse-permutation scatter + the mailbox gathers
      reduce_ms    the consumed aggregation (one scatter-add)
      wide_sort_ms the reference's wide kernel's cost: every column
                   (key, arrival, type, flags, payload) moved through the
                   key sort's permutation
      count_rank_ms `counting_ranks`; auto_rank_ms whatever
                   `stable_ranks` picks here (rank_strategy)
    and slots_phases: rank, place, the spill compaction (spill_ms), the
    reduce, and the whole bounded step (step_ms, the ring kernel's K2 on
    a card) and spill-region step (spill_step_ms, ranked)."""
    dev = resolve_device(device)
    platform = platform_of(torch.empty((0,), device=dev))
    rng = np.random.default_rng(seed)
    dst = torch.as_tensor(rng.integers(0, n_actors, size=m), dtype=torch.int32,
                          device=dev)
    mtype = torch.as_tensor(rng.integers(0, 4, size=m), dtype=torch.int32,
                            device=dev)
    payload = torch.as_tensor(rng.standard_normal((m, p)),
                              dtype=torch.float32, device=dev)
    ones_v = torch.ones((m,), dtype=torch.bool, device=dev)
    key = dst
    i64 = torch.int64
    spill_cap = max(m // 4, 8)

    def key_sort():
        return torch.sort(key, stable=True)

    skey, order = key_sort()

    def rank_phase():
        bounds = torch.searchsorted(
            skey, torch.arange(n_actors + 2, dtype=torch.int32, device=dev))
        rank = torch.empty((m,), dtype=i64, device=dev)
        rank.scatter_(0, order, torch.arange(m, dtype=i64, device=dev)
                      - bounds[skey.long()])
        return rank, (bounds[1:] - bounds[:-1]).to(torch.int32)

    rank, counts_full = rank_phase()
    excl = torch.cumsum(counts_full, 0) - counts_full
    inv = excl[key.long()] + rank

    def inverse():
        s2o = torch.empty((m,), dtype=i64, device=dev)
        return s2o.scatter_(0, inv, torch.arange(m, dtype=i64, device=dev))

    def place_phase():
        s2o = inverse()
        flat = torch.arange(n_actors * slots, dtype=i64, device=dev)
        kk, jj = flat // slots, flat % slots
        buf_v = jj < counts_full[kk]
        row = s2o[torch.clamp(excl[kk] + jj, max=m - 1)]
        return (torch.where(buf_v, mtype[row], 0),
                torch.where(buf_v[:, None], _rows(payload, row), 0), buf_v)

    def reduce_phase():
        return _segment_sums(payload, key, n_actors)

    def spill_phase():
        s2o = inverse()
        counts = counts_full[:n_actors].to(i64)
        spc = (counts - slots).clamp(min=0)
        sp_excl = torch.cat([spc.new_zeros((1,)), torch.cumsum(spc, 0)])
        ss = torch.arange(spill_cap, dtype=i64, device=dev)
        k_c = (torch.searchsorted(sp_excl, ss, right=True) - 1) \
            .clamp(max=n_actors - 1)
        srow = s2o[torch.clamp(excl[k_c] + ss - sp_excl[k_c] + slots,
                               max=m - 1)]
        sp_v = ss < sp_excl[n_actors].clamp(max=spill_cap)
        return (torch.where(sp_v, k_c, -1), torch.where(sp_v, mtype[srow], 0),
                torch.where(sp_v[:, None], _rows(payload, srow), 0))

    def wide_sort():
        cols = torch.stack([key, torch.arange(m, dtype=torch.int32,
                                              device=dev), mtype,
                            torch.zeros_like(key)], 1)
        return _rows(cols, order), _rows(payload, order)

    def best_ms(fn) -> float:
        fn()
        best = float("inf")
        for _ in range(max(repeats, 1)):
            if dev.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                best = min(best, start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                fn()
                best = min(best, (time.perf_counter() - t0) * 1e3)
        return best

    out = {
        "platform": platform,
        "m": int(m), "n": int(n_actors), "p": int(p), "slots": int(slots),
        "key_sort_ms": best_ms(key_sort),
        "rank_ms": best_ms(rank_phase),
        "place_ms": best_ms(place_phase),
        "reduce_ms": best_ms(reduce_phase),
        "wide_sort_ms": best_ms(wide_sort),
        "count_rank_ms": best_ms(lambda: counting_ranks(key, n_actors)),
        "auto_rank_ms": best_ms(lambda: stable_ranks(key, n_actors)),
        "rank_strategy": _auto_rank_strategy(m, n_actors, platform),
    }
    out["total_ms"] = round(out["key_sort_ms"] + out["rank_ms"]
                            + out["place_ms"] + out["reduce_ms"], 4)
    out["slots_phases"] = {
        "strategy": out["rank_strategy"],
        "spill_cap": int(spill_cap),
        "rank_ms": round(out["auto_rank_ms"], 4),
        "place_ms": round(out["place_ms"], 4),
        "spill_ms": round(best_ms(spill_phase), 4),
        "reduce_ms": round(out["reduce_ms"], 4),
        "step_ms": round(best_ms(lambda: deliver_slots(
            dst, mtype, payload, ones_v, n_actors, slots)), 4),
        "spill_step_ms": round(best_ms(lambda: deliver_slots(
            dst, mtype, payload, ones_v, n_actors, slots,
            spill_cap=spill_cap)), 4),
    }
    for k in ("key_sort_ms", "rank_ms", "place_ms", "reduce_ms",
              "wide_sort_ms", "count_rank_ms", "auto_rank_ms"):
        out[k] = round(out[k], 4)
    return out
