"""In-step metric slab: fixed-bucket int32 histograms riding the step carry.

Port of `akka_tpu/batched/metrics_slab.py`. Four distributions (mailbox
occupancy at step entry, message sojourn age in steps, supervision retry
depth, ask latch latency in steps) accumulate inside the step as an
[N_HIST, N_BUCKETS] int32 slab. Bucketing is integer-exact:
bucket(v) = #{b in BOUNDARIES : v >= b} with power-of-two boundaries
2^0..2^(N_BUCKETS-2); v <= 0 lands in bucket 0 and anything
>= 2^(N_BUCKETS-2) saturates into the last bucket.

A quiet step (no live inbox row, no retry bump, no latch flip) adds
nothing: the reference gates the pass with `lax.cond`; the port multiplies
the step's histograms by the same predicate, which needs no host sync.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# histogram lanes (rows of the slab)
(HIST_OCCUPANCY, HIST_SOJOURN, HIST_RETRY, HIST_ASK) = range(4)
N_HIST = 4
HIST_NAMES = ("mailbox_occupancy", "sojourn_steps", "retry_depth",
              "ask_latency_steps")

N_BUCKETS = 16
BOUNDARIES = tuple(1 << k for k in range(N_BUCKETS - 1))  # 1, 2, 4, .. 2^14

# reserved state column: the step a promise row was armed (ask latency)
ASK_ARM_COL = "_m_ask_arm"
ASK_ARM_SPEC = ((), torch.int32)


_BOUNDS: Dict[torch.device, torch.Tensor] = {}


def _bounds(device: torch.device) -> torch.Tensor:
    """BOUNDARIES as an int32 tensor, built once per device (a step that
    is captured as a CUDA graph may not copy host data)."""
    b = _BOUNDS.get(device)
    if b is None:
        b = _BOUNDS[device] = torch.tensor(BOUNDARIES, dtype=torch.int32,
                                           device=device)
    return b


def bucket_of(v: torch.Tensor) -> torch.Tensor:
    """int32 values -> int32 bucket indices of the same shape."""
    return (v[..., None] >= _bounds(v.device)).sum(dim=-1,
                                                   dtype=torch.int32)


def bucket_of_np(v: np.ndarray) -> np.ndarray:
    """Numpy twin of bucket_of (int64 bucket indices)."""
    v = np.asarray(v, np.int64)
    b = np.asarray(BOUNDARIES, np.int64)
    return (v[:, None] >= b[None, :]).sum(axis=1).astype(np.int64)


def masked_hist(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[N_BUCKETS] int32 histogram of values where mask holds, or for
    [D, L] values one histogram per row ([D, N_BUCKETS]); masked-out
    values go to a sacrificial bucket that is sliced off."""
    lead = values.shape[:-1]
    rows = values.reshape(-1, values.shape[-1])
    d = rows.shape[0]
    safe = torch.where(mask.reshape(d, -1), bucket_of(rows.to(torch.int32)),
                       N_BUCKETS).long()
    safe = safe + torch.arange(d, device=values.device)[:, None] \
        * (N_BUCKETS + 1)
    out = torch.zeros((d * (N_BUCKETS + 1),), dtype=torch.int32,
                      device=values.device)
    out.index_add_(0, safe.reshape(-1), mask.reshape(-1).to(torch.int32))
    return out.reshape(lead + (N_BUCKETS + 1,))[..., :N_BUCKETS]


def masked_hist_np(values: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Numpy oracle of masked_hist (int64 counts; compare with ==)."""
    mask = np.asarray(mask, bool)
    buckets = bucket_of_np(np.asarray(values))[mask]
    return np.bincount(buckets, minlength=N_BUCKETS).astype(np.int64)


def accumulate_step(metrics: torch.Tensor, old_state, new_state, old_alive,
                    delivered_count, inbox_valid, inbox_enq, step_count,
                    latch_col=None, n_shards=None) -> torch.Tensor:
    """One step's histogram accumulation over an [N_HIST, N_BUCKETS] slab,
    or, with `n_shards`, over a [D, N_HIST, N_BUCKETS] slab where each of D
    equal contiguous blocks of rows (and of inbox rows) accumulates into
    its own row, gated by its own quiet predicate.

    Lanes:
      HIST_OCCUPANCY  per-row delivered count at step entry, alive rows
      HIST_SOJOURN    step_count - enqueue stamp of every live inbox row
      HIST_RETRY      new `_retries` depth of rows whose counter grew
      HIST_ASK        (step_count + 1) - ask-arm stamp of promise rows
                      whose latch flipped 0 -> 1 this step
    """
    i32 = torch.int32
    dev = metrics.device
    d = 1 if n_shards is None else n_shards

    def blocks(x):
        return x.reshape(d, -1)

    zeros = torch.zeros((d, N_BUCKETS), dtype=i32, device=dev)
    valid = blocks(inbox_valid)
    busy = valid.any(1)
    step = torch.as_tensor(step_count).to(i32)
    age = (step - blocks(inbox_enq)).clamp(min=0)
    lanes = [masked_hist(blocks(delivered_count.to(i32)), blocks(old_alive)),
             masked_hist(age, valid)]
    if "_retries" in new_state:
        retry_mask = blocks(new_state["_retries"] > old_state["_retries"])
        busy = busy | retry_mask.any(1)
        lanes.append(masked_hist(blocks(new_state["_retries"].to(i32)),
                                 retry_mask))
    else:
        lanes.append(zeros)
    if latch_col is not None and latch_col in new_state \
            and ASK_ARM_COL in old_state:
        newly = blocks((new_state[latch_col] != 0)
                       & (old_state[latch_col] == 0))
        busy = busy | newly.any(1)
        lat = (step + 1 - blocks(old_state[ASK_ARM_COL])).clamp(min=0)
        lanes.append(masked_hist(lat, newly))
    else:
        lanes.append(zeros)
    add = torch.stack(lanes, 1) * busy.to(i32)[:, None, None]
    return metrics + (add if n_shards is not None else add[0])


def empty_slab(n_shards: int = 0, device=None) -> torch.Tensor:
    """Zero slab: [N_HIST, N_BUCKETS] (single device) or
    [n_shards, N_HIST, N_BUCKETS]."""
    shape = (N_HIST, N_BUCKETS) if n_shards == 0 else \
        (n_shards, N_HIST, N_BUCKETS)
    return torch.zeros(shape, dtype=torch.int32, device=device)


def slab_totals(slab) -> np.ndarray:
    """Host side: collapse a (possibly per-shard) slab, a tensor or a host
    array, to one [N_HIST, N_BUCKETS] int64 total."""
    if isinstance(slab, torch.Tensor):
        slab = slab.cpu().numpy()
    a = np.asarray(slab, np.int64)
    return a.reshape((-1, N_HIST, N_BUCKETS)).sum(axis=0)


def slab_dict(slab) -> Dict[str, np.ndarray]:
    """Host side: named histogram lanes (HIST_NAMES -> [N_BUCKETS] int64)."""
    totals = slab_totals(slab)
    return {name: totals[i] for i, name in enumerate(HIST_NAMES)}


def slab_epoch(slab: torch.Tensor) -> torch.Tensor:
    """The slab's metrics epoch: its running sum as an int32 scalar on the
    slab's device (no host sync), wrapping modulo 2^32 as the reference's
    int32 sum does."""
    return slab.sum(dtype=torch.int64).to(torch.int32)


def bucket_label(i: int) -> str:
    """Human-readable bucket range, e.g. '0', '1', '4-7', '>=16384'."""
    if i == 0:
        return "0"
    lo = BOUNDARIES[i - 1]
    if i == N_BUCKETS - 1:
        return f">={lo}"
    hi = BOUNDARIES[i] - 1
    return str(lo) if hi == lo else f"{lo}-{hi}"


def bucket_upper_bounds() -> tuple:
    """Inclusive upper bounds per bucket for Prometheus-style `le` labels
    (the last bucket is unbounded -> +Inf)."""
    return tuple(b - 1 for b in BOUNDARIES) + (float("inf"),)


def bucket_percentile(lane: np.ndarray, q: float) -> float:
    """Nearest-rank percentile over one [N_BUCKETS] histogram lane,
    reported as the bucket's inclusive upper bound (conservative: the true
    value is <= the returned bound). Empty lane -> 0. The occupancy signal
    of event/pressure.py reads p90 of the mailbox-occupancy lane through
    this."""
    counts = np.asarray(lane, np.int64)
    total = int(counts.sum())
    if total == 0:
        return 0.0
    rank = max(1, int(np.ceil(q * total)))
    cum = np.cumsum(counts)
    i = int(np.searchsorted(cum, rank))
    ub = bucket_upper_bounds()[i]
    return float(ub) if np.isfinite(ub) else float(BOUNDARIES[-1])
