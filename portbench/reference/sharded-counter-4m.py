"""Plain reference of the sharded counter (configs/sharded-counter-4m.json).

Each entity is a counter that starts at 0, held in float32 as the
configuration states; an ask adds its value (the Increment's 1) and
answers with the new total. The configuration's guarantee: each
entity applies its adds in one order, every reply is the running total
at its place in that order, and a caller's asks to one entity apply in
the order the caller handed them over.

The order per entity is the program's to choose, so the comparison reads
it from the replies themselves: adds are positive, so an entity's running
totals rise, and its asks sorted by reply are its order. The reference
then adds the asks' values in that order, in float32 as the configuration
states, and every reply must equal its running total bit for bit, every
entity's row on the card its last total (0 for an entity never asked),
and each caller's asks to an entity must appear in the order the caller
sent them. Everything is recomputed from the inputs the harness made
(keys, values, callers, in the order they were handed to the front end);
the program's replies and rows are only judged.

Numbers compared (each must be at most its limit; both comparisons are
exact, so both limits are 0):
- `replies_off`: asks whose reply is off: none came, or it differs from
  the reference's running total at its place, or it places the ask ahead
  of an earlier ask of its caller to the same entity;
- `rows_off`: entity rows whose total differs from the reference's.

`simulate` puts the reference in the program's place for a control, in
the order the asks were handed over (`CONTROLS`):
- `bfloat16`: the totals held in the precision below the configuration's;
  an Increment of 1 no longer moves a total from 256 on, so a cell whose
  entities pass 256 fails it, and one whose totals stay small does not;
- `one_round`: the guarantee broken that a faster ask engine would be
  tempted to drop: asks handed over in waves of `max_batch`, and all asks
  of one wave to one entity applied in one round, each answered with the
  entity's total after the round (the per-entity order skipped).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

LIMITS = {"replies_off": 0, "rows_off": 0}
CONTROLS = ("bfloat16", "one_round")


def running_totals(keys: np.ndarray, adds: np.ndarray, dtype: torch.dtype
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Running totals of `adds` per key, in array order, accumulated in
    `dtype` one add at a time. Returns the total after each add, each key
    that was added to, and its last total (all as float32 but the keys)."""
    n = len(keys)
    out = np.zeros(n, np.float32)
    if n == 0:
        return out, np.zeros(0, np.int64), np.zeros(0, np.float32)
    order = np.argsort(keys, kind="stable")
    k = keys[order]
    start = np.r_[True, k[1:] != k[:-1]]
    seg = np.cumsum(start) - 1
    first = np.nonzero(start)[0]
    rank = np.arange(n) - first[seg]
    # the r-th add of every key at once, for r = 0, 1, ...
    by_rank = np.argsort(rank, kind="stable")
    bounds = np.searchsorted(rank[by_rank], np.arange(rank.max() + 2))
    total = torch.zeros(len(first), dtype=dtype)
    vals = torch.from_numpy(adds[order].astype(np.float32)).to(dtype)
    seg_t = torch.from_numpy(seg)
    res = torch.zeros(n, dtype=dtype)
    for r in range(len(bounds) - 1):
        sel = torch.from_numpy(by_rank[bounds[r]:bounds[r + 1]])
        s = seg_t[sel]
        total[s] = total[s] + vals[sel]
        res[sel] = total[s]
    out[order] = res.to(torch.float32).numpy()
    return out, k[first], total.to(torch.float32).numpy()


def compare(out: Dict[str, Any]) -> Dict[str, Tuple[float, float]]:
    keys = np.asarray(out["keys"], np.int64)
    adds = np.asarray(out["adds"], np.float32)
    caller = np.asarray(out["caller"], np.int64)
    replies = np.asarray(out["replies"], np.float32)
    final = np.asarray(out["final"], np.float32)
    sent = np.arange(len(keys))          # the order handed to the front end

    ok = ~np.isnan(replies)
    idx = sent[ok]
    # each entity's order: its answered asks by reply
    by_reply = idx[np.lexsort((replies[idx], keys[idx]))]
    want, last_keys, last = running_totals(keys[by_reply], adds[by_reply],
                                           torch.float32)
    wrong = int((want != replies[by_reply]).sum())

    # a caller's asks to one entity, by reply, must be by sending order
    by_caller = idx[np.lexsort((replies[idx], caller[idx], keys[idx]))]
    same = (keys[by_caller][1:] == keys[by_caller][:-1]) & \
        (caller[by_caller][1:] == caller[by_caller][:-1])
    breaks = int((same & (by_caller[1:] < by_caller[:-1])).sum())

    rows = np.zeros(int(out["n_entities"]), np.float32)
    rows[last_keys] = last
    rows_off = int((rows != final).sum())

    got = {"replies_off": int((~ok).sum()) + wrong + breaks,
           "rows_off": rows_off}
    return {k: (float(v), float(LIMITS[k])) for k, v in got.items()}


def simulate(out: Dict[str, Any], control: str) -> Dict[str, Any]:
    """The reference in the program's place under `control` (one of
    CONTROLS): replies and rows as the program's outputs would be."""
    keys = np.asarray(out["keys"], np.int64)
    adds = np.asarray(out["adds"], np.float32)
    dtype = torch.bfloat16 if control == "bfloat16" else torch.float32
    replies, last_keys, last = running_totals(keys, adds, dtype)
    if control == "one_round":
        # every ask of a (wave, entity) group answered with the group's
        # last running total
        wave = np.arange(len(keys)) // int(out["max_batch"])
        order = np.lexsort((np.arange(len(keys)), keys, wave))
        k, w = keys[order], wave[order]
        end = np.r_[(k[1:] != k[:-1]) | (w[1:] != w[:-1]), True]
        group = np.cumsum(np.r_[True, end[:-1]]) - 1
        last_of_group = order[np.nonzero(end)[0]]
        replies = replies.copy()
        replies[order] = replies[last_of_group][group]
    elif control != "bfloat16":
        raise ValueError(f"unknown control {control!r}")
    final = np.zeros(int(out["n_entities"]), np.float32)
    final[last_keys] = last
    return dict(out, replies=replies, final=final)
