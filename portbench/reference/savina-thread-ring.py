"""Plain reference of the thread ring (configs/savina-thread-ring.json).

n actors in a ring; each step every actor that received something counts
what it received and forwards it, unchanged, to its successor
(id + 1) mod n. A token seeded at actor d with payload p has, after T
steps, visited actors d, d + 1, ..., d + T - 1 (mod n) once each and waits,
still carrying p, in the inbox of actor d + T. The configuration's
guarantee: every message is delivered exactly once, one hop a step, with
its payload unchanged.

The reference recomputes from the seeded tokens (their actors and
payloads, made by the harness) and the number of steps the harness ran:
each actor's `received` count, and each actor's pending messages (their
count and payload sum per recipient). The program's `received` column and
the messages in its inbox are only judged. Payloads are float32 and are
never added to one another in this traffic (at most one token waits for
an actor), so the comparison is exact.

The number compared, `actors_off` (limit 0: the comparison is exact):
actors whose `received` count differs, or whose pending messages differ
in count or in any payload bit.

`simulate` is the control (`CONTROLS`): the reference in the program's
place with its payloads carried in bfloat16, the precision below the
configuration's.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

LIMITS = {"actors_off": 0}
CONTROLS = ("bfloat16",)


def expected(n: int, steps: int, dst0: np.ndarray, payload0: np.ndarray
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """`received` per actor, and pending count and payload sum per actor,
    after `steps` steps from the seeded tokens."""
    dst0 = np.asarray(dst0, np.int64)
    laps, rest = divmod(int(steps), n)
    # each token visits every actor `laps` times, then `rest` more actors
    # starting at its seed: a circular range, as a difference array
    diff = np.zeros(n + 1, np.int64)
    end = dst0 + rest
    np.add.at(diff, dst0, 1)
    np.add.at(diff, np.minimum(end, n), -1)
    wrap = end > n
    np.add.at(diff, np.zeros(int(wrap.sum()), np.int64), 1)
    np.add.at(diff, end[wrap] - n, -1)
    received = (np.cumsum(diff[:n]) + laps * len(dst0)).astype(np.int32)
    at = (dst0 + steps) % n
    count = np.bincount(at, minlength=n).astype(np.int64)
    sums = np.zeros((n, payload0.shape[1]), np.float32)
    np.add.at(sums, at, payload0)
    return received, count, sums


def pending(n: int, dst: np.ndarray, valid: np.ndarray,
            payload: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Count and payload sum per recipient of the valid inbox rows."""
    ok = valid & (dst >= 0) & (dst < n)
    to = dst[ok].astype(np.int64)
    count = np.bincount(to, minlength=n).astype(np.int64)
    sums = np.zeros((n, payload.shape[1]), np.float32)
    np.add.at(sums, to, payload[ok].astype(np.float32))
    return count, sums


def compare(out: Dict[str, Any]) -> Dict[str, Tuple[float, float]]:
    n = int(out["n"])
    received, count, sums = expected(n, int(out["steps"]), out["dst0"],
                                     np.asarray(out["payload0"], np.float32))
    got_count, got_sums = pending(n, np.asarray(out["pend_dst"]),
                                  np.asarray(out["pend_valid"], bool),
                                  np.asarray(out["pend_payload"]))
    # bitwise: a payload off by one ulp is off
    bits = sums.view(np.int32) != got_sums.view(np.int32)
    off = (np.asarray(out["received"]) != received) | \
        (count != got_count) | bits.any(axis=1)
    got = {"actors_off": int(off.sum())}
    return {k: (float(v), float(LIMITS[k])) for k, v in got.items()}


def simulate(out: Dict[str, Any], precision: str) -> Dict[str, Any]:
    """The reference in the program's place with payloads carried in
    `precision` ("bfloat16"): each token's payload as that type holds it,
    waiting at its actor after `steps` steps."""
    n = int(out["n"])
    dtype = getattr(torch, precision)
    low = torch.from_numpy(np.asarray(out["payload0"], np.float32)) \
        .to(dtype).to(torch.float32).numpy()
    received, _, _ = expected(n, int(out["steps"]), out["dst0"], low)
    at = (np.asarray(out["dst0"], np.int64) + int(out["steps"])) % n
    return dict(out, received=received, pend_dst=at.astype(np.int32),
                pend_valid=np.ones(len(at), bool), pend_payload=low)
