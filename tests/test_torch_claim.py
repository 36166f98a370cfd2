"""The cascaded claim of the K2 ring kernel (`ring_sweep<CLAIM=true>` and
`ring_fill` in akka_tpu_torch/csrc/ring_mailbox.cu), replayed in numpy
under several interleavings of its atomics and held against the rings of
`ring_slots_plain`.

Each accepted row j offers v = m - j to level 0 of its recipient's claim
levels (empty is 0, the claim is an atomicMax). When the level held a
value, the smaller of the two (the later row) moves one level down, until
a level was empty or the value falls off the last level. The card runs
these atomics in no fixed order, so the replay advances one row by one
atomic at a time, in random order or in an adversarial one (latest row
first, or rows strictly in order). Whatever the order, level k must end
with each recipient's (k+1)-th earliest row: the cells built from the
levels are bit-identical to the plain version's rings, and the rows that
fell off are exactly `dropped`.
"""

import numpy as np
import pytest
import torch

from akka_tpu_torch.ops import cuda_mailbox as cm

ORDERS = ("random", "latest_first", "in_order")


def _replay_claim(dst, valid, n, slots, order, rng):
    """Claim levels [n, slots] (m - j, 0 = empty) and the number of rows
    that fell off the last level, one atomic per pick."""
    m = len(dst)
    ok = valid & (dst >= 0) & (dst < n)
    levels = np.zeros((n, slots), np.int64)
    pending = {int(j): (0, m - int(j)) for j in np.flatnonzero(ok)}
    fell = 0
    while pending:
        rows = sorted(pending)
        if order == "random":
            j = rows[rng.integers(len(rows))]
        elif order == "latest_first":
            j = rows[-1]
        else:
            j = rows[0]
        k, v = pending.pop(j)
        d = dst[j]
        old = levels[d, k]
        levels[d, k] = max(old, v)                  # atomicMax
        if old == 0:
            continue                                # took an empty level
        if k + 1 == slots:
            fell += 1                               # fell off: dropped
        else:
            pending[j] = (k + 1, min(v, old))       # the later row moves down
    return levels, fell


def _fill(levels, mtype, payload, counts, slots):
    """What `ring_fill` writes from the claim levels."""
    m = len(mtype)
    taken = levels != 0
    rows = np.where(taken, m - levels, 0)
    types = np.where(taken, mtype[rows], 0).astype(np.int32)
    pay = np.where(taken[..., None], payload[rows], 0).astype(np.float32)
    dropped = np.maximum(counts - slots, 0).sum()
    return types, pay, taken, dropped


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("slots", [1, 2, 3, 5])
def test_cascaded_claim_matches_plain_rings(slots, order):
    rng = np.random.default_rng(1000 * slots + len(order))
    overflowed = 0
    for case in range(25):
        n = int(rng.integers(1, 8))
        m = int(rng.integers(1, 61))
        p = int(rng.integers(1, 5))
        dst = rng.integers(-1, n + 1, size=m).astype(np.int32)
        mtype = rng.integers(1, 5, size=m).astype(np.int32)
        payload = rng.standard_normal((m, p)).astype(np.float32)
        valid = rng.random(m) > 0.1

        levels, fell = _replay_claim(dst, valid, n, slots, order, rng)
        want = cm.ring_slots_plain(
            torch.from_numpy(dst), torch.from_numpy(mtype),
            torch.from_numpy(payload), torch.from_numpy(valid), n, slots)
        counts = want[3].numpy()
        types, pay, taken, dropped = _fill(levels, mtype, payload, counts,
                                           slots)
        np.testing.assert_array_equal(types, want[0].numpy(), err_msg=case)
        np.testing.assert_array_equal(pay, want[1].numpy(), err_msg=case)
        np.testing.assert_array_equal(taken, want[2].numpy(), err_msg=case)
        assert fell == dropped == int(want[5]), case
        overflowed += int((counts > slots).any())
    assert overflowed > 0  # recipients with more than S arrivals occurred
