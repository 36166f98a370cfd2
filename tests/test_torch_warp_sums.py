"""The int32 sums of the K2 ring kernel (`ring_sweep_claim_elems` in
akka_tpu_torch/csrc/ring_mailbox.cu), replayed in numpy lane by lane and
held against `ring_reduce_plain`.

A block's lanes own one row each for the accept, the count and the claim.
A warp then adds its 32 rows' payload words one lane a word: lane l takes
elements l, l + 32, ... of the warp's 32 * P words, in groups of
`kClaimElems`. Element x lies in row x // P of the warp and column x % P;
a lane works them out once (one division) and steps by 32 // P rows plus
32 % P columns, carrying a column past P into the row. It takes the row's
recipient from the lane that owns the row (`__shfl_sync`); rows past m and
rejected rows carry -1 and add nothing. The replay runs the same
arithmetic at every P the kernel may see, including P above 32 (a lane's
words then lie in one row, or two).
"""

import numpy as np
import pytest
import torch

from akka_tpu_torch.ops import cuda_mailbox as cm

WARP = 32
CLAIM_ELEMS = 4     # kClaimElems: words a lane loads before their atomics


def _accept(dst, valid, j, m, n):
    if j >= m:
        return -1
    d = int(dst[j])
    return d if valid[j] and 0 <= d < n else -1


def _replay(dst, valid, payload, n):
    """(counts [n], sums [n, P]) as the kernel's lanes add them, int32
    wrapping, plus every (row, column) each warp visited."""
    m, p = payload.shape
    counts = np.zeros(n, np.int64)
    sums = np.zeros((n, p), np.int64)
    flat = payload.reshape(-1)
    step_rows, step_cols = WARP // p, WARP % p
    visited = []
    for row0 in range(0, -(-m // WARP) * WARP, WARP):
        d = [_accept(dst, valid, row0 + lane, m, n) for lane in range(WARP)]
        for x in d:
            if x >= 0:
                counts[x] += 1
        seen = []
        for lane in range(WARP):
            r, c = lane // p, lane - (lane // p) * p
            for k0 in range(0, p, CLAIM_ELEMS):
                for i in range(CLAIM_ELEMS):
                    k = k0 + i
                    if k >= p:
                        continue
                    assert r < WARP, (p, lane, k)
                    assert r * p + c == lane + WARP * k, (p, lane, k)
                    seen.append((r, c))
                    dr = d[r]                       # __shfl_sync(d, r)
                    if dr >= 0:
                        sums[dr, c] += flat[row0 * p + lane + WARP * k]
                    r += step_rows
                    c += step_cols
                    if c >= p:
                        c -= p
                        r += 1
        visited.append(seen)
    wrap = ((sums + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)
    return counts.astype(np.int32), wrap, visited


@pytest.mark.parametrize("p", [1, 2, 3, 4, 5, 8, 31, 32, 33, 40])
def test_lane_words_match_plain_sums(p):
    """Each warp visits each of its 32 rows' P words exactly once, and the
    sums equal the plain version's, bit for bit (m = 77: three warps, the
    last one ragged)."""
    rng = np.random.default_rng(p)
    m, n = 77, 9
    dst = rng.integers(-1, n + 1, m).astype(np.int32)
    valid = rng.random(m) > 0.2
    payload = rng.integers(-2 ** 31, 2 ** 31, (m, p), dtype=np.int64) \
        .astype(np.int32)
    counts, sums, visited = _replay(dst, valid, payload, n)
    for seen in visited:
        assert sorted(seen) == [(r, c) for r in range(WARP)
                                for c in range(p)]
    want = cm.ring_reduce_plain(torch.from_numpy(dst),
                                torch.from_numpy(payload),
                                torch.from_numpy(valid), n)
    np.testing.assert_array_equal(counts, want[0].numpy())
    np.testing.assert_array_equal(sums, want[1].numpy())
