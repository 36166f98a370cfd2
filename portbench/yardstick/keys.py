"""Entity names and key draws of the counter cells, made from the seed.

The key space fills a region exactly: for each of `n_shards` shards, the
first `per_shard` names `e-<k>` (k = 0, 1, ...) that FNV-1a over the
name's UTF-8 bytes, modulo `n_shards`, sends there. This is the hash the
Akka-style region documents for its shard extractor; the copy here is the
benchmark's own, so the key space does not move with the program.

Keys are indices into that list (shard-major: index s * per_shard + i is
the i-th name of shard s). Draws are either uniform over the indices or
Zipfian over ranks 1..N with exponent theta (YCSB's `zipfian` request
distribution), scrambled onto indices by a fixed bijection: the ranks
ordered by FNV-1a 64 of their 8 little-endian bytes (YCSB's `fnvhash64`
scramble, made one-to-one). The bijection does not depend on the seed, so
every seed sends the same law of loads to the same entities, in another
order.
"""

from __future__ import annotations

from typing import List

import numpy as np

FNV32_OFFSET, FNV32_PRIME = 2166136261, 16777619
FNV64_OFFSET, FNV64_PRIME = 0xCBF29CE484222325, 0x100000001B3


def fnv1a32_names(prefix: str, lo: int, hi: int) -> np.ndarray:
    """FNV-1a 32 of the names `<prefix><k>` for k in [lo, hi), vectorised
    over the names' bytes (uint32 products wrap as the hash does)."""
    ks = np.arange(lo, hi, dtype=np.int64)
    lens = np.ones(len(ks), np.int64)          # decimal digits of k
    p = 10
    while len(ks) and p <= ks[-1]:
        lens += ks >= p
        p *= 10
    h = np.full(len(ks), FNV32_OFFSET, np.uint32)
    prime = np.uint32(FNV32_PRIME)
    for byte in prefix.encode("utf-8"):
        h = (h ^ np.uint32(byte)) * prime
    for col in range(int(lens.max()) if len(ks) else 0):
        live = lens > col
        # the digit at position `col` from the left, as its ASCII byte
        digit = (ks // 10 ** np.maximum(lens - 1 - col, 0)) % 10 + 48
        h = np.where(live, (h ^ digit.astype(np.uint32)) * prime, h)
    return h


def key_space(n_shards: int, per_shard: int,
              prefix: str = "e-") -> List[str]:
    """The first `per_shard` names of every shard, shard-major."""
    need = n_shards * per_shard
    hi = need + need // 4 + 1024
    while True:
        shard = (fnv1a32_names(prefix, 0, hi) % np.uint32(n_shards)) \
            .astype(np.int64)
        counts = np.bincount(shard, minlength=n_shards)
        if counts.min() >= per_shard:
            break
        hi *= 2
    order = np.argsort(shard, kind="stable")   # by shard, then by k
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pick = (starts[:, None] + np.arange(per_shard)[None, :]).reshape(-1)
    return [f"{prefix}{k}" for k in order[pick].tolist()]


def fnv1a64_u64(values: np.ndarray) -> np.ndarray:
    """FNV-1a 64 over the 8 little-endian bytes of each value."""
    v = values.astype("<u8")
    h = np.full(v.shape, FNV64_OFFSET, np.uint64)
    prime = np.uint64(FNV64_PRIME)
    with np.errstate(over="ignore"):
        for i in range(8):
            byte = (v >> np.uint64(8 * i)) & np.uint64(0xFF)
            h = (h ^ byte) * prime
    return h


def zipf_scramble(n: int) -> np.ndarray:
    """index of rank r (0 = the hottest) for every r: a fixed bijection."""
    return np.argsort(fnv1a64_u64(np.arange(n, dtype=np.uint64)),
                      kind="stable").astype(np.int64)


def zipf_cdf(n: int, theta: float) -> np.ndarray:
    w = np.arange(1, n + 1, dtype=np.float64) ** -float(theta)
    cdf = np.cumsum(w)
    return cdf / cdf[-1]


def hot_share(n: int, theta: float) -> float:
    """The hottest key's share of the draws: 1 / sum_k k^-theta."""
    return float(1.0 / (np.arange(1, n + 1, dtype=np.float64)
                        ** -float(theta)).sum())


class KeyLaw:
    """A law of key indices over [0, n): "uniform", or "zipf" with
    exponent `theta` (its CDF and scramble built once, shared by every
    caller's draws)."""

    def __init__(self, n: int, law: str, theta: float = 0.99):
        if law not in ("uniform", "zipf"):
            raise ValueError(f"unknown key law {law!r}")
        self.n, self.law = n, law
        if law == "zipf":
            self._cdf = zipf_cdf(n, theta)
            self._scramble = zipf_scramble(n)

    def draw(self, rng: np.random.Generator, count: int) -> np.ndarray:
        if self.law == "uniform":
            return rng.integers(0, self.n, count, dtype=np.int64)
        rank = np.searchsorted(self._cdf, rng.random(count), side="right")
        return self._scramble[np.minimum(rank, self.n - 1)]
