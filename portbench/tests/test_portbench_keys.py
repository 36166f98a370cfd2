"""The counter cells' key space and key laws (yardstick/keys.py)."""

import json

import numpy as np

from portbench import harness
from portbench.yardstick import keys


def fnv1a32(name: str) -> int:
    h = 2166136261
    for byte in name.encode("utf-8"):
        h = ((h ^ byte) * 16777619) & 0xFFFFFFFF
    return h


def test_vectorised_hash_matches_the_byte_loop():
    got = keys.fnv1a32_names("e-", 0, 5000)
    want = [fnv1a32(f"e-{k}") for k in range(5000)]
    assert got.tolist() == want


def test_key_space_fills_every_shard_exactly():
    """At the configuration's own size: 1000 shards of 4096 names."""
    config = json.loads((harness.PKG / "configs" / "sharded-counter-4m.json")
                        .read_text())
    n_shards, eps = config["number_of_shards"], config["entities_per_shard"]
    names = keys.key_space(n_shards, eps)
    assert len(names) == len(set(names)) == n_shards * eps \
        == config["recordcount"]
    ks = np.asarray([int(n[2:]) for n in names])
    shard = keys.fnv1a32_names("e-", 0, int(ks.max()) + 1)[ks] % n_shards
    assert np.array_equal(shard, np.repeat(np.arange(n_shards), eps))
    # the byte loop agrees on a sample of the names
    for i in range(0, len(names), 4099):
        assert fnv1a32(names[i]) % n_shards == i // eps
    # each shard's names are the first that hash there, in order of k
    first = ks[:eps].tolist()
    assert first == sorted(first)
    lower = [k for k in range(first[-1]) if fnv1a32(f"e-{k}") % n_shards == 0]
    assert lower == first[:-1]


def test_zipf_hot_share_and_scramble():
    n = 4_096_000
    law = keys.KeyLaw(n, "zipf", 0.99)
    scramble = keys.zipf_scramble(n)
    assert np.array_equal(np.sort(scramble), np.arange(n))
    draws = law.draw(np.random.default_rng(2 ** 31 + 3), 2_000_000)
    counts = np.bincount(draws, minlength=n)
    share = keys.hot_share(n, 0.99)
    assert abs(share - 0.0587) < 0.0005
    assert counts.argmax() == scramble[0]
    assert abs(counts.max() / len(draws) - share) < 0.002


def test_uniform_and_seeded():
    law = keys.KeyLaw(1000, "uniform")
    a = law.draw(np.random.default_rng([7, 1]), 10_000)
    b = law.draw(np.random.default_rng([7, 1]), 10_000)
    assert np.array_equal(a, b) and a.min() >= 0 and a.max() < 1000
    counts = np.bincount(a, minlength=1000)
    assert counts.max() < 40
