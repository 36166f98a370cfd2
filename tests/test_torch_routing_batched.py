"""The port's device routing logics (akka_tpu_torch/routing/batched.py)
against the reference's (akka_tpu/routing/batched.py): routee rows
bit-identical for keys across the whole int32 range, and `random_dst`
held to its contract (shape, dtype, range, spread)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akka_tpu.routing import batched as jr
from akka_tpu_torch.routing import batched as tr

KEYS = np.concatenate([
    np.array([-2**31, -2**31 + 1, -65536, -257, -1, 0, 1, 255, 256, 65535,
              2**24, 2**31 - 2, 2**31 - 1], np.int64),
    np.random.default_rng(11).integers(-2**31, 2**31, 51)]).astype(np.int32)


def test_keys_span_the_int32_range():
    assert KEYS.shape == (64,)
    assert KEYS.min() == -2**31 and KEYS.max() == 2**31 - 1


def test_fnv1a_matches_the_reference_bit_for_bit():
    want = np.asarray(jr._fnv1a(jnp.asarray(KEYS))).astype(np.int64)
    got = tr._fnv1a(torch.from_numpy(KEYS))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_routees", [1, 7, 64, 100_000, 2**31 - 1])
def test_consistent_hash_dst_matches_the_reference(n_routees):
    want = np.asarray(jr.consistent_hash_dst(jnp.asarray(KEYS), 3, n_routees))
    got = tr.consistent_hash_dst(torch.from_numpy(KEYS), 3, n_routees)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("offset", [0, 5, -9, "tensor"])
def test_round_robin_and_broadcast_dst_match_the_reference(offset):
    off_ref = 13 if offset == "tensor" else offset
    off = torch.tensor(13, dtype=torch.int32) if offset == "tensor" \
        else offset
    want = np.asarray(jr.round_robin_dst(64, 100, 7, off_ref))
    got = tr.round_robin_dst(64, 100, 7, off, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tr.broadcast_dst(9, 40, device="cpu").numpy(),
        np.asarray(jr.broadcast_dst(9, 40)))


@pytest.mark.parametrize("logic", tr.BatchedRouter.LOGICS)
@pytest.mark.parametrize("step", [0, 1, -3, 2**31 - 1])
def test_route_matches_the_reference_bit_for_bit(logic, step):
    """Every logic, "random" included (a hash of key and step), for a
    device-scalar step and a host-int step."""
    ref = jr.BatchedRouter(logic, 10, 997)
    want = np.asarray(jax.vmap(lambda k: ref.route(k, step))(
        jnp.asarray(KEYS)))
    port = tr.BatchedRouter(logic, 10, 997)
    keys = torch.from_numpy(KEYS)
    for s in (torch.tensor(step, dtype=torch.int32), step):
        got = port.route(keys, s)
        assert got.dtype == torch.int32 and got.shape == (64,)
        np.testing.assert_array_equal(got.numpy(), want)
    # a scalar key routes like its row
    assert int(port.route(int(KEYS[5]), step)) == int(want[5])


def test_router_checks_its_arguments():
    with pytest.raises(ValueError, match="unknown routing logic"):
        tr.BatchedRouter("smallest-mailbox", 0, 4)
    with pytest.raises(ValueError, match="n_routees"):
        tr.BatchedRouter("random", 0, 0)


def test_random_dst_meets_its_contract():
    """Not the reference's draws (a torch.Generator, not a JAX key): the
    shape, int32, the range [base, base + n), and the spread: over 2^16
    draws onto 64 routees every routee within 25% of the mean."""
    g = torch.Generator(device="cpu").manual_seed(5)
    base, n, draws = 1000, 64, 1 << 16
    d = tr.random_dst(g, draws, base, n)
    assert d.shape == (draws,) and d.dtype == torch.int32
    assert int(d.min()) >= base and int(d.max()) < base + n
    counts = np.bincount(d.numpy() - base, minlength=n)
    mean = draws / n
    assert (np.abs(counts - mean) <= 0.25 * mean).all(), counts
    # the same seed draws the same rows
    g2 = torch.Generator(device="cpu").manual_seed(5)
    assert torch.equal(tr.random_dst(g2, draws, base, n), d)
