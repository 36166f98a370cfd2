"""The port's tensor CRDT banks (akka_tpu_torch/ddata/tensor.py) against
the reference's (akka_tpu/ddata/tensor.py): values and dtypes
bit-identical, uint32 banks in and out, duplicates that accumulate,
increments that wrap past 2^32 - 1, merges idempotent and commutative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from akka_tpu.ddata import tensor as jt
from akka_tpu_torch.ddata import tensor as tt

RNG = np.random.default_rng(3)


def _t(a: np.ndarray) -> torch.Tensor:
    """A numpy uint32 or bool array as the port's bank."""
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32).copy()).view(torch.uint32)
    return torch.from_numpy(a.copy())


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.uint32:
        return t.view(torch.int32).numpy().view(np.uint32)
    return t.numpy()


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert _np(got).dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(_np(got), want)


def _bank(*shape) -> np.ndarray:
    return RNG.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def test_tensor_gcounter_bank():
    """tests/test_ddata.py::test_tensor_gcounter_bank on both packages."""
    n_keys, n_nodes = 16, 4
    out = {}
    for pkg, mk, arr in (
            ("ref", jt, jnp.array),
            ("port", tt, lambda v: torch.tensor(v, dtype=torch.int64))):
        z = (jnp.zeros((n_keys, n_nodes), jnp.uint32) if pkg == "ref" else
             torch.zeros((n_keys, n_nodes), dtype=torch.int32)
             .view(torch.uint32))
        a = mk.gcounter_increment(z, 0, arr([1, 1, 5]), arr([2, 3, 7]))
        b = mk.gcounter_increment(z, 2, arr([1]), arr([10]))
        m = mk.gcounter_merge(a, b)
        vals = mk.gcounter_value(m)
        assert int(vals[1]) == 15 and int(vals[5]) == 7
        out[pkg] = (a, b, m, vals)
    for got, want in zip(out["port"], out["ref"]):
        _same(got, want)
    a, b, m, _ = out["port"]
    assert torch.equal(tt.gcounter_merge(m, a), m)  # idempotent
    assert torch.equal(tt.gcounter_merge(b, a), m)  # commutative


def test_gcounter_merge_and_value_match_over_the_uint32_range():
    a, b = _bank(64, 4), _bank(64, 4)
    _same(tt.gcounter_merge(_t(a), _t(b)), jt.gcounter_merge(a, b))
    _same(tt.gcounter_value(_t(a)), jt.gcounter_value(a))  # wraps
    m = tt.gcounter_merge(_t(a), _t(b))
    assert torch.equal(tt.gcounter_merge(m, m), m)
    assert torch.equal(tt.gcounter_merge(_t(b), _t(a)), m)


def test_gcounter_increment_accumulates_duplicates_and_wraps():
    bank = _bank(8, 3)
    bank[2, 1] = 2**32 - 2
    keys = np.array([2, 2, 0, 7, 2, 0], np.int32)
    amounts = np.array([1, 5, 2**32 - 1, 9, 2**31, 3], np.uint64) \
        .astype(np.uint32)
    want = jt.gcounter_increment(jnp.asarray(bank), 1, jnp.asarray(keys),
                                 jnp.asarray(amounts))
    got = tt.gcounter_increment(_t(bank), 1, torch.from_numpy(keys),
                                _t(amounts))
    _same(got, want)
    assert _np(got)[2, 1] == (2**32 - 2 + 1 + 5 + 2**31) % 2**32
    # int32 amounts (negatives wrap as uint32) and the input untouched
    signed = np.array([-1, 4, -7, 0, 1, 2], np.int32)
    before = _t(bank)
    got = tt.gcounter_increment(before, 0, torch.from_numpy(keys),
                                torch.from_numpy(signed))
    _same(got, jt.gcounter_increment(jnp.asarray(bank), 0,
                                     jnp.asarray(keys), jnp.asarray(signed)))
    np.testing.assert_array_equal(_np(before), bank)


def test_pncounter_merge_and_value_match_the_reference():
    a, b = _bank(64, 2, 4), _bank(64, 2, 4)
    _same(tt.pncounter_merge(_t(a), _t(b)), jt.pncounter_merge(a, b))
    v = tt.pncounter_value(_t(a))
    assert v.dtype == torch.int32  # the reference's, with 64-bit types off
    _same(v, jt.pncounter_value(a))
    small = np.zeros((4, 2, 3), np.uint32)
    small[0, 0] = [5, 1, 0]
    small[0, 1] = [2, 0, 0]
    small[1, 1] = [9, 0, 0]
    _same(tt.pncounter_value(_t(small)), jt.pncounter_value(small))
    assert tt.pncounter_value(_t(small)).tolist() == [4, -9, 0, 0]


def test_gset_and_flag_merges_match_the_reference():
    a = RNG.random((64, 8)) < 0.3
    b = RNG.random((64, 8)) < 0.3
    _same(tt.gset_merge(_t(a), _t(b)), jt.gset_merge(a, b))
    _same(tt.flag_merge(_t(a[:, 0]), _t(b[:, 0])),
          jt.flag_merge(a[:, 0], b[:, 0]))
    m = tt.gset_merge(_t(a), _t(b))
    assert torch.equal(tt.gset_merge(m, _t(a)), m)
    assert torch.equal(tt.gset_merge(_t(b), _t(a)), m)


@pytest.mark.parametrize("fn", ["converge_over_mesh", "replicate_bank"])
def test_mesh_functions_wait_for_a10(fn):
    """The mesh functions run over a one-card mesh of shard slots
    (tests/test_torch_mesh.py holds them to the reference) and over ranks
    (tests/test_torch_ranks.py); a rank whose slots lie on several cards
    is refused (one process per card), and no mesh is a TypeError."""
    from akka_tpu_torch.parallel import ShardSlot, make_mesh
    two_cards = make_mesh(axis_name="replica", devices=[
        ShardSlot(0, torch.device("cuda", 0)),
        ShardSlot(1, torch.device("cuda", 1))])
    with pytest.raises(NotImplementedError, match="one card per process"):
        getattr(tt, fn)(_t(_bank(2, 4, 2)), mesh=two_cards)
    with pytest.raises(TypeError, match="Mesh"):
        getattr(tt, fn)(_t(_bank(4, 2)), mesh=None)
