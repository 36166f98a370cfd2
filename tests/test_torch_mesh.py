"""Meshes of shard slots (akka_tpu_torch/parallel/mesh.py) and the bank
functions over them (akka_tpu_torch/ddata/tensor.py converge_over_mesh,
replicate_bank), held to the reference's jax meshes
(akka_tpu/parallel/mesh.py) and bank functions on its virtual devices:
the same shapes and axis names, and the same banks bit for bit."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from akka_tpu.ddata import tensor as jt
from akka_tpu.parallel import mesh as jmesh

from akka_tpu_torch.ddata import tensor as tt
from akka_tpu_torch.parallel import mesh as tmesh

RNG = np.random.default_rng(17)


def _t(a: np.ndarray) -> torch.Tensor:
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32).copy()).view(torch.uint32)
    return torch.from_numpy(a.copy())


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.uint32:
        return t.view(torch.int32).numpy().view(np.uint32)
    return t.numpy()


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_make_mesh_matches_reference_shape(n):
    j = jmesh.make_mesh(n)
    t = tmesh.make_mesh(n, device="cpu")
    assert t.shape == dict(j.shape) and t.axis_names == j.axis_names
    assert t.size == j.size == n
    assert [s.index for s in t.slots] == list(range(n))
    assert t.device == torch.device("cpu")
    assert t == tmesh.make_mesh(devices=tmesh.shard_slots(n, "cpu"))


def test_make_mesh_2d_and_specs_match_reference():
    j = jmesh.make_mesh_2d(2, 4)
    t = tmesh.make_mesh_2d(2, 4, device="cpu")
    assert t.shape == dict(j.shape) == {"dp": 2, "tp": 4}
    assert t.devices.shape == j.devices.shape
    # row-major, as the reference reshapes its device list
    assert [[s.index for s in row] for row in t.devices] == \
        [[0, 1, 2, 3], [4, 5, 6, 7]]
    m = tmesh.make_mesh(4, axis_name="shards", device="cpu")
    jm = jmesh.make_mesh(4)
    assert tmesh.shard_spec(m).axes == tuple(jmesh.shard_spec(jm).spec)
    assert tmesh.replicated_spec(m).axes == \
        tuple(jmesh.replicated_spec(jm).spec) == ()
    assert tmesh.host_device_count() == torch.cuda.device_count()


def test_mesh_slots_keep_their_order_and_one_card():
    slots = tmesh.shard_slots(8, "cpu")
    m = tmesh.make_mesh(devices=[slots[3], slots[1], slots[6]])
    assert [s.index for s in m.slots] == [3, 1, 6] and m.size == 3
    assert hash(m) == hash(tmesh.make_mesh(devices=[slots[3], slots[1],
                                                    slots[6]]))
    with pytest.raises(ValueError, match="twice"):
        tmesh.make_mesh(devices=[slots[0], slots[0]])
    with pytest.raises(TypeError, match="ShardSlot"):
        tmesh.make_mesh(devices=[0, 1])
    two = tmesh.make_mesh(devices=[
        tmesh.ShardSlot(0, torch.device("cuda", 0)),
        tmesh.ShardSlot(1, torch.device("cuda", 1))])
    assert len(two.cards) == 2 and two.world_size == 1
    with pytest.raises(NotImplementedError, match="one card per process"):
        two.device
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_mesh(2)


def _replicated(host: np.ndarray, n: int):
    """The reference's stacked bank on n virtual devices, and the port's
    on n slots of the CPU."""
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:n]), ("replica",))
    stacked = jax.device_put(jax.numpy.asarray(host),
                             NamedSharding(mesh, PartitionSpec("replica")))
    return mesh, stacked, tmesh.make_mesh(n, axis_name="replica",
                                          device="cpu")


@pytest.mark.parametrize("kind", ["gcounter", "pncounter", "gset"])
def test_converge_over_mesh_matches_reference(kind):
    n = 4
    if kind == "gcounter":
        host = RNG.integers(0, 2**32, (n, 16, n), dtype=np.uint64) \
            .astype(np.uint32)
    elif kind == "pncounter":
        host = RNG.integers(0, 2**32, (n, 16, 2, n), dtype=np.uint64) \
            .astype(np.uint32)
    else:
        host = RNG.random((n, 16, 8)) < 0.2
    op = "or" if kind == "gset" else "max"
    jmesh_, stacked, tmesh_ = _replicated(host, n)
    want = np.asarray(jt.converge_over_mesh(stacked, jmesh_, op=op))
    got = tt.converge_over_mesh(_t(host), tmesh_, op=op)
    assert got.dtype == _t(host).dtype
    assert _np(got).dtype == want.dtype
    np.testing.assert_array_equal(_np(got), want)
    for r in range(n):  # every replica holds the join
        np.testing.assert_array_equal(_np(got)[r], _np(got)[0])


def test_replicated_counters_converge_like_reference():
    """The reference's own scenario (tests/test_ddata.py): each replica
    bumps its own node column, one converge gives every replica the join,
    and the value is the sum over the nodes."""
    n, n_keys = 4, 8
    base = np.zeros((n_keys, n), np.uint32)
    jmesh_, _, tmesh_ = _replicated(np.zeros((n, n_keys, n), np.uint32), n)
    jrep = np.asarray(jt.replicate_bank(jax.numpy.asarray(base), jmesh_))
    trep = tt.replicate_bank(_t(base), tmesh_)
    np.testing.assert_array_equal(_np(trep), jrep)
    assert trep.shape == (n, n_keys, n) and trep.device.type == "cpu"
    keys = torch.arange(n_keys)
    bumped = torch.stack([tt.gcounter_increment(
        trep[r], r, keys, torch.full((n_keys,), r + 1)) for r in range(n)])
    host = np.stack([_np(b) for b in bumped])
    _, jstacked, _ = _replicated(host, n)
    want = np.asarray(jt.converge_over_mesh(jstacked, jmesh_))
    got = tt.converge_over_mesh(bumped, tmesh_)
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(_np(tt.gcounter_value(got[0])),
                                  np.full(n_keys, sum(range(1, n + 1))))


def test_bank_and_mesh_must_agree():
    m = tmesh.make_mesh(4, axis_name="replica", device="cpu")
    bank = _t(np.zeros((3, 2, 4), np.uint32))
    with pytest.raises(ValueError, match="3 replicas"):
        tt.converge_over_mesh(bank, m)
    with pytest.raises(ValueError, match="no axis 'nodes'"):
        tt.replicate_bank(bank, m, axis="nodes")
    with pytest.raises(ValueError, match="unknown merge op"):
        tt.converge_over_mesh(_t(np.zeros((4, 2), np.uint32)), m, op="sum")
    assert tt.replicate_bank(bank[0], tmesh.shard_spec(m, "replica")) \
        .shape == (4, 2, 4)
