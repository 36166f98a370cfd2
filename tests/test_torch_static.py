"""The port's compiled routing (akka_tpu_torch.ops.segment StaticTopology,
deliver_static, StepCore/BatchedSystem with a topology) against the
reference's (akka_tpu), on the CPU.

Topology builds must give the reference's kind and fields. Delivery over
each kind must give the reference's Delivery: integer fields bit for bit
(int32 payloads: every field), float fields within rtol 1e-4 / atol 1e-3
(the reference sums by cumsum differences, the port by scatter-add, so
float sums associate differently). The static ring and fan-in systems must
match the reference's systems and their static=False twins, carry field by
carry field.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # tiny tensors: spare the other test workers

import jax
import jax.numpy as jnp

import akka_tpu.batched as jb
from akka_tpu.models import baseline_benches as jbb
from akka_tpu.ops import segment as sg

import akka_tpu_torch.batched as tb
from akka_tpu_torch.models import baseline_benches as tbb
from akka_tpu_torch.ops import segment as tsg
from akka_tpu_torch.utils.carry import DEVICE_FIELDS, numpy_carry

RTOL, ATOL = 1e-4, 1e-3
P = 4
N = 48
REF_STATIC = jax.jit(sg.deliver_static, static_argnums=(0,),
                     static_argnames=("need_max",))


def _tables():
    """One [N, K] destination table per topology kind."""
    ids = np.arange(N, dtype=np.int64)
    rng = np.random.default_rng(11)
    return {
        "shift": ((ids + 5) % N)[:, None],
        "mod": np.where(ids >= 8, ids % 8, -1)[:, None],   # 8 collectors
        "block": (ids // 6)[:, None],
        "dense": np.stack([(ids + 1) % N, (ids + 2) % N], 1),  # fan-in 2
        # fan-in ~16 into 6 targets, unused slots, 42 empty segments
        "csr": rng.integers(-1, 6, size=(N, 2)),
    }


TABLES = _tables()


@pytest.mark.parametrize("kind", sorted(TABLES))
def test_from_dst_table_matches_reference(kind):
    ref = sg.StaticTopology.from_dst_table(TABLES[kind])
    port = tsg.StaticTopology.from_dst_table(TABLES[kind])
    assert port.kind == ref.kind == kind
    for f in ("n", "k", "shift", "mod", "block"):
        assert getattr(port, f) == getattr(ref, f), f
    for f in ("inverse_edges", "perm", "bounds"):
        want, got = getattr(ref, f), getattr(port, f)
        assert (want is None) == (got is None), f
        if want is not None:
            assert got.dtype == torch.int32 and got.device.type == "cpu"
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f)
    assert len(port.runtime_arrays()) == len(ref.runtime_arrays())
    assert port.to("cpu") is port


@pytest.mark.parametrize("kind", sorted(TABLES))
@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("need_max", [False, True])
def test_deliver_static_matches_reference(kind, dtype, need_max):
    rng = np.random.default_rng(len(kind) * 7 + need_max)
    k = TABLES[kind].shape[1]
    if dtype == "int32":
        payload = rng.integers(-50, 50, size=(N * k, P)).astype(np.int32)
    else:
        payload = rng.standard_normal((N * k, P)).astype(np.float32)
    valid = rng.random(N * k) > 0.2
    ref_topo = sg.StaticTopology.from_dst_table(TABLES[kind])
    topo = tsg.StaticTopology.from_dst_table(TABLES[kind])
    ref = REF_STATIC(ref_topo, ref_topo.runtime_arrays(),
                     jnp.asarray(payload), jnp.asarray(valid),
                     need_max=need_max)
    got = tsg.deliver_static(topo, topo.runtime_arrays(),
                             torch.from_numpy(payload),
                             torch.from_numpy(valid), need_max=need_max)
    assert got._fields == ref._fields
    for f in ref._fields:
        want, have = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
        assert have.dtype == want.dtype and have.shape == want.shape, f
        if f == "count" or dtype == "int32":
            np.testing.assert_array_equal(have, want, err_msg=f)
        else:
            np.testing.assert_allclose(have, want, rtol=RTOL, atol=ATOL,
                                       err_msg=f)


def jax_carry(s):
    """The reference system's carry under akka_tpu_torch.utils.carry keys."""
    out = {f"state/{c}": np.asarray(jax.device_get(v))
           for c, v in s.state.items()}
    for f in DEVICE_FIELDS:
        out[f] = np.asarray(jax.device_get(getattr(s, f)))
    out["host/next_row"] = np.asarray(s._next_row, np.int64)
    out["host/free_rows"] = np.asarray(s._free_rows, np.int64)
    out["host/generation"] = s._generation.copy()
    out["host/step"] = np.asarray(s._host_step, np.int64)
    return out


def assert_carries_match(ref, port, ctx):
    assert sorted(ref) == sorted(port), ctx
    for k in ref:
        want, got = np.asarray(ref[k]), np.asarray(port[k])
        assert got.shape == want.shape, (ctx, k, got.shape, want.shape)
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{ctx} {k}")
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"{ctx} {k}")


def _ring_ref(n, static=True):
    """The reference's ring, as build_ring builds it, with Python staging
    (tells below)."""
    topo = None
    if static:
        topo = sg.StaticTopology.from_dst_table(
            ((np.arange(n, dtype=np.int64) + 1) % n)[:, None])
    s = jb.BatchedSystem(capacity=n, behaviors=[jbb.ring_behavior],
                         payload_width=P, host_inbox=8, topology=topo,
                         native_staging=False)
    s.spawn_block(jbb.ring_behavior, n)
    return s


@pytest.mark.parametrize("cell", ["ring", "fan_in"])
def test_static_systems_match_reference_and_dynamic_twin(cell):
    if cell == "ring":
        ref = _ring_ref(64)
        port = tbb.build_ring(64, device="cpu")
        twin = tbb.build_ring(64, static=False, device="cpu")
        for s, seed in ((ref, jbb.seed_ring_full),
                        (port, tbb.seed_ring_full),
                        (twin, tbb.seed_ring_full)):
            seed(s)
        kind, steps = "shift", 6
    else:
        ref = jbb.build_fan_in(40, 8, static=True)
        port = tbb.build_fan_in(40, 8, device="cpu")
        twin = tbb.build_fan_in(40, 8, static=False, device="cpu")
        kind, steps = "mod", 4
    assert ref._core.topology.kind == port._core.topology.kind == kind
    assert twin._core.topology is None
    for s in (ref, port, twin):
        s.run(steps)
        s.block_until_ready()
    assert_carries_match(jax_carry(ref), numpy_carry(port), cell)
    assert_carries_match(numpy_carry(twin), numpy_carry(port),
                         f"{cell} dynamic twin")
    if cell == "ring":
        assert (port.read_state("received") == steps).all()
    else:
        assert port.read_state("msgs")[:8].sum() == (steps - 1) * 40


def test_host_tells_on_a_static_ring():
    ref = _ring_ref(32)
    port = tbb.build_ring(32, device="cpu")
    twin = tbb.build_ring(32, static=False, device="cpu")
    for s, seed in ((ref, jbb.seed_ring_full), (port, tbb.seed_ring_full),
                    (twin, tbb.seed_ring_full)):
        seed(s)
        s.run(2)
        s.block_until_ready()
        s.tell([0, 5, 5], np.asarray([[1, 0, 0, 0], [2, 0, 0, 0],
                                      [0.5, 1, 0, 0]], np.float32))
        s.step()
        s.block_until_ready()
        s.tell([31], [1.0, 0, 0, 0])
        s.run(3)
        s.block_until_ready()
    assert_carries_match(jax_carry(ref), numpy_carry(port), "tells")
    assert_carries_match(numpy_carry(twin), numpy_carry(port),
                         "tells dynamic twin")
    # 6 steps, one token each; a told row receives its tells on top (the
    # tokens then merge: a row forwards one message)
    want = np.full(32, 6, np.int32)
    want[[0, 5, 31]] += (1, 2, 1)
    np.testing.assert_array_equal(port.read_state("received"), want)


def test_slots_with_topology_raises():
    topo = tsg.StaticTopology.from_dst_table(TABLES["shift"])
    with pytest.raises(ValueError, match="reduce-mode"):
        tb.BatchedSystem(capacity=N, behaviors=[tbb.ring_behavior],
                         payload_width=P, mailbox_slots=2, topology=topo,
                         device="cpu")
    with pytest.raises(ValueError, match="emission slots"):
        tb.BatchedSystem(capacity=N // 2, behaviors=[tbb.ring_behavior],
                         payload_width=P, topology=topo, device="cpu")


@pytest.mark.parametrize("kind", ["shift", "mod", "dense"])
@pytest.mark.parametrize("need_max", [False, True])
@pytest.mark.parametrize("tail_live", [True, False])
def test_step_core_static_delivery_with_a_tail_matches_reference(kind,
                                                                 need_max,
                                                                 tail_live):
    """StepCore's static path: the emission rows through deliver_static,
    the host tail (live rows, dead rows, strays) merged as the reference
    merges it. The port always runs the tail's scatter; the reference
    skips it when no tail row is live, so an all-dead tail must leave
    every max as the static delivery gave it (negative maxes included)."""
    from akka_tpu.batched.step import StepCore as JStepCore
    from akka_tpu_torch.batched.step import StepCore as TStepCore
    table = TABLES[kind]
    k = table.shape[1]
    rng = np.random.default_rng(k + need_max)
    tail = 8
    m = N * k + tail
    dst = rng.integers(-1, N + 1, size=m).astype(np.int32)
    payload = rng.standard_normal((m, P)).astype(np.float32) - 0.5
    valid = rng.random(m) > 0.2
    if not tail_live:
        valid[N * k:] = False
    mtype = np.zeros(m, np.int32)
    ref_topo = sg.StaticTopology.from_dst_table(table)
    ref = JStepCore([jbb.ring_behavior], N, P, k, jnp.float32,
                    need_max=need_max, topology=ref_topo)
    port = TStepCore([tbb.ring_behavior], N, P, k, torch.float32,
                     need_max=need_max,
                     topology=tsg.StaticTopology.from_dst_table(table),
                     device="cpu")
    want = ref.deliver(jnp.asarray(dst), jnp.asarray(mtype),
                       jnp.asarray(payload), jnp.asarray(valid),
                       ref_topo.runtime_arrays())
    got = port.deliver(*(torch.from_numpy(a) for a in (dst, mtype, payload,
                                                       valid)))
    for f in want._fields:
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        if f == "count":
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=f)
