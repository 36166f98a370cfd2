"""The port's ring mailbox (akka_tpu_torch/ops/cuda_mailbox.py) against the
reference's Pallas kernel (akka_tpu/ops/pallas_mailbox.py), run on the CPU.

The reference kernel runs in Pallas interpret mode, as its own tests run it
(tests/test_bench_smoke.py::test_pallas_interpret_modes_agree); the port
runs its plain PyTorch versions, which is what a wrapper does with CPU
tensors. Integer fields must be bit-identical. Sums agree within rtol 1e-4
/ atol 1e-3: the reference adds in arrival order, the port's kernel with
float atomics in no fixed order (the tolerance the reference accepts
between its own kernel families, tests/test_bench_smoke.py).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # tiny tensors: spare the other test workers

import jax.numpy as jnp

from akka_tpu_torch.ops import cuda_mailbox as cm
from akka_tpu_torch.ops import segment as tsg

pm = pytest.importorskip("akka_tpu.ops.pallas_mailbox")

RTOL, ATOL = 1e-4, 1e-3
INT_FIELDS = ("types", "valid", "count", "dropped", "spill_dst",
              "spill_type", "spill_valid")

# (m, n, p, slots): the reference smoke case, a ragged m (not a multiple
# of the Pallas arrival block), a tiny case with one payload column, and a
# sparse one where many recipients get nothing next to overflowing ones
CASES = [(300, 13, 3, 2), (257, 16, 4, 3), (37, 5, 1, 1), (64, 40, 2, 2)]


def _inputs(m, n, p, seed):
    rng = np.random.default_rng(seed)
    dst = rng.integers(-1, n + 1, size=m).astype(np.int32)  # -1, n: dropped
    dst[:2] = (-1, n)
    mtype = rng.integers(1, 5, size=m).astype(np.int32)
    payload = rng.standard_normal((m, p)).astype(np.float32)
    valid = rng.random(m) > 0.1
    return dst, mtype, payload, valid


def _assert_matches(ref, port):
    assert ref._fields == port._fields
    for f in ref._fields:
        want = np.asarray(getattr(ref, f))
        got = getattr(port, f).numpy()
        assert got.dtype == want.dtype, (f, got.dtype, want.dtype)
        assert got.shape == want.shape, (f, got.shape, want.shape)
        if f in INT_FIELDS:
            np.testing.assert_array_equal(got, want, err_msg=f)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                       err_msg=f)


@pytest.mark.parametrize("m,n,p,slots", CASES)
def test_ring_mailbox_matches_pallas_interpret(m, n, p, slots):
    dst, mtype, payload, valid = _inputs(m, n, p, seed=m * 31 + n)
    cm.reset_launches()
    ref = pm.deliver_reduce(jnp.asarray(dst), jnp.asarray(payload),
                            jnp.asarray(valid), n, True)
    port = cm.deliver_reduce(torch.from_numpy(dst), torch.from_numpy(payload),
                             torch.from_numpy(valid), n, True)
    _assert_matches(ref, port)

    ref = pm.deliver_slots_ring(jnp.asarray(dst), jnp.asarray(mtype),
                                jnp.asarray(payload), jnp.asarray(valid), n,
                                slots, True)
    port = cm.deliver_slots_ring(torch.from_numpy(dst),
                                 torch.from_numpy(mtype),
                                 torch.from_numpy(payload),
                                 torch.from_numpy(valid), n, slots, True)
    _assert_matches(ref, port)
    assert int(port.dropped) > 0 or slots >= int(port.count.max())
    # CPU tensors take the plain versions: no kernel launched
    assert cm.LAUNCHES == {"ring_reduce": 0, "ring_slots": 0}


def test_support_matrix_has_no_state_cap():
    # the reference's 8 MiB VMEM cap would refuse 1M actors at P=4
    assert cm.supported(1 << 20, 4, slots=2)
    assert not pm.supported(1 << 20, 4, slots=2)
    for kwargs, why in [({"spill_cap": 8}, "spill_cap"),
                        ({"slots_kind": torch.ones(4, dtype=torch.bool)},
                         "slots_kind"),
                        ({"suspended": torch.zeros(4, dtype=torch.bool)},
                         "suspended"),
                        ({"dtype": torch.float16}, "dtype")]:
        assert why in cm.unsupported_reason(4, 2, slots=2, **kwargs)


def test_support_matrix_caps_ring_cells_at_int32():
    # the ring kernel indexes its n x S cells with 32-bit ints
    assert cm.supported((1 << 30) - 1, 4, slots=2)
    assert "cell index" in cm.unsupported_reason(1 << 30, 4, slots=2)
    with pytest.raises(ValueError, match="cell index"):
        tsg.deliver_slots(*[torch.zeros(1, dtype=t) for t in (
            torch.int32, torch.int32)], torch.zeros((1, 4)),
            torch.zeros(1, dtype=torch.bool), 1 << 30, 2, backend="cuda")


def test_explicit_cuda_backend_outside_support_raises():
    dst, mtype, payload, valid = _inputs(64, 8, 2, seed=7)
    args = (torch.from_numpy(dst), torch.from_numpy(mtype),
            torch.from_numpy(payload), torch.from_numpy(valid), 8, 2)
    with pytest.raises(ValueError, match="spill_cap"):
        tsg.deliver_slots(*args, spill_cap=8, backend="cuda")
    with pytest.raises(ValueError, match="dtype"):
        tsg.deliver(args[0], args[2].to(torch.float16), args[3], 8,
                    mode="merge", backend="cuda")
    # "auto" on a CPU tensor resolves to the ranked kernels, as on the
    # reference's CPU; with spill it stays ranked
    auto = tsg.deliver_slots(*args, spill_cap=8)
    ranked = tsg.deliver_slots(*args, spill_cap=8, backend="ranked")
    for f in auto._fields:
        assert torch.equal(getattr(auto, f), getattr(ranked, f)), f


def test_wrapper_rejects_bad_inputs():
    dst, mtype, payload, valid = _inputs(16, 4, 2, seed=3)
    with pytest.raises(ValueError, match="int32"):
        cm._check(torch.from_numpy(dst).long(), torch.from_numpy(payload),
                  torch.from_numpy(valid))
    with pytest.raises(ValueError, match="contiguous"):
        cm._check(torch.from_numpy(dst), torch.from_numpy(
            np.asfortranarray(np.tile(payload, (1, 2))))[:, ::2],
            torch.from_numpy(valid))
    with pytest.raises(ValueError, match="shape"):
        cm._check(torch.from_numpy(dst)[:8], torch.from_numpy(payload),
                  torch.from_numpy(valid))


def _typed_inputs(m, n, p, seed, dtype):
    """_inputs with an int32 payload (integers in [-50, 50)) or a bf16 one
    (standard normal values rounded to bf16), as numpy arrays for the
    reference (bf16 as float32, cast on the way in)."""
    dst, mtype, payload, valid = _inputs(m, n, p, seed)
    if dtype == "int32":
        payload = np.random.default_rng(seed + 1).integers(
            -50, 50, size=(m, p)).astype(np.int32)
    else:
        payload = torch.from_numpy(payload).to(torch.bfloat16).float().numpy()
    return dst, mtype, payload, valid


def _as_port(payload, dtype):
    t = torch.from_numpy(payload)
    return t.to(torch.bfloat16) if dtype == "bf16" else t


def _as_ref(payload, dtype):
    a = jnp.asarray(payload)
    return a.astype(jnp.bfloat16) if dtype == "bf16" else a


def _bf16_sum_bound(dst, valid, payload, n):
    """Per element: 2 * k * 2^-8 * sum|x| over that recipient's k accepted
    rows, the recursive-summation bound of both sides (the reference adds
    in bf16, the port in float32 and rounds once)."""
    ok = valid & (dst >= 0) & (dst < n)
    key = np.where(ok, dst, n)
    k = np.bincount(key, minlength=n + 1)[:n].astype(np.float64)
    mag = np.zeros((n + 1, payload.shape[1]))
    np.add.at(mag, key, np.abs(payload.astype(np.float64)))
    return 2 * k[:, None] * 2.0 ** -8 * mag[:n]


@pytest.mark.parametrize("m,n,p,slots", CASES)
@pytest.mark.parametrize("dtype", ["int32", "bf16"])
def test_ring_mailbox_dtypes_match_pallas_interpret(m, n, p, slots, dtype):
    """K1 and K2's plain versions in int32 (every field bit-equal, sums
    included) and bf16 (integer fields, slot payloads and maxes
    bit-equal, sums within the summation bound) against the Pallas
    kernel."""
    dst, mtype, payload, valid = _typed_inputs(m, n, p, m * 17 + n, dtype)
    bound = _bf16_sum_bound(dst, valid, payload, n)
    cm.reset_launches()
    args_ref = (jnp.asarray(dst), _as_ref(payload, dtype), jnp.asarray(valid))
    args_port = (torch.from_numpy(dst), _as_port(payload, dtype),
                 torch.from_numpy(valid))
    ref = pm.deliver_reduce(*args_ref, n, True)
    port = cm.deliver_reduce(*args_port, n, True)
    ref_s = pm.deliver_slots_ring(args_ref[0], jnp.asarray(mtype),
                                  *args_ref[1:], n, slots, True)
    port_s = cm.deliver_slots_ring(args_port[0], torch.from_numpy(mtype),
                                   *args_port[1:], n, slots, True)
    for r, t in ((ref, port), (ref_s, port_s)):
        assert r._fields == t._fields
        for f in r._fields:
            want = np.asarray(jnp.asarray(getattr(r, f), jnp.float32)
                              if dtype == "bf16" and f in ("sum", "max",
                                                           "payload",
                                                           "spill_payload")
                              else getattr(r, f))
            got = getattr(t, f)
            assert tuple(got.shape) == want.shape, f
            if dtype == "bf16" and got.is_floating_point():
                assert got.dtype == torch.bfloat16, f
                got = got.float()
            got = got.numpy()
            if dtype == "bf16" and f == "sum":
                assert (np.abs(got - want) <= bound).all(), f
            else:
                np.testing.assert_array_equal(got, want, err_msg=f)
    assert cm.LAUNCHES == {"ring_reduce": 0, "ring_slots": 0}


def test_int32_max_reads_zero_for_an_empty_recipient():
    """The max convention around the kernel uses the dtype's own sentinel:
    an int32 recipient with no rows reads 0 (not a cast of -inf), one
    whose rows are all negative reads their max, as the reference does."""
    dst = np.array([0, 0, 2, 5, 2], np.int32)        # 1, 3, 4 empty; 5 out
    payload = np.array([[-7, 3], [-2, -9], [4, 1], [8, 8], [-1, -1]],
                       np.int32)
    valid = np.array([True, True, True, True, False])
    ref = pm.deliver_reduce(jnp.asarray(dst), jnp.asarray(payload),
                            jnp.asarray(valid), 5, True)
    port = cm.deliver_reduce(torch.from_numpy(dst), torch.from_numpy(payload),
                             torch.from_numpy(valid), 5, True)
    want = np.array([[-2, 3], [0, 0], [4, 1], [0, 0], [0, 0]], np.int32)
    np.testing.assert_array_equal(port.max.numpy(), want)
    np.testing.assert_array_equal(np.asarray(ref.max), want)
    np.testing.assert_array_equal(port.sum.numpy(), np.asarray(ref.sum))


@pytest.mark.parametrize("dtype", ["float32", "int32", "bf16"])
@pytest.mark.parametrize("pattern", ["random", "ring", "fan_in"])
def test_library_reduce_computes_k1(pattern, dtype):
    """K1's yardstick (`bench_mailbox.library_reduce`, one index_add_)
    against K1's plain version, 320-500 accepted rows onto each of 5
    recipients: int32 bit-equal, float32 within rtol 1e-4 / atol 1e-3,
    bf16 (added in float32, rounded once) within one bf16 ulp plus the
    float32 reordering allowance (`bench_mailbox.compare`)."""
    from akka_tpu_torch.tools import bench_mailbox as bm

    n = 5
    dst, _, payload, valid = bm.make_pattern(
        pattern, 2500 + bm.HOST_ROWS, n, 4, seed=3, device="cpu",
        dtype=bm.DTYPES[dtype])
    want = cm.ring_reduce_plain(dst, payload, valid, n)
    assert int(want[0].min()) > 256
    got = bm.library_reduce(dst, payload, valid, n)()
    assert got[0].dtype == torch.int32 and got[1].dtype == payload.dtype
    slack = bm.sum_slack(dst, payload, valid, n) if dtype == "bf16" else None
    bm.compare(f"library {pattern} {dtype}", got, want, slack)


@pytest.mark.parametrize("dtype", ["float32", "int32", "bf16"])
def test_bound_bytes_counts_the_payload_element_size(dtype):
    """`bench_mailbox.bound_bytes` counts each kernel's payload, sums and
    ring payload at the payload's own element size (bf16's float32
    accumulator and K2's claim levels are scratch, counted nowhere):
    written out term by term at m = 2^20 + 8, n = 2^20, P = 4, S = 2."""
    from akka_tpu_torch.tools import bench_mailbox as bm

    m, n, p, slots, live = (1 << 20) + 8, 1 << 20, 4, 2, 943_000
    elem = {"float32": 4, "int32": 4, "bf16": 2}[dtype]
    k1, k2 = bm.bound_bytes(m, n, p, slots, live, elem)
    inputs1 = m * 4 + m * 1 + live * p * elem       # dst, valid, payload
    outputs1 = n * 4 + n * p * elem                  # counts, sums
    assert k1 == inputs1 + outputs1
    ring = n * slots * (4 + p * elem + 1)            # buf_t, buf_p, buf_v
    assert k2 == k1 + live * 4 + ring + 4            # mtype, rings, dropped


@pytest.mark.parametrize("dtype", ["float32", "int32", "bf16"])
def test_shifted_copy_lies_off_its_word(dtype):
    """`bench_mailbox.shifted` (the misaligned K2 cases' operands): an
    equal, contiguous copy one element past its allocation's start, off
    the 4-element word the vector branches need, and K2's plain version
    gives the same rings and sums for it."""
    from akka_tpu_torch.tools import bench_mailbox as bm

    inputs = bm.make_pattern("random", 45, 11, 4, 1, device="cpu",
                             dtype=bm.DTYPES[dtype])
    moved = bm.shifted(inputs[2])
    assert moved.is_contiguous() and torch.equal(moved, inputs[2])
    assert moved.data_ptr() % (4 * moved.element_size()) != 0
    want = cm.ring_slots_plain(*inputs, 11, 2)
    got = cm.ring_slots_plain(inputs[0], inputs[1], moved, inputs[3], 11, 2)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("key,name", [
    ("void (anonymous namespace)::ring_fill<true, int>(int const*, int)",
     "ring_fill<true, int>"),
    ("(anonymous namespace)::ring_sweep_claim_elems(int const*, int)",
     "ring_sweep_claim_elems"),
    ("Memset (Device)", "Memset")])
def test_kernel_name_of_a_profiler_key(key, name):
    from akka_tpu_torch.tools import bench_mailbox as bm

    assert bm.kernel_name(key) == name
