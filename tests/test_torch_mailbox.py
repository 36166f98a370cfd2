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
                        ({"dtype": torch.bfloat16}, "dtype")]:
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
        tsg.deliver(args[0], args[2].to(torch.bfloat16), args[3], 8,
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
