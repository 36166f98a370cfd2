"""The port's delivery primitives (akka_tpu_torch/ops/segment.py) against
the reference's (akka_tpu/ops/segment.py, backend="xla"), on the CPU.

Shapes follow tests/test_delivery_parity.py. Integer fields must be
bit-identical. Float fields agree within rtol 1e-4 / atol 1e-3: both sides
take cumsums, but XLA and PyTorch associate them differently.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # tiny tensors: spare the other test workers

import jax
import jax.numpy as jnp

from akka_tpu.ops import segment as sg
from akka_tpu_torch.ops import segment as tsg

RTOL, ATOL = 1e-4, 1e-3
# one compile per case instead of one per eager op
REF_DELIVER = jax.jit(sg.deliver, static_argnums=(3,),
                      static_argnames=("need_max", "mode", "backend"))
REF_SLOTS = jax.jit(sg.deliver_slots, static_argnums=(4, 5),
                    static_argnames=("need_max", "spill_cap", "backend"))
REF_RANKS = jax.jit(sg.stable_ranks, static_argnums=(1,),
                    static_argnames=("platform",))
INT_FIELDS = ("count", "types", "valid", "dropped", "spill_dst",
              "spill_type", "spill_valid")

REDUCE_SHAPES = [(257, 64, 3), (1024, 128, 4), (4096, 1000, 2),
                 (65, 7, 1), (5000, 16, 5), (33, 1, 2)]
SLOT_CASES = [
    dict(m=257, n=16, p=3, slots=2, cap=0, kind=False, susp=False),
    dict(m=1024, n=64, p=4, slots=3, cap=64, kind=False, susp=False),
    dict(m=2048, n=32, p=2, slots=2, cap=16, kind=True, susp=True),
    dict(m=4096, n=100, p=4, slots=1, cap=8, kind=True, susp=True),
    dict(m=333, n=8, p=1, slots=4, cap=4, kind=True, susp=True),  # overflow
    dict(m=96, n=96, p=2, slots=2, cap=8, kind=True, susp=False),
]


def _case(m, n, p, seed):
    rng = np.random.default_rng(seed)
    dst = rng.integers(-2, n + 2, size=m).astype(np.int32)  # strays included
    ok = rng.random(m) > 0.15
    payload = rng.standard_normal((m, p)).astype(np.float32)
    mtype = rng.integers(1, 5, size=m).astype(np.int32)
    return dst, ok, payload, mtype, rng


def _assert_matches(ref, port, ctx):
    assert ref._fields == port._fields
    for f in ref._fields:
        want = np.asarray(getattr(ref, f))
        got = getattr(port, f).numpy()
        assert got.dtype == want.dtype, (ctx, f, got.dtype, want.dtype)
        assert got.shape == want.shape, (ctx, f, got.shape, want.shape)
        if f in INT_FIELDS:
            np.testing.assert_array_equal(got, want, err_msg=f"{ctx} {f}")
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{ctx} {f}")


@pytest.mark.parametrize("m,n,p", REDUCE_SHAPES)
@pytest.mark.parametrize("mode", ["scatter", "merge", "sort", "auto"])
@pytest.mark.parametrize("need_max", [False, True])
def test_deliver_matches_reference(m, n, p, mode, need_max):
    dst, ok, payload, _, _ = _case(m, n, p, seed=m + n + p)
    ref = REF_DELIVER(jnp.asarray(dst), jnp.asarray(payload), jnp.asarray(ok),
                     n, need_max=need_max, mode=mode, backend="xla")
    port = tsg.deliver(torch.from_numpy(dst), torch.from_numpy(payload),
                       torch.from_numpy(ok), n, need_max=need_max, mode=mode,
                       backend="ranked")
    _assert_matches(ref, port, f"deliver {mode} m={m} n={n} p={p}")
    if mode in ("merge", "sort"):
        # the ring mailbox's plain version (backend="cuda" on a CPU
        # tensor) follows the merge max convention
        ring = tsg.deliver(torch.from_numpy(dst), torch.from_numpy(payload),
                           torch.from_numpy(ok), n, need_max=need_max,
                           mode=mode, backend="cuda")
        ref = REF_DELIVER(jnp.asarray(dst), jnp.asarray(payload),
                         jnp.asarray(ok), n, need_max=need_max,
                         mode="merge", backend="xla")
        _assert_matches(ref, ring, f"ring m={m} n={n} p={p}")


@pytest.mark.parametrize("case", SLOT_CASES,
                         ids=[f"m{c['m']}n{c['n']}cap{c['cap']}"
                              for c in SLOT_CASES])
@pytest.mark.parametrize("need_max", [False, True])
def test_deliver_slots_matches_reference(case, need_max):
    m, n, p, slots, cap = (case["m"], case["n"], case["p"], case["slots"],
                           case["cap"])
    dst, ok, payload, mtype, rng = _case(m, n, p, seed=m * 7 + n)
    kind = rng.random(n) > 0.5 if case["kind"] else None
    susp = rng.random(n) > 0.7 if case["susp"] else None
    ref = REF_SLOTS(
        jnp.asarray(dst), jnp.asarray(mtype), jnp.asarray(payload),
        jnp.asarray(ok), n, slots, need_max=need_max, spill_cap=cap,
        slots_kind=None if kind is None else jnp.asarray(kind),
        suspended=None if susp is None else jnp.asarray(susp),
        backend="xla")
    args = (torch.from_numpy(dst), torch.from_numpy(mtype),
            torch.from_numpy(payload), torch.from_numpy(ok), n, slots)
    port = tsg.deliver_slots(
        *args, need_max=need_max, spill_cap=cap,
        slots_kind=None if kind is None else torch.from_numpy(kind),
        suspended=None if susp is None else torch.from_numpy(susp),
        backend="ranked")
    _assert_matches(ref, port, f"slots {case}")
    if cap == 0:
        ring = tsg.deliver_slots(*args, need_max=need_max, backend="cuda")
        _assert_matches(ref, ring, f"ring slots {case}")


@pytest.mark.parametrize("m,n", [(257, 16), (1024, 64), (65, 1),
                                 (4096, 1000)])
def test_stable_ranks_match_reference(m, n):
    key = np.random.default_rng(m).integers(0, n + 1, size=m).astype(np.int32)
    r_ref, c_ref = REF_RANKS(jnp.asarray(key), n, platform="tpu")
    r, c = tsg.stable_ranks(torch.from_numpy(key), n)
    np.testing.assert_array_equal(r.numpy(), np.asarray(r_ref))
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_ref))
    assert r.dtype == torch.int32 and c.dtype == torch.int32


@pytest.mark.parametrize("m,platform", [(4096, "cpu"), (4096, "cuda"),
                                        (1024, "cuda")])
def test_choose_reduce_kernel_matches_reference(m, platform):
    want = sg.choose_reduce_kernel(m, 64, 4, "cpu" if platform == "cpu"
                                   else "gpu")
    assert tsg.choose_reduce_kernel(m, 64, 4, platform) == want


def test_unknown_backend_and_mode_raise():
    dst = torch.zeros(4, dtype=torch.int32)
    pl = torch.zeros(4, 2)
    ok = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError, match="backend"):
        tsg.deliver(dst, pl, ok, 2, mode="merge", backend="pallas")
    with pytest.raises(ValueError, match="mode"):
        tsg.deliver(dst, pl, ok, 2, mode="pallas")
