"""The port's delivery seam (akka_tpu_torch/ops/segment.py, backend
"ranked") against the reference's wide family (akka_tpu/ops/segment.py,
backend="reference"), on the CPU. The port has no wide family of its own:
its ranked family computes the same function (ROADMAP C), and these cases
hold it to the wide family's results.

Shapes and cases follow tests/test_delivery_parity.py. Integer fields
(counts, slots, types, valid, dropped, the spill rows and their order)
must be bit-identical; float32 sums agree within rtol 1e-4 / atol 1e-3,
bf16 sums (float32 accumulation, one rounding) within one bf16 ulp of a
float64 oracle, int32 sums wrap alike. BatchedSystems of 64 rows step on
"ranked" against the reference's on "reference" from one carried state.
The reference family's sums are differences of one running prefix sum
and cancel once it passes 2^24 (ROADMAP A14): a 4096-row case with large
odd integers shows that fault there and none in the port.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import akka_tpu.batched as jb
from akka_tpu.models import baseline_benches as jbb
from akka_tpu.ops import segment as sg

import akka_tpu_torch.batched as tb
from akka_tpu_torch.models import baseline_benches as tbb
from akka_tpu_torch.ops import segment as tsg
from akka_tpu_torch.utils.carry import (DEVICE_FIELDS, load_numpy_carry,
                                        numpy_carry)

RTOL, ATOL = 1e-4, 1e-3
P = 4
REF_DELIVER = jax.jit(sg.deliver, static_argnums=(3,),
                      static_argnames=("need_max", "mode", "backend"))
REF_SLOTS = jax.jit(sg.deliver_slots, static_argnums=(4, 5),
                    static_argnames=("need_max", "spill_cap", "backend"))
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
DTYPES = {"float32": (torch.float32, jnp.float32),
          "int32": (torch.int32, jnp.int32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _case(m, n, p, seed, dtype="float32"):
    rng = np.random.default_rng(seed)
    dst = rng.integers(-2, n + 2, size=m).astype(np.int32)  # strays included
    ok = rng.random(m) > 0.15
    if dtype == "int32":
        payload = rng.integers(-50, 50, size=(m, p)).astype(np.int32)
    else:
        payload = rng.standard_normal((m, p)).astype(np.float32)
    mtype = rng.integers(1, 5, size=m).astype(np.int32)
    return dst, ok, payload, mtype, rng


def _pair(payload, dtype):
    """The payload in both packages, in `dtype` (bf16 rounded once)."""
    tdt, jdt = DTYPES[dtype]
    return jnp.asarray(payload).astype(jdt), torch.from_numpy(payload).to(tdt)


def _assert_matches(ref, port, ctx, skip=()):
    assert ref._fields == port._fields
    for f in ref._fields:
        if f in skip:
            continue
        want = np.asarray(getattr(ref, f))
        t = getattr(port, f)
        got = (t.float().numpy() if t.dtype == torch.bfloat16
               else t.numpy())
        if want.dtype == jnp.bfloat16:
            want = want.astype(np.float32)
        else:
            assert got.dtype == want.dtype, (ctx, f, got.dtype, want.dtype)
        assert got.shape == want.shape, (ctx, f, got.shape, want.shape)
        if f in INT_FIELDS or want.dtype.kind in "iub" or f == "max" \
                or f == "payload":
            np.testing.assert_array_equal(got, want, err_msg=f"{ctx} {f}")
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{ctx} {f}")


def _oracle_sums(key, payload, rows, n):
    """float64 per-recipient sums of payload[rows] (rows: bool mask)."""
    out = np.zeros((n + 1, payload.shape[1]), np.float64)
    np.add.at(out, key[rows], payload[rows].astype(np.float64))
    return out[:n]


def _assert_bf16_sums(got, want64, ctx):
    """bf16 sums within one bf16 ulp of the float64 oracle."""
    got = got.float().numpy().astype(np.float64)
    tol = np.maximum(np.abs(got), np.abs(want64)) * 2.0 ** -7
    assert (np.abs(got - want64) <= tol).all(), ctx


# ------------------------------------------------------------ reduce

# the reference compiles once per case, and its max's log-step scan
# most of all: need_max=True runs at one shape here (and in the dtype,
# slots and system cases)
@pytest.mark.parametrize("m,n,p,need_max",
                         [s + (False,) for s in REDUCE_SHAPES]
                         + [(1024, 128, 4, True)])
@pytest.mark.parametrize("mode", ["merge", "sort"])
def test_wide_deliver_matches_reference(m, n, p, mode, need_max):
    dst, ok, payload, _, _ = _case(m, n, p, seed=m + n + p)
    ref = REF_DELIVER(jnp.asarray(dst), jnp.asarray(payload), jnp.asarray(ok),
                      n, need_max=need_max, mode=mode, backend="reference")
    port = tsg.deliver(torch.from_numpy(dst), torch.from_numpy(payload),
                       torch.from_numpy(ok), n, need_max=need_max, mode=mode,
                       backend="ranked")
    _assert_matches(ref, port, f"wide {mode} m={m} n={n} p={p}")


@pytest.mark.parametrize("dtype", ["int32", "bf16"])
@pytest.mark.parametrize("mode", ["merge", "sort"])
def test_wide_deliver_dtypes(dtype, mode):
    m, n = 1024, 64
    dst, ok, payload, _, _ = _case(m, n, P, seed=5, dtype=dtype)
    jp, tp = _pair(payload, dtype)
    ref = REF_DELIVER(jnp.asarray(dst), jp, jnp.asarray(ok), n,
                      need_max=True, mode=mode, backend="reference")
    port = tsg.deliver(torch.from_numpy(dst), tp, torch.from_numpy(ok), n,
                       need_max=True, mode=mode, backend="ranked")
    assert port.sum.dtype == port.max.dtype == tp.dtype
    if dtype == "bf16":
        live = ok & (dst >= 0) & (dst < n)
        key = np.where(live, dst, n)
        _assert_bf16_sums(port.sum, _oracle_sums(
            key, tp.float().numpy(), live, n), f"bf16 {mode}")
        _assert_matches(ref, port, f"bf16 {mode}", skip=("sum",))
    else:
        _assert_matches(ref, port, f"{dtype} {mode}")


def test_wide_deliver_all_invalid_and_all_one_actor():
    rng = np.random.default_rng(3)
    payload = rng.standard_normal((128, 3)).astype(np.float32)
    for dst, ok in ((np.full(128, -1, np.int32), np.zeros(128, bool)),
                    (np.zeros(128, np.int32), np.ones(128, bool))):
        for mode in ("merge", "sort"):
            ref = REF_DELIVER(jnp.asarray(dst), jnp.asarray(payload),
                              jnp.asarray(ok), 5, need_max=True, mode=mode,
                              backend="reference")
            port = tsg.deliver(torch.from_numpy(dst),
                               torch.from_numpy(payload),
                               torch.from_numpy(ok), 5, need_max=True,
                               mode=mode, backend="ranked")
            _assert_matches(ref, port, f"edge {mode} {dst[0]}")


# ------------------------------------------------------------ slots

def _slots_args(case, seed, dtype="float32"):
    m, n, p = case["m"], case["n"], case["p"]
    dst, ok, payload, mtype, rng = _case(m, n, p, seed=seed, dtype=dtype)
    kind = rng.random(n) > 0.5 if case["kind"] else None
    susp = rng.random(n) > 0.7 if case["susp"] else None
    return dst, ok, payload, mtype, kind, susp


def _both_slots(case, dst, ok, payload, mtype, kind, susp, need_max,
                dtype="float32"):
    n, slots, cap = case["n"], case["slots"], case["cap"]
    jp, tp = _pair(payload, dtype)
    ref = REF_SLOTS(
        jnp.asarray(dst), jnp.asarray(mtype), jp, jnp.asarray(ok), n, slots,
        need_max=need_max, spill_cap=cap,
        slots_kind=None if kind is None else jnp.asarray(kind),
        suspended=None if susp is None else jnp.asarray(susp),
        backend="reference")
    port = tsg.deliver_slots(
        torch.from_numpy(dst), torch.from_numpy(mtype), tp,
        torch.from_numpy(ok), n, slots, need_max=need_max, spill_cap=cap,
        slots_kind=None if kind is None else torch.from_numpy(kind),
        suspended=None if susp is None else torch.from_numpy(susp),
        backend="ranked")
    return ref, port, tp


@pytest.mark.parametrize("case,need_max",
                         [(c, i % 2 == 0) for i, c in enumerate(SLOT_CASES)],
                         ids=[f"m{c['m']}n{c['n']}cap{c['cap']}"
                              for c in SLOT_CASES])
def test_wide_slots_match_reference(case, need_max):
    args = _slots_args(case, seed=case["m"] * 7 + case["n"])
    ref, port, _ = _both_slots(case, *args, need_max=need_max)
    _assert_matches(ref, port, f"wide slots {case}")


@pytest.mark.parametrize("dtype", ["int32", "bf16"])
def test_wide_slots_dtypes(dtype):
    case = SLOT_CASES[2]
    dst, ok, payload, mtype, kind, susp = _slots_args(case, 11, dtype)
    ref, port, tp = _both_slots(case, dst, ok, payload, mtype, kind, susp,
                                need_max=True, dtype=dtype)
    if dtype == "bf16":
        # the consumed rows: live, to an unsuspended row, and within the
        # slots where the row is slots-kind
        n = case["n"]
        live = ok & (dst >= 0) & (dst < n)
        key = np.where(live, dst, n)
        rank = np.zeros(len(dst), np.int64)
        seen = {}
        for i in np.flatnonzero(live):
            rank[i] = seen.get(key[i], 0)
            seen[key[i]] = rank[i] + 1
        cd = np.clip(dst, 0, n - 1)
        consumed = live & ~susp[cd] & ~(kind[cd] & (rank >= case["slots"]))
        _assert_bf16_sums(port.sum, _oracle_sums(
            key, tp.float().numpy(), consumed, n), "bf16 slots")
        _assert_matches(ref, port, "bf16 slots", skip=("sum",))
    else:
        _assert_matches(ref, port, f"{dtype} slots")


def test_wide_slots_spill_per_block_matches_reference():
    """shards > 1: each block of recipients compacts its own spill and
    counts its own overflow. The reference has no blocks, so each block's
    spill rows and drop count are held to the reference family run on
    that block's messages alone (the order is (recipient, seq) either
    way); the mailboxes and the consumed aggregation to its run on all."""
    n, m, shards, cap = 64, 512, 4, 4
    dst, ok, payload, mtype, rng = _case(m, n, P, seed=21)
    kind = rng.random(n) > 0.3
    susp = rng.random(n) > 0.8
    port = tsg.deliver_slots(
        torch.from_numpy(dst), torch.from_numpy(mtype),
        torch.from_numpy(payload), torch.from_numpy(ok), n, 2,
        need_max=True, spill_cap=cap, slots_kind=torch.from_numpy(kind),
        suspended=torch.from_numpy(susp), shards=shards, backend="ranked")
    assert port.dropped.shape == (shards,) and int(port.dropped.sum()) > 0

    def ref(rows):
        return REF_SLOTS(jnp.asarray(dst), jnp.asarray(mtype),
                         jnp.asarray(payload), jnp.asarray(ok & rows), n, 2,
                         need_max=True, spill_cap=cap,
                         slots_kind=jnp.asarray(kind),
                         suspended=jnp.asarray(susp), backend="reference")

    spill = ("dropped", "spill_dst", "spill_type", "spill_payload",
             "spill_valid")
    _assert_matches(ref(np.ones(m, bool)), port, "per-block mailboxes",
                    skip=spill)
    per = n // shards
    for blk in range(shards):
        want = ref((dst >= blk * per) & (dst < (blk + 1) * per))
        rows = slice(blk * cap, (blk + 1) * cap)
        assert int(port.dropped[blk]) == int(want.dropped), blk
        for f in spill[1:]:
            np.testing.assert_array_equal(
                getattr(port, f)[rows].numpy(), np.asarray(getattr(want, f)),
                err_msg=f"block {blk} {f}")


# ------------------------------------------------------------ A14

def test_wide_sums_do_not_cancel():
    """4096 rows into 2048 recipients, odd integers from [2^19, 2^20):
    every recipient's total stays below 2^24, so it is exact in float32,
    while the running total over all rows passes 2^24 within its first
    few dozen rows. The port's sums (reduce in both modes, and the slots
    path's aggregation) equal the float64 oracle exactly; the reference
    family's, differences of that running total, do not."""
    m, n = 4096, 2048
    rng = np.random.default_rng(0)
    dst = rng.integers(0, n, size=m).astype(np.int32)
    payload = (rng.integers(1 << 18, 1 << 19, size=(m, P)) * 2 + 1) \
        .astype(np.float32)
    ok = np.ones(m, bool)
    want = _oracle_sums(dst, payload, ok, n)
    assert want.max() < 2 ** 24 < payload[:, 0].sum()
    t = [torch.from_numpy(a) for a in (dst, payload, ok)]
    mtype = torch.ones(m, dtype=torch.int32)
    for mode in ("merge", "sort"):
        port = tsg.deliver(*t, n, mode=mode, backend="ranked")
        np.testing.assert_array_equal(port.sum.numpy(), want, err_msg=mode)
        ref = REF_DELIVER(jnp.asarray(dst), jnp.asarray(payload),
                          jnp.asarray(ok), n, mode=mode, backend="reference")
        assert not np.array_equal(np.asarray(ref.sum), want), mode
    slots = tsg.deliver_slots(t[0], mtype, t[1], t[2], n, 2,
                              backend="ranked")
    np.testing.assert_array_equal(slots.sum.numpy(), want)


# ------------------------------------------------------------ systems

@jb.behavior("ring_slots", {"received": ((), jnp.int32),
                            "acc": ((), jnp.float32)}, inbox="slots")
def j_ring_slots(state, mb, ctx):
    got, acc = mb.fold((jnp.int32(0), jnp.float32(0)),
                       lambda c, t, p: (c[0] + 1, c[1] + p[0] * (t + 1)))
    nxt = (ctx.actor_id + 1) % ctx.n_actors
    return ({"received": state["received"] + got, "acc": state["acc"] + acc},
            jb.Emit.single(nxt, mb.payload[0], 1, P, when=got > 0,
                           mtype=mb.types[0] + 1))


@tb.behavior("ring_slots", {"received": ((), torch.int32),
                            "acc": ((), torch.float32)}, inbox="slots")
def t_ring_slots(state, mb, ctx):
    got, acc = mb.fold((torch.zeros_like(state["received"]),
                        torch.zeros_like(state["acc"])),
                       lambda c, t, p: (c[0] + 1, c[1] + p[:, 0] * (t + 1)))
    nxt = (ctx.actor_id + 1) % ctx.n_actors
    return ({"received": state["received"] + got, "acc": state["acc"] + acc},
            tb.Emit.single(nxt, mb.payload[:, 0], 1, P, when=got > 0,
                           mtype=mb.types[:, 0] + 1))


SYSTEMS = {
    "ring_merge": ([jbb.ring_behavior], [tbb.ring_behavior],
                   {"delivery": "merge"}),
    "slots_unbounded": ([j_ring_slots], [t_ring_slots],
                        {"mailbox_slots": 2, "spill_capacity": 8}),
    "slots_bounded": ([j_ring_slots], [t_ring_slots],
                      {"mailbox_slots": 2, "spill_capacity": 0}),
}


def jax_carry(s):
    out = {f"state/{c}": np.asarray(jax.device_get(v))
           for c, v in s.state.items()}
    for f in DEVICE_FIELDS:
        out[f] = np.asarray(jax.device_get(getattr(s, f)))
    out["host/next_row"] = np.asarray(s._next_row, np.int64)
    out["host/free_rows"] = np.asarray(s._free_rows, np.int64)
    out["host/generation"] = s._generation.copy()
    out["host/step"] = np.asarray(s._host_step, np.int64)
    return out


def _assert_carries(ref, port, ctx):
    assert sorted(ref) == sorted(port), ctx
    for k in ref:
        want, got = np.asarray(ref[k]), np.asarray(port[k])
        assert got.shape == want.shape, (ctx, k)
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{ctx} {k}")
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"{ctx} {k}")


def _drive(s):
    """A token seeded into every row, host tells (four to row 2: its two
    slots overflow), then steps."""
    n = s.capacity
    payload = np.zeros((n, P), np.float32)
    payload[:, 0] = 1.0
    payload[:, 1] = np.arange(n, dtype=np.float32) * 0.25
    s.seed_inbox(np.arange(n, dtype=np.int32), payload,
                 np.full(n, 2, np.int32))
    s.tell([1, 2, 2, 2], np.asarray([[1, 0, 0, 0], [0.5, 1, 0, 0],
                                     [0.25, 0, 1, 0], [2, 0, 0, 1]],
                                    np.float32), mtype=[1, 2, 3, 4])
    for _ in range(6):  # step() compiles the reference's step once; run(n)
        s.step()        # would compile a scan of n more
        s.block_until_ready()  # its host pad: see test_torch_batched


@pytest.mark.parametrize("case", sorted(SYSTEMS))
def test_wide_systems_match_reference(case):
    """Host tells staged in the Python list on both sides."""
    _wide_system_matches_reference(case, native=False)


@pytest.mark.parametrize("case", sorted(SYSTEMS))
def test_wide_systems_on_the_stager_match_reference(case):
    """Host tells staged in the native stager on both sides."""
    _wide_system_matches_reference(case, native=True)


def _wide_system_matches_reference(case, native):
    j_beh, t_beh, kwargs = SYSTEMS[case]
    ref = jb.BatchedSystem(capacity=64, behaviors=j_beh, payload_width=P,
                           host_inbox=8, native_staging=native,
                           delivery_backend="reference", **kwargs)
    port = tb.BatchedSystem(capacity=64, behaviors=t_beh, payload_width=P,
                            host_inbox=8, device="cpu",
                            native_staging=native,
                            delivery_backend="ranked", **kwargs)
    assert (ref._stager is not None) is native
    assert port.native_staging is native
    for s in (ref, port):
        s.spawn_block(0, 64)
    load_numpy_carry(port, jax_carry(ref))
    _drive(ref)
    _drive(port)
    _assert_carries(jax_carry(ref), numpy_carry(port), case)
    assert port.mailbox_overflow == ref.mailbox_overflow
    assert port.dropped_messages == ref.dropped_messages
    if case == "slots_bounded":
        assert port.mailbox_overflow > 0


# ------------------------------------------------------------ the seam

@pytest.fixture
def restore_backend():
    prev = tsg.get_delivery_backend()
    try:
        yield
    finally:
        tsg.set_delivery_backend(prev)


def test_wide_backend_seam(restore_backend):
    """The port has no "wide" backend: it and the reference's own names
    raise, "auto" resolves to "ranked" on a CPU tensor, and a call with
    backend=None reads the process default."""
    assert "wide" not in tsg.DELIVERY_BACKENDS
    for name in ("wide", "xla", "reference", "pallas"):
        with pytest.raises(ValueError, match="backend"):
            tsg.set_delivery_backend(name)
    assert not tsg._use_ring("auto", "cpu", None)
    assert tsg._use_ring("auto", "cuda", None)
    assert not tsg._use_ring("auto", "cuda", "spill_cap > 0")
    dst, ok, payload, mtype, _ = _case(300, 16, 2, seed=8)
    args = [torch.from_numpy(a) for a in (dst, payload, ok)]
    assert tsg.set_delivery_backend("ranked") == "auto"
    default = tsg.deliver(*args, 16, mode="merge")
    explicit = tsg.deliver(*args, 16, mode="merge", backend="ranked")
    for f in default._fields:
        assert torch.equal(getattr(default, f), getattr(explicit, f)), f
    assert tsg.set_delivery_backend("auto") == "ranked"
