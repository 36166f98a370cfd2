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
from akka_tpu_torch.ops import cuda_mailbox as cm
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


# ------------------------------------------------ rank strategies, helpers

REF_RANKS_BY = jax.jit(sg.stable_ranks, static_argnums=(1,),
                       static_argnames=("platform", "strategy"))
COUNT_SHAPES = [(257, 16), (1024, 64), (64, 1), (96, 96), (4096, 1000),
                (33, 3), (333, 8)]


def _keys(m, n, seed):
    return np.random.default_rng(seed).integers(0, n + 1,
                                                size=m).astype(np.int32)


@pytest.mark.parametrize("m,n", COUNT_SHAPES)
@pytest.mark.parametrize("strategy", ["counting", "packed", "sort2",
                                      "auto"])
def test_rank_strategies_match_reference(m, n, strategy):
    key = _keys(m, n, m * 3 + n)
    r_ref, c_ref = REF_RANKS_BY(jnp.asarray(key), n, platform="cpu",
                                strategy=strategy)
    r, c = tsg.stable_ranks(torch.from_numpy(key), n, strategy=strategy)
    assert r.dtype == torch.int32 and c.dtype == torch.int32
    np.testing.assert_array_equal(r.numpy(), np.asarray(r_ref))
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_ref))


def test_counting_ranks_forced_multi_pass_matches_reference():
    """A tiny max_bins forces many 1-bit LSD passes: the ranks must not
    change, and must equal the reference's under the same max_bins."""
    m, n = 777, 1000
    key = _keys(m, n, 5)
    r_ref, c_ref = sg.counting_ranks(jnp.asarray(key), n, max_bins=64)
    r_mp, c_mp = tsg.counting_ranks(torch.from_numpy(key), n, max_bins=64)
    r_1, c_1 = tsg.counting_ranks(torch.from_numpy(key), n)
    for r, c in ((r_mp, c_mp), (r_1, c_1)):
        np.testing.assert_array_equal(r.numpy(), np.asarray(r_ref))
        np.testing.assert_array_equal(c.numpy(), np.asarray(c_ref))


def test_rank_packing_overflow_boundary():
    """(n_keys + 2) * ceil(M/B) >= 2^31: auto picks counting on the CPU
    and an explicit "packed" reroutes to it; the ranks equal the
    reference's sort2."""
    m, n = (1 << 16) + 33, 1 << 20
    assert tsg._auto_rank_strategy(m, n, "cpu") == "counting"
    key = _keys(m, n, 9)
    r_ref, c_ref = REF_RANKS_BY(jnp.asarray(key), n, platform="cpu",
                                strategy="sort2")
    for strategy in ("auto", "packed"):
        r, c = tsg.stable_ranks(torch.from_numpy(key), n, strategy=strategy)
        np.testing.assert_array_equal(r.numpy(), np.asarray(r_ref))
        np.testing.assert_array_equal(c.numpy(), np.asarray(c_ref))
    with pytest.raises(ValueError, match="strategy"):
        tsg.stable_ranks(torch.from_numpy(key), n, strategy="radix")


@pytest.mark.parametrize("m,n", [(64, 8), (4096, 61), (4096, 62),
                                 (1 << 16, 1 << 14), ((1 << 16) + 33, 1 << 20),
                                 (1 << 21, 1 << 20)])
def test_auto_rank_strategy_matches_reference(m, n):
    assert tsg._auto_rank_strategy(m, n, "cpu") == \
        sg._auto_rank_strategy(m, n, "cpu")
    # off the CPU the reference keeps the two-operand sort: so does a card
    assert tsg._auto_rank_strategy(m, n, "cuda") == \
        sg._auto_rank_strategy(m, n, "gpu") == "sort2"


def test_route_one_hop_matches_reference():
    rng = np.random.default_rng(3)
    table = rng.permutation(40).astype(np.int32)
    dst = np.concatenate([rng.integers(0, 40, size=60),
                          [-1, -40, -41, 40, 99]]).astype(np.int32)
    want = np.asarray(sg.route_one_hop(jnp.asarray(dst), jnp.asarray(table)))
    got = tsg.route_one_hop(torch.from_numpy(dst), torch.from_numpy(table))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("capacity", [64, 80, 20])
def test_compact_messages_matches_reference(capacity):
    rng = np.random.default_rng(capacity)
    m = 64
    dst = rng.integers(0, 9, size=m).astype(np.int32)
    payload = rng.standard_normal((m, 3)).astype(np.float32)
    valid = rng.random(m) > 0.4
    ref = sg.compact_messages(jnp.asarray(dst), jnp.asarray(payload),
                              jnp.asarray(valid), capacity)
    port = tsg.compact_messages(torch.from_numpy(dst),
                                torch.from_numpy(payload),
                                torch.from_numpy(valid), capacity)
    for want, got in zip(ref, port):
        want = np.asarray(want)
        assert got.dtype == torch.from_numpy(np.array(want)).dtype
        np.testing.assert_array_equal(got.numpy(), want)
    assert int(port[3]) == max(int(valid.sum()) - capacity, 0)


@pytest.fixture
def restore_backend():
    prev = tsg.get_delivery_backend()
    yield
    tsg.set_delivery_backend(prev)


def test_set_delivery_backend(restore_backend):
    assert tsg.get_delivery_backend() == "auto"
    assert tsg.set_delivery_backend("cuda") == "auto"
    assert tsg.set_delivery_backend("cuda") == "cuda"
    for name in ("xla", "reference", "pallas", None):
        with pytest.raises(ValueError, match="backend"):
            tsg.set_delivery_backend(name)
    assert tsg.get_delivery_backend() == "cuda"
    # a call with backend=None reads the default: "cuda" refuses a spill
    # region, where "auto" ranks it
    dst, ok, payload, mtype, _ = _case(64, 8, 2, seed=4)
    args = (torch.from_numpy(dst), torch.from_numpy(mtype),
            torch.from_numpy(payload), torch.from_numpy(ok), 8, 2)
    with pytest.raises(ValueError, match="spill_cap"):
        tsg.deliver_slots(*args, spill_cap=8)
    tsg.deliver_slots(*args, spill_cap=8, backend="ranked")
    assert tsg.set_delivery_backend("auto") == "cuda"
    tsg.deliver_slots(*args, spill_cap=8)


def test_delivery_attribution_keys_match_reference():
    ref = sg.delivery_attribution(64, 16, repeats=1)
    port = tsg.delivery_attribution(64, 16, repeats=1, device="cpu")
    assert sorted(port) == sorted(ref)
    assert sorted(port["slots_phases"]) == sorted(ref["slots_phases"])
    assert port["platform"] == ref["platform"] == "cpu"
    assert port["rank_strategy"] == ref["rank_strategy"]
    assert all(port[k] >= 0 for k in port if k.endswith("_ms"))


# ------------------------------------------------ A14: sums at full width

def test_ranked_sums_do_not_cancel_at_region_width():
    """At a region's width (the 256 x 4096 counter region's stray-mode
    inbox: m = 2,113,792 rows, n = 1,056,768 recipients, P = 4, the last
    column a reply-row id in [0, n)) every per-recipient sum of the
    ranked kernels must equal the ring kernel's plain version and a
    float64 oracle exactly: every value is an integer and every
    recipient's total stays below 2^24. A prefix sum over the whole sorted
    inbox passes 2^24 early and drops the low bits."""
    m, n, p, slots = 2_113_792, 1_056_768, 4, 2
    rng = np.random.default_rng(14)
    dst = rng.integers(-1, n + 1, size=m).astype(np.int32)
    valid = rng.random(m) > 0.1
    mtype = rng.integers(1, 5, size=m).astype(np.int32)
    payload = np.empty((m, p), np.float32)
    payload[:, :3] = rng.integers(1, 10, size=(m, 3))
    payload[:, 3] = rng.integers(0, n, size=m)
    ok = valid & (dst >= 0) & (dst < n)
    key = np.where(ok, dst, n)
    rank = np.empty(m, np.int64)
    order = np.argsort(key, kind="stable")
    starts = np.searchsorted(key[order], np.arange(n + 1))
    rank[order] = np.arange(m) - starts[key[order]]

    def oracle(rows):
        out = np.zeros((n + 1, p), np.float64)
        np.add.at(out, key[rows], payload[rows].astype(np.float64))
        return out[:n]

    everything = oracle(ok)
    assert everything[:, 3].max() < 2 ** 24 < everything[:, 3].sum()
    t = [torch.from_numpy(a) for a in (dst, mtype, payload, valid)]

    red = tsg.deliver(t[0], t[2], t[3], n, mode="merge", backend="ranked")
    counts, sums = cm.ring_reduce_plain(t[0], t[2], t[3], n)
    np.testing.assert_array_equal(red.sum.numpy(), everything)
    np.testing.assert_array_equal(sums.numpy(), everything)
    np.testing.assert_array_equal(red.count.numpy(), counts.numpy())

    bounded = tsg._deliver_slots_ranked(*t, n, slots, False, 0, None, None)
    plain = cm.ring_slots_plain(*t, n, slots)
    for f, want in zip(("types", "payload", "valid", "count", "sum",
                        "dropped"), plain):
        np.testing.assert_array_equal(getattr(bounded, f).numpy(),
                                      want.numpy(), err_msg=f)
    np.testing.assert_array_equal(bounded.sum.numpy(), everything)

    # with a spill region, overflow past the slots is not consumed: the
    # aggregation covers each recipient's first `slots` rows
    spill = tsg._deliver_slots_ranked(*t, n, slots, False, 4096, None, None)
    np.testing.assert_array_equal(spill.sum.numpy(),
                                  oracle(ok & (rank < slots)))
    np.testing.assert_array_equal(
        spill.count.numpy(), np.minimum(counts.numpy(), slots))
    for f in ("types", "payload", "valid"):
        np.testing.assert_array_equal(getattr(spill, f).numpy(),
                                      getattr(bounded, f).numpy(),
                                      err_msg=f)
