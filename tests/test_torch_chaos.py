"""The port's chaos twins (akka_tpu_torch/testkit/chaos.py) against the
reference's (akka_tpu/testkit/chaos.py), on the CPU.

The hash, the rate tests and the loss schedule must be bit-exact against
the reference's jnp functions and both packages' numpy twins, at rates
0, 1, 1e-9 and 1 - 1e-9 and at steps and lanes up to 2^32 - 1. The loss
injector must rewrite the same attention rows. `inject` with each fault
kind, on a 64-row supervised ring stepped in both packages from one
carried state, must leave the same carry (the `_failed` column and the
supervision counters among it) after every run.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import akka_tpu.batched as jb
from akka_tpu.batched.supervision import ATT_STEP as J_ATT_STEP
from akka_tpu.testkit import chaos as jc

import akka_tpu_torch.batched as tb
from akka_tpu_torch.batched.supervision import ATT_STEP, ATT_WORDS
from akka_tpu_torch.testkit import chaos as tc
from akka_tpu_torch.utils.carry import (DEVICE_FIELDS, load_numpy_carry,
                                        numpy_carry)

U32_MAX = (1 << 32) - 1
EDGE = np.asarray([0, 1, 2, 3, 1000, (1 << 31) - 1, 1 << 31,
                   U32_MAX - 1, U32_MAX], np.uint32)
SEEDS = (0, 7, U32_MAX, (1 << 40) + 3)
RATES = (0.0, 1.0, 1e-9, 1.0 - 1e-9, 1e-3, 0.5)
RTOL, ATOL = 1e-4, 1e-3
P = 4
# every (step, lane) pair of EDGE, plus 4096 random ones
_rng = np.random.default_rng(13)
STEPS = np.concatenate([np.repeat(EDGE, EDGE.size),
                        _rng.integers(0, 1 << 32, 4096, dtype=np.uint64)
                        .astype(np.uint32)])
LANES = np.concatenate([np.tile(EDGE, EDGE.size),
                        _rng.integers(0, 1 << 32, 4096, dtype=np.uint64)
                        .astype(np.uint32)])
REF_HASH = jax.jit(jc.chaos_hash, static_argnums=(0, 3))


@pytest.mark.parametrize("seed", SEEDS)
def test_chaos_hash_bit_exact(seed):
    for salt in range(7):
        want = np.asarray(REF_HASH(seed, jnp.asarray(STEPS),
                                   jnp.asarray(LANES), salt)).astype(np.int64)
        got = tc.chaos_hash(seed, STEPS, LANES, salt)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
        # int32 tensors carry the same bits (the step column is int32)
        got32 = tc.chaos_hash(seed, torch.from_numpy(STEPS.view(np.int32)),
                              torch.from_numpy(LANES.view(np.int32)), salt)
        np.testing.assert_array_equal(got32.numpy(), want)
        uni = tc.chaos_uniform_np(seed, STEPS, LANES, salt)
        np.testing.assert_array_equal(
            uni, jc.chaos_uniform_np(seed, STEPS, LANES, salt))
        np.testing.assert_array_equal(uni * float(1 << 32), want)


@pytest.mark.parametrize("rate", RATES)
def test_chaos_hit_bit_exact(rate):
    for seed in SEEDS:
        want = np.asarray(jc.chaos_hit(seed, jnp.asarray(STEPS),
                                       jnp.asarray(LANES), rate, 3))
        got = tc.chaos_hit(seed, STEPS, LANES, rate, 3)
        assert got.dtype == torch.bool and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            tc.chaos_hit_np(seed, STEPS, LANES, rate, 3), want)
        np.testing.assert_array_equal(
            jc.chaos_hit_np(seed, STEPS, LANES, rate, 3), want)
    assert tc._rate_threshold(rate) == jc._rate_threshold(rate)
    # a 0-d step against a lane column, as in a behavior
    step = torch.tensor(5, dtype=torch.int32)
    lanes = torch.arange(64, dtype=torch.int32)
    np.testing.assert_array_equal(
        tc.chaos_hit(7, step, lanes, rate).numpy(),
        jc.chaos_hit_np(7, 5, np.arange(64), rate))


@pytest.mark.parametrize("steps,shards,rate",
                         [(64, 8, 0.05), (300, 3, 1e-3), (16, 4, 0.0),
                          (16, 4, 1.0)])
def test_loss_schedule_bit_exact(steps, shards, rate):
    want = np.asarray(jc.loss_schedule(11, steps, shards, rate))
    got = tc.loss_schedule(11, steps, shards, rate, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tc.loss_schedule_np(11, steps, shards, rate), want)
    np.testing.assert_array_equal(
        jc.loss_schedule_np(11, steps, shards, rate), want)
    assert (tc.CRASH_SALT, tc.NAN_SALT, tc.DROP_SALT, tc.DUP_SALT,
            tc.LOSS_SALT, tc.STALL_SALT) == (
        jc.CRASH_SALT, jc.NAN_SALT, jc.DROP_SALT, jc.DUP_SALT,
        jc.LOSS_SALT, jc.STALL_SALT)


@pytest.mark.parametrize("kw", [dict(loss_rate=0.02),
                                dict(stall_rate=0.05, stall_steps=3),
                                dict(loss_rate=0.01, stall_rate=0.03),
                                dict(loss_rate=0.5, enabled=False)])
def test_loss_injector_filters_attention_alike(kw):
    assert ATT_STEP == J_ATT_STEP
    shards = 6
    ref = jc.DeviceLossInjector(3, shards, **kw)
    port = tc.DeviceLossInjector(3, shards, **kw)
    rng = np.random.default_rng(2)
    for step in range(80):
        att = rng.integers(0, 1000, (shards, ATT_WORDS)).astype(np.int64)
        att[:, ATT_STEP] = step
        want = ref.filter_attention(att)
        got = port.filter_attention(att)
        np.testing.assert_array_equal(got, want, err_msg=f"step {step}")
        for s in range(shards):
            assert port.lost_at(s, step) == ref.lost_at(s, step)


# ------------------------------------------- inject on a supervised ring

@jb.behavior("chaos_ring", {"received": ((), jnp.int32),
                            "acc": ((), jnp.float32)},
             supervisor=jb.LaneSupervisor(), nonfinite_guard=True)
def j_chaos_ring(state, inbox, ctx):
    return ({"received": state["received"] + inbox.count,
             "acc": state["acc"] + inbox.sum[0]},
            jb.Emit.single((ctx.actor_id + 1) % ctx.n_actors, inbox.sum, 2,
                           P, when=inbox.count > 0))


@tb.behavior("chaos_ring", {"received": ((), torch.int32),
                            "acc": ((), torch.float32)},
             supervisor=tb.LaneSupervisor(), nonfinite_guard=True)
def t_chaos_ring(state, inbox, ctx):
    return ({"received": state["received"] + inbox.count,
             "acc": state["acc"] + inbox.sum[:, 0]},
            tb.Emit.single((ctx.actor_id + 1) % ctx.n_actors, inbox.sum, 2,
                           P, when=inbox.count > 0))


KINDS = {"crash": dict(crash_rate=0.05), "nan": dict(nan_rate=0.05),
         "drop": dict(drop_rate=0.05), "dup": dict(dup_rate=0.05),
         "all": dict(crash_rate=0.03, nan_rate=0.03, drop_rate=0.03,
                     dup_rate=0.03)}


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


def assert_carries_match(ref, port, ctx):
    assert sorted(ref) == sorted(port), ctx
    for k in ref:
        want, got = np.asarray(ref[k]), np.asarray(port[k])
        assert got.shape == want.shape, (ctx, k)
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{ctx} {k}")
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"{ctx} {k}")


def _seeded_pair(j_beh, t_beh):
    ref = jb.BatchedSystem(capacity=64, behaviors=[j_beh], payload_width=P,
                           out_degree=2, host_inbox=8, native_staging=False)
    ref.spawn_block(0, 64)
    payload = np.zeros((64, P), np.float32)
    payload[:, 0] = 1.0
    ref.seed_inbox(np.arange(64, dtype=np.int32), payload)
    port = tb.BatchedSystem(capacity=64, behaviors=[t_beh], payload_width=P,
                            out_degree=2, host_inbox=8, device="cpu")
    load_numpy_carry(port, jax_carry(ref))
    return ref, port


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_inject_matches_reference(kind):
    j_beh = jc.inject(j_chaos_ring, seed=7, **KINDS[kind])
    t_beh = tc.inject(t_chaos_ring, seed=7, **KINDS[kind])
    assert sorted(t_beh.state_spec) == sorted(j_beh.state_spec)
    ref, port = _seeded_pair(j_beh, t_beh)
    for steps in (3, 9):
        ref.run(steps)
        port.run(steps)
        assert_carries_match(jax_carry(ref), numpy_carry(port),
                             f"{kind} after {port._host_step} steps")
    assert port.supervision_counts == ref.supervision_counts
    counts = port.supervision_counts
    if kind in ("crash", "nan", "all"):
        assert counts["failed"] > 0
        assert counts["restarted"] == counts["failed"]


def test_crash_schedule_is_the_numpy_twin_of_the_lanes_that_ran():
    """A ring of single tokens under crash injection: a lane runs while
    it holds a token, a crash discards its update and its emission, and
    the default supervisor restarts it in the same step. So `failed` and
    `restarted` both equal the hits of chaos_hit_np over the lanes that
    held a token, step by step, and a lane's count of messages restarts
    from 0 at its crash."""
    t_beh = tc.inject(dataclasses.replace(t_chaos_ring,
                                          nonfinite_guard=False),
                      seed=7, crash_rate=0.05)
    _, port = _seeded_pair(j_chaos_ring, t_beh)
    n, steps = 64, 12
    tok = np.ones(n, bool)
    received = np.zeros(n, np.int32)
    want = 0
    for t in range(steps):
        hit = tc.chaos_hit_np(7, t, np.arange(n), 0.05, tc.CRASH_SALT) & tok
        want += int(hit.sum())
        received[tok & ~hit] += 1
        received[hit] = 0
        tok = np.roll(tok & ~hit, 1)
    port.run(steps)
    counts = port.supervision_counts
    assert want > 0
    assert counts["failed"] == counts["restarted"] == want
    np.testing.assert_array_equal(port.read_state("received"), received)
