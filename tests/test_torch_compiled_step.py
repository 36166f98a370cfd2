"""The compiled step's contract on the CPU: the in-place carry, warmup()
and the pipelined attention words of the port's BatchedSystem and
ShardedBatchedSystem (akka_tpu_torch), held to the reference's (akka_tpu).

On a card the port replays each step as a CUDA graph over fixed
addresses (akka_tpu_torch/batched/graphs.py); the CPU runs the same
in-place step eagerly. These tests check what the graphs rely on:

- every carried tensor keeps its storage (`data_ptr()`) across step,
  run(n), restart_rows, clear_failed, set_tables, load_numpy_carry,
  run_pipelined, a same-shape restore and a trip through the hand-off
  window's inbox;
- warmup() and the eager warm-up over clones leave the live carry
  bit-equal, and afterwards `warmup(); run(n)` equals the reference's
  from one carried state (integers bit for bit, floats within rtol 1e-4 /
  atol 1e-3: XLA and PyTorch sum in different orders);
- run_pipelined(n, depth=3, on_attention=...) delivers each step's own
  attention word, in order, as the reference does: the step field runs
  1..n and an overflowing bounded-mailbox cell's mail_dropped grows step
  by step (an in-place word read late would repeat the newest step's).

Systems have at most 64 rows; each reference system compiles once.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # tiny tensors: spare the other test workers

import jax
import jax.numpy as jnp

import akka_tpu.batched as jb
from akka_tpu.actor.supervision import Directive as JDirective
from akka_tpu.batched.sharded import ShardedBatchedSystem as JSharded

import akka_tpu_torch.batched as tb
from akka_tpu_torch.batched import core as tcore
from akka_tpu_torch.batched import sharded as tsharded
from akka_tpu_torch.batched.sharded import ShardedBatchedSystem as TSharded
from akka_tpu_torch.utils.carry import (DEVICE_FIELDS, SHARDED_FIELDS,
                                        load_numpy_carry, numpy_carry)

RTOL, ATOL = 1e-4, 1e-3
P = 4
ATT_KEYS = ("flags", "mail_dropped", "dead_letters", "step",
            "exchange_dropped")


# -------------------------------------------- behaviors, both packages

# supervised ring: fails on a row's second message (rows 4, 13, 22, ...)
@jb.behavior("flaky", {"acc": ((), jnp.float32), "hits": ((), jnp.int32)},
             supervisor=jb.LaneSupervisor(JDirective.RESTART,
                                          max_nr_of_retries=1,
                                          min_backoff_steps=1,
                                          max_backoff_steps=2))
def j_flaky(state, inbox, ctx):
    fail = (ctx.actor_id % 9 == 4) & (state["hits"] >= 1)
    return ({"acc": state["acc"] + inbox.sum[0],
             "hits": state["hits"] + inbox.count, "_failed": fail},
            jb.Emit.single((ctx.actor_id + 7) % ctx.n_actors, inbox.sum, 1,
                           P, when=inbox.count > 0))


@tb.behavior("flaky", {"acc": ((), torch.float32), "hits": ((), torch.int32)},
             supervisor=tb.LaneSupervisor(tb.Directive.RESTART,
                                          max_nr_of_retries=1,
                                          min_backoff_steps=1,
                                          max_backoff_steps=2))
def t_flaky(state, inbox, ctx):
    fail = (ctx.actor_id % 9 == 4) & (state["hits"] >= 1)
    return ({"acc": state["acc"] + inbox.sum[:, 0],
             "hits": state["hits"] + inbox.count, "_failed": fail},
            tb.Emit.single((ctx.actor_id + 7) % ctx.n_actors, inbox.sum, 1,
                           P, when=inbox.count > 0))


# every leaf sends [1, 0, 0, 0] to row 0 each step
@jb.behavior("leaf", {}, always_on=True)
def j_leaf(state, inbox, ctx):
    return {}, jb.Emit.single(0, jnp.array([1.0, 0, 0, 0]), 1, P,
                              when=ctx.actor_id > 0)


@tb.behavior("leaf", {}, always_on=True)
def t_leaf(state, inbox, ctx):
    return {}, tb.Emit.single(torch.zeros_like(ctx.actor_id),
                              [1.0, 0, 0, 0], 1, P, when=ctx.actor_id > 0)


# a bounded-mailbox sink: counts the messages that reach its slots
@jb.behavior("sink", {"got": ((), jnp.int32)}, inbox="slots")
def j_sink(state, mb, ctx):
    got = mb.fold(jnp.int32(0), lambda c, t, p: c + 1)
    return {"got": state["got"] + got}, jb.Emit.none(1, P)


@tb.behavior("sink", {"got": ((), torch.int32)}, inbox="slots")
def t_sink(state, mb, ctx):
    got = mb.fold(torch.zeros_like(state["got"]), lambda c, t, p: c + 1)
    return ({"got": state["got"] + got},
            tb.Emit.none(ctx.actor_id.shape[0], 1, P))


# ------------------------------------------------------------- carries

def jax_carry(s, sharded: bool):
    """The reference system's carry under akka_tpu_torch.utils.carry's
    keys (writable copies)."""
    out = {f"state/{c}": np.array(jax.device_get(v))
           for c, v in s.state.items()}
    for f in SHARDED_FIELDS if sharded else DEVICE_FIELDS:
        out[f] = np.array(jax.device_get(getattr(s, f)))
    out["host/next_row"] = np.asarray(s._next_row, np.int64)
    if not sharded:
        out["host/free_rows"] = np.asarray(s._free_rows, np.int64)
        out["host/generation"] = s._generation.copy()
    out["host/step"] = np.asarray(s._host_step, np.int64)
    return out


def assert_carries_match(want_carry, got_carry, ctx, exact=False):
    assert sorted(want_carry) == sorted(got_carry), ctx
    for k, want in want_carry.items():
        got = np.asarray(got_carry[k])
        assert got.shape == want.shape, (ctx, k, got.shape, want.shape)
        if want.dtype.kind == "f" and not exact:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{ctx} {k}")
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"{ctx} {k}")


def carried(system):
    """Every carried tensor of a port system, by name."""
    fields = tsharded.CARRY if hasattr(system, "n_shards") else tcore.CARRY
    out = {f"state/{c}": v for c, v in system.state.items()}
    out.update({f: getattr(system, f) for f in fields})
    out.update({f"tables/{k}": v
                for k, v in getattr(system, "tables", {}).items()})
    return out


def pointers(system):
    return {k: v.data_ptr() for k, v in carried(system).items()}


def batched_pair(j_beh, t_beh, spawns, **kw):
    ref = jb.BatchedSystem(capacity=64, behaviors=j_beh, payload_width=P,
                           host_inbox=8, native_staging=False, **kw)
    port = tb.BatchedSystem(capacity=64, behaviors=t_beh, payload_width=P,
                            host_inbox=8, device="cpu", **kw)
    for b, k in spawns:
        ref.spawn_block(b, k)
        port.spawn_block(b, k)
    load_numpy_carry(port, jax_carry(ref, False))
    return ref, port


def sharded_pair(j_beh, t_beh, spawns, d=2, **kw):
    ref = JSharded(capacity=64, behaviors=j_beh, n_devices=d,
                   payload_width=P, host_inbox_per_shard=8, **kw)
    port = TSharded(capacity=64, behaviors=t_beh, n_devices=d,
                    payload_width=P, host_inbox_per_shard=8, device="cpu",
                    **kw)
    for b, k in spawns:
        ref.spawn_block(b, k)
        port.spawn_block(b, k)
    load_numpy_carry(port, jax_carry(ref, True))
    return ref, port


def seed(s):
    """Traffic for either package: a seeded token per row (a host tell to
    every third row on the sharded system, which has no seed_inbox), row
    i's payload [1, i / 4, 0, 0], then two more host tells."""
    n = s.capacity
    if hasattr(s, "seed_inbox"):
        payload = np.zeros((n, P), np.float32)
        payload[:, 0] = 1.0
        payload[:, 1] = np.arange(n, dtype=np.float32) * 0.25
        s.seed_inbox(np.arange(n, dtype=np.int32), payload,
                     np.zeros(n, np.int32))
    else:
        for i in range(0, n, 3):
            s.tell(i, [1.0, i * 0.25, 0.0, 0.0])
    s.tell(5, [2.0, 0.0, 0.0, 0.0])
    s.tell(9, [0.5, 1.0, 0.0, 0.0])


# --------------------------------------------------------------- tests

@pytest.mark.parametrize("kind", ["batched", "sharded"])
def test_every_carried_tensor_keeps_its_storage(kind, tmp_path):
    if kind == "batched":
        s = tb.BatchedSystem(capacity=64, behaviors=[t_flaky],
                             payload_width=P, host_inbox=8, device="cpu",
                             metrics_enabled=True)
    else:
        s = TSharded(capacity=64, behaviors=[t_flaky], n_devices=4,
                     payload_width=P, host_inbox_per_shard=8, device="cpu",
                     metrics_enabled=True, reroute_strays=True)
        s.set_tables({"base": torch.arange(4, dtype=torch.int32)})
    s.spawn_block(0, 64)
    seed(s)
    ptrs = pointers(s)

    def held(what):
        assert pointers(s) == ptrs, what

    s.step()
    held("step")
    s.run(4)
    held("run(4)")
    s.restart_rows([4, 13], init_state={"acc": 2.5})
    held("restart_rows")
    np.testing.assert_array_equal(s.read_state("acc", [4, 13]), [2.5, 2.5])
    s.clear_failed(s.failed_rows())
    held("clear_failed")
    assert not s.any_failed()
    s.run_pipelined(3, depth=2)
    s.block_until_ready()
    held("run_pipelined")
    before = numpy_carry(s)
    s._warm()  # a card's warm-up before its first capture, over clones
    held("eager warm-up")
    assert_carries_match(before, numpy_carry(s), "warm-up", exact=True)
    if kind == "sharded":
        # the clones' stray layout stayed the clones' own
        assert list(s._inboxes) == [s.pair_cap_base]
    if kind == "sharded":
        s.set_tables({"base": torch.arange(4, dtype=torch.int32) * 16})
        held("set_tables, same shapes")
        np.testing.assert_array_equal(s.tables["base"].numpy(),
                                      [0, 16, 32, 48])
        # a trip through the hand-off window: the inbox moves into the
        # stray layout's tensors and back into the steady ones
        s.enter_stray_mode()
        assert s.inbox_dst.data_ptr() != ptrs["inbox_dst"]
        stray_ptrs = pointers(s)
        s.run(2)
        assert pointers(s) == stray_ptrs
        assert s.exit_stray_mode()
        held("enter_stray_mode, run, exit_stray_mode")
    load_numpy_carry(s, numpy_carry(s))
    held("load_numpy_carry")
    before = numpy_carry(s)
    path = s.checkpoint(str(tmp_path))
    s.run(3)
    s.restore(path)
    held("same-shape restore")
    assert_carries_match(before, numpy_carry(s), "restored", exact=True)


BATCHED_CASES = {
    "supervised": ([j_flaky], [t_flaky], [(0, 64)],
                   {"metrics_enabled": True}),
    "slots_bounded": ([j_sink, j_leaf], [t_sink, t_leaf], [(0, 1), (1, 63)],
                      {"mailbox_slots": 2, "spill_capacity": 0}),
}


@pytest.mark.parametrize("case", sorted(BATCHED_CASES) + ["sharded"])
def test_warmup_leaves_the_carry_then_run_matches_reference(case):
    """warmup() and the eager warm-up over clones (what a card runs before
    its first capture) leave the live carry bit-equal and in place; then
    the port's warmup(); run(n) equals the reference's (the reference's
    sharded system has no warmup: its run(n))."""
    if case == "sharded":
        ref, port = sharded_pair([j_flaky], [t_flaky], [(0, 64)],
                                 metrics_enabled=True)
    else:
        j_beh, t_beh, spawns, kw = BATCHED_CASES[case]
        ref, port = batched_pair(j_beh, t_beh, spawns, **kw)
    sharded = case == "sharded"
    for s in (ref, port):
        seed(s)
        s.run(2)
        s.block_until_ready()
    before, ptrs = numpy_carry(port), pointers(port)
    port.warmup()
    port._warm()
    assert pointers(port) == ptrs
    assert_carries_match(before, numpy_carry(port), "after warm-up",
                         exact=True)
    if not sharded:
        ref.warmup()
    ref.run(5)
    port.run(5)
    assert_carries_match(jax_carry(ref, sharded), numpy_carry(port), case)
    if case == "slots_bounded":
        assert port.mailbox_overflow > 0


@pytest.mark.parametrize("kind", ["batched", "sharded"])
def test_run_pipelined_delivers_each_steps_own_word(kind):
    """63 leaves send to one 2-slot sink every step (61 drops a step):
    with three steps in flight, every retired word is that step's own."""
    kw = {"mailbox_slots": 2, "spill_capacity": 0}
    spawns = [(0, 1), (1, 63)]
    pair = sharded_pair if kind == "sharded" else batched_pair
    ref, port = pair([j_sink, j_leaf], [t_sink, t_leaf], spawns, **kw)
    words = {"ref": [], "port": []}
    n = 6
    ref.run_pipelined(n, depth=3, on_attention=words["ref"].append)
    port.run_pipelined(n, depth=3, on_attention=words["port"].append)
    got = [[w[k] for k in ATT_KEYS] for w in words["port"]]
    assert got == [[w[k] for k in ATT_KEYS] for w in words["ref"]]
    assert [w["step"] for w in words["port"]] == list(range(1, n + 1))
    dropped = [w["mail_dropped"] for w in words["port"]]
    assert dropped[0] == 0 and all(b - a == 61 for a, b in
                                   zip(dropped[1:], dropped[2:]))
    assert dropped[-1] == port.mailbox_overflow > 0
    assert_carries_match(jax_carry(ref, kind == "sharded"), numpy_carry(port),
                         kind)
