"""The port's BatchedSystem (akka_tpu_torch) against the reference's
(akka_tpu), on the CPU: the slice as a whole.

Each case builds the same system in both packages, loads the reference's
initial carry into the port (akka_tpu_torch.utils.carry), drives both with
the same seed_inbox / tell (one of them an expect_gen dead letter) /
stop_block / spawn_block / step() / run(n) calls, and compares the carries
field by field: integer fields (int state, alive, behavior_id, inbox,
attention word, supervision counters, metric slab, host mirrors) bit for
bit, float fields within rtol 1e-4 / atol 1e-3 (sums associate
differently in XLA and PyTorch).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # tiny tensors: spare the other test workers

import jax
import jax.numpy as jnp

import akka_tpu.batched as jb
from akka_tpu.actor.supervision import Directive as JDirective
from akka_tpu.models import baseline_benches as jbb

import akka_tpu_torch.batched as tb
from akka_tpu_torch.models import baseline_benches as tbb
from akka_tpu_torch.utils.carry import (DEVICE_FIELDS, load_numpy_carry,
                                        numpy_carry)

RTOL, ATOL = 1e-4, 1e-3
P = 4


# ------------------------------------------------ behaviors, both packages

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


# fails on a row's second message (rows 4, 13, 22, ...): restart after one
# step of backoff, then the retry budget runs out and the row stops
@jb.behavior("flaky", {"acc": ((), jnp.float32), "hits": ((), jnp.int32)},
             supervisor=jb.LaneSupervisor(JDirective.RESTART,
                                          max_nr_of_retries=1,
                                          min_backoff_steps=1,
                                          max_backoff_steps=2))
def j_flaky(state, inbox, ctx):
    fail = (ctx.actor_id % 9 == 4) & (state["hits"] >= 1)
    return ({"acc": state["acc"] + inbox.sum[0],
             "hits": state["hits"] + inbox.count, "_failed": fail},
            jb.Emit.single((ctx.actor_id + 1) % ctx.n_actors, inbox.sum, 1,
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
            tb.Emit.single((ctx.actor_id + 1) % ctx.n_actors, inbox.sum, 1,
                           P, when=inbox.count > 0))


def make_flaky(directive):
    """The flaky row-failure behavior under `directive`, in both packages."""
    kw = dict(max_nr_of_retries=1, min_backoff_steps=1, max_backoff_steps=2)
    jd, td = getattr(JDirective, directive), getattr(tb.Directive, directive)

    @jb.behavior(f"flaky_{directive}", {"acc": ((), jnp.float32),
                                        "hits": ((), jnp.int32)},
                 supervisor=jb.LaneSupervisor(jd, **kw))
    def j_beh(state, inbox, ctx):
        return j_flaky.receive(state, inbox, ctx)

    @tb.behavior(f"flaky_{directive}", {"acc": ((), torch.float32),
                                        "hits": ((), torch.int32)},
                 supervisor=tb.LaneSupervisor(td, **kw))
    def t_beh(state, inbox, ctx):
        return t_flaky.receive(state, inbox, ctx)

    return [j_beh], [t_beh]


# device-side become: "ping" rows turn into "pong" after two messages
@jb.behavior("ping", {"n": ((), jnp.int32), "_become": ((), jnp.int32)})
def j_ping(state, inbox, ctx):
    n = state["n"] + inbox.count
    return ({"n": n, "_become": jnp.where(n >= 2, 1, -1)},
            jb.Emit.single((ctx.actor_id + 1) % ctx.n_actors, inbox.sum, 1,
                           P, when=inbox.count > 0))


@jb.behavior("pong", {"n": ((), jnp.int32), "_become": ((), jnp.int32)})
def j_pong(state, inbox, ctx):
    return ({"n": state["n"] + 10 * inbox.count},
            jb.Emit.single((ctx.actor_id + 3) % ctx.n_actors,
                           inbox.sum * 2, 1, P, when=inbox.count > 0))


@tb.behavior("ping", {"n": ((), torch.int32), "_become": ((), torch.int32)})
def t_ping(state, inbox, ctx):
    n = state["n"] + inbox.count
    return ({"n": n, "_become": torch.where(n >= 2, 1, -1)},
            tb.Emit.single((ctx.actor_id + 1) % ctx.n_actors, inbox.sum, 1,
                           P, when=inbox.count > 0))


@tb.behavior("pong", {"n": ((), torch.int32), "_become": ((), torch.int32)})
def t_pong(state, inbox, ctx):
    return ({"n": state["n"] + 10 * inbox.count},
            tb.Emit.single((ctx.actor_id + 3) % ctx.n_actors,
                           inbox.sum * 2, 1, P, when=inbox.count > 0))


# non-finite guard: rows 5, 16, 27, ... compute an infinite state
@jb.behavior("guarded", {"x": ((), jnp.float32)}, nonfinite_guard=True)
def j_guarded(state, inbox, ctx):
    x = state["x"] + inbox.sum[0]
    return ({"x": jnp.where(ctx.actor_id % 11 == 5, jnp.inf, x)},
            jb.Emit.single((ctx.actor_id + 1) % ctx.n_actors, inbox.sum, 1,
                           P, when=inbox.count > 0))


@tb.behavior("guarded", {"x": ((), torch.float32)}, nonfinite_guard=True)
def t_guarded(state, inbox, ctx):
    x = state["x"] + inbox.sum[:, 0]
    return ({"x": torch.where(ctx.actor_id % 11 == 5, float("inf"), x)},
            tb.Emit.single((ctx.actor_id + 1) % ctx.n_actors, inbox.sum, 1,
                           P, when=inbox.count > 0))


# case -> (jax behaviors, port behaviors, spawn plan, system kwargs)
CASES = {
    "ring": ([jbb.ring_behavior], [tbb.ring_behavior], [(0, 64)], {}),
    "ring_merge": ([jbb.ring_behavior], [tbb.ring_behavior], [(0, 64)],
                   {"delivery": "merge"}),
    "fan_in": ([jbb.fan_in_collector, jbb.make_fan_in_leaf(4)],
               [tbb.fan_in_collector, tbb.make_fan_in_leaf(4)],
               [(0, 4), (1, 60)], {}),
    "slots_unbounded": ([j_ring_slots], [t_ring_slots], [(0, 64)],
                        {"mailbox_slots": 2}),
    "slots_bounded": ([j_ring_slots], [t_ring_slots], [(0, 64)],
                      {"mailbox_slots": 2, "spill_capacity": 0}),
    "supervised": ([j_flaky], [t_flaky], [(0, 64)],
                   {"metrics_enabled": True}),
    "resume": (*make_flaky("RESUME"), [(0, 64)], {}),
    "stop": (*make_flaky("STOP"), [(0, 64)], {}),
    "escalate": (*make_flaky("ESCALATE"), [(0, 64)], {}),
    "become": ([j_ping, j_pong], [t_ping, t_pong], [(0, 40), (1, 24)],
               {"need_max": True}),
    "guarded": ([j_guarded], [t_guarded], [(0, 64)], {}),
    "slots_metrics": ([j_ring_slots, jbb.ring_behavior],
                      [t_ring_slots, tbb.ring_behavior], [(0, 32), (1, 32)],
                      {"mailbox_slots": 2, "spill_capacity": 4,
                       "metrics_enabled": True}),
}


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
            assert got.dtype == want.dtype, (ctx, k)
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{ctx} {k}")
        else:
            assert got.dtype.kind == want.dtype.kind, (ctx, k, got.dtype)
            np.testing.assert_array_equal(got, want, err_msg=f"{ctx} {k}")


def drive(s):
    """The same public calls on either package's system."""
    n = s.capacity
    payload = np.zeros((n, P), np.float32)
    payload[:, 0] = 1.0
    payload[:, 1] = np.arange(n, dtype=np.float32) * 0.25
    s.seed_inbox(np.arange(n, dtype=np.int32), payload,
                 np.full(n, 2, np.int32))
    s.tell([1, 2, 2, 2], np.asarray([[1, 0, 0, 0], [0.5, 1, 0, 0],
                                     [0.25, 0, 1, 0], [2, 0, 0, 1]],
                                    np.float32), mtype=[1, 2, 3, 4])
    s.stop_block([3])
    stale = int(s.generation_of([3])[0]) - 1
    s.tell([3, 6], [1.5, 0, 0, 0], expect_gen=[stale, 0])  # 3: dead letter
    s.spawn_block(0, 1)                                     # recycles row 3
    s.step()                                                # flush + step
    # the JAX system's host pad is aliased by the dispatched step on the
    # CPU backend and rewritten by the next flush: wait for the step before
    # staging again (a no-op for the port on the CPU)
    s.block_until_ready()
    s.tell([7], [3.0, 0, 0, 0], mtype=5)
    s.run(4)
    s.step()


@pytest.mark.parametrize("case", sorted(CASES))
def test_batched_system_matches_reference(case):
    j_beh, t_beh, spawns, kwargs = CASES[case]
    ref = jb.BatchedSystem(capacity=64, behaviors=j_beh, payload_width=P,
                           host_inbox=8, native_staging=False, **kwargs)
    for b, k in spawns:
        ref.spawn_block(b, k)
    port = tb.BatchedSystem(capacity=64, behaviors=t_beh, payload_width=P,
                            host_inbox=8, device="cpu", **kwargs)
    load_numpy_carry(port, jax_carry(ref))
    assert_carries_match(jax_carry(ref), numpy_carry(port), f"{case} load")

    drive(ref)
    drive(port)
    assert_carries_match(jax_carry(ref), numpy_carry(port), case)
    np.testing.assert_array_equal(port.attention.numpy(),
                                  np.asarray(ref.attention))
    assert port.read_attention()["step"] == 6
    assert port.dead_lettered == ref.dead_lettered == 1
    assert port.supervision_counts == ref.supervision_counts
    assert port.mailbox_overflow == ref.mailbox_overflow
    assert port.live_count == ref.live_count
    assert port.pending_messages == ref.pending_messages
    assert port.dropped_messages == ref.dropped_messages
    if case == "supervised":
        counts = port.supervision_counts
        assert counts["restarted"] > 0 and counts["stopped"] > 0
        for name, lane in ref.read_metrics().items():
            np.testing.assert_array_equal(port.read_metrics()[name], lane)
    if case == "slots_bounded":
        assert port.mailbox_overflow > 0
    if case == "escalate":
        assert port.any_escalated() and ref.any_escalated()
        np.testing.assert_array_equal(port.escalated_rows(),
                                      ref.escalated_rows())
    if case == "become":
        assert (port.behavior_id[:40] == 1).all()  # every ping became pong


def _same(ref, port, ctx):
    assert_carries_match(jax_carry(ref), numpy_carry(port), ctx)


def test_host_fault_helpers_match_reference():
    """failed_rows / restart_rows / clear_failed / set_behavior and the
    pipelined run's attention words, on the non-finite guard case."""
    j_beh, t_beh, spawns, kwargs = CASES["guarded"]
    ref = jb.BatchedSystem(capacity=64, behaviors=j_beh, payload_width=P,
                           host_inbox=8, native_staging=False, **kwargs)
    ref.spawn_block(0, 64)
    port = tb.BatchedSystem(capacity=64, behaviors=t_beh, payload_width=P,
                            host_inbox=8, device="cpu", **kwargs)
    load_numpy_carry(port, jax_carry(ref))
    for s in (ref, port):
        drive(s)
    failed = port.failed_rows()
    np.testing.assert_array_equal(failed, ref.failed_rows())
    assert len(failed) >= 2 and port.any_failed() and ref.any_failed()
    for s in (ref, port):
        s.restart_rows(failed[:1], init_state={"x": 2.5})
        s.clear_failed(failed[1:])
        s.set_behavior([9, 10], 0)
        s.tell(failed, [1.0, 2.0, 0, 0])
    _same(ref, port, "after host fault helpers")
    words = {"ref": [], "port": []}
    ref.run_pipelined(3, depth=2, on_attention=words["ref"].append)
    port.run_pipelined(3, depth=2, on_attention=words["port"].append)
    _same(ref, port, "after run_pipelined")
    keys = ("flags", "mail_dropped", "dead_letters", "step",
            "exchange_dropped")
    assert [[w[k] for k in keys] for w in words["port"]] == \
        [[w[k] for k in keys] for w in words["ref"]]
    assert [w["step"] for w in words["port"]] == [7, 8, 9]


def test_numpy_carry_round_trip_and_shape_check():
    a = tbb.build_ring(16, device="cpu")
    tbb.seed_ring_full(a)
    a.run(2)
    b = tbb.build_ring(16, device="cpu")
    load_numpy_carry(b, numpy_carry(a))
    assert_carries_match(numpy_carry(a), numpy_carry(b), "round trip")
    a.run(3)
    b.run(3)
    np.testing.assert_array_equal(a.read_state("received"),
                                  np.full(16, 5, np.int32))
    assert_carries_match(numpy_carry(a), numpy_carry(b), "after run")
    small = tbb.build_ring(8, device="cpu")
    with pytest.raises(ValueError, match="shape|capacity"):
        load_numpy_carry(small, numpy_carry(a))
