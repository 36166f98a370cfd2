"""The port's ShardedBatchedSystem (akka_tpu_torch, D shards on a leading
axis of one device's tensors) against the reference's (akka_tpu, D of the
8 virtual CPU devices of tests/conftest.py), on the CPU.

Each case builds the same system in both packages, loads the reference's
carry into the port (akka_tpu_torch.utils.carry; the flat global layout is
the same in both), drives both with the same public calls, and compares
every carry field: integer fields (int state, alive, behavior ids, the
whole inbox, exchange and mailbox drops per shard, supervision counters,
metric slab, attention words) bit for bit, float fields within rtol 1e-4 /
atol 1e-3 (the ROADMAP's tolerance: XLA and PyTorch sum in different
orders).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # tiny tensors: spare the other test workers

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec

import akka_tpu.batched as jb
from akka_tpu.actor.supervision import Directive as JDirective
from akka_tpu.batched.sharded import ShardedBatchedSystem as JSharded
from akka_tpu.models import baseline_benches as jbb

import akka_tpu_torch.batched as tb
from akka_tpu_torch.batched.sharded import ShardedBatchedSystem as TSharded
from akka_tpu_torch.event.flight_recorder import FlightRecorder
from akka_tpu_torch.models import baseline_benches as tbb
from akka_tpu_torch.parallel import ShardSlot, make_mesh, shard_spec
from akka_tpu_torch.utils.carry import (SHARDED_FIELDS, load_numpy_carry,
                                        numpy_carry)

RTOL, ATOL = 1e-4, 1e-3
P = 4
SET, DEPOSIT = 2, 0
ATT_KEYS = ("flags", "mail_dropped", "dead_letters", "step",
            "exchange_dropped")
PER_SHARD = ("mail_dropped_per_shard", "dropped_per_shard",
             "progress_per_shard")


# ---------------------------------------------------------------- carries

def jax_carry(s):
    """The reference system's carry under akka_tpu_torch.utils.carry's
    sharded keys (writable copies)."""
    out = {f"state/{c}": np.array(jax.device_get(v))
           for c, v in s.state.items()}
    for f in SHARDED_FIELDS:
        out[f] = np.array(jax.device_get(getattr(s, f)))
    out["host/next_row"] = np.asarray(s._next_row, np.int64)
    out["host/step"] = np.asarray(s._host_step, np.int64)
    return out


def load_jax_carry(s, arrays):
    """Put a carry into the reference system, sharded as it shards it."""
    shard = NamedSharding(s.mesh, PartitionSpec(s.axis))
    s.state = {c: jax.device_put(jnp.asarray(arrays[f"state/{c}"]), shard)
               for c in s.state}
    for f in SHARDED_FIELDS:
        spec = shard if f != "step_count" else \
            NamedSharding(s.mesh, PartitionSpec())
        setattr(s, f, jax.device_put(jnp.asarray(arrays[f]), spec))


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


def same(ref, port, ctx):
    assert_carries_match(jax_carry(ref), numpy_carry(port), ctx)
    rw, pw = ref.read_attention(), port.read_attention()
    assert [pw[k] for k in ATT_KEYS] == [rw[k] for k in ATT_KEYS], ctx
    for k in PER_SHARD:
        np.testing.assert_array_equal(pw[k], rw[k], err_msg=f"{ctx} {k}")
    assert port.total_dropped == ref.total_dropped, ctx
    assert port.mailbox_overflow == ref.mailbox_overflow, ctx
    assert port.supervision_counts == ref.supervision_counts, ctx


def pair(j_beh, t_beh, capacity, d, spawns, **kw):
    """The same sharded system in both packages, spawned alike, with the
    reference's initial carry loaded into the port."""
    ref = JSharded(capacity=capacity, behaviors=j_beh, n_devices=d,
                   payload_width=P, **kw)
    port = TSharded(capacity=capacity, behaviors=t_beh, n_devices=d,
                    payload_width=P, device="cpu", **kw)
    for b, k, init in spawns:
        ref.spawn_block(b, k, init_state=init)
        port.spawn_block(b, k, init_state=init)
    load_numpy_carry(port, jax_carry(ref))
    same(ref, port, "spawned")
    return ref, port


def both(ref, port, fn):
    for s in (ref, port):
        fn(s)
        s.block_until_ready()


# -------------------------------------------- behaviors, both packages

@jb.behavior("ring", {"received": ((), jnp.int32), "last": ((), jnp.float32)})
def j_ring(state, inbox, ctx):
    token = inbox.sum[0]
    return ({"received": state["received"] + inbox.count, "last": token},
            jb.Emit.single((ctx.actor_id + 1) % ctx.n_actors,
                           jnp.stack([token + 1, 0.0, 0.0, 0.0]), 1, P,
                           when=inbox.count > 0))


@tb.behavior("ring", {"received": ((), torch.int32),
                      "last": ((), torch.float32)})
def t_ring(state, inbox, ctx):
    token = inbox.sum[:, 0]
    pl = torch.zeros_like(inbox.sum)
    pl[:, 0] = token + 1
    return ({"received": state["received"] + inbox.count, "last": token},
            tb.Emit.single((ctx.actor_id + 1) % ctx.n_actors, pl, 1, P,
                           when=inbox.count > 0))


@jb.behavior("leaf", {}, always_on=True)
def j_leaf(state, inbox, ctx):
    return {}, jb.Emit.single(0, jnp.array([1.0, 0, 0, 0]), 1, P,
                              when=ctx.actor_id > 0)


@tb.behavior("leaf", {}, always_on=True)
def t_leaf(state, inbox, ctx):
    return {}, tb.Emit.single(torch.zeros_like(ctx.actor_id),
                              [1.0, 0, 0, 0], 1, P, when=ctx.actor_id > 0)


@jb.behavior("collector", {"total": ((), jnp.float32),
                           "msgs": ((), jnp.int32)})
def j_collector(state, inbox, ctx):
    return ({"total": state["total"] + inbox.sum[0],
             "msgs": state["msgs"] + inbox.count}, jb.Emit.none(1, P))


@tb.behavior("collector", {"total": ((), torch.float32),
                           "msgs": ((), torch.int32)})
def t_collector(state, inbox, ctx):
    return ({"total": state["total"] + inbox.sum[:, 0],
             "msgs": state["msgs"] + inbox.count},
            tb.Emit.none(ctx.actor_id.shape[0], 1, P))


@jb.behavior("spam", {}, always_on=True)
def j_spam(state, inbox, ctx):
    return {}, jb.Emit.single(ctx.actor_id % 3, jnp.array([1.0, 0, 0, 0]),
                              1, P)


@tb.behavior("spam", {}, always_on=True)
def t_spam(state, inbox, ctx):
    return {}, tb.Emit.single(ctx.actor_id % 3, [1.0, 0, 0, 0], 1, P)


# the ring over ordered mailboxes, folding type-weighted payloads
@jb.behavior("ring_slots", {"received": ((), jnp.int32),
                            "acc": ((), jnp.float32)}, inbox="slots")
def j_ring_slots(state, mb, ctx):
    got, acc = mb.fold((jnp.int32(0), jnp.float32(0)),
                       lambda c, t, p: (c[0] + 1, c[1] + p[0] * (t + 1)))
    return ({"received": state["received"] + got, "acc": state["acc"] + acc},
            jb.Emit.single((ctx.actor_id + 5) % ctx.n_actors, mb.payload[0],
                           1, P, when=got > 0, mtype=mb.types[0] + 1))


@tb.behavior("ring_slots", {"received": ((), torch.int32),
                            "acc": ((), torch.float32)}, inbox="slots")
def t_ring_slots(state, mb, ctx):
    got, acc = mb.fold((torch.zeros_like(state["received"]),
                        torch.zeros_like(state["acc"])),
                       lambda c, t, p: (c[0] + 1, c[1] + p[:, 0] * (t + 1)))
    return ({"received": state["received"] + got, "acc": state["acc"] + acc},
            tb.Emit.single((ctx.actor_id + 5) % ctx.n_actors,
                           mb.payload[:, 0], 1, P, when=got > 0,
                           mtype=mb.types[:, 0] + 1))


# supervised: fails on a row's second message (rows 4, 13, 22, ...)
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


def j_bank(mb, bal, failed=None):
    def apply(c, t, pl):
        b, f = c
        b = jnp.where(t == SET, pl[0], jnp.where(t == DEPOSIT, b + pl[0], b))
        return b, f | (t == 99)
    return mb.fold((bal, failed if failed is not None else False), apply)


def t_bank(mb, bal, failed):
    def apply(c, t, pl):
        b, f = c
        b = torch.where(t == SET, pl[:, 0],
                        torch.where(t == DEPOSIT, b + pl[:, 0], b))
        return b, f | (t == 99)
    return mb.fold((bal, failed), apply)


@jb.behavior("account", {"balance": ((), jnp.float32)}, inbox="slots")
def j_account(state, mb, ctx):
    bal, _ = j_bank(mb, state["balance"])
    return {"balance": bal}, jb.Emit.none(2, P)


@tb.behavior("account", {"balance": ((), torch.float32)}, inbox="slots")
def t_account(state, mb, ctx):
    bal, _ = t_bank(mb, state["balance"],
                    torch.zeros_like(state["balance"], dtype=torch.bool))
    return {"balance": bal}, tb.Emit.none(ctx.actor_id.shape[0], 2, P)


@jb.behavior("teller", {"target": ((), jnp.int32), "x": ((), jnp.float32)},
             inbox="slots")
def j_teller(state, mb, ctx):
    e = jb.Emit.none(2, P)
    return {}, jb.Emit(
        dst=e.dst.at[0].set(state["target"]).at[1].set(state["target"]),
        payload=e.payload.at[0, 0].set(state["x"]).at[1, 0].set(1.0),
        valid=e.valid.at[0].set(True).at[1].set(True),
        type=e.type.at[0].set(SET).at[1].set(DEPOSIT))


@tb.behavior("teller", {"target": ((), torch.int32),
                        "x": ((), torch.float32)}, inbox="slots")
def t_teller(state, mb, ctx):
    n = ctx.actor_id.shape[0]
    e = tb.Emit.none(n, 2, P)
    e.dst[:, 0] = state["target"]
    e.dst[:, 1] = state["target"]
    e.payload[:, 0, 0] = state["x"]
    e.payload[:, 1, 0] = 1.0
    e.valid[:] = True
    e.type[:, 0] = SET
    e.type[:, 1] = DEPOSIT
    return {}, e


@jb.behavior("fragile", {"balance": ((), jnp.float32),
                         "_failed": ((), jnp.bool_)}, inbox="slots")
def j_fragile(state, mb, ctx):
    bal, failed = j_bank(mb, state["balance"], state["_failed"])
    return {"balance": bal, "_failed": failed}, jb.Emit.none(1, P)


@tb.behavior("fragile", {"balance": ((), torch.float32),
                         "_failed": ((), torch.bool)}, inbox="slots")
def t_fragile(state, mb, ctx):
    bal, failed = t_bank(mb, state["balance"], state["_failed"])
    return ({"balance": bal, "_failed": failed},
            tb.Emit.none(ctx.actor_id.shape[0], 1, P))


# ------------------------------------------------------------------ cases

@pytest.mark.parametrize("d", [1, 2, 8])
def test_cross_shard_ring_run_and_steps(d):
    """A token crossing every shard boundary; ten run(1) steps, then one
    run(6) (the scan against stepwise runs), with a host tell between."""
    ref, port = pair([j_ring], [t_ring], 32, d, [(0, 32, None)])
    both(ref, port, lambda s: s.tell(0, [1.0, 0, 0, 0]))
    for k in range(10):
        both(ref, port, lambda s: s.run(1))
    same(ref, port, f"d={d} after 10 x run(1)")
    both(ref, port, lambda s: s.tell(17, [5.0, 0, 0, 0]))
    both(ref, port, lambda s: s.run(6))
    same(ref, port, f"d={d} after run(6)")
    want = np.zeros(32, np.int32)
    for k in range(16):
        want[k % 32] += 1
    for k in range(6):
        want[(17 + k) % 32] += 1
    np.testing.assert_array_equal(port.read_state("received"), want)
    assert port.total_dropped == 0


@pytest.mark.parametrize("d", [1, 2, 8])
def test_cross_shard_fan_in(d):
    ref, port = pair([j_collector, j_leaf], [t_collector, t_leaf], 64, d,
                     [(0, 1, None), (1, 63, None)])
    both(ref, port, lambda s: s.run(4))
    same(ref, port, f"fan-in d={d}")
    assert port.read_state("msgs")[0] == 63 * 3


@pytest.mark.parametrize("d", [2, 8])
def test_exchange_overflow_drops_per_shard(d):
    """A pair capacity of 2: every shard sends its rows to shard 0."""
    ref, port = pair([j_spam], [t_spam], 64, d, [(0, 64, None)],
                     remote_capacity_per_pair=2)
    warnings = {"ref": [], "port": []}
    for name, s in (("ref", ref), ("port", port)):
        s.flight_recorder = Recorder(warnings[name])
    both(ref, port, lambda s: s.run(3))
    same(ref, port, f"overflow d={d}")
    assert port.total_dropped > 0
    np.testing.assert_array_equal(port.dropped_per_shard,
                                  ref.dropped_per_shard)
    # one shard_overflow warning per shard whose counters grew, once
    assert warnings["port"] == warnings["ref"] and warnings["port"]
    port.read_attention()
    assert len(warnings["port"]) == len(warnings["ref"])


class Recorder(FlightRecorder):
    """A flight recorder that keeps the shard_overflow warnings (every
    other hook of the SPI is a no-op)."""

    def __init__(self, out):
        self.out = out

    def shard_overflow(self, source, **fields):
        self.out.append((source, sorted(fields.items())))


def _tell_burst(s, targets):
    for i, t in enumerate(targets):
        s.tell(int(t), [1.0 + i, 0.5, 0, 0], mtype=i % 3)


@pytest.mark.parametrize("d", [2, 8])
def test_bounded_slots(d):
    """2-slot bounded mailboxes: rows past the slots are dropped and
    counted per shard."""
    ref, port = pair([j_ring_slots], [t_ring_slots], 64, d, [(0, 64, None)],
                     mailbox_slots=2, spill_capacity=0,
                     host_inbox_per_shard=8)
    both(ref, port, lambda s: _tell_burst(s, [1, 1, 1, 1, 2, 40, 40, 63]))
    both(ref, port, lambda s: s.run(3))
    same(ref, port, f"bounded d={d}")
    assert port.mailbox_overflow > 0


@pytest.mark.parametrize("d", [2, 8])
def test_spill_one_shard_over_its_cap_another_under(d):
    """Unbounded slots with a 4-row spill region per shard: shard 0 gets 12
    messages for one row (10 past the 2 slots: 4 spill, 6 are lost), the
    last shard 5 (3 past the slots: all spill); both redeliver in order."""
    ref, port = pair([j_ring_slots], [t_ring_slots], 64, d, [(0, 64, None)],
                     mailbox_slots=2, spill_capacity=4,
                     host_inbox_per_shard=16)
    last = 64 - 64 // d + 1
    both(ref, port, lambda s: _tell_burst(s, [3] * 12 + [last] * 5))
    both(ref, port, lambda s: s.run(1))
    same(ref, port, f"spill d={d} step 1")
    per = port.mailbox_overflow_per_shard
    assert per[0] == 6 and per[-1] == 0, per
    both(ref, port, lambda s: [s.run(1) for _ in range(3)])
    same(ref, port, f"spill d={d} after redelivery")


def test_sharded_bank_account_cross_shard_fifo():
    """Typed ordered messages cross shards and still apply in per-sender
    FIFO order (tests/test_mailbox_slots.py, the 8-shard bank account)."""
    targets = ((np.arange(64) * 7) % 64).astype(np.int32)
    xs = (100.0 + np.arange(64)).astype(np.float32)
    ref, port = pair([j_account, j_teller], [t_account, t_teller], 128, 8,
                     [(0, 64, None), (1, 64, {"target": targets, "x": xs})],
                     out_degree=2, mailbox_slots=8, host_inbox_per_shard=64)
    for t in range(64, 128):
        both(ref, port, lambda s: s.tell(t, np.zeros(4, np.float32)))
    both(ref, port, lambda s: s.run(2))
    same(ref, port, "bank account")
    want = np.zeros(64, np.float32)
    want[targets] = xs[np.arange(64)] + 1.0
    np.testing.assert_array_equal(port.read_state("balance")[:64], want)
    assert port.mailbox_overflow == 0 and port.total_dropped == 0


def test_burst_and_suspension_on_8_shards():
    """A 4S burst to one actor arrives in order through its shard's spill
    region; mail to a suspended row is held until the host restarts it
    (tests/test_mailbox_slots.py, the 8-device burst and suspension)."""
    s_slots = 4
    ref, port = pair([j_fragile], [t_fragile], 16, 8, [(0, 16, None)],
                     mailbox_slots=s_slots,
                     host_inbox_per_shard=4 * s_slots + 1)

    def burst(s):
        for k in range(4 * s_slots):
            s.tell(9, np.asarray([float(k), 0, 0, 0], np.float32), mtype=SET)
        s.tell(9, np.asarray([1.0, 0, 0, 0], np.float32), mtype=DEPOSIT)
        for _ in range(s_slots + 2):
            s.run(1)

    both(ref, port, burst)
    same(ref, port, "burst")
    assert port.read_state("balance")[9] == float(4 * s_slots - 1) + 1.0
    both(ref, port, lambda s: (s.tell(3, np.zeros(4, np.float32), mtype=99),
                               s.run(1)))
    np.testing.assert_array_equal(port.failed_rows(), ref.failed_rows())
    assert 3 in list(port.failed_rows()) and port.any_failed()
    both(ref, port, lambda s: (s.tell(3, [40.0, 0, 0, 0], mtype=SET),
                               s.tell(3, [2.0, 0, 0, 0], mtype=DEPOSIT),
                               s.run(1), s.run(1)))
    same(ref, port, "suspended")
    both(ref, port, lambda s: (s.restart_rows([3]), s.run(1)))
    same(ref, port, "restarted")
    assert port.read_state("balance")[3] == 42.0
    assert port.mailbox_overflow == 0


@pytest.mark.parametrize("d", [2, 8])
def test_supervision_metrics_and_latch(d):
    """In-step supervision, the metric slab and the latch bit, per shard;
    run_pipelined's words and the host fault helpers."""
    ref, port = pair([j_flaky], [t_flaky], 64, d, [(0, 64, None)],
                     metrics_enabled=True, attention_latch_col="hits")
    for s in (ref, port):
        for i in range(0, 64, 3):
            s.tell(i, [1.0, 0, 0, 0])
    both(ref, port, lambda s: (s.run(1), s.run(1)))
    same(ref, port, f"supervised d={d} two steps")
    words = {"ref": [], "port": []}
    ref.run_pipelined(3, depth=2, on_attention=words["ref"].append)
    port.run_pipelined(3, depth=2, on_attention=words["port"].append)
    assert [[w[k] for k in ATT_KEYS] for w in words["port"]] == \
        [[w[k] for k in ATT_KEYS] for w in words["ref"]]
    same(ref, port, f"supervised d={d} pipelined")
    counts = port.supervision_counts
    assert counts["restarted"] > 0 and counts["failed"] > 0
    assert port.read_attention()["any_latched"]
    for name, lane in ref.read_metrics().items():
        np.testing.assert_array_equal(port.read_metrics()[name], lane)
    both(ref, port, lambda s: (s.clear_failed([4]), s.stop_block([5, 6]),
                               s.restart_rows([13], {"acc": 2.5}),
                               s.run(1)))
    same(ref, port, f"supervised d={d} host helpers")


def test_stray_rows_forwarded_in_stray_mode():
    """Rows addressed outside their shard (a rebalance moved their
    recipients): the steady step drops them, the hand-off step forwards
    them one hop; exit_stray_mode waits until none is left."""
    ref, port = pair([j_ring], [t_ring], 32, 8, [(0, 32, None)],
                     reroute_strays=True)
    arrays = jax_carry(ref)
    m_local, sc, pc = ref.m_local, ref.spill_cap, ref.pair_cap
    for shard, row, dst in ((0, 0, 9), (0, 1, 30), (5, 2, 1), (2, 0, 8)):
        i = shard * m_local + sc + row
        arrays["inbox_dst"][i] = dst
        arrays["inbox_payload"][i] = [2.0 + row, 0, 0, 0]
        arrays["inbox_valid"][i] = True
    load_jax_carry(ref, arrays)
    load_numpy_carry(port, arrays)
    same(ref, port, "strays loaded")
    for s in (ref, port):
        s.enter_stray_mode()
    assert port.pair_cap == ref.pair_cap == 2 * pc
    same(ref, port, "stray mode entered")
    assert not port.exit_stray_mode() and not ref.exit_stray_mode()
    both(ref, port, lambda s: s.run(1))
    same(ref, port, "strays forwarded")
    assert port.exit_stray_mode() and ref.exit_stray_mode()
    same(ref, port, "stray mode left")
    both(ref, port, lambda s: s.run(2))
    same(ref, port, "after strays")
    # the steady step: a stray row is not delivered and not forwarded
    arrays = jax_carry(ref)
    arrays["inbox_dst"][sc] = 20
    arrays["inbox_valid"][sc] = True
    load_jax_carry(ref, arrays)
    load_numpy_carry(port, arrays)
    both(ref, port, lambda s: s.run(1))
    same(ref, port, "stray dropped by the steady step")


def test_host_inbox_overflow_per_shard():
    """Two host rows per shard: of five tells to shard 0 the first two are
    kept, in staging order; shards 2 and 7 keep their one tell each."""
    ref, port = pair([j_ring], [t_ring], 32, 8, [(0, 32, None)],
                     host_inbox_per_shard=2)
    for s in (ref, port):
        for dst in (0, 1, 2, 3, 0, 9, 31):
            s.tell(dst, [float(dst + 1), 0, 0, 0])
        s._flush_staged()
        s.block_until_ready()
    same(ref, port, "flushed")
    assert int(np.asarray(port.inbox_valid).sum()) == 4
    both(ref, port, lambda s: s.run(2))
    same(ref, port, "after host overflow")


@pytest.mark.parametrize("d", [2, 8])
def test_flat_delivery_equals_local_calls(d):
    """The sharded step's one delivery call over the flat inbox, with rows
    addressed outside their shard masked, equals one call per shard, on
    the ring kernels' plain versions and on the ranked kernels."""
    from akka_tpu_torch.ops import segment as tsg
    ln = 16
    ml = d * ln + 8
    rng = np.random.default_rng(d)
    rows = d * ml
    shard = np.arange(rows) // ml
    home = rng.integers(0, ln, rows) + shard * ln
    dst = np.where(rng.random(rows) < 0.8, home,
                   rng.integers(-1, d * ln + 1, rows)).astype(np.int32)
    dst, mtype = torch.from_numpy(dst), torch.from_numpy(
        rng.integers(1, 5, rows).astype(np.int32))
    payload = torch.from_numpy(rng.standard_normal((rows, P))
                               .astype(np.float32))
    valid = torch.from_numpy(rng.random(rows) > 0.3)
    base = torch.from_numpy(shard * ln)
    own = valid & (dst >= base) & (dst < base + ln)
    for backend in ("cuda", "ranked"):
        red = tsg.deliver(dst, payload, own, d * ln, mode="merge",
                          backend=backend)
        slo = tsg.deliver_slots(dst, mtype, payload, own, d * ln, 2,
                                backend=backend)
        loc = [(tsg.deliver(dst[b] - s * ln, payload[b], valid[b], ln,
                            mode="merge", backend="ranked"),
                tsg.deliver_slots(dst[b] - s * ln, mtype[b], payload[b],
                                  valid[b], ln, 2, backend="ranked"))
               for s, b in ((s, slice(s * ml, (s + 1) * ml))
                            for s in range(d))]
        assert torch.equal(red.count, torch.cat([r.count for r, _ in loc]))
        torch.testing.assert_close(red.sum,
                                   torch.cat([r.sum for r, _ in loc]),
                                   rtol=RTOL, atol=ATOL)
        for f in ("types", "payload", "valid", "count"):
            assert torch.equal(getattr(slo, f), torch.cat(
                [getattr(x, f) for _, x in loc])), (backend, f)
        assert int(slo.dropped) == sum(int(x.dropped) for _, x in loc)


def test_mesh_and_unknown_backends_raise():
    """A mesh of shard slots on one card sets the shard count and the
    device; a rank whose slots lie on several cards is refused (one
    process per card: ranks over a process group are
    tests/test_torch_ranks.py's); and the port's backends only: the
    reference's "reference" family is not ported."""
    two_cards = make_mesh(devices=[ShardSlot(0, torch.device("cuda", 0)),
                                   ShardSlot(1, torch.device("cuda", 1))])
    with pytest.raises(NotImplementedError, match="one card per process"):
        TSharded(capacity=8, behaviors=[t_ring], mesh=two_cards,
                 device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        TSharded(capacity=8, behaviors=[t_ring], mesh=object(), device="cpu")
    mesh = make_mesh(3, device="cpu")
    for m in (mesh, shard_spec(mesh)):
        s = TSharded(capacity=8, behaviors=[t_ring], mesh=m)
        assert (s.n_shards, s.capacity, s.device.type) == (3, 9, "cpu")
        assert s.mesh == mesh
    with pytest.raises(ValueError, match="n_devices=2"):
        TSharded(capacity=8, behaviors=[t_ring], mesh=mesh, n_devices=2)
    for backend in ("reference", "xla", "pallas"):
        with pytest.raises(ValueError, match="unknown delivery backend"):
            TSharded(capacity=8, behaviors=[t_ring], n_devices=2,
                     delivery_backend=backend, device="cpu")
    s = TSharded(capacity=9, behaviors=[t_ring], n_devices=2, device="cpu")
    assert (s.capacity, s.local_n, s.n_shards) == (10, 5, 2)


def test_carry_round_trip_and_shape_check():
    """A reference system's carry loads into the port and, after steps on
    both, the port's carry loads back into the reference, which steps on
    from it as its twin does; a carry of another shard count is
    rejected."""
    ref, port = pair([j_ring], [t_ring], 32, 2, [(0, 32, None)])
    both(ref, port, lambda s: (s.tell(3, [1.0, 0, 0, 0]), s.run(3)))
    same(ref, port, "stepped")
    twin = JSharded(capacity=32, behaviors=[j_ring], n_devices=2,
                    payload_width=P)
    twin.spawn_block(0, 32)
    load_jax_carry(twin, numpy_carry(port))
    twin._host_step = port._host_step
    both(twin, port, lambda s: s.run(4))
    same(twin, port, "port carry loaded into the reference")
    other = TSharded(capacity=32, behaviors=[t_ring], n_devices=4,
                     payload_width=P, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        load_numpy_carry(other, numpy_carry(port))


# ------------------------------------------------- baseline bench parity

@pytest.mark.parametrize("d", [1, 8])
def test_cross_shard_bench_matches_reference(d):
    ref = jbb.build_cross_shard(n_shards=8, entities_per_shard=8,
                                n_devices=d)
    port = tbb.build_cross_shard(n_shards=8, entities_per_shard=8,
                                 n_devices=d, device="cpu")
    assert port.n_shards == ref.n_shards == d
    jbb.seed_ring_full(ref)
    tbb.seed_ring_full(port)
    same(ref, port, "seeded")
    both(ref, port, lambda s: s.run(5))
    same(ref, port, "cross-shard bench")
    assert (port.read_state("received") == 5).all()
    assert port.total_dropped == 0


def test_cross_shard_slots_bench_counts_every_token():
    """The port's slots twin of the bench (bounded 2-slot mailboxes): every
    entity receives one token per step, and its ring-kernel plain version
    agrees with the ranked kernels bit for bit."""
    a, b = (tbb.build_cross_shard_slots(8, 8, n_devices=8, device="cpu",
                                        delivery_backend=be)
            for be in ("cuda", "ranked"))
    for s in (a, b):
        tbb.seed_ring_full(s)
        s.run(5)
    assert (a.read_state("received") == 5).all()
    assert a.mailbox_overflow == 0 and a.total_dropped == 0
    ca, cb = numpy_carry(a), numpy_carry(b)
    for k in ca:
        np.testing.assert_array_equal(ca[k], cb[k], err_msg=k)
