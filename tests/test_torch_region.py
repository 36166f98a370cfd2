"""The port's DeviceShardRegion and batched ask engine (akka_tpu_torch)
against the reference's (akka_tpu), on the CPU.

Every case builds the same region in both packages (D of the conftest's 8
virtual CPU devices on the reference side, D shards on the leading axis of
the port's tensors), sends both the same asks, tells, rebalances and runs,
and compares what comes back: reply payloads bit for bit (the counter adds
integer-valued floats, so every sum is exact), the same outcome types, the
same promise slot, promise row and entity row for every ask, and the
systems' carries (integer fields bit for bit, floats within rtol 1e-4 /
atol 1e-3). The ask-engine cases follow tests/test_ask_batch.py, the
region cases tests/test_device_sharding.py, at D in {1, 2} and with
mailbox_slots in {0, 2}; each system holds at most 64 rows.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # tiny tensors: spare the other test workers

import jax
import jax.numpy as jnp

import akka_tpu.batched as jb
from akka_tpu.batched.bridge import reply_dst as j_reply_dst
from akka_tpu.gateway import counter_behavior as j_counter
from akka_tpu.sharding.ask_batch import BatchAsk as JBatchAsk
from akka_tpu.sharding.ask_batch import execute_ask_batch as j_execute
from akka_tpu.sharding.device import DeviceEntity as JEntity
from akka_tpu.sharding.device import DeviceShardRegion as JRegion

import akka_tpu_torch.batched as tb
from akka_tpu_torch.batched.bridge import (AskPoolExhausted, max_exact_row_id,
                                           reply_dst as t_reply_dst)
from akka_tpu_torch.gateway import counter_behavior as t_counter
from akka_tpu_torch.sharding import BatchAsk as TBatchAsk
from akka_tpu_torch.sharding import execute_ask_batch as t_execute
from akka_tpu_torch.sharding.device import DeviceEntity as TEntity
from akka_tpu_torch.sharding.device import DeviceShardRegion as TRegion
from akka_tpu_torch.utils.carry import SHARDED_FIELDS, numpy_carry

RTOL, ATOL = 1e-4, 1e-3
P = 4
CONFIGS = [(1, 0), (1, 2), (2, 0), (2, 2)]  # (D, mailbox_slots)
CONFIG_IDS = [f"d{d}-slots{s}" for d, s in CONFIGS]


# ------------------------------------------------------------ comparisons

def assert_systems_match(jsys, tsys, ctx):
    """Every carry field of the two sharded systems."""
    want = {f"state/{c}": np.asarray(jax.device_get(v))
            for c, v in jsys.state.items()}
    for f in SHARDED_FIELDS:
        want[f] = np.asarray(jax.device_get(getattr(jsys, f)))
    got = numpy_carry(tsys)
    for k in want:
        w, g = want[k], got[k]
        assert g.shape == w.shape, (ctx, k, g.shape, w.shape)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{ctx} {k}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{ctx} {k}")
    assert tsys._host_step == jsys._host_step, ctx


def assert_outcomes_match(jout, tout, ctx):
    """Same outcome types; replies bit-identical, as float32 arrays."""
    assert len(jout) == len(tout), ctx
    for i, (j, t) in enumerate(zip(jout, tout)):
        assert type(t).__name__ == type(j).__name__, (ctx, i, j, t)
        if isinstance(j, BaseException):
            assert str(t) == str(j), (ctx, i)
        else:
            assert t.dtype == np.float32 and np.asarray(j).dtype == t.dtype
            np.testing.assert_array_equal(t, np.asarray(j),
                                          err_msg=f"{ctx} member {i}")


def both_ask_many(jr, tr, requests, ctx, **kw):
    jout = jr.ask_many(requests, **kw)
    tout = tr.ask_many(requests, **kw)
    assert_outcomes_match(jout, tout, ctx)
    return tout


def refs(jr, tr, entity_id):
    """The entity in both regions: same shard, index and row."""
    j, t = jr.entity_ref(entity_id), tr.entity_ref(entity_id)
    assert (t.shard, t.index, t.row) == (j.shard, j.index, j.row), entity_id
    return t


def total(region, entity_id):
    ref = region.entity_ref(entity_id)
    return float(np.asarray(region.system.read_state(
        "total", np.asarray([ref.row], np.int32)))[0])


# ------------------------------------------------------- counter regions

_REGIONS = {}


def counter_regions(d, slots):
    """The counter region of test_ask_batch.py (2 shards x 16 entities,
    two spare blocks so a shard can move: 64 rows), once per config."""
    if (d, slots) not in _REGIONS:
        kw = dict(n_shards=2, entities_per_shard=16, n_devices=d,
                  payload_width=P, mailbox_slots=slots, spare_blocks=2)
        jr = JRegion(JEntity(f"ab-d{d}-s{slots}", j_counter(P), **kw))
        tr = TRegion(TEntity(f"ab-d{d}-s{slots}", t_counter(P), **kw),
                     device="cpu")
        assert tr.system.capacity == jr.system.capacity <= 64
        assert tr._promise_block == jr._promise_block
        _REGIONS[(d, slots)] = (jr, tr)
    return _REGIONS[(d, slots)]


@pytest.mark.parametrize("d,slots", CONFIGS, ids=CONFIG_IDS)
def test_solo_and_batched_asks_bit_identical(d, slots):
    """A batch of one runs the solo step schedule; a batch of N to
    distinct entities returns what the serialized loop returns; both
    packages give the same replies (test_ask_batch.py:49)."""
    jr, tr = counter_regions(d, slots)
    values = [1.0, 2.0, 3.0, 4.0]
    serial = []
    for i, v in enumerate(values):
        ref = refs(jr, tr, f"par-s{i}")
        j = np.asarray(jr.ask(ref.shard, ref.index, [v]))
        t = tr.ask(ref.shard, ref.index, [v])
        np.testing.assert_array_equal(t, j)
        serial.append(t)
    brefs = [refs(jr, tr, f"par-b{i}") for i in range(len(values))]
    batched = both_ask_many(jr, tr, [(r.shard, r.index, [v])
                                     for r, v in zip(brefs, values)],
                            "batched")
    for s, b in zip(serial, batched):
        np.testing.assert_array_equal(s, b)
    ref = refs(jr, tr, "par-s0")
    again = tr.ask(ref.shard, ref.index, [values[0]])
    np.testing.assert_array_equal(
        again, np.asarray(jr.ask(ref.shard, ref.index, [values[0]])))
    assert float(again[0]) == 2 * values[0]
    assert_systems_match(jr.system, tr.system, "solo and batched")


@pytest.mark.parametrize("d,slots", CONFIGS, ids=CONFIG_IDS)
def test_same_entity_batch_linearized(d, slots):
    """Same-row asks serialize across rounds: each reply is a distinct
    prefix sum (test_ask_batch.py:71)."""
    jr, tr = counter_regions(d, slots)
    ref = refs(jr, tr, "lin-0")
    out = both_ask_many(jr, tr, [(ref.shard, ref.index, [v])
                                 for v in (1.0, 2.0, 4.0)], "linearized")
    assert [float(r[0]) for r in out] == [1.0, 3.0, 7.0]
    assert total(tr, "lin-0") == total(jr, "lin-0") == 7.0


@pytest.mark.parametrize("d,slots", CONFIGS, ids=CONFIG_IDS)
def test_mid_batch_timeout_retires_only_that_slot(d, slots):
    """An ask to a never-spawned row times out and retires its slot; its
    batch-mate gets its reply (test_ask_batch.py:157)."""
    jr, tr = counter_regions(d, slots)
    ref = refs(jr, tr, "to-live")
    dead_idx = tr.eps - 1
    assert dead_idx >= tr._spawned[ref.shard]
    before = tr.ask_pool_stats()
    out = both_ask_many(jr, tr, [(ref.shard, ref.index, [5.0]),
                                 (ref.shard, dead_idx, [1.0])],
                        "timeout", steps=2, max_extra_steps=2)
    assert float(out[0][0]) == 5.0
    assert isinstance(out[1], TimeoutError)
    assert "unanswered after 4 steps" in str(out[1])
    after = tr.ask_pool_stats()
    assert after == jr.ask_pool_stats()
    assert after["retired"] == before["retired"] + 1
    assert float(tr.ask(ref.shard, ref.index, [1.0])[0]) == 6.0
    assert float(np.asarray(jr.ask(ref.shard, ref.index, [1.0]))[0]) == 6.0


@pytest.mark.parametrize("d,slots", CONFIGS, ids=CONFIG_IDS)
def test_mid_batch_pool_exhaustion_is_per_member(d, slots):
    """Two free slots: a batch of 3 gets two replies and ONE typed
    AskPoolExhausted, position-aligned (test_ask_batch.py:179)."""
    jr, tr = counter_regions(d, slots)
    names = [f"exh-{i}" for i in range(3)]
    for r in (jr, tr):
        r._ensure_promise_rows()
        r._reclaim_promise_slots()
    rs = [refs(jr, tr, n) for n in names]
    parked = {}
    for key, r in (("j", jr), ("t", tr)):
        with r._lock:
            free = r._promise_free
            parked[key], r._promise_free = free[2:], free[:2]
    try:
        out = both_ask_many(jr, tr, [(r.shard, r.index, [1.0]) for r in rs],
                            "exhaustion")
    finally:
        for key, r in (("j", jr), ("t", tr)):
            with r._lock:
                r._promise_free.extend(parked[key])
    assert isinstance(out[2], AskPoolExhausted)
    assert "promise rows exhausted" in str(out[2])
    assert [float(r[0]) for r in out[:2]] == [1.0, 1.0]
    assert tr.ask_pool_stats() == jr.ask_pool_stats()


@pytest.mark.parametrize("d,slots", CONFIGS, ids=CONFIG_IDS)
def test_ask_trace_slots_rows_and_rebalance(d, slots):
    """Waves with repeated entities through execute_ask_batch: every member
    gets the same promise slot, promise row and entity row in both
    packages and the same reply, which is the host oracle's running total.
    Then one shard moves to the spare block and the trace goes on: totals
    are conserved, the systems match, no ask is left in flight."""
    jr, tr = counter_regions(d, slots)
    names = [f"tr-{i}" for i in range(6)]
    rs = [refs(jr, tr, n) for n in names]
    oracle = {n: 0.0 for n in names}
    rng = np.random.default_rng(7 * d + slots)

    def wave(tag, picks, vals):
        jbatch = [JBatchAsk(rs[i].shard, rs[i].index, [v])
                  for i, v in zip(picks, vals)]
        tbatch = [TBatchAsk(rs[i].shard, rs[i].index, [v])
                  for i, v in zip(picks, vals)]
        with jr._ask_lock:
            j_execute(jr, jbatch)
        with tr._ask_lock:
            t_execute(tr, tbatch)
        for ja, ta in zip(jbatch, tbatch):
            assert (ta.slot, ta.prow, ta.row) == (ja.slot, ja.prow, ja.row)
        assert_outcomes_match([a.outcome for a in jbatch],
                              [a.outcome for a in tbatch], tag)
        for i, v, a in zip(picks, vals, tbatch):
            oracle[names[i]] += v
            assert float(a.outcome[0]) == oracle[names[i]], (tag, names[i])
        return [a.outcome for a in tbatch]

    trace = []
    for k in range(3):
        picks = rng.integers(0, len(names), 7)
        vals = rng.integers(1, 10, 7).astype(np.float64)
        trace.append((picks, vals))
        wave(f"wave {k}", picks, vals)
    assert_systems_match(jr.system, tr.system, "before rebalance")

    moved = rs[0].shard
    new_block = tr.rebalance(moved)
    assert new_block == jr.rebalance(moved)
    assert tr.system.stray_mode and jr.system.stray_mode
    assert_systems_match(jr.system, tr.system, "rebalanced")
    for n, r in zip(names, rs):
        assert tr.entity_ref(n).row == jr.entity_ref(n).row
        assert total(tr, n) == total(jr, n) == oracle[n]
    picks = np.asarray([0, 0, 1, 2, 0, 3, 4])
    vals = np.asarray([3.0, 1.0, 2.0, 5.0, 4.0, 1.0, 2.0])
    trace.append((picks, vals))
    wave("after rebalance", picks, vals)
    assert_systems_match(jr.system, tr.system, "after rebalance")
    for n in names:
        assert total(tr, n) == total(jr, n) == oracle[n]
    assert tr.ask_pool_stats() == jr.ask_pool_stats()
    assert tr.ask_pool_stats()["in_flight"] == \
        tr.ask_pool_stats()["retired"]
    assert tr.stats() == jr.stats()
    if slots:
        # the bounded-mailbox region (spill_capacity=0, the ring-slots
        # kernel's mode on a card) answers the same trace bit for bit
        br = TRegion(TEntity("bounded", t_counter(P), n_shards=2,
                             entities_per_shard=16, n_devices=d,
                             payload_width=P, mailbox_slots=slots,
                             spare_blocks=2, spill_capacity=0),
                     device="cpu")
        bt = {n: 0.0 for n in names}
        brs = [br.entity_ref(n) for n in names]
        for k, (picks, vals) in enumerate(trace):
            if k == 3:
                br.rebalance(moved)
            out = br.ask_many([(brs[i].shard, brs[i].index, [v])
                               for i, v in zip(picks, vals)])
            for i, v, o in zip(picks, vals, out):
                bt[names[i]] += v
                assert float(o[0]) == bt[names[i]]
        assert bt == oracle


# ------------------------------------------- region cases, both packages

@jb.behavior("dev-counter", {"n": ((), jnp.int32)})
def j_dev_counter(state, inbox, ctx):
    return ({"n": state["n"] + inbox.count}, jb.Emit.none(1, P))


@tb.behavior("dev-counter", {"n": ((), torch.int32)})
def t_dev_counter(state, inbox, ctx):
    return ({"n": state["n"] + inbox.count},
            tb.Emit.none(ctx.actor_id.shape[0], 1, P))


def make_forwarders(n_shards):
    """Entities forwarding their token to the same index of the NEXT
    logical shard through the live placement table (both packages)."""
    cols = {"received": ((), jnp.int32), "myshard": ((), jnp.int32),
            "myidx": ((), jnp.int32)}

    @jb.behavior("dev-fwd", cols)
    def j_fwd(state, inbox, ctx):
        base = ctx.tables["shard_row_base"]
        dst = base[(state["myshard"] + 1) % n_shards] + state["myidx"]
        return ({"received": state["received"] + inbox.count,
                 "myshard": state["myshard"], "myidx": state["myidx"]},
                jb.Emit.single(dst, inbox.sum, 1, P, when=inbox.count > 0))

    @tb.behavior("dev-fwd", {k: ((), torch.int32) for k in cols})
    def t_fwd(state, inbox, ctx):
        base = ctx.tables["shard_row_base"]
        dst = base[((state["myshard"] + 1) % n_shards).long()] \
            + state["myidx"]
        return ({"received": state["received"] + inbox.count,
                 "myshard": state["myshard"], "myidx": state["myidx"]},
                tb.Emit.single(dst, inbox.sum, 1, P, when=inbox.count > 0))

    return j_fwd, t_fwd


def region_pair(j_beh, t_beh, name, **kw):
    jr = JRegion(JEntity(name, j_beh, payload_width=P, **kw))
    tr = TRegion(TEntity(name, t_beh, payload_width=P, **kw), device="cpu")
    assert tr.system.capacity == jr.system.capacity <= 64
    return jr, tr


def both_run(jr, tr, n):
    for r in (jr, tr):
        r.run(n)
        r.block_until_ready()


@pytest.mark.parametrize("d", [1, 2])
def test_entity_allocation_and_tell(d):
    """test_device_sharding.py:39."""
    jr, tr = region_pair(j_dev_counter, t_dev_counter, "counters",
                         n_shards=4, entities_per_shard=8, n_devices=d)
    a, b = refs(jr, tr, "alice"), refs(jr, tr, "bob")
    assert tr.entity_ref("alice").row == a.row
    for r in (jr, tr):
        ra, rb = r.entity_ref("alice"), r.entity_ref("bob")
        ra.tell([1.0, 0, 0, 0])
        ra.tell([1.0, 0, 0, 0])
        rb.tell([1.0, 0, 0, 0])
    both_run(jr, tr, 1)
    assert a.read_state("n") == 2 and b.read_state("n") == 1
    assert tr.stats() == jr.stats()
    assert tr.stats()["entities"] >= 2 and tr.stats()["shards"] == 4
    assert {tr.device_of_shard(s) for s in range(4)} == set(range(d))
    assert_systems_match(jr.system, tr.system, "tells")


def _seed_forwarders(region, n_shards, eps):
    """Identity columns and one token per entity (host tells)."""
    sys = region.system
    myshard = np.zeros((sys.capacity,), np.int32)
    myidx = np.zeros((sys.capacity,), np.int32)
    for s in range(n_shards):
        base = region.row_of(s, 0)
        myshard[base:base + eps] = s
        myidx[base:base + eps] = np.arange(eps)
    if isinstance(region, TRegion):
        sys.state["myshard"][:] = torch.from_numpy(myshard)
        sys.state["myidx"][:] = torch.from_numpy(myidx)
    else:
        sys.state["myshard"] = sys.state["myshard"].at[:].set(
            jnp.asarray(myshard))
        sys.state["myidx"] = sys.state["myidx"].at[:].set(
            jnp.asarray(myidx))
    for s in range(n_shards):
        for i in range(eps):
            sys.tell(region.row_of(s, i), [1.0, 0, 0, 0])


def _received(region, n_shards, eps):
    return [region.system.read_state(
        "received", np.arange(region.row_of(s, 0), region.row_of(s, 0) + eps,
                              dtype=np.int32)) for s in range(n_shards)]


def _value_in_flight(region):
    sys = region.system
    return float(sys.inbox_payload[sys.inbox_valid, 0].sum())


def _move(jr, tr, shard):
    """Rebalance `shard` in both regions; True if it changed shard of the
    axis (its in-flight messages then ride the stray-forwarding step)."""
    old = tr.device_of_shard(shard)
    assert tr.rebalance(shard) == jr.rebalance(shard)
    assert tr.device_of_shard(shard) == jr.device_of_shard(shard)
    return tr.device_of_shard(shard) != old


@pytest.mark.parametrize("d", [1, 2])
def test_forwarder_ring_stray_window_and_rebalances(d):
    """The forwarder ring under the sharding API (test_device_sharding.py:65),
    a rebalance whose stray-forwarding step is confined to the hand-off
    window of one long run() (:94), and a second rebalance mid-run that
    moves state and messages (:271): the same carries in both packages,
    and the reference's per-entity delivery counts."""
    n_shards, eps = 4, 8
    j_fwd, t_fwd = make_forwarders(n_shards)
    jr, tr = region_pair(j_fwd, t_fwd, "fwd", n_shards=n_shards,
                         entities_per_shard=eps, n_devices=d, spare_blocks=2)
    for r in (jr, tr):
        r.allocate_all()
        _seed_forwarders(r, n_shards, eps)
    base_pair_cap = tr.system.pair_cap
    both_run(jr, tr, 2)
    assert not tr.system.stray_mode
    assert_systems_match(jr.system, tr.system, "ring, 2 steps")
    for recv in _received(tr, n_shards, eps):
        assert (recv == 2).all()

    # shard 3 moves to the spare block: from shard 1 of the axis to shard
    # 0 at D=2, within the one shard at D=1
    crossed = _move(jr, tr, 3)
    assert tr.system.stray_mode and jr.system.stray_mode
    assert_systems_match(jr.system, tr.system, "rebalanced")
    both_run(jr, tr, 10)     # drain (3) + steady remainder (7)
    assert not tr.system.stray_mode and not jr.system.stray_mode
    assert tr.system.pair_cap == base_pair_cap
    assert_systems_match(jr.system, tr.system, "stray window drained")
    # a move within one shard of the axis delays nothing; across the axis,
    # the forwarding hop delays a batch that then merges with the next
    # (counts are the reference's, checked above), and the value in
    # flight is conserved either way
    assert _value_in_flight(tr) == n_shards * eps
    if not crossed:
        for s, recv in enumerate(_received(tr, n_shards, eps)):
            assert (recv == 12).all(), (s, recv)

    before = sum(int(r.sum()) for r in _received(tr, n_shards, eps))
    crossed = _move(jr, tr, 2)
    both_run(jr, tr, 3)
    assert_systems_match(jr.system, tr.system, "second rebalance")
    assert _value_in_flight(tr) == n_shards * eps
    if not crossed:
        after = _received(tr, n_shards, eps)
        assert sum(int(r.sum()) for r in after) - before == \
            3 * n_shards * eps
    assert tr.system.total_dropped == jr.system.total_dropped == 0
    assert tr.stats() == jr.stats()


@pytest.mark.parametrize("d", [1, 2])
def test_ask_timeout_slot_reclaimed_after_late_reply(d):
    """A timed-out ask retires its slot; once the late reply's latch shows
    it returns to the pool (test_device_sharding.py:358)."""
    @jb.behavior("late-echo", {"asked": ((), jnp.int32)})
    def j_echo(state, inbox, ctx):
        return ({"asked": state["asked"] + inbox.count},
                jb.Emit.single(j_reply_dst(inbox.sum), inbox.sum, 1, P,
                               when=inbox.count > 0))

    @tb.behavior("late-echo", {"asked": ((), torch.int32)})
    def t_echo(state, inbox, ctx):
        return ({"asked": state["asked"] + inbox.count},
                tb.Emit.single(t_reply_dst(inbox.sum), inbox.sum, 1, P,
                               when=inbox.count > 0))

    jr, tr = region_pair(j_echo, t_echo, "late-ask", n_shards=4,
                         entities_per_shard=8, n_devices=d,
                         host_inbox_per_shard=8)
    for r in (jr, tr):
        r.allocate_all()
    free0 = len(tr._promise_free)
    for r in (jr, tr):
        with pytest.raises(TimeoutError):
            r.ask(0, 3, [5.0], steps=1, max_extra_steps=0)
    assert len(tr._promise_free) == free0 - 1
    assert tr._promise_retired == jr._promise_retired and \
        len(tr._promise_retired) == 1
    both_run(jr, tr, 4)
    assert tr._reclaim_promise_slots() == jr._reclaim_promise_slots() == 1
    assert len(tr._promise_free) == free0 and tr._promise_retired == []
    reply = tr.ask(0, 3, [7.0, 0, 0])
    np.testing.assert_array_equal(reply,
                                  np.asarray(jr.ask(0, 3, [7.0, 0, 0])))
    assert reply[0] == 7.0
    assert_systems_match(jr.system, tr.system, "late reply")


# -------------------------------------------------------- port-side rules

def test_promise_rows_are_exact_in_float32_only_up_to_2_24():
    assert max_exact_row_id(torch.float32) == 1 << 24
    assert max_exact_row_id(torch.float16) == 1 << 11
    assert max_exact_row_id(torch.bfloat16) == 1 << 8
    assert max_exact_row_id(torch.int32) == 2 ** 31 - 1
    pl = torch.tensor([[0.0, 0.0, 0.0, float((1 << 24) - 1)]])
    assert int(t_reply_dst(pl)[0]) == (1 << 24) - 1


def test_region_backends_and_rebalance_rules():
    """The port's backends only, the lease is honoured, a region with no
    spare block cannot move a shard, and delivery_backend="cuda" outside
    the ring kernel's support matrix raises instead of falling back."""
    with pytest.raises(ValueError, match="unknown delivery backend"):
        TRegion(TEntity("x", t_counter(P), n_shards=2, entities_per_shard=4,
                        delivery_backend="reference"), device="cpu")

    class Lease:
        class settings:
            lease_name = "shard-lease"

        def acquire(self):
            return False

    r = TRegion(TEntity("x", t_counter(P), n_shards=2, entities_per_shard=4,
                        spare_blocks=2, lease=Lease()), device="cpu")
    with pytest.raises(RuntimeError, match="shard-lease"):
        r.rebalance(0)
    r = TRegion(TEntity("x", t_counter(P), n_shards=2, entities_per_shard=4),
                device="cpu")
    with pytest.raises(RuntimeError, match="no spare blocks"):
        r.rebalance(0)
    r = TRegion(TEntity("x", t_counter(P), n_shards=2, entities_per_shard=4,
                        mailbox_slots=2, delivery_backend="cuda"),
                device="cpu")
    with pytest.raises(ValueError, match="spill_cap"):
        r.ask(0, 0, [1.0])
