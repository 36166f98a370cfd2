"""The port's ask front end (akka_tpu_torch.sharding.ask_batch: AskBatcher,
ContinuousWaveScheduler, wait_adaptive_close) against the reference's
(akka_tpu), on the CPU.

Every parity case builds the same counter region in both packages (2
shards x 16 entities, two spare blocks: 64 rows; D in {1, 2},
mailbox_slots in {0, 2}), starts the port's from the reference's carried
state (device carry and the region's promise-slot bookkeeping), sends both
front ends the same asks and compares what comes back: reply payloads bit
for bit (the counter adds integer-valued floats, so every sum is exact),
the same outcome types and messages, the same resolve ordinals, and, on
the serialized paths, the systems' carries (integer fields bit for bit,
floats within rtol 1e-4 / atol 1e-3). The cases follow
tests/test_ask_batch.py and tests/test_continuous_wave.py. Threaded cases
assert counts and conserved totals, never timing; every wait is bounded.
"""

import os
import threading

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # tiny tensors: spare the other test workers

import jax

from akka_tpu.gateway import counter_behavior as j_counter
from akka_tpu.sharding.ask_batch import AskBatcher as JBatcher
from akka_tpu.sharding.ask_batch import \
    wait_adaptive_close as j_wait_adaptive_close
from akka_tpu.sharding.device import DeviceEntity as JEntity
from akka_tpu.sharding.device import DeviceShardRegion as JRegion

from akka_tpu_torch.batched.bridge import AskPoolExhausted
from akka_tpu_torch.gateway import counter_behavior as t_counter
from akka_tpu_torch.sharding import AskBatcher as TBatcher
from akka_tpu_torch.sharding import (ContinuousWaveScheduler,
                                     wait_adaptive_close)
from akka_tpu_torch.sharding.device import DeviceEntity as TEntity
from akka_tpu_torch.sharding.device import DeviceShardRegion as TRegion
from akka_tpu_torch.utils.carry import (SHARDED_FIELDS, load_numpy_carry,
                                        numpy_carry)

RTOL, ATOL = 1e-4, 1e-3
P = 4
CONFIGS = [(1, 0), (1, 2), (2, 0), (2, 2)]  # (D, mailbox_slots)
CONFIG_IDS = [f"d{d}-slots{s}" for d, s in CONFIGS]
WAIT_S = 60.0  # bound on every future, join and event wait


# ------------------------------------------------------------ the pair

def jax_carry(jsys):
    """The reference system's carry in the port's numpy layout."""
    out = {f"state/{c}": np.asarray(jax.device_get(v))
           for c, v in jsys.state.items()}
    for f in SHARDED_FIELDS:
        out[f] = np.asarray(jax.device_get(getattr(jsys, f)))
    out["host/next_row"] = np.asarray(jsys._next_row, np.int64)
    out["host/step"] = np.asarray(jsys._host_step, np.int64)
    return out


_HOST_FIELDS = ("_promise_free", "_promise_retired", "_promise_spawned",
                "_stat_ask_exhausted", "_wave_seq")


def sync_pair(jr, tr):
    """Start the port's region from the reference's state: the device
    carry and the promise-slot bookkeeping."""
    assert not jr.system.stray_mode and not tr.system.stray_mode
    load_numpy_carry(tr.system, jax_carry(jr.system))
    for f in _HOST_FIELDS:
        v = getattr(jr, f)
        setattr(tr, f, list(v) if isinstance(v, list) else v)


def assert_systems_match(jsys, tsys, ctx):
    want = jax_carry(jsys)
    got = numpy_carry(tsys)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, (ctx, k, g.shape, w.shape)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{ctx} {k}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{ctx} {k}")


def assert_outcomes_match(jout, tout, ctx):
    """Same outcome types and messages; replies bit-identical float32."""
    assert len(jout) == len(tout), ctx
    for i, (j, t) in enumerate(zip(jout, tout)):
        assert type(t).__name__ == type(j).__name__, (ctx, i, j, t)
        if isinstance(j, BaseException):
            assert str(t) == str(j), (ctx, i)
        else:
            t = np.asarray(t)
            assert t.dtype == np.float32 == np.asarray(j).dtype, (ctx, i)
            np.testing.assert_array_equal(t, np.asarray(j),
                                          err_msg=f"{ctx} member {i}")


_REGIONS = {}


def region_pair(d, slots, group):
    """One region per package, config and group of tests (a group stays
    within the region's 32 entity slots)."""
    key = (d, slots, group)
    if key not in _REGIONS:
        kw = dict(n_shards=2, entities_per_shard=16, n_devices=d,
                  payload_width=P, mailbox_slots=slots, spare_blocks=2)
        name = f"af-{group}-d{d}-s{slots}"
        jr = JRegion(JEntity(name, j_counter(P), **kw))
        tr = TRegion(TEntity(name, t_counter(P), **kw), device="cpu")
        assert tr.system.capacity == jr.system.capacity <= 64
        _REGIONS[key] = (jr, tr)
    jr, tr = _REGIONS[key]
    sync_pair(jr, tr)
    return jr, tr


def refs(jr, tr, names):
    out = []
    for n in names:
        j, t = jr.entity_ref(n), tr.entity_ref(n)
        assert (t.shard, t.index, t.row) == (j.shard, j.index, j.row), n
        out.append(t)
    return out


def total(region, ref):
    return float(np.asarray(region.system.read_state(
        "total", np.asarray([ref.row], np.int32)))[0])


def batcher_pair(jr, tr, **kw):
    return JBatcher(jr, **kw), TBatcher(tr, **kw)


def close_all(*batchers):
    for b in batchers:
        b.close()


# ----------------------------------------------------- serialized engine

@pytest.mark.parametrize("d,slots", CONFIGS, ids=CONFIG_IDS)
def test_continuous_off_is_bit_identical_to_serialized(d, slots):
    """AskBatcher with continuous=False (the default and explicit) serves
    exactly what the region's own ask_many serves, in both packages: the
    same replies for solo asks and multi-member waves, and the same
    carry afterwards."""
    jr, tr = region_pair(d, slots, "ser")
    rs = refs(jr, tr, [f"co-{i}" for i in range(4)])
    trace = [[(0, 1.0)], [(1, 2.0), (2, 3.0), (1, 4.0)], [(3, 5.0)],
             [(0, 1.0), (0, 2.0), (3, 3.0), (2, 1.0)]]
    jb, tb = batcher_pair(jr, tr, max_batch=8, continuous=False)
    tb_default = TBatcher(tr, max_batch=8)
    assert tb._sched is None and tb_default._sched is None
    try:
        for k, wave in enumerate(trace):
            reqs = [(rs[i].shard, rs[i].index, [v]) for i, v in wave]
            batcher = tb_default if k % 2 else tb
            if len(reqs) == 1:
                s, i, m = reqs[0]
                jout = [jb.ask(s, i, m)]
                tout = [batcher.ask(s, i, m)]
            else:
                jout = jb.ask_many(reqs)
                tout = batcher.ask_many(reqs)
            assert_outcomes_match(jout, tout, f"wave {k}")
            direct = jr.ask_many([(s, i, [0.0]) for s, i, _ in reqs[:1]])
            assert_outcomes_match(direct, tr.ask_many(
                [(s, i, [0.0]) for s, i, _ in reqs[:1]]), f"direct {k}")
    finally:
        close_all(jb, tb, tb_default)
    assert_systems_match(jr.system, tr.system, "continuous off")
    assert tb.stats()["overlap_ratio"] == 0.0


@pytest.mark.parametrize("d,slots", CONFIGS, ids=CONFIG_IDS)
def test_solo_and_batched_asks_bit_identical(d, slots):
    """A solo ask and the same asks as one wave (distinct entities) give
    the same replies in both packages (test_ask_batch.py:49)."""
    jr, tr = region_pair(d, slots, "ser")
    solo = refs(jr, tr, [f"sb-s{i}" for i in range(3)])
    wave = refs(jr, tr, [f"sb-b{i}" for i in range(3)])
    values = [1.0, 2.0, 3.0]
    jb, tb = batcher_pair(jr, tr, max_batch=8)
    try:
        serial = []
        for r, v in zip(solo, values):
            t = tb.ask(r.shard, r.index, [v])
            np.testing.assert_array_equal(t, np.asarray(
                jb.ask(r.shard, r.index, [v])))
            serial.append(t)
        reqs = [(r.shard, r.index, [v]) for r, v in zip(wave, values)]
        jout, tout = jb.ask_many(reqs), tb.ask_many(reqs)
    finally:
        close_all(jb, tb)
    assert_outcomes_match(jout, tout, "batched")
    for s, b in zip(serial, tout):
        np.testing.assert_array_equal(s, b)
    assert_systems_match(jr.system, tr.system, "solo and batched")


@pytest.mark.parametrize("continuous", [False, True],
                         ids=["serialized", "continuous"])
@pytest.mark.parametrize("d,slots", CONFIGS, ids=CONFIG_IDS)
def test_same_entity_batch_linearized(d, slots, continuous):
    """Same-row asks of one wave serialize across rounds: each reply is a
    distinct prefix sum, in both packages (test_ask_batch.py:71)."""
    jr, tr = region_pair(d, slots, "cont" if continuous else "ser")
    (r,) = refs(jr, tr, [f"lin-{int(continuous)}"])
    jb, tb = batcher_pair(jr, tr, max_batch=8, continuous=continuous)
    reqs = [(r.shard, r.index, [v]) for v in (1.0, 2.0, 4.0)]
    try:
        jout, tout = jb.ask_many(reqs), tb.ask_many(reqs)
    finally:
        close_all(jb, tb)
    assert_outcomes_match(jout, tout, "linearized")
    assert [float(x[0]) for x in tout] == [1.0, 3.0, 7.0]
    assert total(tr, r) == total(jr, r) == 7.0
    if not continuous:
        assert_systems_match(jr.system, tr.system, "linearized")


@pytest.mark.parametrize("continuous", [False, True],
                         ids=["serialized", "continuous"])
@pytest.mark.parametrize("d,slots", CONFIGS, ids=CONFIG_IDS)
def test_mid_batch_timeout_and_pool_exhaustion_are_per_member(
        d, slots, continuous):
    """An ask to a never-spawned row times out and retires only its own
    slot while its wave-mate gets its reply; with two free slots a wave
    of three gets two replies and one typed AskPoolExhausted,
    position-aligned (test_ask_batch.py:157, :179;
    test_continuous_wave.py)."""
    jr, tr = region_pair(d, slots, "cont" if continuous else "ser")
    tag = int(continuous)
    live, *exh = refs(jr, tr, [f"to-{tag}"] + [f"exh-{tag}-{i}"
                                              for i in range(3)])
    dead_idx = tr.eps - 1
    assert dead_idx >= tr._spawned[live.shard]
    before = tr.ask_pool_stats()
    jb, tb = batcher_pair(jr, tr, max_batch=8, steps=2, max_extra_steps=2,
                          continuous=continuous)
    try:
        reqs = [(live.shard, live.index, [5.0]),
                (live.shard, dead_idx, [1.0])]
        jout, tout = jb.ask_many(reqs), tb.ask_many(reqs)
        assert_outcomes_match(jout, tout, "timeout")
        assert float(tout[0][0]) == 5.0
        assert isinstance(tout[1], TimeoutError)
        assert "unanswered after 4 steps" in str(tout[1])
        after = tr.ask_pool_stats()
        assert after == jr.ask_pool_stats()
        assert after["retired"] == before["retired"] + 1

        parked = {}
        for key, r in (("j", jr), ("t", tr)):
            with r._lock:
                free = r._promise_free
                parked[key], r._promise_free = free[2:], free[:2]
        try:
            reqs = [(r.shard, r.index, [1.0]) for r in exh]
            jout, tout = jb.ask_many(reqs), tb.ask_many(reqs)
        finally:
            for key, r in (("j", jr), ("t", tr)):
                with r._lock:
                    r._promise_free.extend(parked[key])
        assert_outcomes_match(jout, tout, "exhaustion")
        assert isinstance(tout[2], AskPoolExhausted)
        assert "promise rows exhausted" in str(tout[2])
        assert [float(x[0]) for x in tout[:2]] == [1.0, 1.0]
        assert tr.ask_pool_stats()["exhausted"] == \
            jr.ask_pool_stats()["exhausted"]
    finally:
        close_all(jb, tb)
    if not continuous:
        assert_systems_match(jr.system, tr.system, "timeout + exhaustion")


def test_batch_capped_at_promise_pool():
    """max_batch is capped at the promise pool, and a wave larger than
    the pool rides consecutive sub-batches with the reference's
    outcomes."""
    jr, tr = region_pair(1, 0, "ser")
    assert TBatcher(tr, max_batch=4096).max_batch == tr.eps == \
        JBatcher(jr, max_batch=4096).max_batch
    rs = refs(jr, tr, [f"cap-{i}" for i in range(6)])
    reqs = [(rs[i % 6].shard, rs[i % 6].index, [float(i % 5 + 1)])
            for i in range(tr.eps + 4)]
    jb, tb = batcher_pair(jr, tr, max_batch=4096)
    try:
        jout, tout = jb.ask_many(reqs), tb.ask_many(reqs)
        st = tb.stats()
    finally:
        close_all(jb, tb)
    assert_outcomes_match(jout, tout, "capped")
    assert st["batches"] == 2.0 and st["max_batch_size"] == tr.eps
    assert_systems_match(jr.system, tr.system, "capped")


# ------------------------------------------------------ continuous waves

@pytest.mark.parametrize("d,slots", CONFIGS, ids=CONFIG_IDS)
def test_sequential_continuous_waves_match_reference(d, slots):
    """Continuous waves from one thread, one after another (repeated
    entities within a wave): the same replies and the same global
    resolve ordinals as the reference's scheduler."""
    jr, tr = region_pair(d, slots, "cont")
    rs = refs(jr, tr, [f"sq-{i}" for i in range(5)])
    rng = np.random.default_rng(11 * d + slots)
    jb, tb = batcher_pair(jr, tr, max_batch=8, continuous=True,
                          pipeline_depth=4)
    try:
        for k in range(4):
            picks = rng.integers(0, len(rs), 6)
            vals = rng.integers(1, 10, 6).astype(np.float64)
            reqs = [(rs[i].shard, rs[i].index, [v])
                    for i, v in zip(picks, vals)]
            jout, jseq = jb.ask_many(reqs, with_seqs=True)
            tout, tseq = tb.ask_many(reqs, with_seqs=True)
            assert_outcomes_match(jout, tout, f"wave {k}")
            assert tseq == jseq, (k, tseq, jseq)
        assert tb.quiesce(WAIT_S) and jb.quiesce(WAIT_S)
        st = tb.stats()
    finally:
        close_all(jb, tb)
    assert st["asks"] == 24.0 and st["pending"] == 0.0
    for r in rs:
        assert total(tr, r) == total(jr, r)
    # no ask left in flight but the timed-out one the carry retired
    assert tr.ask_pool_stats() == jr.ask_pool_stats()
    assert tr.ask_pool_stats()["in_flight"] == \
        tr.ask_pool_stats()["retired"]


@pytest.mark.parametrize("d,slots", CONFIGS, ids=CONFIG_IDS)
def test_overlapped_async_waves_match_reference(d, slots):
    """Waves staged back to back with ask_many_async (so several are open
    at once, duplicates spanning waves): the same replies per member and
    the same totals as the reference (step counts may differ, so the
    carries are not compared)."""
    jr, tr = region_pair(d, slots, "cont")
    rs = refs(jr, tr, [f"ov-{i}" for i in range(6)])
    rng = np.random.default_rng(5 + 7 * d + slots)
    waves = []  # 12 members: every one fits the free promise slots
    for _ in range(3):
        picks = rng.integers(0, len(rs), 4)
        vals = rng.integers(1, 10, 4).astype(np.float64)
        waves.append([(rs[i].shard, rs[i].index, [v])
                      for i, v in zip(picks, vals)])
    start = [total(tr, r) for r in rs]

    def run(batcher):
        done = [threading.Event() for _ in waves]
        outs = [None] * len(waves)

        def on_done(k):
            def cb(outcomes, seqs):
                outs[k] = list(outcomes)
                done[k].set()
            return cb

        for k, w in enumerate(waves):
            batcher.ask_many_async(w, on_done=on_done(k))
        for ev in done:
            assert ev.wait(WAIT_S)
        assert batcher.quiesce(WAIT_S)
        return outs

    jb, tb = batcher_pair(jr, tr, max_batch=8, continuous=True,
                          pipeline_depth=4)
    try:
        jouts, touts = run(jb), run(tb)
        st = tb.stats()
    finally:
        close_all(jb, tb)
    for k, (j, t) in enumerate(zip(jouts, touts)):
        assert_outcomes_match(j, t, f"async wave {k}")
    # every reply is its entity's running total in submit order
    run_tot = dict(zip((r.row for r in rs), start))
    for w, outs in zip(waves, touts):
        for (s, i, (v,)), o in zip(w, outs):
            row = tr.row_of(s, i)
            run_tot[row] += v
            assert float(o[0]) == run_tot[row]
    for r in rs:
        assert total(tr, r) == total(jr, r) == run_tot[r.row]
    assert st["waves_busy_s"] > 0.0 and st["asks"] == 12.0
    # no ask left in flight but the timed-out one the carry retired
    assert tr.ask_pool_stats() == jr.ask_pool_stats()
    assert tr.ask_pool_stats()["in_flight"] == \
        tr.ask_pool_stats()["retired"]


# --------------------------------------------- window close (port only)

_PORT = {}


def port_region():
    if "r" not in _PORT:
        _PORT["r"] = TRegion(TEntity(
            "af-port", t_counter(P), n_shards=2, entities_per_shard=16,
            n_devices=1, payload_width=P, spare_blocks=2), device="cpu")
    return _PORT["r"]


def _wait_for(pred):
    ev = threading.Event()
    for _ in range(int(WAIT_S / 1e-3)):
        if pred():
            return
        ev.wait(1e-3)
    raise AssertionError("condition not reached")


@pytest.mark.parametrize("continuous", [False, True],
                         ids=["serialized", "continuous"])
def test_window_coalesces_concurrent_submits(continuous):
    """Counted, not timed: with the region's ask lock held, one ask is
    taken into a batch of its own and blocks on the lock; the N asks
    submitted meanwhile all pend, and once the lock is released they
    close as ONE full batch of N."""
    region = port_region()
    n = 6
    rs = [region.entity_ref(f"coal-{int(continuous)}-{i}")
          for i in range(n + 1)]
    before = [total(region, r) for r in rs]
    batcher = TBatcher(region, max_batch=n, window_s=WAIT_S,
                       continuous=continuous)
    try:
        with region._ask_lock:
            first = batcher.submit(rs[0].shard, rs[0].index, [1.0])
            _wait_for(lambda: not batcher._pending)
            futs = [batcher.submit(r.shard, r.index, [float(i + 2)])
                    for i, r in enumerate(rs[1:])]
        replies = [first.result(WAIT_S)] + [f.result(WAIT_S) for f in futs]
        st = batcher.stats()
    finally:
        batcher.close()
    for i, (r, b) in enumerate(zip(replies, before)):
        assert float(r[0]) == b + float(i + 1)
    assert st["asks"] == n + 1 and st["batches"] == 2.0
    assert st["max_batch_size"] == float(n)
    assert st["multi_ask_batches"] == 1.0 and st["pending"] == 0.0
    with pytest.raises(RuntimeError, match="closed"):
        batcher.submit(0, 0, [1.0])


@pytest.mark.parametrize("continuous", [False, True],
                         ids=["serialized", "continuous"])
def test_idle_fast_close(continuous):
    """With nothing executing downstream, a lone ask's window closes at
    once instead of waiting out its window: with a window far longer
    than the bounded wait, the ask still resolves."""
    region = port_region()
    (r,) = [region.entity_ref(f"fc-{int(continuous)}")]
    batcher = TBatcher(region, max_batch=16, window_s=10 * WAIT_S,
                       continuous=continuous)
    try:
        for i in range(3):
            out = batcher.submit(r.shard, r.index, [1.0]).result(WAIT_S)
            assert float(out[0]) == float(i + 1)
        assert batcher.stats()["batches"] == 3.0
    finally:
        batcher.close()


@pytest.mark.parametrize("fn", [wait_adaptive_close, j_wait_adaptive_close],
                         ids=["port", "reference"])
def test_wait_adaptive_close(fn):
    """Returns at once when the window is full or the pipeline is idle,
    when the window has elapsed, and when an arrival fills it."""
    work = threading.Event()
    calls = []

    def full_now():
        calls.append(1)
        return True

    fn(work, 10 * WAIT_S, full_now)
    assert len(calls) == 1
    fn(work, 10 * WAIT_S, lambda: False, idle=lambda: True)
    fn(work, 0.0, lambda: False)
    state = {"n": 0}
    lock = threading.Lock()

    def full():
        with lock:
            return state["n"] >= 3

    def arrive():
        for _ in range(3):
            with lock:
                state["n"] += 1
            work.set()

    t = threading.Thread(target=arrive)
    t.start()
    fn(work, 10 * WAIT_S, full, idle=lambda: False)
    t.join(WAIT_S)
    assert full() and not t.is_alive()


def test_scheduler_closed_rejects_and_counts_overlap():
    """A closed scheduler refuses new waves; its stats surface has the
    reference's keys."""
    region = port_region()
    sched = ContinuousWaveScheduler(region, depth=2)
    (r,) = [region.entity_ref("sc-0")]
    from akka_tpu_torch.sharding import BatchAsk
    h = sched.submit_wave([BatchAsk(r.shard, r.index, [3.0])])
    assert h.done.wait(WAIT_S)
    assert float(h.outcomes()[0][0]) == 3.0
    sched.close()
    with pytest.raises(RuntimeError, match="closed"):
        sched.submit_wave([BatchAsk(r.shard, r.index, [1.0])])
    assert set(sched.stats()) == {
        "open_waves", "waves_resolved", "busy_s", "overlap_s",
        "overlap_ratio", "idle_wakeups", "idle_wakeups_per_s"}
    assert sched.stats()["waves_resolved"] == 1.0


def test_concurrent_continuous_asks_linearized_and_conserved():
    """Stress: more submitting threads than cores, a short interpreter
    switch interval, shared entities hit by every thread's waves. Every
    ack is a distinct prefix sum of its entity's sent values (the
    one-ask-in-flight-per-row rule across open waves) and each entity's
    total is exactly its sent sum; a lost or doubled update breaks
    both. A member the 16-slot promise pool turns away (typed
    AskPoolExhausted) applies nothing."""
    import sys
    region = port_region()
    ents = [region.entity_ref(f"st-{k}") for k in range(6)]
    before = {r.row: total(region, r) for r in ents}
    batcher = TBatcher(region, max_batch=8, continuous=True,
                       pipeline_depth=4)
    n_threads = 2 * (os.cpu_count() or 4)
    sent = {r.row: [] for r in ents}
    acks = {r.row: [] for r in ents}
    errors = []
    lock = threading.Lock()

    def worker(w):
        try:
            for i in range(6):
                picks = [ents[(w + i + j) % len(ents)] for j in range(3)]
                vals = [float(w * 18 + i * 3 + j + 1) for j in range(3)]
                outs = batcher.ask_many([(r.shard, r.index, [v])
                                         for r, v in zip(picks, vals)])
                with lock:
                    for r, v, o in zip(picks, vals, outs):
                        if isinstance(o, AskPoolExhausted):
                            continue  # typed fast-fail: nothing applied
                        if isinstance(o, BaseException):
                            errors.append(repr(o))
                            continue
                        sent[r.row].append(v)
                        acks[r.row].append(float(o[0]) - before[r.row])
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=worker, args=(w,))
               for w in range(n_threads)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT_S)
        assert not any(t.is_alive() for t in threads)
        assert batcher.quiesce(WAIT_S)
    finally:
        sys.setswitchinterval(old)
        batcher.close()
    assert not errors, errors[:3]
    assert sum(len(v) for v in sent.values()) > 0
    for r in ents:
        chain = sorted(acks[r.row])
        if not chain:
            assert total(region, r) == before[r.row]
            continue
        diffs = [chain[0]] + [b - a for a, b in zip(chain, chain[1:])]
        assert sorted(diffs) == sorted(sent[r.row])
        assert total(region, r) - before[r.row] == sum(sent[r.row]) \
            == chain[-1]


@pytest.mark.parametrize("engine", ["continuous", "serialized"])
def test_a_round_stages_no_more_tells_than_its_host_rows(engine):
    """400 asks to 400 distinct entities staged for one round: 400 tells
    for a one-shard system whose flush holds 256 host rows. Continuous:
    two async waves of 200, both submitted before the scheduler's first
    round (the region's ask lock held). Serialized: one region.ask_many
    of 400. The reference stages them all, the flush skips 144, and
    those asks time out; the port keeps the asks past the host rows for
    the next round, and every ask is answered (ROADMAP C)."""
    outs = {}
    for name, entity, region_cls, counter, batcher_cls, kw in (
            ("ref", JEntity, JRegion, j_counter, JBatcher, {}),
            ("port", TEntity, TRegion, t_counter, TBatcher,
             {"device": "cpu"})):
        region = region_cls(entity(
            "rows", counter(P), n_shards=2, entities_per_shard=512,
            n_devices=1, payload_width=P, spare_blocks=2), **kw)
        assert region.system.host_inbox == 256
        rs = [region.entity_ref(f"hr-{i}") for i in range(400)]
        asks = [(r.shard, r.index, [1.0]) for r in rs]
        if engine == "serialized":
            outs[name] = region.ask_many(asks)
            continue
        waves = [asks[k:k + 200] for k in (0, 200)]
        batcher = batcher_cls(region, max_batch=256, continuous=True,
                              pipeline_depth=4)
        done = [threading.Event() for _ in waves]
        got = [None] * len(waves)

        def on_done(k):
            def cb(outcomes, seqs):
                got[k] = list(outcomes)
                done[k].set()
            return cb
        try:
            with region._ask_lock:
                for k, w in enumerate(waves):
                    batcher.ask_many_async(w, on_done=on_done(k))
            for ev in done:
                assert ev.wait(WAIT_S)
            assert batcher.quiesce(WAIT_S)
        finally:
            batcher.close()
        outs[name] = [o for w in got for o in w]
    lost = [o for o in outs["ref"] if isinstance(o, TimeoutError)]
    assert len(lost) == 400 - 256
    assert len(outs["port"]) == 400
    assert all(not isinstance(o, BaseException) and float(o[0]) == 1.0
               for o in outs["port"])
