"""Crash recovery of the port (akka_tpu_torch) on the CPU: the systems'
checkpoint/restore with the tell WAL, the region's durability half, and
the files of either package restored by the other.

The kill/restore/continue cases abandon a system at a seeded point (no
drain, no goodbye: what the snapshot and the journals hold on disk is all
recovery gets), rebuild a fresh one from disk, continue it, and hold it to
an uninterrupted twin and to `sum_oracle`, bit for bit (the adds are
integer-valued float32). They are held to the twin and the oracle, not to
the reference's restore. Shapes stay at most 64 rows; each
parametrisation runs the reference once at most.
"""

import json
import shutil

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # tiny tensors: spare the other test workers

import jax.numpy as jnp

import akka_tpu.batched as jb
import akka_tpu.gateway as jg
from akka_tpu.persistence import slab_snapshot as jslab
from akka_tpu.persistence.tell_journal import TellJournal as JTellJournal
from akka_tpu.sharding.ask_batch import BatchAsk as JBatchAsk
from akka_tpu.sharding.ask_batch import \
    ContinuousWaveScheduler as JContinuousWaveScheduler
from akka_tpu.sharding.device import DeviceEntity as JEntity
from akka_tpu.sharding.device import DeviceShardRegion as JRegion

import akka_tpu_torch.batched as tb
import akka_tpu_torch.gateway as tg
from akka_tpu_torch.batched.sharded import ShardedBatchedSystem
from akka_tpu_torch.parallel import shard_slots
from akka_tpu_torch.persistence.slab_snapshot import latest_slab_path
from akka_tpu_torch.persistence.tell_journal import TellJournal
from akka_tpu_torch.sharding import DeviceEntity, DeviceShardRegion
from akka_tpu_torch.sharding.ask_batch import BatchAsk, \
    ContinuousWaveScheduler
from akka_tpu_torch.sharding.remember import JournalRememberEntitiesStore

P = 4
N = 32


# --------------------------------------------------------------- systems

@tb.behavior("sum", {"total": ((), torch.float32)})
def t_sum(state, inbox, ctx):
    return ({"total": state["total"] + inbox.sum[:, 0]},
            tb.Emit.none(inbox.count.shape[0], 1, P))


@jb.behavior("sum", {"total": ((), jnp.float32)})
def j_sum(state, inbox, ctx):
    return {"total": state["total"] + inbox.sum[0]}, jb.Emit.none(1, P)


@tb.behavior("ring", {"received": ((), torch.int32),
                      "last": ((), torch.float32)})
def t_ring(state, inbox, ctx):
    nxt = (ctx.actor_id + 1) % ctx.n_actors
    token = inbox.sum[:, 0]
    pl = torch.zeros((token.shape[0], P), dtype=torch.float32)
    pl[:, 0] = token + 1
    return ({"received": state["received"] + inbox.count,
             "last": token}, tb.Emit.single(nxt, pl, 1, P,
                                            when=inbox.count > 0))


def tell_schedule(seed, n, steps, every=3):
    """Deterministic tell plan: {step: (dst_rows, value)}."""
    rng = np.random.default_rng(seed)
    return {s: (rng.integers(0, n, 1 + s % 2).astype(np.int32),
                float(1 + s % 5))
            for s in range(0, steps, every)}


def drive(sys_, sched, upto, staged=(), block=False):
    """Step `sys_` to host step `upto`, staging the scheduled tells at
    their step counters; `staged`: schedule steps already staged before
    the kill (the journal replays them). `block` waits for each step (the
    reference's host pads may be rewritten before a dispatched step reads
    them, ROADMAP C)."""
    while sys_._host_step < upto:
        s = sys_._host_step
        if s in sched and s not in staged:
            dst, val = sched[s]
            pl = np.zeros((len(dst), P), np.float32)
            pl[:, 0] = val
            sys_.tell(dst, pl)
        sys_.step()
        if block:
            sys_.block_until_ready()


def sum_oracle(sched, n, upto):
    """A tell staged at host step c is delivered by dispatch c+1."""
    out = np.zeros(n, np.float32)
    for s, (dst, val) in sched.items():
        if s <= upto - 1:
            np.add.at(out, dst, val)
    return out


def t_system():
    s = tb.BatchedSystem(N, [t_sum], payload_width=P, device="cpu")
    s.spawn_block(0, N)
    return s


def j_system():
    s = jb.BatchedSystem(N, [j_sum], payload_width=P)
    s.spawn_block(0, N)
    return s


def kill_points(seed):
    rng = np.random.default_rng(seed)
    ckpt_at = 8 + int(rng.integers(0, 6))
    return ckpt_at, ckpt_at + 2 + int(rng.integers(0, 6))


def die(victim, sched, kill_at, phase):
    """The victim's last act before the crash; returns the schedule steps
    it staged."""
    staged = {s for s in sched if s < kill_at}
    if phase == "staging":
        # a batch journaled and staged but not yet dispatched
        if kill_at in sched:
            dst, val = sched[kill_at]
            pl = np.zeros((len(dst), P), np.float32)
            pl[:, 0] = val
            victim.tell(dst, pl)
            staged.add(kill_at)
    else:
        victim.run_pipelined(3, depth=2)  # dispatches in flight
    return staged


# ------------------------------------------- kill / restore / continue

@pytest.mark.parametrize("phase", ["staging", "pipeline-full"])
def test_kill_restore_continue_parity(tmp_path, phase):
    seed, horizon = 23, 30
    sched = tell_schedule(seed, N, horizon)
    twin = t_system()
    drive(twin, sched, horizon)
    truth = twin.read_state("total")
    np.testing.assert_array_equal(truth, sum_oracle(sched, N, horizon))

    ckpt_at, kill_at = kill_points(seed)
    victim = t_system()
    victim.tell_journal = TellJournal(str(tmp_path / "tells.wal"))
    drive(victim, sched, ckpt_at)
    victim.checkpoint(str(tmp_path))
    drive(victim, sched, kill_at)
    staged = die(victim, sched, kill_at, phase)
    del victim  # the crash

    fresh = t_system()
    j = TellJournal(str(tmp_path / "tells.wal"))
    step = fresh.restore(latest_slab_path(str(tmp_path)), journal=j)
    assert step >= ckpt_at
    drive(fresh, sched, horizon, staged=staged)
    np.testing.assert_array_equal(fresh.read_state("total"), truth)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_snapshot_and_wal_restore_in_the_other_package(tmp_path,
                                                       monkeypatch, writer):
    """A snapshot plus WAL written by one package, restored by the other
    and continued to the horizon: the totals are the uninterrupted
    twin's (the writer's package) and the oracle's."""
    monkeypatch.setattr(jslab, "_try_orbax", lambda: None)
    seed, horizon = 41, 24
    sched = tell_schedule(seed, N, horizon)
    ckpt_at, kill_at = kill_points(seed)
    make_w, make_r = (j_system, t_system) if writer == "ref" \
        else (t_system, j_system)
    wal_w, wal_r = (JTellJournal, TellJournal) if writer == "ref" \
        else (TellJournal, JTellJournal)
    twin = make_w()
    drive(twin, sched, horizon, block=True)
    truth = np.asarray(twin.read_state("total"))
    np.testing.assert_array_equal(truth, sum_oracle(sched, N, horizon))

    victim = make_w()
    victim.tell_journal = wal_w(str(tmp_path / "tells.wal"))
    drive(victim, sched, ckpt_at, block=True)
    path = victim.checkpoint(str(tmp_path))
    assert path.endswith(".npz")
    drive(victim, sched, kill_at, block=True)
    staged = die(victim, sched, kill_at, "staging")
    del victim

    fresh = make_r()
    journal = wal_r(str(tmp_path / "tells.wal"))
    if writer == "ref":
        fresh.restore(path, journal=journal)
    else:
        # the reference restores the slabs; the WAL replays with a wait
        # after each step (its host pads, ROADMAP C)
        start = fresh.restore(path)
        for rec in journal.records():
            if int(rec["step"]) < start:
                continue
            drive(fresh, {}, int(rec["step"]), block=True)
            fresh.tell(rec["dst"], rec["payload"], rec["mtype"])
    assert fresh._host_step == kill_at
    drive(fresh, sched, horizon, staged=staged, block=True)
    np.testing.assert_array_equal(np.asarray(fresh.read_state("total")),
                                  truth)


def test_checkpoint_compacts_the_wal_and_seed_replays(tmp_path):
    s = t_system()
    s.tell_journal = TellJournal(str(tmp_path / "tells.wal"))
    for _ in range(6):
        s.tell([0], np.ones((1, P), np.float32))
        s.step()
    assert len(list(s.tell_journal.records())) == 6
    s.checkpoint(str(tmp_path))
    assert list(s.tell_journal.records()) == []
    s.seed_inbox(torch.tensor([3, 4], dtype=torch.int32),
                 torch.full((2, P), 2.0))
    s.tell([5], np.ones((1, P), np.float32))
    recs = list(s.tell_journal.records())
    assert [r["kind"] for r in recs] == ["seed", "tell"]
    assert isinstance(recs[0]["dst"], np.ndarray)
    s.step()
    want = s.read_state("total")
    fresh = t_system()
    fresh.restore(latest_slab_path(str(tmp_path)),
                  journal=TellJournal(str(tmp_path / "tells.wal")))
    fresh.step()
    np.testing.assert_array_equal(fresh.read_state("total"), want)


# ----------------------------------------------------- sharded re-shard

def t_ring_system(d):
    s = ShardedBatchedSystem(capacity=N, behaviors=[t_ring], n_devices=d,
                             payload_width=P, device="cpu")
    s.spawn_block(t_ring, N)
    return s


@pytest.mark.parametrize("path", ["same_d", "d8_to_d1_to_d8"])
def test_sharded_restore_same_and_across_shard_counts(tmp_path, path):
    """After the reference's test_sharded_restore_across_device_counts:
    the ring's tokens keep moving across a restore into the same shard
    count, and across 8 -> 1 -> 8 shards (per-shard counters conserved
    into shard 0), bit-identical to the uninterrupted 8-shard run."""
    a = t_ring_system(8)
    for r in (0, 9, 20):
        a.tell(r, [1.0, 0, 0, 0])
    a.run(10)
    a.checkpoint(str(tmp_path / "a"))
    a.run(7)
    mid = {c: a.read_state(c) for c in ("received", "last")}
    a.run(8)
    truth = {c: a.read_state(c) for c in ("received", "last")}
    counts = a.supervision_counts

    if path == "same_d":
        b = t_ring_system(8)
        assert b.restore(latest_slab_path(str(tmp_path / "a"))) == 10
        b.run_pipelined(15, depth=2)
    else:
        one = t_ring_system(1)
        assert one.restore(latest_slab_path(str(tmp_path / "a"))) == 10
        assert one.n_shards == 1
        one.run(7)
        for c in mid:
            np.testing.assert_array_equal(one.read_state(c), mid[c])
        one.checkpoint(str(tmp_path / "b"))
        b = t_ring_system(8)
        assert b.restore(latest_slab_path(str(tmp_path / "b"))) == 17
        b.run(8)
    for c in truth:
        np.testing.assert_array_equal(b.read_state(c), truth[c], err_msg=c)
    assert b.supervision_counts == counts
    assert b.total_dropped == a.total_dropped == 0


# ----------------------------------------------------------------- region

_SPEC_KW = dict(n_shards=2, entities_per_shard=16, n_devices=1,
                payload_width=P, spare_blocks=2)

_SEQ = [[("ej-a0", 2.0), ("ej-a1", 3.0), ("ej-a2", 5.0)],
        [("ej-a0", 1.0), ("ej-a3", 7.0), ("ej-a0", 2.0)],
        [("ej-a1", 4.0), ("ej-a2", 0.25), ("ej-a4", 9.0)]]


def t_region(name, behavior=None, **kw):
    spec = DeviceEntity(name, behavior or tg.counter_behavior(P),
                        **{**_SPEC_KW, **kw})
    return DeviceShardRegion(spec, device="cpu")


@tb.behavior("forward_once", {"total": ((), torch.float32)})
def t_forward_once(state, inbox, ctx):
    """total += value; the value goes on to the row in the payload's
    last column, stamped so that its receiver forwards it nowhere."""
    got = inbox.count > 0
    out = torch.zeros((got.shape[0], P), dtype=torch.float32)
    out[:, 0] = inbox.sum[:, 0]
    out[:, -1] = -1.0
    return ({"total": state["total"] + inbox.sum[:, 0]},
            tb.Emit.single(inbox.sum[:, -1].to(torch.int32), out, 1, P,
                           when=got))


def ask_waves(region, seq):
    """One ask wave per batch; returns the acked totals."""
    acked = {}
    for batch in seq:
        refs = [region.entity_ref(e) for e, _v in batch]
        outs = region.ask_many([(r.shard, r.index, [v])
                                for r, (_e, v) in zip(refs, batch)])
        for (e, _v), out in zip(batch, outs):
            assert not isinstance(out, BaseException), out
            acked[e] = float(np.asarray(out)[0])
    return acked


def totals(region, names):
    rows = [region.entity_ref(e).row for e in names]
    return {e: float(v) for e, v in zip(
        names, region.system.read_state("total", np.asarray(rows)))}


def test_journaled_region_bit_identical_to_undisturbed_twin(tmp_path):
    """The durable layer only observes the wave: replies and state equal
    a twin without it, and the journal's fold equals the acked totals,
    one group-committed record per wave."""
    a = t_region("ej-par")
    a.attach_journal(str(tmp_path))
    a.attach_entity_journal(str(tmp_path))
    b = t_region("ej-par")
    acked = ask_waves(a, _SEQ)
    assert acked == ask_waves(b, _SEQ)
    for f in ("inbox_dst", "inbox_valid", "alive", "behavior_id"):
        assert torch.equal(getattr(a.system, f), getattr(b.system, f)), f
    assert torch.equal(a.system.state["total"], b.system.state["total"])
    ej = a._entity_journal
    assert ej.totals() == acked
    st = ej.stats()
    assert st["waves"] == len(_SEQ)
    assert st["events"] == sum(len(w) for w in _SEQ)
    assert len(ej.records()) == len(_SEQ)
    a.detach_entity_journal()
    assert a._entity_journal is None


def test_crash_restore_replays_exact_acked_state(tmp_path):
    """A fresh identically-spec'd region on the journal directory
    restores, respawns every remembered entity with zero traffic, and its
    totals equal the original's acked totals exactly."""
    d = str(tmp_path / "r")
    a = t_region("ej-res")
    a.attach_journal(d)
    a.attach_entity_journal(d)
    a.checkpoint()
    acked = ask_waves(a, _SEQ)
    del a  # no close or sync: every wave was fsync'd (fsync_every_n=1)

    c = t_region("ej-res")
    c.attach_journal(d)
    c.attach_entity_journal(d)
    step = c.restore()
    assert step >= 2 and c._durable_replayed_totals == acked
    assert totals(c, list(acked)) == acked
    assert set(c.restore_timings) >= {"load_ms", "h2d_ms", "replay_ms",
                                      "replayed_steps"}
    # the restored region serves on: a new wave adds to the acked totals
    more = ask_waves(c, [[("ej-a0", 1.0), ("ej-new", 2.0)]])
    assert more == {"ej-a0": acked["ej-a0"] + 1.0, "ej-new": 2.0}


def test_region_wal_restore_continues_like_the_twin(tmp_path):
    """Without the entity journal: asks, a rebalance (which drains and
    checkpoints), more asks, tells staged but not stepped, then the
    crash. The restored region replays the WAL; after the same steps its
    totals equal the twin's and the host oracle's."""
    d = str(tmp_path / "w")
    names = [f"w{i}" for i in range(10)]
    plan = [[(names[(w * 3 + i) % 10], float(1 + (w + i) % 4))
             for i in range(4)] for w in range(6)]
    tells = [(names[i], float(i + 1)) for i in range(0, 10, 3)]

    def run(region, crash):
        oracle = {}
        for k, wave in enumerate(plan):
            ask_waves(region, [wave])
            for e, v in wave:
                oracle[e] = oracle.get(e, 0.0) + v
            if k == 1 and region.checkpoint_dir is not None:
                region.checkpoint()
            if k == 3:
                region.rebalance(region.entity_ref(names[0]).shard)
        for e, v in tells:
            region.entity_ref(e).tell([v, 0.0, 0.0, -1.0])
            oracle[e] = oracle.get(e, 0.0) + v
        if crash:
            return oracle
        region.run(2)
        return oracle

    twin = t_region("wal")
    oracle = run(twin, crash=False)
    victim = t_region("wal")
    victim.attach_journal(d)
    assert run(victim, crash=True) == oracle
    del victim

    fresh = t_region("wal")
    fresh.attach_journal(d)
    fresh.restore()
    assert totals(fresh, names) == totals(twin, names) == \
        {e: oracle.get(e, 0.0) for e in names}
    assert fresh.ask_pool_stats()["in_flight"] == 0


def test_respawn_remembered_from_journal_store(tmp_path):
    """A fresh incarnation on a fresh store handle (opened after the
    adds, as a restarted process would) respawns every remembered id with
    zero traffic, on the rows the entities had."""
    path = str(tmp_path / "remember.journal")
    store_a = JournalRememberEntitiesStore(path)
    r1 = t_region("re-journal", remember_store=store_a)
    ids = {f"re-{i}" for i in range(6)}
    rows = {e: r1.entity_ref(e).row for e in sorted(ids)}
    store_a.close()

    store_b = JournalRememberEntitiesStore(path)
    r2 = t_region("re-journal", remember_store=store_b)
    r2._respawn_remembered()
    got = set()
    for shard in range(r2.spec.n_shards):
        got.update(r2._entities[shard])
    assert got == ids
    assert {e: r2.entity_ref(e).row for e in ids} == rows
    assert r2.stats()["entities"] == len(ids)
    alive = r2.system.alive.numpy()
    assert all(alive[r] for r in rows.values())
    store_b.close()


def test_checkpoint_inside_the_stray_window(tmp_path):
    """A checkpoint taken in the hand-off window after a rebalance (the
    wider stray-mode inbox, a message in flight to the moved block on the
    other shard) restores into a fresh region, which is not in stray
    mode, through the re-sharding path; after the same steps every total
    equals the twin's."""
    kw = dict(n_devices=2, spare_blocks=4)
    names = [f"s{i}" for i in range(12)]

    def build():
        region = t_region("stray", t_forward_once, **kw)
        refs = {e: region.entity_ref(e) for e in names}
        src = refs["s0"]
        dst = next(r for r in refs.values() if r.shard != src.shard)
        for e in names[1:]:
            refs[e].tell([1.0, 0.0, 0.0, -1.0])
        # s0 forwards its 5 to dst's row: a message in flight to dst's
        # block once the step has run (one tell to s0 only: the inbox
        # sums its payloads, the forwarding column included)
        src.tell([5.0, 0.0, 0.0, float(dst.row)])
        region.run(1)
        region.rebalance(dst.shard, to_device=1 - region.device_of_shard(
            dst.shard))
        return region, dst

    twin, dst_t = build()
    victim, dst_v = build()
    assert victim.system.stray_mode
    valid = victim.system.inbox_valid.numpy()
    dests = victim.system.inbox_dst.numpy()[valid]
    assert dst_v.row in dests.tolist()  # the re-pointed message
    victim.attach_journal(str(tmp_path))
    victim.checkpoint()
    del victim

    fresh = t_region("stray", t_forward_once, **kw)
    fresh.attach_journal(str(tmp_path))
    fresh.restore()
    assert not fresh.system.stray_mode
    twin.run(4)
    fresh.run(4)
    want = totals(twin, names)
    assert want[dst_t.entity_id] == 1.0 + 5.0  # its tell + s0's 5
    assert totals(fresh, names) == want
    assert not bool(fresh.system.inbox_valid.any())  # all delivered


def test_dedup_rehydrates_after_restore_through_the_gateway(tmp_path):
    """The ok replies of idempotent-session requests ride the entity
    journal; a gateway brought up over the restored region rehydrates its
    reply cache, so a retried request id gets the cached reply and is not
    applied twice."""
    d = str(tmp_path)

    def stack():
        region = t_region("dedup")
        region.attach_journal(d)
        region.attach_entity_journal(d)
        return region

    def gateway(region):
        backend = tg.RegionBackend(region)
        srv = tg.GatewayServer(
            None, backend, tg.AdmissionController(rate=1e9, burst=1e9),
            tg.SloTracker(), dedup=tg.ReplyCacheTable(window=64))
        return backend, srv

    def req(rid, entity, value):
        return json.dumps({"id": rid, "tenant": "t0", "entity": entity,
                           "op": "add", "value": value}).encode()

    a = stack()
    a.checkpoint()
    backend, srv = gateway(a)
    first = [json.loads(srv.handle_frame(req(i, f"d{i % 3}", float(i))))
             for i in range(1, 7)]
    assert all(r["status"] == "ok" for r in first)
    backend.close()
    del a, srv  # the crash

    b = stack()
    b.restore()
    backend, srv = gateway(b)
    try:
        again = json.loads(srv.handle_frame(req(5, "d2", 5.0)))
        assert again["status"] == "ok" and again.get("dedup") is True
        assert again["value"] == first[4]["value"]
        assert srv.dedup.stats()["loads"] == 6
        assert backend.sum_all() == sum(range(1, 7))
        fresh = json.loads(srv.handle_frame(req(7, "d0", 7.0)))
        assert fresh["value"] == first[5]["value"] + 7.0  # d0: 3 + 6
    finally:
        backend.close()


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_region_journals_restore_in_the_other_package(tmp_path, monkeypatch,
                                                      writer):
    """A region's directory (npz snapshot, sidecar, WAL, entities.log,
    entity journal) written by one package restores in the other to the
    acked totals."""
    monkeypatch.setattr(jslab, "_try_orbax", lambda: None)
    d = str(tmp_path)
    mk = {"port": lambda: t_region("x-pkg"),
          "ref": lambda: JRegion(JEntity("x-pkg", jg.counter_behavior(P),
                                         **_SPEC_KW))}
    a = mk[writer]()
    a.attach_journal(d)
    a.attach_entity_journal(d)
    a.checkpoint()
    acked = ask_waves(a, _SEQ[:2])
    a.checkpoint()
    acked.update(ask_waves(a, _SEQ[2:]))
    del a

    reader = "port" if writer == "ref" else "ref"
    c = mk[reader]()
    c.attach_journal(d)
    c.attach_entity_journal(d)
    c.restore()
    assert c._durable_replayed_totals == acked
    assert totals(c, list(acked)) == acked


def checkpoint_mid_wave(region, sched, batch, d, crash_dir):
    """Submit `batch` as one continuous wave and checkpoint before its
    first round: the test holds `_ask_lock`, which the scheduler's runner
    takes for every round, across the staging instant and the barrier.
    `crash_dir` gets the directory as it stood then, which is what a
    kill -9 at that instant leaves on disk. The region runs on: the wave
    resolves and the scheduler closes. Returns the wave's slots."""
    with region._ask_lock:
        h = sched.submit_wave(batch)
        region.checkpoint()
        shutil.copytree(d, crash_dir)
    assert h.done.wait(30.0)
    sched.close()
    return [a.slot for a in batch]


def restore_from(mk, crash_dir):
    c = mk()
    c.attach_journal(crash_dir)
    c.attach_entity_journal(crash_dir)
    c.restore()
    return c


def test_slot_in_flight_at_checkpoint_is_reclaimed_after_restore(tmp_path):
    """An ask staged by the continuous scheduler but not yet stepped at
    the barrier holds a promise slot. The sidecar writes that slot as
    retired, so the restored region frees it once the late reply (the
    WAL's replayed ask) has latched, and a fresh ask on that slot gets
    its own reply."""
    d, crash = str(tmp_path / "live"), str(tmp_path / "crash")
    a = t_region("ej-fly")
    a.attach_journal(d)
    a.attach_entity_journal(d)
    acked = ask_waves(a, _SEQ[:1])
    ref = a.entity_ref("ej-a0")
    (slot,) = checkpoint_mid_wave(a, ContinuousWaveScheduler(a),
                                  [BatchAsk(ref.shard, ref.index, [5.0])],
                                  d, crash)
    assert a.ask_pool_stats()["in_flight"] == 0  # the live run freed it

    c = restore_from(lambda: t_region("ej-fly"), crash)
    before = c.ask_pool_stats()
    assert (before["retired"], before["in_flight"]) == (1, 1)
    assert c._promise_retired == [slot]
    base = c._promise_block * c.eps
    assert bool(c.system.state["__promise_replied"][base + slot])
    assert c._reclaim_promise_slots() == 1
    after = c.ask_pool_stats()
    assert (after["retired"], after["in_flight"], after["free"]) == \
        (0, 0, c.eps)
    assert c._promise_free[-1] == slot  # the next ask takes it
    # the unacked add is pinned away: the entity journal's fold rules
    assert totals(c, list(acked)) == acked
    got = ask_waves(c, [[("ej-a0", 1.0)]])
    assert got == {"ej-a0": acked["ej-a0"] + 1.0}
    assert c.ask_pool_stats()["in_flight"] == 0


@tb.behavior("blackhole", {"total": ((), torch.float32)})
def t_blackhole(state, inbox, ctx):
    """total += value; never replies."""
    return ({"total": state["total"] + inbox.sum[:, 0]},
            tb.Emit.none(inbox.count.shape[0], 1, P))


def test_blackhole_slot_in_flight_at_checkpoint_stays_retired(tmp_path):
    """The same, to an entity that never replies: no late reply ever
    latches, so the restored slot stays retired and counted in flight,
    as a live ask that timed out on a blackhole does. A fresh ask times
    out (it does not hang) and retires one slot more."""
    d, crash = str(tmp_path / "live"), str(tmp_path / "crash")
    mk = lambda: t_region("bh", behavior=t_blackhole)  # noqa: E731
    a = mk()
    a.attach_journal(d)
    a.attach_entity_journal(d)
    ref = a.entity_ref("bh-0")
    sched = ContinuousWaveScheduler(a)
    batch = [BatchAsk(ref.shard, ref.index, [5.0], max_extra_steps=2)]
    (slot,) = checkpoint_mid_wave(a, sched, batch, d, crash)
    assert isinstance(batch[0].outcome, TimeoutError)
    assert a.ask_pool_stats()["retired"] == 1  # the live run's view

    c = restore_from(mk, crash)
    assert c._promise_retired == [slot]
    assert c._reclaim_promise_slots() == 0
    st = c.ask_pool_stats()
    assert (st["retired"], st["in_flight"], st["free"]) == \
        (1, 1, c.eps - 1)
    (out,) = c.ask_many([(ref.shard, ref.index, [1.0])], max_extra_steps=2)
    assert isinstance(out, TimeoutError)
    st = c.ask_pool_stats()
    assert (st["retired"], st["in_flight"]) == (2, 2)


def test_reference_sidecar_leaks_a_slot_in_flight_at_checkpoint(tmp_path):
    """What the port's sidecar repairs: the reference writes a slot held
    by an in-flight ask as neither free nor retired, so its restored
    region counts it in flight for good, after the late reply has
    latched and the reclaim has run."""
    d, crash = str(tmp_path / "live"), str(tmp_path / "crash")
    mk = lambda: JRegion(JEntity("leak", jg.counter_behavior(P),  # noqa
                                 **_SPEC_KW))
    a = mk()
    a.attach_journal(d)
    a.attach_entity_journal(d)
    ask_waves(a, _SEQ[:1])
    ref = a.entity_ref("ej-a0")
    (slot,) = checkpoint_mid_wave(
        a, JContinuousWaveScheduler(a),
        [JBatchAsk(ref.shard, ref.index, [5.0])], d, crash)

    c = restore_from(mk, crash)
    base = c._promise_block * c.eps
    assert bool(np.asarray(c.system.state["__promise_replied"])[
        base + slot])
    c._reclaim_promise_slots()
    st = c.ask_pool_stats()
    assert slot not in c._promise_free and slot not in c._promise_retired
    assert (st["retired"], st["in_flight"], st["free"]) == \
        (0, 1, c.eps - 1)


@pytest.mark.parametrize("slots", [0, 2], ids=["reduce", "slots"])
def test_region_failover_two_slots_to_one_like_reference(tmp_path,
                                                         monkeypatch, slots):
    """Both packages' regions on 2 shard slots (the reference on 2 of its
    virtual devices) take the same ask waves, a checkpoint and more
    waves (a WAL tail), then fail over onto their first slot: the
    recovered step, every reply before and after, the totals, the
    durable fold, the slot pool and the carries are equal."""
    monkeypatch.setattr(jslab, "_try_orbax", lambda: None)
    import jax
    from akka_tpu.batched.sharded import ShardedBatchedSystem as JSharded
    from akka_tpu_torch.utils.carry import SHARDED_FIELDS, numpy_carry
    kw = {**_SPEC_KW, "n_devices": 2, "mailbox_slots": slots}
    regions = {"jax": JRegion(JEntity("fo", jg.counter_behavior(P), **kw)),
               "port": t_region("fo", **kw)}
    got = {}
    for pkg, r in regions.items():
        d = str(tmp_path / pkg)
        r.attach_journal(d)
        r.attach_entity_journal(d)
        first = ask_waves(r, _SEQ[:2])
        r.checkpoint()
        second = ask_waves(r, _SEQ[2:])
        survivors = (jax.devices()[:1] if pkg == "jax"
                     else list(r.system.mesh.slots[:1]))
        step = r.failover(survivors)
        assert (r.n_devices, r.blocks_per_device) == (1, r.total_blocks)
        third = ask_waves(r, _SEQ)
        got[pkg] = (first, second, step, third, r._durable_replayed_totals,
                    totals(r, sorted(third)), r.ask_pool_stats(),
                    r.system._host_step, r.system.n_shards)
    assert got["port"] == got["jax"]
    t = regions["port"]
    assert isinstance(regions["jax"].system, JSharded)
    assert [s.index for s in t.system.mesh.slots] == [0]
    carry = numpy_carry(t.system)
    jsys = regions["jax"].system
    for c, v in jsys.state.items():
        np.testing.assert_array_equal(carry[f"state/{c}"],
                                      np.asarray(jax.device_get(v)), c)
    for f in SHARDED_FIELDS:
        np.testing.assert_array_equal(
            carry[f], np.asarray(jax.device_get(getattr(jsys, f))), f)


def test_region_failover_needs_a_journal_and_a_divisor(tmp_path):
    """failover refuses without the journal, and onto a survivor count
    that does not divide the blocks; checkpoint and restore still need
    attach_journal."""
    region = t_region("fo", n_devices=2)
    slots = list(region.system.mesh.slots)
    with pytest.raises(RuntimeError, match="attach_journal"):
        region.failover(slots[:1])
    with pytest.raises(RuntimeError, match="attach_journal"):
        region.checkpoint()
    with pytest.raises(RuntimeError, match="attach_journal"):
        region.restore()
    big = t_region("fo3", n_devices=2, n_shards=3, spare_blocks=1)
    big.attach_journal(str(tmp_path))
    with pytest.raises(RuntimeError, match="cannot re-stripe 4 blocks"):
        big.failover(shard_slots(3, "cpu"))
