"""Shard failure detection and failover (MeshSentinel) on the port
(akka_tpu_torch/batched/sentinel.py, shard slots of one card, here the
CPU) held to the reference's (akka_tpu/batched/sentinel.py, on 4 of its 8
virtual devices): the same behaviors, spawns, tells, asks and
DeviceLossInjector seed go through both, and the states, the failover
records without their times, the recorder's events, the asks' outcomes
and the breaker's halt must agree (float32 sums of small integers, so
bit-identical). Detection runs on an injected manual clock on both.

Each reference run compiles one sharded step per shard count, so each
uses two (4 and 3) and is shared through module-scoped fixtures built
on the file's one fixture, `fleet`, which shuts every sentinel down and
checks that no thread it started is left.

Seeds are scanned, as the reference's tests do: the loss schedule is a
pure function of (seed, step, shard), and a loss on the last shard cannot
re-fire once the mesh is renumbered (tests/test_failover.py's docstring).
"""

import shutil

import numpy as np
import pytest
import torch

from akka_tpu.event.flight_recorder import \
    InMemoryFlightRecorder as JRecorder
from akka_tpu.testkit import chaos as jchaos

from akka_tpu_torch.batched.sentinel import MeshSentinel, SentinelHalted
from akka_tpu_torch.event.flight_recorder import \
    InMemoryFlightRecorder as TRecorder
from akka_tpu_torch.parallel import ShardSlot
from akka_tpu_torch.testkit import chaos as tchaos
from torch_sentinel_fixture import (Fleet, echo_pair, events, outcome,
                                    slots, sum_pair, untimed)

P = 4
N = 8          # actors
CAP = 48       # divides by 4, 3, 2 and 1
NDEV = 4
DT = 0.1       # manual-clock seconds per drive iteration
DETECT = dict(detector_threshold=3.0, heartbeat_interval=DT,
              acceptable_pause=3 * DT)
J_SUM, T_SUM = sum_pair(P)
J_ECHO, T_ECHO = echo_pair(P)
PKGS = {"jax": (JRecorder, jchaos), "torch": (TRecorder, tchaos)}


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    f = Fleet(tmp_path_factory.mktemp("failover"))
    try:
        yield f
    finally:
        f.close()


def make(fleet, pkg, tag, b, clk, **kw):
    args = dict(n_devices=NDEV, payload_width=P,
                checkpoint_interval_steps=4, pipeline_depth=2,
                failover_min_backoff=0.35, clock=lambda: clk["t"], **DETECT)
    args.update(kw)
    build = fleet.ref if pkg == "jax" else fleet.port
    return build(tag, CAP, [b], **args)


def tell_schedule(seed, n, steps, every=3):
    rng = np.random.default_rng(seed)
    return {s: (int(rng.integers(0, n)), float(1 + s % 5))
            for s in range(0, steps, every)}


def sum_oracle(sched, n, upto):
    """A tell staged at host step c is delivered by dispatch c + 1."""
    out = np.zeros(n, np.float32)
    for s, (dst, val) in sched.items():
        if s <= upto - 1:
            out[dst] += val
    return out


def drive(sent, sched, upto, staged, clk, chunk=1):
    """Step `sent` to host step `upto`, staging scheduled tells at their
    step counters; `staged` persists across failovers (the WAL replay
    re-stages journaled tells after a rewind)."""
    while sent.host_step < upto:
        hs = sent.host_step
        if hs in sched and hs not in staged:
            dst, val = sched[hs]
            pl = np.zeros(P, np.float32)
            pl[0] = val
            sent.tell(dst, pl)
            staged.add(hs)
        nxt = min([s for s in sched if s > hs and s not in staged] + [upto])
        k = max(1, min(chunk, nxt - hs, upto - hs))
        clk["t"] += DT * k
        sent.step(k)


def pick_seed(horizon, rate=0.012, lo=6, hi=16, shard=NDEV - 1):
    """A seed whose only scheduled loss in the horizon hits `shard`
    mid-run."""
    for seed in range(30000):
        g = tchaos.loss_schedule_np(seed, horizon + 1, NDEV, rate)
        hits = np.argwhere(g)
        if len(hits) == 1 and hits[0][1] == shard and \
                lo <= hits[0][0] <= hi:
            return seed, int(hits[0][0])
    raise AssertionError("no single-loss seed in the scan range")


# ------------------------------------------------- automatic 4 -> 3 failover
BACKENDS = [(None, None, "staging"), ("reference", "ranked", "pipeline-full")]


@pytest.fixture(scope="module", params=BACKENDS,
                ids=["default-staging", "ranked-pipeline-full"])
def auto_runs(request, fleet):
    """Both packages through the reference's tentpole scenario: a chaos
    loss on the last shard mid-run, detected from the frozen progress
    lane, failed over 4 -> 3 from snapshot + WAL with no manual call."""
    j_backend, t_backend, phase = request.param
    horizon = 40
    seed, t1 = pick_seed(horizon)
    sched = tell_schedule(seed, N, horizon)
    chunk, depth = (1, 2) if phase == "staging" else (3, 3)
    out = {}
    for pkg, b, backend in (("jax", J_SUM, j_backend),
                            ("torch", T_SUM, t_backend)):
        recorder, chaos = PKGS[pkg]
        clk, fr = {"t": 0.0}, recorder()
        s = make(fleet, pkg, f"auto-{phase}", b, clk, pipeline_depth=depth,
                 delivery_backend=backend, flight_recorder=fr,
                 injector=chaos.DeviceLossInjector(seed, NDEV,
                                                   loss_rate=0.012))
        rows = s.spawn(0, N)
        drive(s, sched, horizon, set(), clk, chunk)
        out[pkg] = {"s": s, "fr": fr, "rows": rows,
                    "total": np.asarray(s.read_state("total", rows)),
                    "word": s.read_attention()}
    return out, sched, horizon, t1


def test_auto_failover_state_matches_reference_and_oracle(auto_runs):
    runs, sched, horizon, _t1 = auto_runs
    j, t = runs["jax"], runs["torch"]
    assert t["total"].dtype == j["total"].dtype == np.float32
    np.testing.assert_array_equal(t["total"], j["total"])
    np.testing.assert_array_equal(t["total"], sum_oracle(sched, N, horizon))
    assert t["s"].system.n_shards == NDEV - 1
    assert [d.index for d in t["s"].devices] == [0, 1, 2]
    # the degraded mesh keeps heartbeating: 3 live progress lanes
    for r in (j, t):
        assert r["word"]["progress_per_shard"].shape == (NDEV - 1,)
        assert (r["word"]["progress_per_shard"] > 0).all()
    np.testing.assert_array_equal(t["word"]["progress_per_shard"],
                                  j["word"]["progress_per_shard"])


def test_auto_failover_records_and_events_match_reference(auto_runs):
    runs, _sched, _horizon, t1 = auto_runs
    js, ts = runs["jax"]["s"], runs["torch"]["s"]
    jst, tst = js.sentinel_stats(), ts.sentinel_stats()
    assert tst["failovers"] == 1 and tst["halted"] is None
    assert [untimed(r) for r in tst.pop("failover_stats")] == \
        [untimed(r) for r in jst.pop("failover_stats")]
    tst.pop("last_reshard_pause_ms"), jst.pop("last_reshard_pause_ms")
    assert tst == jst
    st = ts.failover_stats[0]
    assert st["lost_shards"] == [NDEV - 1]
    assert st["detector"] == "phi-accrual"
    assert st["evicted_at_step"] >= t1  # never before the loss fires
    assert st["mttr_s"] is not None and st["mttr_s"] > 0
    assert st["rebuild_s"] > 0
    got, want = events(runs["torch"]["fr"]), events(runs["jax"]["fr"])
    assert got == want
    names = [e["event"] for e in got]
    for ev in ("device_suspected", "device_evicted", "failover_completed"):
        assert names.count(ev) == 1, ev


# ------------------------------------------------- a forced one, and asks
@pytest.fixture(scope="module")
def ask_runs(fleet):
    """The reference's ask scenario on both: an ask resolves, one to a
    row that never replies times out on the sentinel clock, an ask in
    flight at a forced eviction fails fast with RecoveredAskLost, and the
    rebuilt system answers fresh asks."""
    out = {}
    for pkg, b in (("jax", J_ECHO), ("torch", T_ECHO)):
        recorder, _ = PKGS[pkg]
        clk, fr = {"t": 0.0}, recorder()
        s = make(fleet, pkg, "ask", b, clk, promise_rows=8,
                 flight_recorder=fr)
        rows = s.spawn(0, N)
        got = []
        fut = s.ask(int(rows[2]), np.array([21.0, 0, 0], np.float32),
                    timeout=50.0)
        clk["t"] += 2 * DT
        s.step(2)  # deliver, reply, latch, resolve at the drain
        got.append(outcome(fut))
        dead = s.ask(int(rows[0]) + CAP // 2, np.array([1.0], np.float32),
                     timeout=0.5)
        for _ in range(8):
            clk["t"] += DT
            s.step(1)
        got.append(outcome(dead))
        lost = s.ask(int(rows[3]), np.array([7.0, 0, 0], np.float32),
                     timeout=50.0)
        also = s.ask(int(rows[5]), np.array([3.0, 0, 0], np.float32),
                     timeout=50.0)
        s.force_evict([NDEV - 1])
        got += [outcome(lost), outcome(also)]
        fresh = s.ask(int(rows[2]), np.array([4.0, 0, 0], np.float32),
                      timeout=50.0)
        clk["t"] += 2 * DT
        s.step(2)
        got.append(outcome(fresh))
        out[pkg] = {"s": s, "fr": fr, "rows": rows, "outcomes": got,
                    "seen": np.asarray(s.read_state("seen", rows))}
    return out


def test_asks_resolve_time_out_and_fail_fast_like_reference(ask_runs):
    j, t = ask_runs["jax"], ask_runs["torch"]
    assert t["outcomes"] == j["outcomes"]
    assert t["outcomes"] == [("ok", 42.0), "AskTimeoutException",
                             "RecoveredAskLost", "RecoveredAskLost",
                             ("ok", 8.0)]
    np.testing.assert_array_equal(t["seen"], j["seen"])


def test_forced_failover_records_match_reference(ask_runs):
    js, ts = ask_runs["jax"]["s"], ask_runs["torch"]["s"]
    jst = [untimed(r) for r in js.failover_stats]
    tst = [untimed(r) for r in ts.failover_stats]
    assert tst == jst
    assert tst[0]["detector"] == "manual" and tst[0]["survivors"] == 3
    assert events(ask_runs["torch"]["fr"]) == events(ask_runs["jax"]["fr"])
    # the promise pool is whole again after the rebuild's reset
    assert sorted(ts._promise_free) == sorted(js._promise_free)


# ------------------------------------------------------- the breaker's halt
@pytest.fixture(scope="module")
def halt_runs(fleet):
    """max_failovers=1: the first eviction fails over 4 -> 3 and trips
    the breaker; the next suspicion halts instead of failing over."""
    out = {}
    for pkg, b in (("jax", J_SUM), ("torch", T_SUM)):
        recorder, _ = PKGS[pkg]
        clk, fr = {"t": 0.0}, recorder()
        s = make(fleet, pkg, "halt", b, clk, flight_recorder=fr,
                 max_failovers=1, pipeline_depth=4,
                 failover_min_backoff=0.01)
        rows = s.spawn(0, N)
        s.tell(int(rows[0]), np.array([1.0, 0, 0, 0], np.float32))
        s.step(2)
        s.force_evict([3])
        s.step(1)
        s.force_evict([1])
        raised = []
        for call in (lambda: s.step(1),
                     lambda: s.tell(int(rows[0]), np.ones(P, np.float32))):
            try:
                call()
                raised.append(None)
            except SentinelHalted as e:  # the port's class
                raised.append(("port", str(e)))
            except Exception as e:  # noqa: BLE001 — the reference's class
                raised.append((type(e).__name__, str(e)))
        out[pkg] = {"s": s, "fr": fr, "raised": raised,
                    "total": np.asarray(s.read_state("total", rows))}
    return out


def test_breaker_halts_after_max_failovers_like_reference(halt_runs):
    j, t = halt_runs["jax"], halt_runs["torch"]
    assert t["s"].halted == j["s"].halted
    assert "failover breaker open after 1 failovers" in t["s"].halted
    assert [r[1] for r in t["raised"]] == [r[1] for r in j["raised"]]
    assert [r[0] for r in t["raised"]] == ["port", "port"]
    assert [r[0] for r in j["raised"]] == ["SentinelHalted"] * 2
    jst, tst = j["s"].sentinel_stats(), t["s"].sentinel_stats()
    assert [untimed(r) for r in tst.pop("failover_stats")] == \
        [untimed(r) for r in jst.pop("failover_stats")]
    assert tst == jst
    assert events(t["fr"]) == events(j["fr"])
    assert [e["event"] for e in events(t["fr"])].count(
        "failover_halted") == 1
    np.testing.assert_array_equal(t["total"], j["total"])


# ------------------------------------------------------------ carried state
@pytest.fixture(scope="module")
def carried(fleet, tmp_path_factory):
    """The reference's sentinel runs on 4 devices to step 10 (snapshots
    every 4 steps, the WAL on), then fails over onto 3; a copy of its
    directory taken at that moment restores into a fresh port sentinel
    through its own forced eviction onto 3 slots, and both run on with
    the same tells."""
    seed, horizon, cut = 11, 20, 10
    sched = tell_schedule(seed, N, horizon, every=2)
    clk = {"t": 0.0}
    ref = make(fleet, "jax", "carried", J_SUM, clk)
    ref.spawn(0, N)
    staged = set()
    drive(ref, sched, cut, staged, clk)
    copy = tmp_path_factory.mktemp("carried") / "ref-dir"
    shutil.copytree(ref.checkpoint_dir, copy)
    ref.force_evict([NDEV - 1])
    port = make(fleet, "torch", "carried", T_SUM, clk,
                checkpoint_dir=str(copy))
    port.spawn(0, N)
    port.force_evict([NDEV - 1])
    restored = (ref.failover_stats[0]["restored_step"],
                port.failover_stats[0]["restored_step"])
    for s in (ref, port):
        drive(s, sched, horizon, set(staged), clk)
    return ref, port, restored, sched, horizon


def test_reference_snapshot_and_wal_fail_over_into_the_port(carried):
    ref, port, restored, sched, horizon = carried
    assert restored[1] == restored[0] > 0
    assert port.system.n_shards == ref.system.n_shards == NDEV - 1
    want = np.asarray(ref.read_state("total", np.arange(N)))
    got = port.read_state("total", np.arange(N))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, sum_oracle(sched, N, horizon))


# -------------------------------------------------- the port on its own
@pytest.fixture
def local(fleet):
    """Port sentinels built on the module's fleet."""
    def build(tag, b=T_SUM, clk=None, **kw):
        clk = clk if clk is not None else {"t": 0.0}
        return make(fleet, "torch", tag, b, clk, **kw), clk
    return build


def test_mid_backoff_second_loss_cascades_to_two_slots(local):
    """A second loss inside the post-failover backoff window is deferred,
    then acted on: 4 -> 3 -> 2 slots, depth degraded, oracle-exact."""
    horizon, rate = 60, 0.012
    seed = None
    for cand in range(30000):
        g = tchaos.loss_schedule_np(cand, horizon + 1, NDEV, rate)
        hits = sorted((int(t), int(s)) for t, s in np.argwhere(g))
        if (len(hits) == 2 and hits[0][1] == 3 and hits[1][1] == 2
                and 6 <= hits[0][0] <= 14
                and hits[0][0] + 10 <= hits[1][0] <= hits[0][0] + 16):
            seed = cand
            break
    assert seed is not None
    sched = tell_schedule(seed, N, horizon)
    fr = TRecorder()
    s, clk = local("cascade", flight_recorder=fr,
                   injector=tchaos.DeviceLossInjector(seed, NDEV,
                                                      loss_rate=rate),
                   failover_min_backoff=1.2, max_failovers=5)
    rows = s.spawn(0, N)
    drive(s, sched, horizon, set(), clk)
    assert s.sentinel_stats()["failovers"] == 2
    assert [d.index for d in s.devices] == [0, 1]
    assert len(fr.of_type("device_suspected")) == 2
    assert [e["shard"] for e in fr.of_type("device_evicted")] == [3, 2]
    f1, f2 = s.failover_stats
    assert f2["at_clock"] - f1["at_clock"] >= 2.4
    assert f2["pipeline_depth"] < f1["pipeline_depth"]
    np.testing.assert_array_equal(s.read_state("total", rows),
                                  sum_oracle(sched, N, horizon))


def test_poll_deadline_evicts_the_stalest_slot(local):
    fr = TRecorder()
    s, clk = local("poll", flight_recorder=fr)
    s.spawn(0, N)
    for _ in range(3):
        clk["t"] += DT
        s.step(1)
    s.poll()
    assert s.sentinel_stats()["failovers"] == 0  # healthy: a no-op
    clk["t"] += 10.0  # the pump goes silent past the deadline
    s.poll()
    assert s.sentinel_stats()["failovers"] == 1
    assert fr.of_type("device_suspected")[0]["detector"] == "deadline"
    assert len(s.devices) == NDEV - 1


def test_survivor_count_that_does_not_divide_capacity_halts(fleet):
    """Capacity 8 on 4 slots: 3 survivors cannot hold the id space, so
    the sentinel halts with the reference's reason instead of
    renumbering actors; the system keeps its rows."""
    fr = TRecorder()
    s = fleet.port("indivisible", 8, [T_SUM], n_devices=4, payload_width=P,
                   flight_recorder=fr)
    rows = s.spawn(0, 8)
    s.tell(int(rows[5]), np.array([2.0, 0, 0, 0], np.float32))
    s.step(2)
    s.force_evict([2])
    assert "not divisible by the surviving shard count 3" in s.halted
    assert len(fr.of_type("failover_halted")) == 1
    with pytest.raises(SentinelHalted):
        s.step(1)
    np.testing.assert_array_equal(s.read_state("total", rows),
                                  [0, 0, 0, 0, 0, 2.0, 0, 0])


def test_disabled_injector_is_bit_invisible(local):
    """An armed but disabled injector changes nothing: totals, attention
    words and counters equal a sentinel with none."""
    sched = tell_schedule(5, N, 12)
    off = tchaos.DeviceLossInjector(62, NDEV, loss_rate=0.9, enabled=False)
    runs = []
    for tag, inj in (("armed", off), ("bare", None)):
        s, clk = local(f"quiet-{tag}", injector=inj)
        rows = s.spawn(0, N)
        drive(s, sched, 12, set(), clk)
        runs.append((s.read_state("total", rows),
                     s.system.attention.numpy().copy(),
                     s.system.dropped_per_shard,
                     s.sentinel_stats()["failovers"]))
    for a, b in zip(runs[0][:3], runs[1][:3]):
        np.testing.assert_array_equal(a, b)
    assert runs[0][3] == runs[1][3] == 0
    np.testing.assert_array_equal(runs[0][0], sum_oracle(sched, N, 12))


def test_slots_of_one_card_only(fleet):
    """The default slots are the first n of an 8-slot pool on the card;
    slots on two cards of one rank are refused (one process per card),
    and slots over several ranks naming ROADMAP A10.3 (this machine has
    no card, so a CUDA default raises)."""
    s = fleet.port("defaults", 16, [T_SUM], n_devices=2, payload_width=P)
    assert s.devices == slots(2) and s.device == torch.device("cpu")
    assert s.system.mesh.slots == tuple(slots(2))
    with pytest.raises(NotImplementedError, match="one card per process"):
        MeshSentinel(16, [T_SUM], checkpoint_dir=str(fleet.root / "x"),
                     devices=[ShardSlot(0, torch.device("cuda", 0)),
                              ShardSlot(1, torch.device("cuda", 1))])
    cpu = torch.device("cpu")
    with pytest.raises(NotImplementedError, match="A10.3"):
        MeshSentinel(16, [T_SUM], checkpoint_dir=str(fleet.root / "z"),
                     devices=[ShardSlot(0, cpu), ShardSlot(1, cpu, 1)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MeshSentinel(16, [T_SUM], checkpoint_dir=str(fleet.root / "y"),
                         n_devices=2)
