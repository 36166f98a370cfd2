"""The elastic mesh on the port: MeshSentinel.scale_to / expand and the
autoscaler (akka_tpu_torch/batched/{sentinel,autoscale}.py) held to the
reference's (akka_tpu/batched/{sentinel,autoscale}.py).

1. AutoscalePolicy's decisions over one pressure trace, the autoscaler's
   against a fake sentinel, and autoscaler_from_config's keys equal the
   reference's (no device).
2. scale_to walks 1 -> 2 -> 1 and 2 -> 4 -> 2 on both packages with
   asks in flight across each re-shard: states, reshard records without
   pause_s, recorder events and every ask's reply equal the reference's
   (each reference run compiles two shard counts, shared through a
   module-scoped fixture on the file's one fixture, `fleet`).
3. The port on its own: the background snapshot writer's file and WAL,
   rollback on a failed rebuild, refusals, the depth ladder's recovery,
   and the autoscaler widening and narrowing under real exchange drops.
"""

import itertools

import numpy as np
import pytest

from akka_tpu.batched import autoscale as ja
from akka_tpu.config import Config as JConfig
from akka_tpu.event.flight_recorder import \
    InMemoryFlightRecorder as JRecorder
from akka_tpu.event.metrics import MetricsRegistry as JRegistry

from akka_tpu_torch.batched import autoscale as ta
from akka_tpu_torch.batched.sentinel import SentinelHalted
from akka_tpu_torch.config import Config as TConfig
from akka_tpu_torch.event.flight_recorder import \
    InMemoryFlightRecorder as TRecorder
from akka_tpu_torch.event.metrics import MetricsRegistry as TRegistry
from akka_tpu_torch.persistence.slab_snapshot import latest_slab_path
from torch_sentinel_fixture import (Fleet, echo_pair, events, outcome,
                                    relay_pair, slots, sum_pair, untimed)

P = 2
J_ECHO, T_ECHO = echo_pair(P)
T_SUM = sum_pair(P)[1]       # the port-only tests' behaviors
T_RELAY = relay_pair(P)[1]


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    f = Fleet(tmp_path_factory.mktemp("autoscale"))
    try:
        yield f
    finally:
        f.close()


# ------------------------------------------------------- 1. the control plane
def pressure_trace(seed: int, n: int = 64):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        p = {}
        if rng.random() < 0.5:
            p["mailbox_overflow"] = float(rng.integers(0, 4))
        if rng.random() < 0.4:
            p["exchange_dropped"] = float(rng.integers(0, 6))
        if rng.random() < 0.5:
            p["ask_pool_occupancy"] = float(rng.random())
        if rng.random() < 0.2:
            p["mailbox_occupancy_p90"] = float(rng.integers(0, 64))
        out.append(p)
    return out


@pytest.mark.parametrize("kw", [
    {},
    {"widen_after": 1, "narrow_after": 3, "cooldown_polls": 0},
    {"min_shards": 2, "max_shards": 8, "widen_after": 2, "narrow_after": 4,
     "cooldown_polls": 2, "thresholds": {"exchange_dropped": 3.0,
                                         "mailbox_occupancy_p90": 16.0}},
], ids=["defaults", "eager", "bounded"])
def test_policy_decisions_match_reference(kw):
    """Both policies see the same trace; the width follows each decision
    and a re-shard arms the cooldown, as MeshAutoscaler does."""
    got = {}
    for name, mod in (("jax", ja), ("torch", ta)):
        pol = mod.AutoscalePolicy(**kw)
        width, seen = 2, []
        for p in pressure_trace(4):
            d = pol.observe(p, width)
            seen.append(None if d is None else
                        (d.direction, d.to_shards, d.signal, d.value))
            if d is not None:
                width = d.to_shards
                pol.note_resharded()
            seen.append((pol.pressured_polls, pol.quiet_polls))
        got[name] = seen
    assert got["torch"] == got["jax"]
    assert any(isinstance(x, tuple) and len(x) == 4 for x in got["torch"])


class FakeSystem:
    def __init__(self):
        self.mailbox_overflow = 0
        self.dropped_per_shard = np.zeros(2)
        self.metrics_on = False


class FakeSentinel:
    """The MeshSentinel surface the autoscaler reads: scale_to swaps the
    device list and appends a reshard record, or raises on demand."""

    def __init__(self, recorder, n=2, capacity=48):
        self.system = FakeSystem()
        self.devices = list(range(n))
        self.capacity = capacity
        self.halted = None
        self.promise_rows_n = 0
        self.reshard_stats = []
        self.flight_recorder = recorder
        self.fail_next = None

    def scale_to(self, devices, trigger="manual", signal="manual",
                 value=0.0):
        if self.fail_next is not None:
            exc, self.fail_next = self.fail_next, None
            raise exc
        old = len(self.devices)
        self.devices = list(devices)
        rec = {"direction": "grow" if len(devices) > old else "shrink",
               "from_shards": old, "to_shards": len(devices),
               "trigger": trigger, "signal": signal, "value": value,
               "step": 7, "pause_s": 0.25}
        self.reshard_stats.append(rec)
        return rec


@pytest.mark.parametrize("n, capacity", [(2, 48), (3, 48), (1, 7)])
def test_autoscaler_against_a_fake_sentinel_matches_reference(n,
                                                             capacity):
    """One overflow trace through both autoscalers (a failing scale_to in
    the middle): widths, records, stats, registry counters and recorder
    events equal."""
    got = {}
    for name, mod, recorder, registry in (("jax", ja, JRecorder, JRegistry),
                                          ("torch", ta, TRecorder,
                                           TRegistry)):
        fake = FakeSentinel(recorder(), n, capacity)
        reg = registry()
        auto = mod.MeshAutoscaler(
            fake, mod.AutoscalePolicy(widen_after=1, narrow_after=2,
                                      cooldown_polls=1),
            device_pool=list(range(8)), metrics_registry=reg)
        trace = []
        for i, ovf in enumerate([10, 99, 150, 150, 150, 400, 400, 400,
                                 400, 900, 900, 900, 900]):
            fake.system.mailbox_overflow = ovf
            if i == 5:
                fake.fail_next = RuntimeError("breaker open")
            rec = auto.poll()
            trace.append((list(fake.devices),
                          None if rec is None else untimed(rec)))
        snap = reg.snapshot()
        got[name] = (trace, auto.stats(), auto.skipped_infeasible,
                     auto.failed, snap["counters"],
                     {k: v for k, v in snap["collected"].items()
                      if k.startswith("autoscale")},
                     events(fake.flight_recorder))
    assert got["torch"] == got["jax"]


def test_from_config_keys_match_reference():
    assert ta.autoscaler_from_config(FakeSentinel(TRecorder()),
                                     TConfig({})) is None
    assert ta.autoscaler_from_config(FakeSentinel(TRecorder()), None) is None
    body = {"akka": {"autoscale": {
        "enabled": True, "min-shards": 2, "max-shards": 4,
        "widen-after-polls": 1, "narrow-after-polls": 5,
        "cooldown-polls": 3, "overflow-threshold": 5.0,
        "ask-occupancy-threshold": 0.5}}}
    got = {}
    for name, mod, config in (("jax", ja, JConfig), ("torch", ta, TConfig)):
        fake = FakeSentinel(TRecorder())
        auto = mod.autoscaler_from_config(fake, config(body),
                                          device_pool=list(range(8)))
        pol = auto.policy
        got[name] = (pol.min_shards, pol.max_shards, pol.widen_after,
                     pol.narrow_after, pol.cooldown_polls,
                     dict(pol.thresholds), auto.device_pool)
    assert got["torch"] == got["jax"]
    assert got["torch"][5]["mailbox_occupancy_p90"] == float("inf")


# --------------------------------------------------------- 2. scale_to walks
WALKS = [(1, 2, 1), (2, 4, 2)]


@pytest.fixture(scope="module", params=WALKS, ids=["1-2-1", "2-4-2"])
def walk_runs(request, fleet):
    """Both packages walk the widths with tells and asks in flight across
    each re-shard (one delivered, its reply in flight; one staged)."""
    walk = request.param
    out = {}
    for pkg in ("jax", "torch"):
        fr = JRecorder() if pkg == "jax" else TRecorder()
        # a clock that stands still: no ask deadline passes however long
        # the reference takes to compile a new shard count
        kw = dict(payload_width=P, checkpoint_interval_steps=4,
                  pipeline_depth=2, promise_rows=4,
                  failover_min_backoff=0.0, flight_recorder=fr,
                  clock=lambda: 0.0)
        b = J_ECHO if pkg == "jax" else T_ECHO
        tag = "walk-" + "-".join(map(str, walk))
        if pkg == "jax":
            s = fleet.ref(tag, 16, [b], devices=walk[0], **kw)
            widths = {w: __import__("jax").devices()[:w] for w in walk}
        else:
            s = fleet.port(tag, 16, [b], devices=slots(walk[0]), **kw)
            widths = {w: slots(w) for w in walk}
        s.spawn(0, 8)
        base = s._promise_base + s.promise_rows_n
        futs, recs = [], []
        for i in range(8):
            s.tell(base + i, [float(i + 1), 0.0])
        s.step(2)
        for w in walk[1:]:
            futs.append(s.ask(base + len(futs) % 8, [3.0 + len(futs), 0.0],
                              timeout=5.0))
            s.step(1)  # delivered: the reply is in flight
            futs.append(s.ask(base + 5, [10.0, 0.0], timeout=5.0))  # staged
            recs.append(s.scale_to(widths[w], trigger="test",
                                   signal="mailbox_overflow", value=9.0))
            for i in range(8):
                s.tell(base + i, [1.0, 0.0])
            s.step(2)
        s.step(2)
        out[pkg] = {"s": s, "fr": fr, "recs": recs,
                    "outcomes": [outcome(f) for f in futs],
                    "seen": np.asarray(s.read_state("seen",
                                                    np.arange(base,
                                                              base + 8))),
                    "shards": s.system.n_shards}
    return walk, out


def test_scale_to_walk_matches_reference(walk_runs):
    walk, out = walk_runs
    j, t = out["jax"], out["torch"]
    np.testing.assert_array_equal(t["seen"], j["seen"])
    assert t["shards"] == j["shards"] == walk[-1]
    assert [untimed(r) for r in t["recs"]] == [untimed(r) for r in j["recs"]]
    assert [r["direction"] for r in t["recs"]] == ["grow", "shrink"]
    assert all(r["pause_s"] > 0 for r in t["recs"])
    assert events(t["fr"]) == events(j["fr"])
    st = t["s"].sentinel_stats()
    assert st["reshards"] == 2 and st["last_reshard_pause_ms"] > 0


def test_asks_in_flight_survive_each_reshard_like_reference(walk_runs):
    _walk, out = walk_runs
    got, want = out["torch"]["outcomes"], out["jax"]["outcomes"]
    assert got == want
    assert all(isinstance(o, tuple) and o[0] == "ok" for o in got), got


# ---------------------------------------------------- 3. the port on its own
LOCAL = itertools.count()  # a checkpoint directory per local sentinel


@pytest.fixture
def port(fleet):
    """Port sentinels built on the module's fleet."""
    def build(n_dev=1, b=T_SUM, **kw):
        kw.setdefault("payload_width", P)
        kw.setdefault("checkpoint_interval_steps", 4)
        kw.setdefault("pipeline_depth", 2)
        kw.setdefault("promise_rows", 4)
        kw.setdefault("failover_min_backoff", 0.0)
        return fleet.port(f"local-{next(LOCAL)}", kw.pop("capacity", 16),
                          [b], devices=slots(n_dev), **kw)
    return build


def test_snapshot_writer_writes_the_barrier_and_compacts(port):
    """The re-shard's snapshot is written off the pause by the writer
    thread from host copies: it lands at the barrier step, holds the
    state at the barrier even though steps ran on meanwhile, and the WAL
    keeps only records from that step on."""
    s = port(1)
    base = s._promise_base + s.promise_rows_n
    s.spawn(0, 4)
    for i in range(4):
        s.tell(base + i, [float(i + 1), 0.0])
    s.step(6)
    rec = s.scale_to(slots(2))
    for i in range(4):
        s.tell(base + i, [100.0, 0.0])
    s.step(3)
    s._snapshot_writer.join(10.0)
    path = latest_slab_path(s.checkpoint_dir)
    assert path.endswith(f"slab-{rec['step']}.npz")
    snap = np.load(path)
    np.testing.assert_array_equal(snap["state.total"][base:base + 4],
                                  [1.0, 2.0, 3.0, 4.0])
    steps = [r["step"] for r in s._journal.records()]
    assert steps and min(steps) >= rec["step"]
    np.testing.assert_array_equal(
        s.read_state("total", np.arange(base, base + 4)),
        [101.0, 102.0, 103.0, 104.0])


def test_failed_rebuild_rolls_back_and_counts(port, monkeypatch):
    s = port(2, failover_min_backoff=60.0)
    s.spawn(0, 4)
    s.step(2)
    old = s.system

    def broken(devices):
        raise RuntimeError("no memory for the wider mesh")

    monkeypatch.setattr(s, "_build_system", broken)
    with pytest.raises(RuntimeError, match="no memory"):
        s.scale_to(slots(4))
    assert s.system is old and s.devices == slots(2)
    assert s._scale_failures == 1
    monkeypatch.undo()
    with pytest.raises(RuntimeError, match="anti-thrash"):
        s.scale_to(slots(4))  # the backoff window after a failure
    s.step(1)  # the old mesh still serves


def test_scale_to_refusals(port):
    s = port(2, capacity=12)
    s.spawn(0, 4)
    s.step(1)
    assert s.scale_to(slots(2)) is None  # already the mesh
    with pytest.raises(ValueError, match="not divisible by 5"):
        s.scale_to(slots(5))
    with pytest.raises(ValueError, match="zero devices"):
        s.scale_to([])
    assert s.expand(slots(2)) is None  # idempotent re-announce
    rec = s.expand(slots(4)[2:3])
    assert rec["to_shards"] == 3 and rec["trigger"] == "device_rejoined"
    s.force_evict([0, 1, 2])
    assert s.halted is not None
    with pytest.raises(SentinelHalted):
        s.scale_to(slots(1))


def test_depth_ladder_recovers_after_healthy_drains(port):
    fr = TRecorder()
    s = port(1, flight_recorder=fr)
    s.spawn(0, 4)
    s.depth_recovery_rounds = 3
    s._depth = 1
    s.step(3)
    assert s.pipeline_depth == 2
    assert [e for e in fr.events()
            if e["event"] == "pipeline_depth_restored"
            and e["from_depth"] == 1 and e["to_depth"] == 2]
    s2 = port(1, depth_recovery_rounds=0)
    s2.spawn(0, 4)
    s2._depth = 1
    s2.step(4)
    assert s2.pipeline_depth == 1


def test_autoscaler_widens_and_narrows_under_real_pressure(port):
    """Relays on slot 1 of a 2-slot mesh overload the (1 -> 0) exchange
    pair (2 rows a step): the attached autoscaler widens to 4 slots, then
    the quiet window narrows it back; every decision is in the recorder
    and the registry. The default pool is 8 slots on the sentinel's
    card."""
    n = 32
    fr, reg = TRecorder(), TRegistry()
    s = port(2, b=T_RELAY, capacity=n, promise_rows=0,
             checkpoint_interval_steps=8, remote_capacity_per_pair=2,
             flight_recorder=fr)
    s.spawn(0, n)
    auto = ta.MeshAutoscaler(
        s, ta.AutoscalePolicy(min_shards=2, max_shards=4, widen_after=2,
                              narrow_after=4, cooldown_polls=1,
                              thresholds={"exchange_dropped": 3.0}),
        metrics_registry=reg)
    assert auto.device_pool == slots(8)
    s.attach_autoscaler(auto)
    for _ in range(12):
        for i in range(8):
            s.tell(n // 2 + i, [1.0, 0.0])
        s.step(1)
        if len(s.devices) == 4:
            break
    assert s.devices == slots(4)
    ev = fr.of_type("autoscale_decision")
    assert ev and ev[0]["direction"] == "widen"
    assert ev[0]["signal"] == "exchange_dropped" and ev[0]["value"] > 3.0
    assert fr.of_type("mesh_expanded") and fr.of_type("device_rejoined")
    assert reg.snapshot()["counters"]["autoscale_widen_total"] == 1
    for _ in range(20):
        s.step(1)
        if len(s.devices) == 2:
            break
    assert s.devices == slots(2)
    assert reg.snapshot()["counters"]["autoscale_narrow_total"] == 1
    st = auto.stats()
    assert st["widened"] == 1 and st["narrowed"] == 1
    assert s.read_state("seen", np.arange(n)).sum() > 0
