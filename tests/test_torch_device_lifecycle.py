"""Device lifecycle and the depth-k pump of the port's bridge, held to
the reference (akka_tpu) on the CPU: row free lists, stop/respawn
generations and the generation guard (through BatchedSystem and through
a DeviceActorRef of an ActorSystem), device-side become, the error lane
with host-mediated restart/stop/suspend (the sharded error lane is held
in tests/test_torch_sharded.py), a handle checkpoint restored by the other package in both directions, and the
pump's scenarios of tests/test_bridge.py: an ask timing out with steps in
flight, a rebuild racing a full pipeline, and depth-1 against depth-4
runs of one chaos schedule (the port's "ranked" and "auto" backends
against the reference's, and the numpy chaos oracle).

Integer state, counts, generations and dead-letter counts must be
bit-identical; float state within rtol 1e-4 / atol 1e-3. Every
ActorSystem, handle and thread starts through the `actors` fixture
(tests/torch_actor_fixture.py), which ends them and asserts that no
thread the test started is still alive; every wait has a 10 s timeout.
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import akka_tpu.batched as jb
from akka_tpu.batched import bridge as jbridge
from akka_tpu.pattern.ask import AskTimeoutException as JAskTimeout

import akka_tpu_torch.batched as tb
from akka_tpu_torch.batched import bridge as tbridge
from akka_tpu_torch.pattern.ask import AskTimeoutException as TAskTimeout

from torch_actor_fixture import Actors, host, state_of, steps_of

RTOL, ATOL = 1e-4, 1e-3
P = 4
TIMEOUT = 10.0  # every ask, result() and wait
CFG = {"akka": {"stdout-loglevel": "OFF", "log-dead-letters": 0,
                "actor": {"tpu-dispatcher": {
                    "device": "cpu", "capacity": 256, "payload-width": 8,
                    "mailbox-slots": 4, "host-inbox": 256,
                    "promise-rows": 16}}}}


@pytest.fixture()
def actors():
    a = Actors(CFG)
    try:
        yield a
    finally:
        a.close()


# ------------------------------------------------------- behaviors, twice
@jb.behavior("counter", {"n": ((), jnp.int32)})
def j_counter(state, inbox, ctx):
    return ({"n": state["n"] + inbox.count}, jb.Emit.none(1, P))


@tb.behavior("counter", {"n": ((), torch.int32)})
def t_counter(state, inbox, ctx):
    return ({"n": state["n"] + inbox.count},
            tb.Emit.none(ctx.actor_id.shape[0], 1, P))


@jb.behavior("doubler", {"n": ((), jnp.int32)})
def j_doubler(state, inbox, ctx):
    return ({"n": state["n"] + 2 * inbox.count}, jb.Emit.none(1, P))


@tb.behavior("doubler", {"n": ((), torch.int32)})
def t_doubler(state, inbox, ctx):
    return ({"n": state["n"] + 2 * inbox.count},
            tb.Emit.none(ctx.actor_id.shape[0], 1, P))


@jb.behavior("flipper", {"n": ((), jnp.int32), "_become": ((), jnp.int32)})
def j_flipper(state, inbox, ctx):
    return ({"n": state["n"] + inbox.count,
             "_become": jnp.where(inbox.count > 0, 1, -1)},
            jb.Emit.none(1, P))


@tb.behavior("flipper", {"n": ((), torch.int32),
                         "_become": ((), torch.int32)})
def t_flipper(state, inbox, ctx):
    return ({"n": state["n"] + inbox.count,
             "_become": torch.where(inbox.count > 0, 1, -1).to(torch.int32)},
            tb.Emit.none(ctx.actor_id.shape[0], 1, P))


@jb.behavior("fragile", {"n": ((), jnp.int32), "_failed": ((), jnp.bool_)})
def j_fragile(state, inbox, ctx):
    poison = (inbox.count > 0) & (inbox.sum[0] < 0)
    return ({"n": state["n"] + inbox.count,
             "_failed": state["_failed"] | poison}, jb.Emit.none(1, P))


@tb.behavior("fragile", {"n": ((), torch.int32),
                         "_failed": ((), torch.bool)})
def t_fragile(state, inbox, ctx):
    poison = (inbox.count > 0) & (inbox.sum[:, 0] < 0)
    return ({"n": state["n"] + inbox.count,
             "_failed": state["_failed"] | poison},
            tb.Emit.none(ctx.actor_id.shape[0], 1, P))


@jb.behavior("acc", {"n": ((), jnp.int32), "total": ((), jnp.float32)})
def j_acc(state, inbox, ctx):
    return ({"n": state["n"] + inbox.count,
             "total": state["total"] + inbox.sum[0]}, jb.Emit.none(1, P))


@tb.behavior("acc", {"n": ((), torch.int32), "total": ((), torch.float32)})
def t_acc(state, inbox, ctx):
    return ({"n": state["n"] + inbox.count,
             "total": state["total"] + inbox.sum[:, 0]},
            tb.Emit.none(ctx.actor_id.shape[0], 1, P))


@jb.behavior("echo2", {})
def j_echo2(state, inbox, ctx):
    return state, jb.Emit.single(jb.reply_dst(inbox.sum), inbox.sum * 2, 1,
                                 P, when=inbox.count > 0)


@tb.behavior("echo2", {})
def t_echo2(state, inbox, ctx):
    return state, tb.Emit.single(tb.reply_dst(inbox.sum), inbox.sum * 2, 1,
                                 P, when=inbox.count > 0)


@jb.behavior("mute", {})
def j_mute(state, inbox, ctx):
    return state, jb.Emit.none(1, P)


@tb.behavior("mute", {})
def t_mute(state, inbox, ctx):
    return state, tb.Emit.none(ctx.actor_id.shape[0], 1, P)


def systems(cap, behaviors, **kw):
    """A port and a reference BatchedSystem of one config."""
    t = tb.BatchedSystem(capacity=cap, behaviors=[b[0] for b in behaviors],
                         payload_width=P, device="cpu", **kw)
    j = jb.BatchedSystem(capacity=cap, behaviors=[b[1] for b in behaviors],
                         payload_width=P, **kw)
    return t, j


def both(fn, t, j):
    """fn on each system; returns (port, reference) host values."""
    return host(fn(t)), host(fn(j))


# ------------------------------------------------------------ BatchedSystem
def test_spawn_stop_churn_reuses_rows_without_leak():
    t, j = systems(256, [(t_counter, j_counter)], host_inbox=32)
    for s, b in ((t, t_counter), (j, j_counter)):
        for _ in range(8):  # 800 spawns through 256 rows
            s.stop_block(s.spawn_block(b, 100))
    assert t.free_row_count == j.free_row_count == 256
    assert t.live_count == j.live_count == 0
    np.testing.assert_array_equal(t.generation_of(np.arange(256)),
                                  j.generation_of(np.arange(256)))


def test_reused_row_starts_fresh_and_scrubs_stale_messages():
    t, j = systems(4, [(t_counter, j_counter)], host_inbox=8)
    got = {}
    for name, s, b in (("port", t, t_counter), ("ref", j, j_counter)):
        ids = s.spawn_block(b, 4, init_state={"n": 7})
        s.tell(int(ids[0]), [1.0, 0, 0, 0])
        s.step()
        first = int(s.read_state("n", ids[:1])[0])
        s.stop_block(ids)
        s.tell(int(ids[0]), [1.0, 0, 0, 0])  # stale: addressed to the dead
        fresh = s.spawn_block(b, 2)
        s.step()
        got[name] = (first, np.asarray(fresh).tolist(),
                     np.asarray(s.read_state("n", fresh)).tolist(),
                     s.generation_of(fresh).tolist())
    assert got["port"] == got["ref"]
    assert got["port"][0] == 8 and got["port"][2] == [0, 0]


def test_generation_guards_stop_respawn_race():
    t, j = systems(4, [(t_counter, j_counter)], host_inbox=8)
    got = {}
    for name, s, b in (("port", t, t_counter), ("ref", j, j_counter)):
        ids = s.spawn_block(b, 4)
        gen0 = s.generation_of(ids)
        dead = []
        s.on_dead_letter = dead.append
        s.tell(int(ids[0]), [1.0, 0, 0, 0], expect_gen=int(gen0[0]))
        s.step()
        s.stop_block(ids[:1])
        fresh = s.spawn_block(b, 1)
        # the old incarnation's tell after the respawn dead-letters
        s.tell(int(ids[0]), [1.0, 0, 0, 0], expect_gen=int(gen0[0]))
        s.step()
        mid = int(s.read_state("n", fresh)[0])
        s.tell(int(fresh[0]), [1.0, 0, 0, 0],
               expect_gen=int(s.generation_of(fresh)[0]))
        s.step()
        got[name] = (int(fresh[0]), s.generation_of(ids).tolist(), mid,
                     int(s.read_state("n", fresh)[0]), s.dead_lettered, dead)
    assert got["port"] == got["ref"]
    assert got["port"][2:] == (0, 1, 1, [1])


def test_device_become_switches_behavior():
    t, j = systems(8, [(t_flipper, j_flipper), (t_doubler, j_doubler)],
                   host_inbox=8)
    got = {}
    for name, s, b in (("port", t, t_flipper), ("ref", j, j_flipper)):
        ids = s.spawn_block(b, 2)
        seq = []
        for row in (0, 0, 1):
            s.tell(int(ids[row]), [0.0] * P)
            s.step()
            seq.append(np.asarray(s.read_state("n", ids)).tolist())
        got[name] = (seq, host(s.behavior_id).tolist())
    assert got["port"] == got["ref"]
    assert got["port"][0] == [[1, 0], [3, 0], [3, 1]]


def test_error_lane_suspends_and_discards_failing_update():
    t, j = systems(8, [(t_fragile, j_fragile)], host_inbox=8)
    got = {}
    for name, s, b in (("port", t, t_fragile), ("ref", j, j_fragile)):
        ids = s.spawn_block(b, 2)
        seen = []
        for x in (1.0, -1.0, 1.0):  # ok, poison, while suspended
            s.tell(int(ids[0]), [x, 0, 0, 0])
            s.step()
            seen.append((int(s.read_state("n", ids[:1])[0]),
                         list(map(int, s.failed_rows()))))
        s.restart_rows(s.failed_rows())
        s.tell(int(ids[0]), [1.0, 0, 0, 0])
        s.step()
        seen.append((int(s.read_state("n", ids[:1])[0]),
                     list(map(int, s.failed_rows()))))
        got[name] = (seen, s.generation_of(ids).tolist())
    assert got["port"] == got["ref"]
    assert got["port"][0] == [(1, []), (1, [0]), (1, [0]), (1, [])]


# ------------------------------------------------------ through the handle
@pytest.mark.parametrize("policy", ["restart", "stop", "suspend"])
def test_handle_failure_policy(actors, policy):
    """A poison message raises a row's error lane; the handle's pump
    publishes DeviceActorFailed once and restarts the row with its
    spawn-time init, stops it, or leaves it suspended, alike in both
    packages."""
    from akka_tpu.event.event_stream import EventStream as JEvents
    from akka_tpu_torch.event.event_stream import EventStream as TEvents
    got = {}
    for name, events, fail_cls, b, make in (
            ("port", TEvents(), tbridge.DeviceActorFailed, t_fragile,
             actors.port_handle),
            ("ref", JEvents(), jbridge.DeviceActorFailed, j_fragile,
             actors.ref_handle)):
        seen = []
        events.subscribe(seen.append, fail_cls)
        h = make(capacity=64, payload_width=P, host_inbox=8, promise_rows=8,
                 event_stream=events, failure_policy=policy)
        rows = h.spawn(b, 2, init_state={"n": np.asarray([5, 6], np.int32)})
        h.tell(int(rows[0]), [-1.0, 0, 0, 0])
        deadline = time.monotonic() + TIMEOUT
        while time.monotonic() < deadline and not seen:
            time.sleep(0.01)
        assert seen and seen[0].action == policy
        h.tell(int(rows[0]), [1.0, 0, 0, 0])
        h.step(2)
        got[name] = ([(list(map(int, e.rows)), e.action) for e in seen],
                     np.asarray(h.read_state("n", rows)).tolist(),
                     h.generation_of(rows).tolist(),
                     list(map(int, h.runtime.failed_rows())))
    assert got["port"] == got["ref"]
    want_n = {"restart": [6, 6], "stop": [5, 6], "suspend": [5, 6]}[policy]
    assert got["port"][1] == want_n


def test_device_ref_pins_incarnation(actors):
    """A DeviceActorRef captured before stop+respawn dead-letters its tells
    (DeviceDeadLetters on the event stream) and fails its asks fast."""
    @jb.behavior("gen-counter8", {"n": ((), jnp.float32)}, inbox="slots")
    def j_c8(state, mailbox, ctx):
        return {"n": state["n"] + mailbox.reduce().count}, jb.Emit.none(1, 8)

    @tb.behavior("gen-counter8", {"n": ((), torch.float32)}, inbox="slots")
    def t_c8(state, mailbox, ctx):
        return ({"n": state["n"] + mailbox.reduce().count},
                tb.Emit.none(ctx.actor_id.shape[0], 1, 8))

    t_sys, j_sys = actors.systems("genpin")
    got = {}
    for name, s, b, br in (("port", t_sys, t_c8, tbridge),
                           ("ref", j_sys, j_c8, jbridge)):
        ref = s.actor_of(br.device_props(b), "pinned")
        h = br.get_handle(s)
        seen = []
        s.event_stream.subscribe(seen.append, br.DeviceDeadLetters)
        ref.stop()  # bumps the row's generation 0 -> 1
        stale = br.DeviceActorRef(s, h, ref.row, ref.path, gen=0)
        stale.tell([1.0, 0, 0, 0])
        with pytest.raises(RuntimeError, match="dead incarnation"):
            stale.ask([1.0, 0, 0, 0], timeout=1.0).result(TIMEOUT)
        got[name] = (int(h.generation_of(ref.row)[0]),
                     int(h.runtime.dead_lettered),
                     [type(e).__name__ for e in seen])
    assert got["port"] == got["ref"]
    assert got["port"] == (1, 2, ["DeviceDeadLetters"] * 2)


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_checkpoint_restores_across_packages(actors, tmp_path, monkeypatch,
                                             writer):
    """A handle checkpoint written by one package is restored by the
    other's handle (the schema-v3 .npz): every state column, the step
    counter and what later tells add are equal."""
    import akka_tpu.persistence.slab_snapshot as jsnap
    monkeypatch.setattr(jsnap, "_try_orbax", lambda: None)  # .npz only
    rng = np.random.default_rng(23)
    kw = dict(capacity=128, payload_width=P, host_inbox=64, promise_rows=8)
    first = [(int(r), float(v)) for r, v in zip(
        rng.integers(0, 16, 40), rng.integers(-50, 50, 40))]
    later = [(int(r), float(v)) for r, v in zip(
        rng.integers(0, 16, 20), rng.integers(-50, 50, 20))]
    handles = {"port": (actors.port_handle, t_acc),
               "ref": (actors.ref_handle, j_acc)}
    reader = "ref" if writer == "port" else "port"

    def drive(h, tells):
        for r, v in tells:
            h.runtime.tell(r, [v, 0, 0, 0])
        h.step(3)

    make, b = handles[writer]
    w = make(checkpoint_dir=str(tmp_path), **kw)
    rows_w = w.spawn(b, 16)
    drive(w, first)
    path = w.checkpoint()
    make, b = handles[reader]
    r = make(**kw)
    rows_r = r.spawn(b, 16)
    r.runtime  # built, then restored
    assert r.restore(path) == steps_of(w) == 3
    np.testing.assert_array_equal(rows_w, rows_r)
    sw, sr = state_of(w), state_of(r)
    assert sw.keys() == sr.keys()
    for col in sw:
        np.testing.assert_array_equal(sw[col], sr[col], err_msg=col)
    drive(w, later)
    drive(r, later)
    sw, sr = state_of(w), state_of(r)
    np.testing.assert_array_equal(sw["n"], sr["n"])
    np.testing.assert_allclose(sw["total"], sr["total"], rtol=RTOL,
                               atol=ATOL)
    assert steps_of(w) == steps_of(r) == 6
    want = np.zeros(16)
    for rr, v in first + later:
        want[rr] += v
    np.testing.assert_array_equal(sr["total"][:16], want)


# ------------------------------------------------------- the depth-k pump
def test_ask_timeout_with_pipeline_in_flight(actors):
    """An ask that times out while the depth-4 pump keeps steps in flight
    fails with AskTimeoutException, quarantines its promise row, and
    leaves the handle healthy: a later ask to a new behavior (a rebuild on
    top of the zombie) completes."""
    th, jh = actors.handles_pair(capacity=128, payload_width=P,
                                 promise_rows=8, host_inbox=32,
                                 pipeline_depth=4)
    got = {}
    for name, h, mute, echo, exc in (("port", th, t_mute, t_echo2,
                                      TAskTimeout),
                                     ("ref", jh, j_mute, j_echo2,
                                      JAskTimeout)):
        rows = h.spawn(mute, 1)
        fut = h.ask(int(rows[0]), (0, [1.0]), timeout=0.25)
        with pytest.raises(exc):
            fut.result(TIMEOUT)
        assert h._promise_zombies  # quarantined, not recycled yet
        assert h.pipeline_stats()["steps"] > 0
        erow = h.spawn(echo, 1)  # rebuild with the zombie outstanding
        got[name] = (np.asarray(h.ask_sync(int(erow[0]), (0, [21.0]),
                                           timeout=TIMEOUT), np.float32),
                     int(erow[0]), len(h._promise_zombies))
    np.testing.assert_array_equal(got["port"][0], got["ref"][0])
    assert got["port"][1:] == got["ref"][1:]
    assert got["port"][0][0] == 42.0


def test_rebuild_races_full_pipeline(actors):
    """spawn() of a new behavior (a rebuild) racing a stepper thread that
    keeps the depth-4 pipeline full: no exception on either side, the
    always-on rows advance in lockstep through the rebuild, and a tell to
    the new behavior lands exactly once."""
    @jb.behavior("race-acc", {"acc": ((), jnp.float32)}, always_on=True)
    def j_acc(state, inbox, ctx):
        return {"acc": state["acc"] + 1.0}, jb.Emit.none(1, P)

    @tb.behavior("race-acc", {"acc": ((), torch.float32)}, always_on=True)
    def t_acc(state, inbox, ctx):
        return ({"acc": state["acc"] + 1.0},
                tb.Emit.none(ctx.actor_id.shape[0], 1, P))

    @jb.behavior("race-late", {"seen": ((), jnp.float32)})
    def j_late(state, inbox, ctx):
        return {"seen": state["seen"] + inbox.sum[0]}, jb.Emit.none(1, P)

    @tb.behavior("race-late", {"seen": ((), torch.float32)})
    def t_late(state, inbox, ctx):
        return ({"seen": state["seen"] + inbox.sum[:, 0]},
                tb.Emit.none(ctx.actor_id.shape[0], 1, P))

    th, jh = actors.handles_pair(capacity=128, payload_width=P,
                                 promise_rows=8, host_inbox=64,
                                 pipeline_depth=4)
    got = {}
    for name, h, acc_b, late_b in (("port", th, t_acc, t_late),
                                   ("ref", jh, j_acc, j_late)):
        errors = []
        rows = h.spawn(acc_b, 16)
        h.step(1)  # built and warm
        stop = threading.Event()

        def stepper(h=h, stop=stop, errors=errors):
            try:
                while not stop.is_set():
                    h.step(8)
            except Exception as e:  # noqa: BLE001 — surfaced below
                errors.append(e)

        t = actors.thread(stepper)
        try:
            time.sleep(0.05)  # the pipeline is full
            lrow = h.spawn(late_b, 1)  # rebuild mid-flight
            h.tell(int(lrow[0]), (0, [5.0]))
            time.sleep(0.05)
        finally:
            stop.set()
            t.join(TIMEOUT)
        assert not t.is_alive() and not errors, errors
        h.step(2)  # the tell's flush has run
        acc = np.asarray(h.read_state("acc", rows))
        assert np.unique(acc).size == 1 and acc[0] >= 9.0
        assert acc[0] == steps_of(h)  # always on: one per step, no reset
        got[name] = (float(np.asarray(h.read_state("seen", lrow))[0]),
                     int(lrow[0]))
    assert got["port"] == got["ref"] == (5.0, got["ref"][1])


def _chaos_run(make_handle, pkg, chaos, backend, depth, windows,
               seed=11, rate=0.08, n=48):
    """One handle lifecycle of the reference's depth-k parity test: an
    always-on chaos accumulator and staged tells, driven only through
    h.step() windows (tells go through runtime.tell, so the pump stays
    dormant and the step count is exact)."""
    if pkg is tb:
        from akka_tpu_torch.batched.supervision import Directive

        @tb.behavior("par-acc", {"acc": ((), torch.float32)},
                     always_on=True,
                     supervisor=tb.LaneSupervisor(directive=Directive.RESUME))
        def acc(state, inbox, ctx):
            return ({"acc": state["acc"] + 1.0 + inbox.sum[:, 0]},
                    tb.Emit.none(ctx.actor_id.shape[0], 1, P))
    else:
        from akka_tpu.actor.supervision import Directive

        @jb.behavior("par-acc", {"acc": ((), jnp.float32)}, always_on=True,
                     supervisor=jb.LaneSupervisor(
                         directive=Directive.RESUME))
        def acc(state, inbox, ctx):
            return ({"acc": state["acc"] + 1.0 + inbox.sum[0]},
                    jb.Emit.none(1, P))

    h = make_handle(pipeline_depth=depth, delivery_backend=backend)
    rows = h.spawn(chaos.inject(acc, seed=seed, crash_rate=rate), n)
    base, msg = int(rows[0]), 0
    for w in windows:
        for _ in range(3):
            h.runtime.tell(base + (msg % n), [float(msg + 1), 0, 0, 0])
            msg += 1
        h.step(w)
    return (np.asarray(rows), state_of(h), dict(h.runtime.supervision_counts),
            steps_of(h))


@pytest.mark.parametrize("backend", ["ranked", "auto"])
def test_depth_k_parity_with_chaos_oracle(actors, backend):
    """Depth 1 and depth 4 runs of one chaos schedule are bit-identical in
    the port (every state column, the supervision counters, the step
    count), equal to the reference's run of the same schedule, and the
    failed counter equals the numpy chaos oracle's."""
    from akka_tpu.testkit import chaos as jchaos
    from akka_tpu_torch.testkit import chaos as tchaos

    windows, seed, rate = (7, 5, 9), 11, 0.08
    kw = dict(capacity=128, payload_width=P, promise_rows=8, host_inbox=64)

    def port_handle(**extra):
        return actors.port_handle(**kw, **extra)

    def ref_handle(**extra):
        return actors.ref_handle(**kw, **extra)

    r1, s1, c1, n1 = _chaos_run(port_handle, tb, tchaos, backend, 1, windows)
    r4, s4, c4, n4 = _chaos_run(port_handle, tb, tchaos, backend, 4, windows)
    rj, sj, cj, nj = _chaos_run(ref_handle, jb, jchaos, "xla", 4, windows)
    assert n1 == n4 == nj == sum(windows)
    np.testing.assert_array_equal(r1, r4)
    np.testing.assert_array_equal(r1, rj)
    assert s1.keys() == s4.keys() == sj.keys()
    for col in s1:
        np.testing.assert_array_equal(s1[col], s4[col], err_msg=col)
        if s1[col].dtype.kind == "f":
            np.testing.assert_allclose(s1[col], sj[col], rtol=RTOL,
                                       atol=ATOL, err_msg=col)
        else:
            np.testing.assert_array_equal(s1[col], sj[col], err_msg=col)
    assert c1 == c4 == cj
    expect_failed = int(sum(
        tchaos.chaos_hit_np(seed, s, r1, rate, tchaos.CRASH_SALT).sum()
        for s in range(sum(windows))))
    assert c1["failed"] == expect_failed > 0
    assert c1["resumed"] == expect_failed


@pytest.mark.parametrize("depth", [2, 3, 4])
def test_pump_retires_each_steps_own_attention_word(actors, depth):
    """The step writes its attention word into one carried tensor; the
    depth-k pipeline must retire, in order, the word each step wrote (its
    step lane 1, 2, ...), never the newest word k times."""
    from akka_tpu_torch.batched.supervision import ATT_STEP
    h = actors.port_handle(capacity=64, payload_width=P, host_inbox=16,
                           promise_rows=8, pipeline_depth=depth)
    h.spawn(t_counter, 4)
    h.runtime  # built
    retired = []
    drain = h._drain_one

    def record(inflight):
        host, copied = inflight[0]
        if copied is not None:  # the word's copy has landed
            copied.synchronize()
        retired.append(int(host[ATT_STEP]))
        return drain(inflight)

    h._drain_one = record
    h.step(12)
    assert retired == list(range(1, 13))
    assert h.pipeline_stats()["drains"] == 12
