"""The port's flight recorder (akka_tpu_torch/event/flight_recorder.py)
against the reference's (akka_tpu/event/flight_recorder.py), on the CPU.

The SPI must derive the same hook fields, name for name. A 64-row
BatchedSystem of each package, fed the same seeded tells and stepped by
the same script, must record the same sequence of events with the same
integer and string fields (`device_flush` staged counts, `device_step`
n_steps, `device_supervision` deltas under `testkit.chaos.inject`, and
`shard_overflow` on a bounded-mailbox system); only the measured seconds
and the timestamps differ. The recorders, `from_config` and the dual
timestamps follow tests/test_flight_recorder.py, without an actor system
and without a profiler.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import akka_tpu.batched as jb
from akka_tpu.event import flight_recorder as jfr
from akka_tpu.testkit import chaos as jc

import akka_tpu_torch.batched as tb
from akka_tpu_torch.config import Config
from akka_tpu_torch.event import flight_recorder as tfr
from akka_tpu_torch.testkit import chaos as tc
from akka_tpu_torch.tools import trace_export

P = 4
N = 64


def test_spi_hook_fields_equal_the_reference():
    want = jfr.spi_hook_fields()
    got = tfr.spi_hook_fields()
    assert list(got) == list(want)
    for name, fields in want.items():
        assert got[name] == fields, name
    assert tfr._NON_HOOKS == jfr._NON_HOOKS
    assert tfr.InMemoryFlightRecorder._FIELDS == got


def test_noop_is_inert_and_from_config_falls_back():
    assert isinstance(tfr.from_config(None), tfr.NoOpFlightRecorder)
    noop = tfr.NoOpFlightRecorder()
    assert noop.enabled is False
    noop.device_step("s", 1, 0.0)
    assert noop.events() == []
    mem = tfr.from_config(Config({"akka": {"flight-recorder": {
        "implementation": "memory", "capacity": 3}}}))
    assert isinstance(mem, tfr.InMemoryFlightRecorder)
    for i in range(5):
        mem.device_flush("s", i)
    assert [e["staged"] for e in mem.events()] == [2, 3, 4]


def test_jsonl_recorder_writes_lines(tmp_path):
    path = str(tmp_path / "fr" / "flight.jsonl")
    fr = tfr.from_config(Config({"akka": {"flight-recorder": {
        "implementation": "jsonl", "path": path}}}))
    try:
        assert isinstance(fr, tfr.JsonlFlightRecorder)
        fr.device_step("batched", 3, 0.25)
        fr.journal_truncated("tells.wal", 17)
        fr.event("custom", answer=42)
    finally:
        fr.close()
    fr.close()  # idempotent
    fr.device_flush("batched", 1)  # after close: recorded, not written
    with open(path) as fh:
        rows = [json.loads(line) for line in fh if line.strip()]
    assert [r["event"] for r in rows] == ["device_step", "journal_truncated",
                                          "custom"]
    assert (rows[0]["system"], rows[0]["n_steps"]) == ("batched", 3)
    assert (rows[1]["path"], rows[1]["dropped_bytes"]) == ("tells.wal", 17)
    assert rows[2]["answer"] == 42
    assert all("ts" in r and "ts_mono" in r for r in rows)
    assert len(fr.events()) == 4


def test_rows_carry_dual_timestamps():
    import time

    fr = tfr.InMemoryFlightRecorder()
    fr.device_step("sys", 4, 0.01)
    fr.event("custom", answer=42)
    for ev in fr.events():
        assert 0 < ev["ts_mono"] <= time.monotonic()
        assert abs(ev["ts"] - time.time()) < 60.0
    step = fr.of_type("device_step")[0]
    assert (step["system"], step["n_steps"]) == ("sys", 4)
    assert fr.of_type("custom")[0]["answer"] == 42
    doc = trace_export.to_perfetto([], fr.events() + [
        {"event": "old_row", "ts": 123.0}])
    assert trace_export.validate_trace(doc) == []


def test_structured_hooks_record_their_fields():
    r = tfr.InMemoryFlightRecorder()
    r.device_supervision("s", 1, 2, 3, 4, 5, 6, 7)
    r.shard_overflow("s", shard=2, mailbox_overflow=5, dropped=1)
    sup, over = r.events()
    assert sup["event"] == "device_supervision"
    assert (sup["steps"], sup["failed"], sup["dead_letters"]) == (1, 2, 7)
    assert (over["shard"], over["mailbox_overflow"], over["dropped"]) == \
        (2, 5, 1)


def test_trace_span_without_a_profiler_is_harmless():
    with tfr.trace_span("akka.test") as span:
        x = 1 + 1
    assert x == 2 and isinstance(span, tfr.trace_span)
    with pytest.raises(ValueError):
        with tfr.trace_span("akka.test-raises"):
            raise ValueError("propagates")


# ----------------------------------- the device runtime's event sequence

@jb.behavior("fr_ring", {"n": ((), jnp.int32), "acc": ((), jnp.float32)})
def j_ring(state, inbox, ctx):
    return ({"n": state["n"] + inbox.count,
             "acc": state["acc"] + inbox.sum[0]},
            jb.Emit.single((ctx.actor_id + 1) % ctx.n_actors, inbox.sum, 1,
                           P, when=inbox.count > 0))


@tb.behavior("fr_ring", {"n": ((), torch.int32), "acc": ((), torch.float32)})
def t_ring(state, inbox, ctx):
    return ({"n": state["n"] + inbox.count,
             "acc": state["acc"] + inbox.sum[:, 0]},
            tb.Emit.single((ctx.actor_id + 1) % ctx.n_actors, inbox.sum, 1,
                           P, when=inbox.count > 0))


@jb.behavior("fr_slots", {"n": ((), jnp.int32)}, inbox="slots")
def j_slots(state, mb, ctx):
    got = mb.fold(jnp.int32(0), lambda c, t, p: c + 1)
    return ({"n": state["n"] + got},
            jb.Emit.single((ctx.actor_id + 1) % ctx.n_actors, mb.payload[0],
                           1, P, when=got > 0))


@tb.behavior("fr_slots", {"n": ((), torch.int32)}, inbox="slots")
def t_slots(state, mb, ctx):
    got = mb.fold(torch.zeros_like(state["n"]), lambda c, t, p: c + 1)
    return ({"n": state["n"] + got},
            tb.Emit.single((ctx.actor_id + 1) % ctx.n_actors,
                           mb.payload[:, 0], 1, P, when=got > 0))


def _supervised(pkg):
    import dataclasses
    b = j_ring if pkg is jb else t_ring
    chaos = jc if pkg is jb else tc
    supervised = dataclasses.replace(b, supervisor=pkg.LaneSupervisor())
    return chaos.inject(supervised, seed=5, crash_rate=0.2)


SCENARIOS = {
    "reduce": (lambda pkg: j_ring if pkg is jb else t_ring, {}),
    "supervised": (_supervised, {}),
    "slots": (lambda pkg: j_slots if pkg is jb else t_slots,
              dict(mailbox_slots=2, spill_capacity=0)),
}


def _system(pkg, scenario):
    make, kw = SCENARIOS[scenario]
    b = make(pkg)
    if pkg is jb:
        s = jb.BatchedSystem(capacity=N, behaviors=[b], payload_width=P,
                             host_inbox=N, native_staging=False, **kw)
    else:
        s = tb.BatchedSystem(capacity=N, behaviors=[b], payload_width=P,
                             host_inbox=N, device="cpu", **kw)
    s.spawn_block(0, N)
    s.flight_recorder = (jfr if pkg is jb else tfr).InMemoryFlightRecorder()
    return s


def _drive(s, seed):
    """The same script for either package: seeded tells, steps, runs and
    attention reads (each read may raise one shard_overflow)."""
    rng = np.random.default_rng(seed)

    def tell(k, hot=None):
        dst = np.full(k, hot, np.int32) if hot is not None \
            else rng.integers(0, N, k).astype(np.int32)
        s.tell(dst, np.ones((k, P), np.float32))

    tell(48)
    s.step()
    s.run(3)
    tell(5, hot=7)
    s.step()
    s.read_attention()
    s.read_attention()  # no growth since the last read: no event
    tell(9)
    s.run(3)
    s.read_attention()
    for _ in range(2):
        s.step()
    tell(6, hot=11)
    s.run(3)
    s.read_attention()


def _fields(ev):
    """An event's name and its integer and string fields (the seconds it
    measured and its timestamps are the run's own)."""
    return {k: v for k, v in ev.items()
            if k not in ("ts", "ts_mono")
            and isinstance(v, (int, str, np.integer))}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_device_events_match_the_reference(scenario):
    ref, port = _system(jb, scenario), _system(tb, scenario)
    _drive(ref, seed=len(scenario))
    _drive(port, seed=len(scenario))
    want = [_fields(e) for e in ref.flight_recorder.events()]
    got = [_fields(e) for e in port.flight_recorder.events()]
    assert got == want
    names = {e["event"] for e in got}
    assert {"device_flush", "device_step"} <= names
    steps = [e["n_steps"] for e in got if e["event"] == "device_step"]
    assert steps == [1, 3, 1, 3, 1, 1, 3]
    assert sum(steps) == port._host_step
    assert [e["staged"] for e in got if e["event"] == "device_flush"] == \
        [48, 5, 9, 6]
    if scenario == "supervised":
        sup = [e for e in got if e["event"] == "device_supervision"]
        assert sup and sum(e["failed"] for e in sup) == \
            port.supervision_counts["failed"] > 0
    else:
        assert "device_supervision" not in names  # nothing compiled in
    if scenario == "slots":
        over = [e for e in got if e["event"] == "shard_overflow"]
        assert over and over[-1]["mailbox_overflow"] == \
            port.mailbox_overflow > 0
    else:
        assert "shard_overflow" not in names


def test_warmup_records_device_compile():
    port = _system(tb, "reduce")
    port.warmup()
    ev = port.flight_recorder.of_type("device_compile")
    assert len(ev) == 1 and ev[0]["system"] == "batched"
    assert ev[0]["elapsed_s"] >= 0.0


def test_no_recorder_records_nothing_and_steps_alike():
    """flight_recorder None: the same script runs, with the same state,
    as on a system with a recorder."""
    quiet, loud = _system(tb, "supervised"), _system(tb, "supervised")
    quiet.flight_recorder = None
    _drive(quiet, seed=3)
    _drive(loud, seed=3)
    np.testing.assert_array_equal(quiet.read_state("n"), loud.read_state("n"))
    assert quiet.supervision_counts == loud.supervision_counts
