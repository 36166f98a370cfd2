"""The port's region tracer (`DeviceShardRegion.attach_tracer` and the ask
engine's spans) against the reference's, on the CPU.

Each case builds the same small counter region in both packages (at most
64 rows), attaches a `Tracer` sampling every trace with the same seed,
and sends two seeded waves through `ask_many`, each member carrying the
context of its own `gw.request` root span (as the gateway's columnar
windows do; no thread, no server). The span trees must be equal: names,
trace, span and parent ids, the step stamps on the region's step axis
and every attribute but the clocks. The port's spans, with its
system's flight-recorder events, must export to a Perfetto document
that passes `validate_trace`, and the `device_step` events must account
for every step the region ran.
"""

import numpy as np
import pytest

from akka_tpu.event import tracing as jtr
from akka_tpu.gateway import counter_behavior as j_counter
from akka_tpu.sharding.device import DeviceEntity as JEntity
from akka_tpu.sharding.device import DeviceShardRegion as JRegion

from akka_tpu_torch.event import tracing as ttr
from akka_tpu_torch.event.flight_recorder import InMemoryFlightRecorder
from akka_tpu_torch.gateway import counter_behavior as t_counter
from akka_tpu_torch.sharding.device import DeviceEntity as TEntity
from akka_tpu_torch.sharding.device import DeviceShardRegion as TRegion
from akka_tpu_torch.tools import trace_export

P = 4
CLOCKS = ("ts", "t0", "t1")


def _region(pkg, d, slots):
    kw = dict(n_shards=2, entities_per_shard=16, n_devices=d,
              payload_width=P, mailbox_slots=slots)
    if pkg == "ref":
        return JRegion(JEntity("trc", j_counter(P), **kw))
    return TRegion(TEntity("trc", t_counter(P), **kw), device="cpu")


def _waves(seed):
    """Two waves of adds over 12 entities; each wave repeats one entity
    (the repeat rides a deferred flush)."""
    rng = np.random.default_rng(seed)
    waves = []
    for k in (6, 9):
        names = [f"e{i}" for i in rng.choice(12, k, replace=False)]
        names.append(names[0])
        waves.append([(n, float(v)) for n, v in
                      zip(names, rng.integers(1, 9, len(names)))])
    return waves


def _serve(pkg, d, slots, seed):
    region = _region(pkg, d, slots)
    tracer = (jtr if pkg == "ref" else ttr).Tracer(sample_rate=1.0,
                                                   seed=seed)
    region.attach_tracer(tracer)
    assert region.tracer is tracer and tracer.step_fn is not None
    if pkg == "port":
        region.system.flight_recorder = InMemoryFlightRecorder()
    steps0 = region.system._host_step
    replies = []
    for wave in _waves(seed):
        refs = [region.entity_ref(n) for n, _ in wave]
        roots = [tracer.begin("gw.request", tracer.start_trace(), parent=0,
                              entity=n) for n, _ in wave]
        out = region.ask_many([(r.shard, r.index, [v])
                               for r, (_, v) in zip(refs, wave)],
                              ctxs=[root.ctx for root in roots])
        for root in roots:
            root.finish()
        replies.append(out)
    return region, tracer, replies, steps0


@pytest.mark.parametrize("d,slots", [(1, 0), (2, 0), (2, 2)],
                         ids=["d1", "d2", "d2-slots2"])
def test_span_trees_equal_the_reference(d, slots):
    seed = 11 + d + slots
    ref, jtracer, jreplies, _ = _serve("ref", d, slots, seed)
    port, ttracer, treplies, steps0 = _serve("port", d, slots, seed)
    for jw, tw in zip(jreplies, treplies):
        for j, t in zip(jw, tw):
            assert not isinstance(t, BaseException), t
            np.testing.assert_array_equal(t, np.asarray(j))
    want = [{k: v for k, v in s.items() if k not in CLOCKS}
            for s in jtracer.spans()]
    got = [{k: v for k, v in s.items() if k not in CLOCKS}
           for s in ttracer.spans()]
    assert got == want
    names = {s["name"] for s in got}
    assert {"gw.request", "ask.wave", "ask.member", "wave.flush",
            "wave.step_round", "wave.stage", "wave.resolve"} <= names
    # every member parents to its own request root, every wave child to
    # its wave, and every stamp lies on the region's step axis
    by_id = {(s["trace"], s["span"]): s for s in got}
    for s in got:
        if s["parent"]:
            assert (s["trace"], s["parent"]) in by_id, s
        assert steps0 <= s["step0"] <= s["step1"] <= port.system._host_step
    for m in (s for s in got if s["name"] == "ask.member"):
        assert by_id[(m["trace"], m["parent"])]["name"] == "gw.request"
    assert sum(1 for s in got if s["name"] == "ask.member"
               and s["deferred"]) == 2
    # the Perfetto document of the port's spans and its recorder's events
    events = port.system.flight_recorder.events()
    doc = trace_export.to_perfetto(ttracer.spans(), events)
    assert trace_export.validate_trace(doc) == []
    ran = [e["n_steps"] for e in events if e["event"] == "device_step"]
    assert sum(ran) == port.system._host_step - steps0 > 0
    assert all(e["system"] == "sharded" for e in events)


def test_detached_tracer_records_nothing():
    port, tracer, _, _ = _serve("port", 1, 0, 3)
    n = len(tracer.spans())
    port.attach_tracer(None)
    assert port.tracer is None
    ref = port.entity_ref("e0")
    root = tracer.begin("gw.request", tracer.start_trace(), parent=0)
    out = port.ask_many([(ref.shard, ref.index, [1.0])], ctxs=[root.ctx])
    assert not isinstance(out[0], BaseException)
    assert len(tracer.spans()) == n
