"""The port's metrics registry (akka_tpu_torch/event/metrics.py) against
the reference's (akka_tpu/event/metrics.py), on the CPU.

The registry scenarios of tests/test_metrics.py (series, step stamps,
nearest-rank percentiles, collectors, device-slab ingestion and the
Prometheus exposition, `from_config` gating), without the HTTP endpoint
and without the periodic JSONL thread: this file starts no thread and no
server (the card-only tests start and join both). Fed the same
observations and device lanes, the port's `expose()` text and
`snapshot()` dict must equal the reference's, and `emit_jsonl_once`
rows the reference's but for their wall-clock stamp.
"""

import inspect
import json

import numpy as np
import pytest

from akka_tpu.batched import metrics_slab as jslab
from akka_tpu.config import Config as JConfig
from akka_tpu.event import metrics as jm

from akka_tpu_torch.batched import metrics_slab as tslab
from akka_tpu_torch.config import Config
from akka_tpu_torch.event import metrics as tm
from akka_tpu_torch.event.flight_recorder import (_NON_HOOKS, FlightRecorder,
                                                  InMemoryFlightRecorder)


def test_registry_counter_gauge_and_step_stamp():
    reg = tm.MetricsRegistry()
    reg.counter("tells").inc(3, step=7)
    reg.gauge("depth").set(2.5, step=9)
    assert reg.counter("tells").value == 3
    assert reg.gauge("depth").value == 2.5
    assert reg.counter("tells").step == 7
    assert reg.gauge("depth").step == 9
    reg.set_step(4)
    assert reg.step == 4
    reg.set_step(2)
    assert reg.step == 4  # monotonic


def test_host_histogram_nearest_rank_percentiles():
    reg = tm.MetricsRegistry()
    h = reg.histogram("lat")
    h.observe(1)
    h.observe(16)
    assert h.percentile(0.50) == 1.0
    assert h.percentile(0.99) == 31.0  # bucket of 16 -> [16, 31]
    assert tm._host_bucket(0) == 0 and tm._host_bucket(1) == 1
    assert tm._host_bucket(2 ** 70) == 63  # saturates
    s = h.snapshot()
    assert s["count"] == 2 and s["sum"] == 17.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_observe_many_buckets_like_observe(seed):
    rng = np.random.default_rng(seed)
    vals = np.concatenate([rng.exponential(500.0, 300),
                           [0.0, 0.5, 1.0, 2.0 ** 40]])
    one, many = tm.Histogram("a"), tm.Histogram("b")
    for v in vals:
        one.observe(v)
    many.observe_many(vals)
    np.testing.assert_array_equal(one._buckets, many._buckets)
    ref = jm.Histogram("c")
    ref.observe_many(vals)
    np.testing.assert_array_equal(many._buckets, ref._buckets)
    for q in (0.5, 0.95, 0.99):
        assert many.percentile(q) == ref.percentile(q)


def test_registry_collector_pull_skips_non_numeric():
    reg = tm.MetricsRegistry()
    reg.register_collector("pipe", lambda: {"steps": 5, "ok": True,
                                            "name": "x", "depth": 2.0})
    reg.register_collector("sick", lambda: 1 / 0)
    text = reg.expose()
    assert "akka_pipe_steps 5" in text
    assert "akka_pipe_depth 2" in text
    assert "akka_pipe_ok" not in text  # bools skipped
    assert "akka_pipe_name" not in text
    assert "sick" not in text  # a raising collector never breaks expose


def test_registry_ingests_device_slab_and_exposes_prometheus():
    reg = tm.MetricsRegistry()
    lanes = {name: np.zeros(tslab.N_BUCKETS, np.int64)
             for name in tslab.HIST_NAMES}
    lanes["mailbox_occupancy"][0] = 10
    lanes["mailbox_occupancy"][1] = 4
    reg.ingest_device_slab(lanes, step=42)
    h = reg.device_histogram("mailbox_occupancy")
    assert h is not None and h.count == 14 and h.step == 42
    assert h.percentile(0.50) == 0.0
    assert h.percentile(0.99) == 1.0
    text = reg.expose()
    assert 'akka_device_mailbox_occupancy_bucket{le="0"} 10' in text
    assert 'akka_device_mailbox_occupancy_bucket{le="1"} 14' in text
    assert 'le="+Inf"' in text
    assert "akka_device_mailbox_occupancy_count 14" in text
    assert "akka_device_mailbox_occupancy_step 42" in text
    assert reg.step == 42
    lanes["mailbox_occupancy"][1] = 6  # a later drain replaces, not adds
    reg.ingest_device_slab(lanes, step=50)
    assert reg.device_histogram("mailbox_occupancy").count == 16
    assert reg.snapshot()["device"]["device_mailbox_occupancy"]["step"] == 50


def test_slab_constants_equal_the_reference():
    assert tslab.N_BUCKETS == jslab.N_BUCKETS
    assert tslab.HIST_NAMES == jslab.HIST_NAMES
    assert tslab.bucket_upper_bounds() == jslab.bucket_upper_bounds()


def _feed(mod, seed, namespace):
    """The same observations and device lanes into a registry of `mod`."""
    rng = np.random.default_rng(seed)
    reg = mod.MetricsRegistry(namespace)
    reg.counter("tells", "host tells").inc(int(rng.integers(1, 99)), step=3)
    reg.counter("asks").inc()
    reg.gauge("depth", "in flight").set(float(rng.random()), step=5)
    h = reg.histogram("wave_ms", "wave latency")
    for v in rng.exponential(40.0, 64):
        h.observe(float(v), step=int(rng.integers(0, 9)))
    reg.histogram("batch").observe_many(rng.integers(1, 300, 50))
    reg.register_collector("pipe", lambda: {"steps": 5, "ratio": 0.25,
                                            "on": False})
    for step in (11, 17):
        lanes = {name: rng.integers(0, 1000, mod_slab(mod).N_BUCKETS)
                 .astype(np.int64) for name in mod_slab(mod).HIST_NAMES}
        reg.ingest_device_slab(lanes, step=step)
    reg.set_step(9)
    return reg


def mod_slab(mod):
    return jslab if mod is jm else tslab


@pytest.mark.parametrize("seed,namespace", [(0, "akka"), (1, "tpu"),
                                            (2, "akka")])
def test_expose_and_snapshot_equal_the_reference(seed, namespace):
    ref, port = _feed(jm, seed, namespace), _feed(tm, seed, namespace)
    assert port.expose() == ref.expose()
    assert port.snapshot() == ref.snapshot()
    for lane in tslab.HIST_NAMES:
        a, b = port.device_histogram(lane), ref.device_histogram(lane)
        for q in (0.5, 0.95, 0.99):
            assert a.percentile(q) == b.percentile(q)


@pytest.mark.parametrize("seed", [0, 3])
def test_emit_jsonl_once_rows_equal_the_reference(tmp_path, seed):
    """The JSONL emitter's rows, written through its file handle (no
    emitter thread): one per emit_jsonl_once and a final one at close()."""
    rows = {}
    for name, mod in (("ref", jm), ("port", tm)):
        reg = _feed(mod, seed, "akka")
        path = tmp_path / name / "metrics.jsonl"
        path.parent.mkdir()
        reg._jsonl_fh = open(path, "a", buffering=1)
        reg.emit_jsonl_once()
        reg.counter("tells").inc(2)
        reg.emit_jsonl_once()
        reg.close()
        assert reg._jsonl_fh is None
        rows[name] = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert len(rows["port"]) == 3
    for got, want in zip(rows["port"], rows["ref"]):
        assert got.pop("event") == "metrics" and isinstance(got.pop("ts"),
                                                             float)
        want.pop("ts")
        want.pop("event")
        assert got == want
    assert rows["port"][1]["counters"]["tells"] == \
        rows["port"][0]["counters"]["tells"] + 2


def test_emit_without_a_sink_writes_nothing():
    reg = tm.MetricsRegistry()
    reg.emit_jsonl_once()  # no file: a no-op
    reg.close()  # nothing started: nothing to stop
    assert reg._http_thread is None and reg._jsonl_thread is None


def test_from_config_gating():
    """Disabled or absent: no registry. Enabled with no port and no path:
    a registry that started nothing."""
    assert tm.from_config(None) is None
    assert tm.from_config(Config({"akka": {"metrics": {"enabled": False}}})) \
        is None
    cfg = {"akka": {"metrics": {"enabled": True, "namespace": "tpu"}}}
    reg = tm.from_config(Config(cfg))
    ref = jm.from_config(JConfig(cfg))
    try:
        assert reg is not None and reg.namespace == "tpu" == ref.namespace
        assert reg._http_server is None and reg._http_thread is None
        assert reg._jsonl_fh is None and reg._jsonl_thread is None
        assert reg.expose() == ref.expose() == "\n"
    finally:
        reg.close()
        ref.close()


def test_flight_recorder_fields_derived_from_spi():
    derived = InMemoryFlightRecorder._FIELDS
    spi = {name: fn for name, fn in vars(FlightRecorder).items()
           if callable(fn) and not name.startswith("_")
           and name not in _NON_HOOKS}
    assert set(derived) == set(spi)
    for name, fn in spi.items():
        params = tuple(inspect.signature(fn).parameters)[1:]
        assert derived[name] == params, name
    r = InMemoryFlightRecorder()
    r.device_supervision("s", 1, 2, 3, 4, 5, 6, 7)
    ev = r.events()[0]
    assert ev["event"] == "device_supervision"
    assert (ev["steps"], ev["failed"], ev["dead_letters"]) == (1, 2, 7)
