"""The port's gateway host layers (akka_tpu_torch.gateway and
akka_tpu_torch.serialization.frames) against the reference's (akka_tpu),
on the CPU.

One request trace of JSON, binary and mixed windows (bad frames, sheds,
dedup hits, replica gets, the admin ops sum, stats, rebalance, durable,
artifact and an unknown one) goes through both packages'
`GatewayServer.handle_frame` / `handle_frame_batch` (serialized backends)
and `submit_frames` (continuous backends), each over a counter region of
the same shape (64 rows; D in {1, 2}, mailbox_slots in {0, 2}) with the
admission clock faked. Every reply must be byte-identical, but for the
`stats` and `artifact` admin replies, whose wall-clock fields (idle
wakeups per second, busy seconds, latency percentiles) are dropped before
the parsed replies are compared. The counter adds integer-valued floats,
so every reply value is exact; the carries are compared integer-exact and
floats within rtol 1e-4 / atol 1e-3. The frame codec, `VectorTenantTable`,
`ReplyCacheTable` and `SloTracker` are held to the reference unit by unit.
"""

import json

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # tiny tensors: spare the other test workers

import jax

import akka_tpu.gateway as jg
from akka_tpu.gateway.replica import ReadReplicaCache as JReplica
from akka_tpu.serialization import frames as jframes
from akka_tpu.sharding.device import DeviceEntity as JEntity
from akka_tpu.sharding.device import DeviceShardRegion as JRegion

import akka_tpu_torch.gateway as tg
from akka_tpu_torch.gateway.replica import ReadReplicaCache as TReplica
from akka_tpu_torch.serialization import frames as tframes
from akka_tpu_torch.sharding.device import DeviceEntity as TEntity
from akka_tpu_torch.sharding.device import DeviceShardRegion as TRegion
from akka_tpu_torch.utils.carry import SHARDED_FIELDS, numpy_carry

RTOL, ATOL = 1e-4, 1e-3
P = 4
CONFIGS = [(1, 0), (1, 2), (2, 0), (2, 2)]  # (D, mailbox_slots)
CONFIG_IDS = [f"d{d}-slots{s}" for d, s in CONFIGS]
WAIT_S = 60.0


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


# wall-clock fields of the admin replies (everything else is compared)
_TIMED = {"idle_wakeups", "idle_wakeups_per_s", "waves_overlap_s",
          "waves_busy_s", "overlap_ratio", "runner_idle_wakeups",
          "runner_idle_wakeups_per_s", "p50_ms", "p99_ms", "p50_met",
          "p99_met", "replica_p50_ms", "replica_p99_ms", "auth_p50_ms",
          "auth_p99_ms"}


def _untimed(obj):
    if isinstance(obj, dict):
        return {k: _untimed(v) for k, v in obj.items() if k not in _TIMED}
    return obj


# ------------------------------------------------------------- the trace

def _json(rid, tenant, entity, op, value=None, **extra):
    req = {"id": rid, "tenant": tenant, "op": op, **extra}
    if entity is not None:
        req["entity"] = entity
    if value is not None:
        req["value"] = value
    return json.dumps(req, separators=(",", ":")).encode()


def _bin(fr, rows):
    ids, tenants, ents, ops, vals = zip(*rows)
    return fr.encode_request_batch(list(ids), list(tenants), list(ents),
                                   list(ops), list(vals))


def make_trace(fr):
    """[(kind, payload)]: kind "frame" goes through handle_frame, "batch"
    through handle_frame_batch (or submit_frames), "tick" advances the
    admission clock."""
    return [
        ("frame", _json(1, "t0", "e0", "add", 1.0)),
        ("frame", _bin(fr, [(2, "t0", "e0", "add", 2.0),
                            (3, "t0", "e1", "add", 3.0),
                            (4, "t1", "e2", "get", 0.0)])),
        ("batch", [
            _json(5, "t1", "e1", "add", 4.0),
            _bin(fr, [(6, "t0", "e2", "add", 5.0),
                      (7, "t0", "e0", "add", 1.0)]),
            _json(8, "t1", "e0", "get"),
            b"{not json",
            b"\xab\x01garbage",
            _json(9, "t0", None, "add", 1.0),
            _json(10, "t0", "e3", "mul", 1.0),
            _json(11, "t1", "e3", "add", "abc"),
            _json("x-12", "t1", "e3", "add", 2.5),
            _json(13, "__admin", "", "sum"),
            _bin(fr, [(14, "__admin", "e0", "add", 1.0)]),
        ]),
        ("tick", 100.0),
        # dedup: a resent id replays the cached reply; a duplicate id
        # inside one window aliases its first row
        ("frame", _json(1, "t0", "e0", "add", 1.0)),
        ("batch", [_bin(fr, [(20, "t1", "e4", "add", 2.0),
                             (20, "t1", "e4", "add", 2.0),
                             (21, "t1", "e4", "add", 3.0)]),
                   _json(2, "t0", "e0", "add", 2.0)]),
        # sheds: 12 records of one tenant against a burst of 8
        ("batch", [_bin(fr, [(100 + i, "greedy", f"g{i % 3}", "add",
                              float(i % 4 + 1)) for i in range(12)])]),
        ("frame", _json(200, "greedy", "g0", "add", 1.0)),
        ("tick", 100.0),
        ("frame", _json(201, "greedy", "g0", "add", 1.0)),
        # replica gets: hot entities answered from the published totals
        ("batch", [_json(30, "t0", "e0", "get"),
                   _bin(fr, [(31, "t0", "e1", "get", 0.0),
                             (32, "t1", "e4", "get", 0.0)])]),
        ("frame", _json(33, "__admin", "", "rebalance", 0.0)),
        ("batch", [_bin(fr, [(34, "t0", "e0", "add", 1.0),
                             (35, "t0", "e1", "add", 1.0),
                             (36, "t1", "e2", "add", 1.0)]),
                   _json(37, "t1", "e3", "get")]),
        ("frame", _json(38, "__admin", "", "sum")),
        ("frame", _json(39, "__admin", "", "stats")),
        ("frame", _json(40, "__admin", "", "durable")),
        ("frame", _json(41, "__admin", "", "nope")),
        ("frame", _json(42, "__admin", "", "artifact")),
    ]


def build(pkg, d, slots, continuous, clock):
    """One package's stack: region, backend, admission with the fake
    clock and the backend's pressure signals, SLO tracker, reply-cache
    dedup and (serialized only) a local read replica."""
    if pkg == "jax":
        g, Region, Entity, Replica = jg, JRegion, JEntity, JReplica
        kw = {}
    else:
        g, Region, Entity, Replica = tg, TRegion, TEntity, TReplica
        kw = {"device": "cpu"}
    region = Region(Entity(f"gw-d{d}-s{slots}-{int(continuous)}",
                           g.counter_behavior(P), n_shards=2,
                           entities_per_shard=16, n_devices=d,
                           payload_width=P, mailbox_slots=slots,
                           spare_blocks=2), **kw)
    backend = g.RegionBackend(region, max_batch=16, continuous=continuous,
                              pipeline_depth=4)
    adm = g.AdmissionController(
        rate=1.0, burst=8.0, clock=clock, check_interval_s=0.0,
        pressure_signals=backend.pressure_signals(),
        thresholds={"ask_pool_occupancy": 0.99})
    replica = None if continuous else Replica(
        lambda: region.system._host_step, hot_hits=1, hot_window_s=1e9,
        hot_ttl_s=1e9, max_step_lag=1 << 30)
    srv = g.GatewayServer(None, backend, adm, g.SloTracker(),
                          replica_cache=replica,
                          dedup=g.ReplyCacheTable(window=64))
    return region, backend, srv


def serve_trace(srv, trace, clock, continuous):
    out = []
    for kind, payload in trace:
        if kind == "tick":
            clock.t += payload
        elif kind == "frame" and not continuous:
            out.append([bytes(srv.handle_frame(payload))])
        else:
            bodies = [payload] if kind == "frame" else payload
            if continuous:
                got = srv.submit_frames(bodies).result(WAIT_S)
            else:
                got = srv.handle_frame_batch(bodies)
            out.append([bytes(b) for b in got])
    return out


def _admin_op(body):
    try:
        req = json.loads(body)
    except ValueError:
        return None
    return req.get("op") if req.get("tenant") == "__admin" else None


def assert_carries_match(jsys, tsys):
    got = numpy_carry(tsys)
    want = {f"state/{c}": np.asarray(jax.device_get(v))
            for c, v in jsys.state.items()}
    for f in SHARDED_FIELDS:
        want[f] = np.asarray(jax.device_get(getattr(jsys, f)))
    for k, w in want.items():
        if w.dtype.kind == "f":
            np.testing.assert_allclose(got[k], w, rtol=RTOL, atol=ATOL,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("continuous", [False, True],
                         ids=["serialized", "continuous"])
@pytest.mark.parametrize("d,slots", CONFIGS, ids=CONFIG_IDS)
def test_gateway_trace_replies_byte_identical(d, slots, continuous):
    results = {}
    for pkg, fr in (("jax", jframes), ("torch", tframes)):
        clock = FakeClock()
        region, backend, srv = build(pkg, d, slots, continuous, clock)
        trace = make_trace(fr)
        try:
            replies = serve_trace(srv, trace, clock, continuous)
            total = backend.sum_all()
        finally:
            backend.close()
        results[pkg] = (region, replies, total, trace)
    jregion, jrep, jtotal, trace = results["jax"]
    tregion, trep, ttotal, _ = results["torch"]
    sent = [p for k, p in trace if k != "tick"]
    assert len(jrep) == len(trep) == len(sent)
    for k, (jw, tw, bodies) in enumerate(zip(jrep, trep, sent)):
        bodies = [bodies] if isinstance(bodies, bytes) else bodies
        assert len(jw) == len(tw) == len(bodies)
        for j, t, body in zip(jw, tw, bodies):
            op = _admin_op(body)
            if op in ("stats", "artifact"):
                assert _untimed(json.loads(t)) == _untimed(json.loads(j)), op
            else:
                assert t == j, (k, body, j, t)
    assert ttotal == jtotal
    # every kind of reply showed up in the trace
    flat = [r for w in trep for r in w]
    text = b"".join(flat)
    for needle in (b"rate_limited", b"bad_request:JSONDecodeError",
                   b"bad_frame:", b"missing_entity", b"unknown_op:mul",
                   b'"dedup":true', b"admin_requires_json",
                   b"unknown_admin_op:nope"):
        assert needle in text, needle
    if not continuous:
        assert b'"replica":true' in text
        assert_carries_match(jregion.system, tregion.system)


def test_port_admin_ops_not_ported_reply_typed_errors(tmp_path):
    """checkpoint answers ok once the region has its journal (and the
    region's restore() returns the step); failover rebuilds the region on
    the first `value` shard slots of its mesh (2 -> 1) and answers ok with
    the recovered step, as the reference's op does on its devices; the
    replica's ddata mode still raises naming A11/A12."""
    clock = FakeClock()
    stacks = {pkg: build(pkg, 2, 0, False, clock) for pkg in ("jax",
                                                              "torch")}
    try:
        got = {}
        for pkg, (region, backend, srv) in stacks.items():
            rep = json.loads(srv.handle_frame(_json(1, "__admin", "",
                                                    "checkpoint", 1.0)))
            assert rep["status"] == "error"  # no journal attached yet
            assert rep["reason"].startswith("admin_fault:RuntimeError"), rep
            region.attach_journal(str(tmp_path / pkg))
            json.loads(srv.handle_frame(_json(2, "t0", "e0", "add", 3.0)))
            rep = json.loads(srv.handle_frame(_json(3, "__admin", "",
                                                    "checkpoint", 1.0)))
            assert rep["status"] == "ok", rep
            step = region.system._host_step
            if pkg == "torch":
                assert rep["data"]["path"].endswith(".npz")
                assert region.restore() == step  # the recovered frontier
                assert region.system._host_step == step + 2  # the flush
            rep = json.loads(srv.handle_frame(_json(4, "__admin", "",
                                                    "failover", 1.0)))
            assert rep["status"] == "ok", rep
            assert rep["value"] == float(step)  # the snapshot, no WAL tail
            assert region.system.n_shards == region.n_devices == 1
            assert region.blocks_per_device == region.total_blocks
            assert backend.sum_all() == 3.0
            got[pkg] = (rep["value"], region.system._host_step)
        assert got["torch"] == got["jax"]
        # the survivor is the mesh's first slot
        assert [s.index for s in stacks["torch"][0].system.mesh.slots] == [0]
        with pytest.raises(NotImplementedError, match="A11/A12"):
            TReplica(lambda: 0, system=object())
    finally:
        for _region, backend, srv in stacks.values():
            srv.stop()
            backend.close()


# ------------------------------------------------------------ frame codec

def _codec_inputs(seed, n):
    rng = np.random.default_rng(seed)
    ids = [int(x) for x in rng.integers(-(1 << 62), 1 << 62, n)]
    tenants = [f"t{int(x)}" * int(1 + x % 5) for x in rng.integers(0, 50, n)]
    ents = [f"ent-{int(x)}" for x in rng.integers(0, 1 << 30, n)]
    ops = [["add", "get", 1, 2][int(x)] for x in rng.integers(0, 4, n)]
    vals = [float(x) for x in rng.normal(size=n)]
    return ids, tenants, ents, ops, vals


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 7), (2, 64)])
def test_frames_encode_decode_byte_equal(seed, n):
    ids, tenants, ents, ops, vals = _codec_inputs(seed, n)
    jb = jframes.encode_request_batch(ids, tenants, ents, ops, vals)
    tb = tframes.encode_request_batch(ids, tenants, ents, ops, vals)
    assert tb == jb
    assert tframes.frame(tb) == jframes.frame(jb)
    jr, tr = jframes.decode_request_batch(jb), tframes.decode_request_batch(tb)
    assert tr.tobytes() == jr.tobytes() and tr.dtype == jr.dtype
    jm, jc = jframes.decode_request_batches([jb, jb])
    tm, tc = tframes.decode_request_batches([tb, tb])
    assert tm.tobytes() == jm.tobytes() and tc == jc
    rng = np.random.default_rng(seed + 100)
    rids = np.asarray(ids, np.int64)
    status = rng.integers(0, 3, n).astype(np.uint8)
    reason = np.asarray([b"", b"rate_limited", b"timeout"])[
        rng.integers(0, 3, n)]
    value = rng.normal(size=n)
    retry = rng.integers(0, 1000, n).astype(np.uint32)
    traces = rng.integers(0, 1 << 62, n).astype(np.uint64)
    lags = rng.integers(-1, 50, n).astype(np.int32)
    dedups = rng.integers(0, 2, n).astype(np.uint8)
    for extra in ((), (traces,), (traces, lags), (traces, lags, dedups),
                  (None, None, dedups)):
        jrb = jframes.encode_reply_batch(rids, status, reason, value, retry,
                                         *extra)
        trb = tframes.encode_reply_batch(rids, status, reason, value, retry,
                                         *extra)
        assert trb == jrb
        assert tframes.decode_replies(trb) == jframes.decode_replies(jrb)
    for bad in (b"", b"\xab", b"\xab\x01\x00", jb[:-3], b"\x00" + jb[1:]):
        with pytest.raises(jframes.FrameFormatError) as je:
            jframes.decode_request_batch(bad)
        with pytest.raises(tframes.FrameFormatError) as te:
            tframes.decode_request_batch(bad)
        assert te.value.code == je.value.code


def test_frame_reader_and_json_codec_equal():
    body = {"id": 7, "tenant": "t0", "entity": "acct-42", "op": "add",
            "value": 3}
    assert tg.encode_frame(body) == jg.encode_frame(body)
    assert tg.encode_body(body) == jg.encode_body(body)
    stream = tg.encode_frame(body) * 3
    tr, jr = tg.FrameReader(), jg.FrameReader()
    got_t, got_j = [], []
    for i in range(0, len(stream), 5):  # partial chunks
        got_t += list(tr.feed(stream[i:i + 5]))
        got_j += list(jr.feed(stream[i:i + 5]))
    assert got_t == got_j == [body] * 3
    assert tg.DEFAULT_MAX_FRAME == jg.DEFAULT_MAX_FRAME
    with pytest.raises(ValueError, match="exceeds"):
        list(tg.FrameReader(max_frame=8).feed_raw(b"\x00\x00\x01\x00"))


# ------------------------------------------------------ admission, dedup

@pytest.mark.parametrize("max_resident", [3, 1024])
def test_vector_tenant_table_grants_equal(max_resident):
    """charge_groups over a random tenant stream (with LRU spills when
    residency is tight): grants, retry-afters and stats bit-equal."""
    jt = jg.VectorTenantTable(rate=3.0, burst=5.0, max_resident=max_resident,
                              init_capacity=1)
    tt = tg.VectorTenantTable(rate=3.0, burst=5.0, max_resident=max_resident,
                              init_capacity=1)
    rng = np.random.default_rng(max_resident)
    now = 10.0
    for _ in range(200):
        k = int(rng.integers(1, 4))  # a window fits the residency
        tenants = [f"ten-{int(x)}" for x in
                   rng.choice(9, size=k, replace=False)]
        counts = [int(x) for x in rng.integers(0, 7, k)]
        now += float(rng.exponential(0.4))
        jk, jr = jt.charge_groups(tenants, counts, now)
        tk, trr = tt.charge_groups(tenants, counts, now)
        np.testing.assert_array_equal(tk, jk)
        np.testing.assert_array_equal(trr, jr)
    assert tt.stats() == jt.stats()
    if max_resident == 3:
        assert tt.stats()["spills"] > 0


def test_admission_controller_verdicts_equal():
    """admit_groups with a pressure signal and the ask-pool cooldown:
    verdicts and stats equal the reference's."""
    level = {"v": 0.0}
    out = {}
    for name, g in (("jax", jg), ("torch", tg)):
        clock = FakeClock()
        adm = g.AdmissionController(
            rate=2.0, burst=4.0, clock=clock, check_interval_s=0.0,
            cooldown_s=1.5, pressure_signals={"load": lambda: level["v"]},
            thresholds={"load": 0.5})
        seen = []
        for step in range(30):
            level["v"] = 0.9 if step in (7, 8) else 0.1
            if step == 15:
                adm.note_ask_pool_exhausted()
            verdicts = adm.admit_groups({"a": step % 3 + 1, "b": 2})
            seen.append({t: (k, None if r is None else
                             (r.reason, r.retry_after_s))
                         for t, (k, r) in verdicts.items()})
            r = adm.admit("c")
            seen.append(None if r is None else (r.reason, r.retry_after_s))
            clock.t += 0.4
        out[name] = (seen, adm.stats())
    assert out["torch"] == out["jax"]


def test_reply_cache_table_equal():
    """begin / record / release / load over a random stream (hits,
    same-window aliases, in-flight duplicates, window evictions):
    verdicts, lookups and stats equal the reference's."""
    out = {}
    for name, g in (("jax", jg), ("torch", tg)):
        clock = FakeClock()
        t = g.ReplyCacheTable(window=8, max_resident=4, init_capacity=1,
                              clock=clock)
        rng = np.random.default_rng(3)
        seen = []
        t.load([("t0", 1, 0, 5.0), ("t1", 2, 2, 0.0)])
        for _ in range(60):
            keys = [None if x == 0 else (f"t{int(x) % 3}",
                                         int(rng.integers(0, 12)))
                    for x in rng.integers(0, 4, int(rng.integers(1, 5)))]
            v = t.begin(keys)
            seen.append(v)
            for key, verdict in zip(keys, v):
                if verdict[0] != "miss":
                    continue
                r = rng.integers(0, 3)
                if r == 0:
                    t.release(key)
                else:
                    t.record(key, int(r - 1), float(rng.integers(0, 9)),
                             b"timeout" if r == 2 else b"")
            seen.append(t.lookup(("t0", 1)))
            clock.t += 1.0
        out[name] = (seen, t.stats())
    assert out["torch"] == out["jax"]
    assert tg.dedup.DUPLICATE_INFLIGHT == jg.dedup.DUPLICATE_INFLIGHT


def test_slo_tracker_equal():
    """record / record_many with latencies and replica flags: the same
    artifact (latency percentiles included) as the reference's."""
    out = {}
    for name, g in (("jax", jg), ("torch", tg)):
        s = g.SloTracker(target_p50_ms=5.0, target_p99_ms=20.0, window=64)
        rng = np.random.default_rng(9)
        for i in range(150):
            ten = f"t{i % 3}"
            outc = ["ok", "ok", "ok", "reject", "timeout", "error"][i % 6]
            s.record(ten, outc, float(rng.exponential(0.004)))
        s.record_many("t9", ["ok", "reject", "ok"], [0.001, None, 0.002],
                      [True, False, False])
        with pytest.raises(ValueError):
            s.record("t0", "bogus")
        out[name] = (s.artifact(), s.percentile(0.5), s.percentile(0.99))
    assert out["torch"] == out["jax"]
