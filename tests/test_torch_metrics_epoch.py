"""The metrics epoch and the epoch-gated slab drain of the port's
BatchedSystem and ShardedBatchedSystem against the reference's, on the
CPU.

Both packages build the same 64-row system (a ring whose tokens cross
shards on the sharded one), with metrics on or off, quiet (no message in
flight: the slab stays empty) or seeded with the same tells, and run the
same steps. After every `run(k)`, `metrics_epoch_value()` must equal the
reference's bit for bit, `drain_metrics()` must return the same
`(step, lanes)` (or None where the reference does), and a second drain
None. A `checkpoint`/`restore` must make the restored slab drainable
again, in place and, for the sharded system, across a change of shard
count (the resharded restore).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import akka_tpu.batched as jb
from akka_tpu.batched.sharded import ShardedBatchedSystem as JSharded
from akka_tpu.persistence import slab_snapshot as jsnap

import akka_tpu_torch.batched as tb
from akka_tpu_torch.batched.sharded import ShardedBatchedSystem as TSharded

P = 4
N = 64


@jb.behavior("ep_ring", {"n": ((), jnp.int32)})
def j_ring(state, inbox, ctx):
    return ({"n": state["n"] + inbox.count},
            jb.Emit.single((ctx.actor_id + 1) % ctx.n_actors, inbox.sum, 1,
                           P, when=inbox.count > 0))


@tb.behavior("ep_ring", {"n": ((), torch.int32)})
def t_ring(state, inbox, ctx):
    return ({"n": state["n"] + inbox.count},
            tb.Emit.single((ctx.actor_id + 1) % ctx.n_actors, inbox.sum, 1,
                           P, when=inbox.count > 0))


def _pair(kind, metrics, d=2):
    """The same system in both packages, every row spawned."""
    if kind == "batched":
        ref = jb.BatchedSystem(capacity=N, behaviors=[j_ring],
                               payload_width=P, host_inbox=16,
                               native_staging=False, metrics_enabled=metrics)
        port = tb.BatchedSystem(capacity=N, behaviors=[t_ring],
                                payload_width=P, host_inbox=16, device="cpu",
                                metrics_enabled=metrics)
    else:
        ref = JSharded(capacity=N, behaviors=[j_ring], n_devices=d,
                       payload_width=P, host_inbox_per_shard=8,
                       metrics_enabled=metrics)
        port = TSharded(capacity=N, behaviors=[t_ring], n_devices=d,
                        payload_width=P, host_inbox_per_shard=8,
                        metrics_enabled=metrics, device="cpu")
    for s in (ref, port):
        s.spawn_block(0, N)
    return ref, port


def _tell(systems, seed, k):
    rng = np.random.default_rng(seed)
    dsts = rng.integers(0, N, k)
    for s in systems:
        if hasattr(s, "n_shards"):  # one row per tell
            for d in dsts:
                s.tell(int(d), np.ones(P, np.float32))
        else:
            s.tell(dsts.astype(np.int32), np.ones((k, P), np.float32))


def _assert_drains_match(ref, port, ctx):
    assert port.metrics_epoch_value() == ref.metrics_epoch_value(), ctx
    want, got = ref.drain_metrics(), port.drain_metrics()
    if want is None:
        assert got is None, ctx
    else:
        assert got is not None, ctx
        assert got[0] == want[0], ctx
        assert sorted(got[1]) == sorted(want[1]), ctx
        for lane, buckets in want[1].items():
            assert got[1][lane].dtype == np.int64
            np.testing.assert_array_equal(got[1][lane], buckets,
                                          err_msg=f"{ctx} {lane}")
    assert port.drain_metrics() is None and ref.drain_metrics() is None, ctx
    return got


CASES = [(m, t) for m in (True, False) for t in ("seeded", "quiet")]
IDS = [f"metrics_{'on' if m else 'off'}-{t}" for m, t in CASES]


@pytest.mark.parametrize("kind", ["batched", "sharded"])
@pytest.mark.parametrize("metrics,traffic", CASES, ids=IDS)
def test_epoch_and_drain_equal_the_reference(kind, metrics, traffic):
    ref, port = _pair(kind, metrics)
    word = port.metrics_epoch.data_ptr()
    drained = []
    for i in range(3):
        if traffic == "seeded":
            _tell((ref, port), seed=i, k=5 + 3 * i)
        ref.run(3)
        port.run(3)
        drained.append(_assert_drains_match(ref, port, f"run {i}"))
    assert port.metrics_epoch.data_ptr() == word  # written in place
    epoch = port.metrics_epoch_value()
    if metrics and traffic == "seeded":
        assert all(d is not None for d in drained)
        assert epoch == int(sum(v.sum() for v in port.read_metrics()
                                .values())) > 0
        assert drained[-1][0] == port._host_step == 9
    else:
        assert epoch == 0 and drained == [None, None, None]


def _restored(kind, tmp_path, d_from=2, d_to=2):
    """Seeded traffic, a drained checkpoint, then a fresh system of each
    package restored from its own package's snapshot."""
    ref, port = _pair(kind, True, d=d_from)
    _tell((ref, port), seed=4, k=12)
    for s in (ref, port):
        s.run(3)
    _assert_drains_match(ref, port, "before the checkpoint")
    paths = (ref.checkpoint(str(tmp_path / "ref")),
             port.checkpoint(str(tmp_path / "port")))
    lanes = port.read_metrics()
    fresh = _pair(kind, True, d=d_to)
    for s, path in zip(fresh, paths):
        s.restore(path)
    return fresh, lanes


@pytest.mark.parametrize("kind", ["batched", "sharded"])
def test_restore_makes_the_slab_drainable_again(kind, tmp_path, monkeypatch):
    monkeypatch.setattr(jsnap, "_try_orbax", lambda: None)
    (ref, port), lanes = _restored(kind, tmp_path)
    got = _assert_drains_match(ref, port, "after restore")
    assert got is not None and got[0] == 3
    for lane, buckets in lanes.items():
        np.testing.assert_array_equal(got[1][lane], buckets)
    _tell((ref, port), seed=5, k=4)
    for s in (ref, port):
        s.run(3)
    assert _assert_drains_match(ref, port, "after the next run")[0] == 6


@pytest.mark.parametrize("d_from,d_to", [(2, 1), (1, 2)])
def test_resharded_restore_makes_the_slab_drainable_again(
        tmp_path, monkeypatch, d_from, d_to):
    monkeypatch.setattr(jsnap, "_try_orbax", lambda: None)
    (ref, port), lanes = _restored("sharded", tmp_path, d_from, d_to)
    assert port.n_shards == ref.n_shards == d_to  # another inbox layout
    got = _assert_drains_match(ref, port, "after the resharded restore")
    assert got is not None
    for lane, buckets in lanes.items():  # conserved into shard 0
        np.testing.assert_array_equal(got[1][lane], buckets)
    _tell((ref, port), seed=6, k=4)
    for s in (ref, port):
        s.run(3)
    _assert_drains_match(ref, port, "after the next run")


def test_metrics_off_restore_keeps_the_epoch_zero(tmp_path):
    ref, port = _pair("batched", False)
    _tell((port,), seed=7, k=8)
    port.run(3)
    path = port.checkpoint(str(tmp_path))
    fresh = _pair("batched", False)[1]
    fresh.restore(path)
    assert fresh.metrics_epoch_value() == 0
    assert fresh.drain_metrics() is None
    assert ref.metrics_epoch_value() == 0


def test_region_with_metrics_drains_its_slab():
    """The port's DeviceEntity.metrics_enabled compiles the slab into the
    region's step: asks and a rebalance fill it, and the region's system
    drains it once."""
    from akka_tpu_torch.gateway import counter_behavior
    from akka_tpu_torch.sharding import DeviceEntity, DeviceShardRegion

    region = DeviceShardRegion(DeviceEntity(
        "m", counter_behavior(P), n_shards=2, entities_per_shard=16,
        n_devices=2, metrics_enabled=True), device="cpu")
    assert region.system.metrics_on
    refs = [region.entity_ref(f"e{i}") for i in range(6)]
    out = region.ask_many([(r.shard, r.index, [1.0]) for r in refs])
    assert all(float(o[0]) == 1.0 for o in out)
    region.rebalance(refs[0].shard)
    out = region.ask_many([(r.shard, r.index, [2.0]) for r in refs])
    assert all(float(o[0]) == 3.0 for o in out)
    step, lanes = region.system.drain_metrics()
    assert step == region.system._host_step
    assert lanes["mailbox_occupancy"].sum() > 0
    assert lanes["sojourn_steps"].sum() > 0
    assert region.system.drain_metrics() is None
