"""The port's durability files (akka_tpu_torch.persistence and the
remember-entities store) against the reference's (akka_tpu), on the CPU.

The same bytes go through both packages: the record log's torn-tail repair,
and every journal written by one package and read by the other
(TellJournal, EntityJournal, JournalRememberEntitiesStore). Slab snapshots:
a `.npz` written by either package loads in the other (the reference writes
an orbax directory whenever orbax imports, so `_try_orbax` is patched to
None inside the tests that need its `.npz`), restores into the other's
system to the same carry, upgrades v1/v2 snapshots the same way, and a
snapshot newer than v3 is refused. Integers and totals are compared bit for
bit (the counters add integer-valued float32).
"""

import os
import pickle
import struct

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # tiny tensors: spare the other test workers

import jax.numpy as jnp

import akka_tpu.batched as jb
from akka_tpu.actor.supervision import Directive as JDirective
from akka_tpu.persistence import EntityJournal as JEntityJournal
from akka_tpu.persistence import journal as jjournal
from akka_tpu.persistence import slab_snapshot as jslab
from akka_tpu.persistence.tell_journal import TellJournal as JTellJournal
from akka_tpu.sharding import \
    JournalRememberEntitiesStore as JRememberStore

import akka_tpu_torch.batched as tb
from akka_tpu_torch.persistence import EntityJournal as TEntityJournal
from akka_tpu_torch.persistence import OP_ADD
from akka_tpu_torch.persistence import journal as tjournal
from akka_tpu_torch.persistence import slab_snapshot as tslab
from akka_tpu_torch.persistence.tell_journal import TellJournal as TTellJournal
from akka_tpu_torch.sharding import remember as tremember
from akka_tpu_torch.utils.carry import DEVICE_FIELDS, numpy_carry

P = 4
N = 16


def _no_orbax(monkeypatch):
    """Make the reference write and read `.npz` (its orbax path is a JAX
    library the port cannot read)."""
    monkeypatch.setattr(jslab, "_try_orbax", lambda: None)


# ------------------------------------------------------------- record log

def _blob(i):
    return pickle.dumps({"i": i, "a": np.arange(i, dtype=np.int32)},
                        protocol=4)


TAILS = {
    "intact": b"",
    "short_header": b"\x07garbage",
    "short_blob": struct.pack("<Q", len(_blob(9))) + _blob(9)[:11],
    "absurd_length": (1 << 40).to_bytes(8, "little") + b"torn",
    "garbled_pickle": struct.pack("<Q", 6) + b"\x80\x04garb",
}


@pytest.mark.parametrize("tail", sorted(TAILS))
def test_record_log_repair_matches_reference_on_same_bytes(tmp_path, tail):
    body = b"".join(struct.pack("<Q", len(_blob(i))) + _blob(i)
                    for i in range(4))
    out = {}
    for name, mod in (("ref", jjournal), ("port", tjournal)):
        path = str(tmp_path / f"{name}.log")
        with open(path, "wb") as f:
            f.write(body + TAILS[tail])
        scanned = [(end, rec["i"]) for end, rec in mod.scan_record_log(path)]
        dropped = mod.repair_record_log(path)
        out[name] = (scanned, dropped, os.path.getsize(path),
                     mod.repair_record_log(path))
    assert out["port"] == out["ref"]
    assert out["port"][1] == len(TAILS[tail])
    assert out["port"][3] == 0  # idempotent on a repaired log


# --------------------------------------------------------------- journals

def _tell_records(j):
    rng = np.random.default_rng(3)
    for step in range(5):
        k = int(rng.integers(1, 4))
        j.append(step, "tell", rng.integers(0, N, k).astype(np.int32),
                 rng.integers(1, 9, (k, P)).astype(np.float32),
                 np.zeros((k,), np.int32))
    j.append(5, "seed", np.arange(3, dtype=np.int32),
             np.ones((3, P), np.float32), np.asarray(0))
    j.append(6, "tell", torch.tensor([2], dtype=torch.int32),
             torch.ones((1, P)), torch.tensor([1], dtype=torch.int32))


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_tell_journal_read_by_the_other_package(tmp_path, writer):
    path = str(tmp_path / "tells.wal")
    W, R = (TTellJournal, JTellJournal) if writer == "port" \
        else (JTellJournal, TTellJournal)
    if writer == "ref":  # the reference's records hold numpy only
        j = W(path)
        j.append(0, "tell", np.asarray([1], np.int32),
                 np.ones((1, P), np.float32), np.asarray([0], np.int32))
    else:
        j = W(path, fsync_every_n=3)
        _tell_records(j)
    j.close()
    with open(path, "ab") as f:  # a torn tail the reader must drop
        f.write((1 << 20).to_bytes(8, "little") + b"torn")
    r = R(path)
    assert r.truncated_bytes == 12
    recs = list(r.records())
    assert recs and all(isinstance(rec[k], np.ndarray) for rec in recs
                        for k in ("dst", "mtype", "payload"))
    if writer == "port":
        assert [rec["step"] for rec in recs] == list(range(7))
        assert recs[5]["kind"] == "seed"
        assert recs[6]["dst"].tolist() == [2]
    # compaction keeps exactly the records at or after the step
    assert r.compact(4) == sum(rec["step"] >= 4 for rec in recs)
    r.close()
    back = W(path)
    assert [rec["step"] for rec in back.records()] == \
        [rec["step"] for rec in recs if rec["step"] >= 4]
    back.close()


def _entity_waves(j):
    rng = np.random.default_rng(5)
    for step in range(12):
        ents = [f"e{int(x)}" for x in rng.integers(0, 5, 3)]
        vals = rng.integers(1, 9, 3).astype(float)
        replies = [(f"t{step % 2}", step * 10 + i, 0, float(v))
                   for i, v in enumerate(vals)]
        j.append_wave(step, [(e, OP_ADD, v) for e, v in zip(ents, vals)],
                      replies=replies)
        if step == 6:
            j.compact()
    j.append_wave(12, [], replies=[("t0", 999, 0, 1.0)])  # gets only


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_entity_journal_read_by_the_other_package(tmp_path, writer):
    path = str(tmp_path / "entities.journal")
    W = TEntityJournal if writer == "port" else JEntityJournal
    w = W(path, snapshot_every=3)
    _entity_waves(w)
    want = (w.totals(), w.replies(), w.stats()["waves"])
    w.close()
    with open(path, "ab") as f:
        f.write((1 << 20).to_bytes(8, "little") + b"torn")
    readers = {"port": TEntityJournal(path, snapshot_every=3),
               "ref": JEntityJournal(path, snapshot_every=3)}
    try:
        assert readers["port"].truncated_bytes == 12  # opened first
        # one file, one fold: both packages replay it alike
        assert readers["port"].totals() == readers["ref"].totals()
        assert readers["port"].replies() == readers["ref"].replies() \
            == want[1]
        assert readers["port"].replayed_events() == \
            readers["ref"].replayed_events()
        assert readers["port"].records() == readers["ref"].records()
        assert want[2] == 13
        if writer == "port":
            # the port's snaps are post-wave totals: the file replays to
            # the writer's live fold. (The reference's live fold differs
            # from its own file here: wave 5 repeats e3 across its
            # snapshot threshold, and the reference snaps the total in
            # between.)
            assert readers["port"].totals() == want[0]
    finally:
        for r in readers.values():
            r.close()


def test_entity_journal_snap_is_the_post_wave_total(tmp_path):
    """An entity repeated in one wave across its snapshot threshold: the
    piggybacked snap is its total after the whole wave, so a reopen
    replays exactly the live fold."""
    path = str(tmp_path / "e.journal")
    ej = TEntityJournal(path, snapshot_every=2)
    ej.append_wave(1, [("a", OP_ADD, 1.0)])
    ej.append_wave(2, [("a", OP_ADD, 2.0), ("a", OP_ADD, 4.0)])
    assert ej.records()[1]["snaps"] == {"a": 7.0}
    assert ej.totals() == {"a": 7.0}
    ej.close()
    for cls in (TEntityJournal, JEntityJournal):
        twin = cls(path, snapshot_every=2)
        assert twin.totals() == {"a": 7.0}
        twin.close()


def test_entity_journal_group_commit_and_per_event_leg(tmp_path):
    ej = TEntityJournal(str(tmp_path / "e.journal"), fsync_every_n=4)
    for step in range(7):
        ej.append_wave(step, [("a", OP_ADD, 1.0)])
    assert ej.stats()["fsyncs"] == 1  # wave 4 only; 3 pending
    ej.sync()
    assert ej.stats()["fsyncs"] == 2
    ej.append_wave(8, [("a", OP_ADD, 1.0), ("b", OP_ADD, 2.0)],
                   per_event_fsync=True)
    assert ej.stats()["fsyncs"] == 4 and len(ej.records()) == 9
    assert ej.append_wave(9, []) == 0  # an all-get wave writes nothing
    assert ej.totals() == {"a": 8.0, "b": 2.0}
    ej.close()
    with pytest.raises(ValueError, match="closed"):
        ej.append_wave(10, [("a", OP_ADD, 1.0)])


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_remember_store_read_by_the_other_package(tmp_path, writer):
    path = str(tmp_path / "remember.journal")
    W, R = (tremember.JournalRememberEntitiesStore, JRememberStore) \
        if writer == "port" else \
        (JRememberStore, tremember.JournalRememberEntitiesStore)
    w = W(path, fsync_every_n=2)
    for i in range(8):
        w.add("Counter", str(i % 2), f"e{i}")
    w.add("Counter", "0", "e0")  # already present: no record
    w.remove("Counter", "1", "e1")
    assert w.compact() == 7
    w.add("Other", "3", "x")
    w.close()
    with open(path, "ab") as f:
        f.write((1 << 20).to_bytes(8, "little") + b"torn")
    r = R(path)
    assert r.truncated_bytes == 12
    assert r.remembered("Counter", "0") == {"e0", "e2", "e4", "e6"}
    assert r.remembered("Counter", "1") == {"e3", "e5", "e7"}
    assert r.remembered("Other", "3") == {"x"}
    r.close()


def test_inproc_store_and_ddata_store_refusal():
    tremember.InProcRememberEntitiesStore.reset()
    s = tremember.InProcRememberEntitiesStore()
    s.add("T", "0", "a")
    assert tremember.InProcRememberEntitiesStore().remembered("T", "0") \
        == {"a"}
    s.remove("T", "0", "a")
    assert s.remembered("T", "0") == set()
    tremember.InProcRememberEntitiesStore.reset()
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        tremember.DDataRememberEntitiesStore(object())


# ---------------------------------------------------------- slab snapshots

def _j_acc(sup):
    @jb.behavior("acc", {"acc": ((), jnp.float32)}, always_on=True,
                 supervisor=sup)
    def acc(state, inbox, ctx):
        fail = (ctx.actor_id % 5 == 2) & (ctx.step % 4 == 3)
        return ({"acc": state["acc"] + 1.0 + inbox.sum[0],
                 "_failed": fail},
                jb.Emit.single((ctx.actor_id + 3) % ctx.n_actors,
                               inbox.sum + 1.0, 1, P))
    return acc


def _t_acc(sup):
    @tb.behavior("acc", {"acc": ((), torch.float32)}, always_on=True,
                 supervisor=sup)
    def acc(state, inbox, ctx):
        fail = (ctx.actor_id % 5 == 2) & (ctx.step % 4 == 3)
        return ({"acc": state["acc"] + 1.0 + inbox.sum[:, 0],
                 "_failed": fail},
                tb.Emit.single((ctx.actor_id + 3) % ctx.n_actors,
                               inbox.sum + 1.0, 1, P))
    return acc


def _pair():
    """The same supervised system in both packages (RESTART with
    backoff, so the supervision slabs are non-trivial)."""
    j = jb.BatchedSystem(N, [_j_acc(jb.LaneSupervisor(
        JDirective.RESTART, min_backoff_steps=2, max_backoff_steps=8))],
        payload_width=P)
    t = tb.BatchedSystem(N, [_t_acc(tb.LaneSupervisor(
        tb.Directive.RESTART, min_backoff_steps=2, max_backoff_steps=8))],
        payload_width=P, device="cpu")
    j.spawn_block(0, N)
    t.spawn_block(0, N)
    return j, t


def _jax_carry(j):
    out = {f"state/{c}": np.asarray(v) for c, v in j.state.items()}
    for f in DEVICE_FIELDS:
        out[f] = np.asarray(getattr(j, f))
    return out


def _assert_carry_equal(a, b):
    assert set(a) >= set(b) or set(b) >= set(a)
    for k in sorted(set(a) & set(b)):
        if k.startswith("host/"):
            continue
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _drive(sys_, steps, block=None):
    for s in range(steps):
        sys_.tell(np.asarray([s % N]), np.full((1, P), float(s % 3 + 1),
                                                np.float32))
        sys_.step()
        if block is not None:
            block()


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_npz_snapshot_restores_in_the_other_package(tmp_path, monkeypatch,
                                                    writer):
    _no_orbax(monkeypatch)
    j, t = _pair()
    src = t if writer == "port" else j
    _drive(src, 9, block=getattr(src, "block_until_ready"))
    path = src.checkpoint(str(tmp_path / writer))
    assert path.endswith("slab-9.npz")
    # both loaders read the same file to the same tree
    jt, tt = jslab.load_slab_tree(path), tslab.load_slab_tree(path)
    assert sorted(jt) == sorted(tt) and sorted(jt["state"]) == \
        sorted(tt["state"])
    for k in jt:
        if k != "state":
            np.testing.assert_array_equal(jt[k], tt[k], err_msg=k)
    assert int(tt["schema_version"]) == tslab.SCHEMA_VERSION
    # the other package's system restores it to the writer's carry
    dst = j if writer == "port" else t
    dst.restore(path)
    assert dst._host_step == 9
    want = numpy_carry(t) if writer == "port" else _jax_carry(j)
    got = _jax_carry(j) if writer == "port" else numpy_carry(t)
    _assert_carry_equal(got, want)


def test_port_snapshot_layout_is_the_reference_slab_pytree(tmp_path):
    j, t = _pair()
    tree_t = tslab.slab_pytree(t)
    tree_j = jslab.slab_pytree(j)
    assert sorted(tree_t) == sorted(tree_j)
    assert sorted(tree_t["state"]) == sorted(tree_j["state"])
    for k in tree_j:
        if k == "state":
            continue
        assert np.asarray(tree_t[k]).dtype == np.asarray(tree_j[k]).dtype, k
        assert np.shape(tree_t[k]) == np.shape(tree_j[k]), k


@pytest.mark.parametrize("version", [1, 2])
def test_old_schema_upgrade_zero_fills_like_the_reference(tmp_path, version):
    """A v1 (core slabs only, no schema_version) or v2 (no telemetry
    slabs) snapshot restored into dirty supervised systems of both
    packages: every slab the file lacks is re-armed, the same way."""
    j, t = _pair()
    _drive(t, 12)
    tree = tslab.slab_pytree(t)
    flat = {}
    for col, arr in tree["state"].items():
        if version > 1 or not col.startswith("_"):
            flat[f"state.{col}"] = arr
    keys = tslab._SLAB_KEYS_V1 + (tslab._SLAB_KEYS_V2 if version > 1
                                  else ())
    for k in keys:
        if k in tree:
            flat[k] = tree[k]
    if version > 1:
        flat["schema_version"] = np.int64(2)
    path = str(tmp_path / "slab-12.npz")
    np.savez(path, **flat)

    dj, dt = _pair()
    _drive(dj, 20, block=dj.block_until_ready)  # dirty the targets
    _drive(dt, 20)
    dj.restore(path)
    dt.restore(path)
    got, want = numpy_carry(dt), _jax_carry(dj)
    _assert_carry_equal(got, want)
    assert int(dt.step_count) == 12
    np.testing.assert_array_equal(got["metrics"], 0)  # v3, absent
    if version == 1:
        np.testing.assert_array_equal(got["sup_counts"], 0)
        np.testing.assert_array_equal(got["state/_restart_at"],
                                      np.full(N, -1))
        np.testing.assert_array_equal(got["state/_retries"], 0)


def test_newer_schema_refused(tmp_path):
    _, t = _pair()
    path = t.checkpoint(str(tmp_path))
    tree = dict(tslab.load_slab_tree(path))
    tree["schema_version"] = np.int64(tslab.SCHEMA_VERSION + 1)
    with pytest.raises(ValueError, match="newer"):
        tslab.restore_slab_pytree(t, tree)
    with pytest.raises(ValueError, match="orbax"):
        tslab.load_slab_tree(str(tmp_path / "slab-0"))


def test_restore_writes_the_live_tensors_in_place(tmp_path):
    """Restore copies into the system's existing tensors: a holder of
    `state[col]` or the inbox keeps reading the restored state."""
    _, t = _pair()
    _drive(t, 5)
    path = t.checkpoint(str(tmp_path))
    _, fresh = _pair()
    held = {"acc": fresh.state["acc"], "inbox_dst": fresh.inbox_dst,
            "step_count": fresh.step_count}
    fresh.restore(path)
    assert fresh.state["acc"] is held["acc"]
    assert fresh.inbox_dst is held["inbox_dst"]
    assert fresh.step_count is held["step_count"]
    np.testing.assert_array_equal(held["acc"].numpy(),
                                  t.state["acc"].numpy())


def test_gc_and_latest_snapshot(tmp_path):
    _, t = _pair()
    d = str(tmp_path)
    for _ in range(4):
        _drive(t, 2)
        t.checkpoint(d, keep=2)
    names = sorted(os.listdir(d))
    assert names == ["slab-6.npz", "slab-8.npz"]
    assert tslab.latest_slab_path(d).endswith("slab-8.npz")
    assert tslab.latest_slab_path(str(tmp_path / "none")) is None
