"""The port's native substrate (akka_tpu_torch/native/): the reference's
tests/test_native.py cases that have a port counterpart, in-process, and
the port's own contracts: the locked build, no silent fallback, and a
stager that never drops a batch a drain fenced. BatchedSystem's staging
scenarios (drops, WAL, slots type tags, the recycled-row scrub, restore)
run on both packages, each on the native stager and on the Python list:
every port path equals the reference's same path.

Every thread, timer and ActorSystem starts through the `actors` fixture,
which stops them, asserts that each system finished terminating and that
no thread the test started is still alive. The native library builds at
first use through native/lib.py's locked build (the one build a tier-1
test may run)."""

import os
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import akka_tpu.batched as jb
from akka_tpu.persistence.tell_journal import TellJournal as JTellJournal
from akka_tpu_torch import ActorSystem, Props
from akka_tpu_torch.actor.actor import Actor
from akka_tpu_torch.batched import BatchedSystem, Emit, behavior
from akka_tpu_torch.native import lib as native_lib
from akka_tpu_torch.persistence.tell_journal import TellJournal
from akka_tpu_torch.testkit import TestProbe

from torch_actor_fixture import Actors

CFG = {"akka": {"stdout-loglevel": "OFF", "log-dead-letters": 0}}


class _Kit(Actors):
    """The file's one fixture's bookkeeping: Actors plus native timers."""

    def __init__(self, config):
        super().__init__(config)
        self.timers = []

    def timer(self, **kw):
        from akka_tpu_torch.native.queues import NativeWheelTimer
        t = NativeWheelTimer(**kw)
        self.timers.append(t)
        return t

    def close(self):
        for t in self.timers:
            t.shutdown()
        super().close()


@pytest.fixture()
def actors():
    kit = _Kit(CFG)
    try:
        yield kit
    finally:
        kit.close()


def _join(threads, timeout=10.0):
    deadline = time.monotonic() + timeout
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    assert not any(t.is_alive() for t in threads)


# ------------------------------------------------------------------ build
def test_library_builds_into_the_ports_build_dir_under_a_lock():
    assert native_lib.available()
    so = native_lib.so_path()
    assert os.path.dirname(so) == native_lib.BUILD_DIR
    assert native_lib.BUILD_DIR.endswith(
        os.path.join("akka_tpu_torch", "_build", "native"))
    assert os.path.exists(so)
    assert os.path.exists(os.path.join(native_lib.BUILD_DIR, "build.lock"))
    assert not [f for f in os.listdir(native_lib.BUILD_DIR)
                if f.endswith(".tmp")]


def test_concurrent_builders_compile_once(actors, tmp_path, monkeypatch):
    """Builders racing on an empty build dir (threads here; processes
    take the same flock) wait for one compile, which writes a temp name
    of its own and moves it into place, and all load one file. The
    compiler is a stand-in that writes its output file."""
    monkeypatch.setattr(native_lib, "BUILD_DIR", str(tmp_path))
    compiles = []

    def fake_run(cmd, **kw):
        out = cmd[cmd.index("-o") + 1]
        compiles.append(out)
        time.sleep(0.2)  # long enough for the others to queue on the lock
        with open(out, "wb") as f:
            f.write(b"\x7fELF")
        return native_lib.subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(native_lib.subprocess, "run", fake_run)
    paths, errors = [], []

    def build():
        try:
            paths.append(native_lib._build())
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    _join([actors.thread(build) for _ in range(3)])
    assert not errors and len(paths) == 3 and len(set(paths)) == 1
    assert len(compiles) == 1 and compiles[0].endswith(".tmp")
    assert compiles[0] != paths[0]
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["build.lock", os.path.basename(paths[0])])


def test_missing_compiler_raises_naming_gpp(tmp_path, monkeypatch):
    monkeypatch.setattr(native_lib, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native_lib.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match=r"g\+\+"):
        native_lib._build()


@pytest.fixture()
def unbuildable(monkeypatch):
    """The library as if it could not be built."""
    monkeypatch.setattr(native_lib, "_lib", None)
    monkeypatch.setattr(native_lib, "_error",
                        "g++ was not found on PATH (simulated)")


def test_nothing_falls_back_when_the_library_cannot_be_built(unbuildable):
    assert not native_lib.available()
    with pytest.raises(RuntimeError, match=r"g\+\+"):
        BatchedSystem(8, [_counter], device="cpu", native_staging=True)
    # None chooses: the Python list
    s = BatchedSystem(8, [_counter], device="cpu", native_staging=None)
    assert not s.native_staging


@pytest.mark.parametrize("config", [
    {"scheduler": {"implementation": "native"}},
    {"actor": {"native-mailboxes": True}}],
    ids=["native-scheduler", "native-mailboxes"])
def test_native_config_keys_raise_when_the_library_cannot_be_built(
        actors, unbuildable, config):
    with pytest.raises(RuntimeError, match=r"g\+\+"):
        ActorSystem.create("unbuildable", {"akka": {
            "stdout-loglevel": "OFF", **config}})


# ------------------------------------------------------------ MPSC queue
def test_mpsc_queue_fifo_single_thread():
    from akka_tpu_torch.native.queues import NativeMpscQueue
    q = NativeMpscQueue()
    for i in range(100):
        q.enqueue(("msg", i))
    assert len(q) == 100
    out = []
    while True:
        m = q.dequeue()
        if m is None:
            break
        out.append(m[1])
    assert out == list(range(100))
    q.close()


def test_mpsc_queue_many_producers_one_consumer(actors):
    from akka_tpu_torch.native.queues import NativeMpscQueue
    q = NativeMpscQueue()
    n_producers, per = 8, 2000

    def produce(pid):
        for i in range(per):
            q.enqueue((pid, i))

    threads = [actors.thread(lambda p=p: produce(p))
               for p in range(n_producers)]
    seen = []
    deadline = time.monotonic() + 10
    while len(seen) < n_producers * per and time.monotonic() < deadline:
        m = q.dequeue()
        if m is None:
            time.sleep(0.0005)
            continue
        seen.append(m)
    _join(threads)
    assert len(seen) == n_producers * per
    assert len(set(seen)) == n_producers * per  # no duplication
    for p in range(n_producers):  # per-producer FIFO
        assert [i for (pid, i) in seen if pid == p] == list(range(per))
    q.close()


def test_mpsc_close_races_with_producers_and_consumer(actors):
    from akka_tpu_torch.native.queues import NativeMpscQueue
    for _ in range(5):
        q = NativeMpscQueue()
        stop = threading.Event()
        consumed = []

        def produce():
            i = 0
            while not stop.is_set():
                q.enqueue(i)
                i += 1

        def consume():
            while not stop.is_set():
                m = q.dequeue()
                if m is not None:
                    consumed.append(m)

        threads = [actors.thread(produce) for _ in range(4)]
        threads.append(actors.thread(consume))
        time.sleep(0.01)
        q.close()  # producers and the consumer still running
        time.sleep(0.01)
        stop.set()
        _join(threads)
        before = len(q._registry)
        assert q.enqueue("late-1") is False
        assert q.enqueue("late-2") is False
        assert len(q._registry) == before
        del q


# ------------------------------------------------------------ wheel timer
def test_wheel_timer_fires_and_cancels(actors):
    t = actors.timer(tick_duration=0.001)
    fired, periodic = [], []
    t.schedule_once(0.02, lambda: fired.append("once"))
    tid = t.schedule_once(0.5, lambda: fired.append("cancelled"))
    t.cancel(tid)
    pid = t.schedule_periodically(0.01, 0.02, lambda: periodic.append(1))
    time.sleep(0.3)
    t.cancel(pid)
    assert "once" in fired and "cancelled" not in fired
    assert len(periodic) >= 3
    n_at_cancel = len(periodic)
    time.sleep(0.1)
    assert len(periodic) <= n_at_cancel + 1  # stops after cancel


def test_wheel_timer_interval_exact_wheel_multiple(actors):
    """An interval of exactly one (and two) wheel revolutions fires once
    per interval, and schedule/cancel stay responsive."""
    t = actors.timer(tick_duration=0.002, wheel_size=8)
    one_rev, two_rev = [], []
    p1 = t.schedule_periodically(0.016, 0.016, lambda: one_rev.append(1))
    p2 = t.schedule_periodically(0.032, 0.032, lambda: two_rev.append(1))
    time.sleep(0.25)
    start = time.monotonic()
    t.cancel(p1)
    t.cancel(p2)
    assert time.monotonic() - start < 1.0
    assert 5 <= len(one_rev) <= 25
    assert 3 <= len(two_rev) <= 12


# ---------------------------------------------------------------- stager
def test_stager_stage_and_drain():
    from akka_tpu_torch.native.queues import NativeStager
    s = NativeStager(64, 4, np.float32)
    s.stage(np.array([1, 2], np.int32),
            np.array([[1, 0, 0, 0], [2, 0, 0, 0]], np.float32))
    s.stage(np.array([3], np.int32), np.array([[3, 0, 0, 0]], np.float32))
    assert len(s) == 3
    dst, pl = s.drain()
    assert dst.tolist() == [1, 2, 3]
    assert pl[:, 0].tolist() == [1.0, 2.0, 3.0]
    assert len(s) == 0
    # a genuinely full buffer drops whole batches and counts them
    big = np.zeros(100, np.int32)
    assert s.stage(big, np.zeros((100, 4), np.float32)) == 0
    assert s.dropped == 100 and len(s) == 0
    s.close()


def test_stager_concurrent_producers(actors):
    from akka_tpu_torch.native.queues import NativeStager
    s = NativeStager(64 * 1024, 4, np.float32)
    n_threads, per = 8, 500

    def produce(tid):
        for i in range(per):
            s.stage(np.array([tid * per + i], np.int32),
                    np.array([[float(tid)] * 4], np.float32))

    _join([actors.thread(lambda t=t: produce(t)) for t in range(n_threads)])
    dst, pl = s.drain()
    assert dst.shape[0] == n_threads * per
    assert len(set(dst.tolist())) == n_threads * per  # every slot distinct
    assert (pl == (dst // per)[:, None]).all()  # rows stay whole
    s.close()


def test_stager_stage_during_drain_never_drops(actors):
    """Stages racing drains, 20 races of 0.1 s: a stage that meets a drain
    waits for it and retries, so nothing drops while the buffer is not
    full. Each producer keeps its own count, and the four stage at most
    16000 rows each (batches of 32 rows of 64 float32) into a 65536-row
    buffer, so the buffer cannot fill even if the drain is descheduled:
    any drop is a false one. The wide rows make a drain copy megabytes,
    so producers meet its fence for many retries."""
    from akka_tpu_torch.native.queues import NativeStager
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # more interleavings of stage and drain
    try:
        for rep in range(20):
            _stage_during_drain(actors, NativeStager(1 << 16, 64), rep)
    finally:
        sys.setswitchinterval(switch)


def _stage_during_drain(actors, s, rep, quota=16000, batch=32):
    own = [0] * 4
    stop = threading.Event()
    dsts = np.arange(batch, dtype=np.int32)
    rows = np.ones((batch, 64), np.float32)

    def produce(i):
        while not stop.is_set() and own[i] < quota:
            own[i] += s.stage(dsts, rows)

    threads = [actors.thread(lambda i=i: produce(i)) for i in range(4)]
    drained, drains = 0, 0
    deadline = time.monotonic() + 0.1
    while time.monotonic() < deadline:
        dst, pl = s.drain()
        drained += dst.shape[0]
        drains += 1
        assert (dst == np.resize(dsts, dst.shape)).all() and (pl == 1).all()
    stop.set()
    _join(threads)
    drained += s.drain()[0].shape[0]
    assert s.dropped == 0, (rep, s.dropped)
    assert drained == sum(own), (rep, drained, own)
    assert drains > 1
    s.close()


# ------------------------------------------------------ the actor system
def test_native_mailbox_in_actor_system(actors):
    system = actors.port_system("native-mb", {"akka": {
        "stdout-loglevel": "OFF", "log-dead-letters": 0,
        "actor": {"native-mailboxes": True}}})
    probe = TestProbe(system)

    class Echo(Actor):
        def receive(self, message):
            self.sender.tell(message * 2, self.self_ref)

    ref = system.actor_of(Props(factory=Echo, cls=Echo,
                                mailbox="native-unbounded"), "necho")
    from akka_tpu_torch.native.integration import NativeMessageQueue
    assert isinstance(ref.cell.mailbox.message_queue, NativeMessageQueue)
    for i in range(50):
        ref.tell(i, probe.ref)
    got = [probe.receive_one(5.0) for _ in range(50)]
    assert got == [i * 2 for i in range(50)]  # FIFO through the queue


def test_native_scheduler_in_actor_system(actors):
    system = actors.port_system("native-sched", {"akka": {
        "stdout-loglevel": "OFF", "log-dead-letters": 0,
        "scheduler": {"implementation": "native", "tick-duration": "1ms"}}})
    from akka_tpu_torch.native.integration import NativeScheduler
    assert isinstance(system.scheduler, NativeScheduler)
    probe = TestProbe(system)
    system.scheduler.schedule_tell_once(0.03, probe.ref, "tick")
    assert probe.receive_one(5.0) == "tick"
    c = system.scheduler.schedule_tell_with_fixed_delay(
        0.01, 0.02, probe.ref, "beat")
    assert probe.receive_one(5.0) == "beat"
    assert probe.receive_one(5.0) == "beat"
    c.cancel()


def test_late_tell_to_stopped_native_mailbox_goes_to_dead_letters(actors):
    from akka_tpu_torch.actor.messages import DeadLetter, PoisonPill
    system = actors.port_system("native-dl", {"akka": {
        "stdout-loglevel": "OFF", "log-dead-letters": 0,
        "actor": {"native-mailboxes": True}}})
    probe = TestProbe(system)
    system.event_stream.subscribe(probe.ref, DeadLetter)

    class Sink(Actor):
        def receive(self, message):
            pass

    ref = system.actor_of(Props(factory=Sink, cls=Sink,
                                mailbox="native-unbounded"), "sink")
    stop_probe = TestProbe(system)
    stop_probe.watch(ref)
    ref.tell(PoisonPill, None)
    stop_probe.expect_terminated(ref, 5.0)
    ref.tell("too-late", probe.ref)
    dl = probe.receive_one(5.0)
    assert isinstance(dl, DeadLetter) and dl.message == "too-late"


# --------------------------------------------------- BatchedSystem staging
@behavior("counter", {"n": ((), torch.int32), "s": ((), torch.float32)})
def _counter(state, inbox, ctx):
    return ({"n": state["n"] + inbox.count,
             "s": state["s"] + inbox.sum[:, 0]},
            Emit.none(ctx.actor_id.shape[0], 1, 4,
                      device=ctx.actor_id.device))


def test_batched_system_uses_native_stager():
    from akka_tpu_torch.models.baseline_benches import build_ring
    s = build_ring(64, device="cpu")
    assert s.native_staging
    s.tell(np.arange(8), np.ones((8, 4), np.float32))
    assert len(s._staging) == 8
    s._flush_staged()
    assert len(s._staging) == 0
    base = s.spill_cap + s.capacity * s.out_degree
    assert s.inbox_valid[base:base + 8].all()


@jb.behavior("counter", {"n": ((), jnp.int32), "s": ((), jnp.float32)})
def _j_counter(state, inbox, ctx):
    return ({"n": state["n"] + inbox.count, "s": state["s"] + inbox.sum[0]},
            jb.Emit.none(1, 4))


@jb.behavior("slots", {"n": ((), jnp.int32)}, inbox="slots")
def _j_slots(state, mb, ctx):
    return {"n": state["n"]}, jb.Emit.none(1, 4)


def _systems(native: bool, **kw) -> dict:
    """The port's counter system and the reference's, both staging host
    tells on one path: the native stager (each package's own build) or
    the Python list. The reference falls back to its list silently, so
    its stager is checked."""
    port = BatchedSystem(8, [_counter], host_inbox=8, device="cpu",
                         native_staging=native, **kw)
    ref = jb.BatchedSystem(8, [_j_counter], host_inbox=8,
                           native_staging=native, **kw)
    assert port.native_staging is native
    assert (ref._stager is not None) is native
    return {"port": port, "ref": ref}


def _journal(pkg: str, path) -> object:
    return (TellJournal if pkg == "port" else JTellJournal)(str(path))


def _assert_same(a, b, ctx):
    assert len(a) == len(b), ctx
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=str(ctx))
        else:
            assert x == y, ctx


def _assert_paths_match(out: dict) -> None:
    """out[(pkg, native)]: each port path equals the reference's same
    path, and the port's two paths agree."""
    for native in (True, False):
        _assert_same(out["port", native], out["ref", native],
                     f"port vs reference, native_staging={native}")
    _assert_same(out["port", True], out["port", False], "stager vs list")


def _tell_script(s):
    """12 one-row tells into an 8-row host inbox, a step, then a batch,
    a late spawn-free step: both staging paths drop the last four tells
    of the first flush and deliver the rest in order."""
    for i in range(12):
        s.tell(i % 6, [float(i + 1), 0, 0, 0])
    s.step()
    s.block_until_ready()  # the reference's host pad: see test_torch_batched
    s.tell([1, 2, 3], np.array([[10, 0, 0, 0], [20, 0, 0, 0],
                                [30, 0, 0, 0]], np.float32))
    s.step()
    s.block_until_ready()


def test_both_staging_paths_give_the_same_deliveries_drops_and_wal(
        tmp_path):
    """Deliveries, drops (counted and reported) and the tell WAL, on
    each staging path of each package."""
    out = {}
    for native in (True, False):
        for pkg, s in _systems(native).items():
            s.spawn_block(0, 8)
            wal = tmp_path / f"wal-{pkg}-{native}.log"
            s.tell_journal = _journal(pkg, wal)
            dropped = []
            s.on_dropped = dropped.append
            _tell_script(s)
            s.tell_journal.close()
            out[pkg, native] = (s.read_state("n"), s.read_state("s"),
                                s.dropped_messages, sum(dropped),
                                wal.read_bytes())
    _assert_paths_match(out)
    n, _, dropped, reported, _ = out["port", True]
    assert dropped == reported == 4
    assert n.sum() == 8 + 3


def test_slots_mode_stages_type_tags_exactly():
    """In slots mode a stager row carries its type tag bitcast into the
    staging dtype: the flushed host rows equal the Python list's, and
    each path's equal the reference's on that path."""
    from akka_tpu_torch.models.baseline_benches import build_ring_slots
    out = {}
    for native in (True, False):
        port = build_ring_slots(16, 2, device="cpu", native_staging=native)
        ref = jb.BatchedSystem(16, [_j_slots], host_inbox=8,
                               mailbox_slots=2, spill_capacity=0,
                               native_staging=native)
        ref.spawn_block(0, 16)
        assert port.native_staging is native
        assert (ref._stager is not None) is native
        for pkg, s in (("port", port), ("ref", ref)):
            s.tell([3, 5, 3, 9],
                   np.arange(16, dtype=np.float32).reshape(4, 4),
                   mtype=np.array([7, -2, 2**31 - 1, 0], np.int32))
            s._flush_staged()
            out[pkg, native] = tuple(
                np.asarray(getattr(s, f)) for f in (
                    "inbox_dst", "inbox_type", "inbox_payload",
                    "inbox_valid"))
    _assert_paths_match(out)


def test_slots_mode_with_a_two_byte_staging_dtype_keeps_the_list():
    from akka_tpu_torch.models.baseline_benches import build_ring_slots
    s = build_ring_slots(8, 2, device="cpu", payload_dtype=torch.float16)
    assert not s.native_staging
    with pytest.raises(ValueError, match="4 bytes"):
        build_ring_slots(8, 2, device="cpu", payload_dtype=torch.float16,
                         native_staging=True)
    # bf16 stages as float32: exact, so it takes the stager
    assert build_ring_slots(8, 2, device="cpu",
                            payload_dtype=torch.bfloat16).native_staging


def test_both_staging_paths_scrub_a_recycled_rows_staged_tells():
    """A tell staged to a stopped row must not reach the row's next
    occupant: spawn_block drains the stager, drops the row's tells and
    re-stages the rest, as the Python list filters them, on both
    packages."""
    out = {}
    for native in (True, False):
        for pkg, s in _systems(native).items():
            s.spawn_block(0, 8)
            s.stop_block([3])
            s.tell([3, 4, 3, 5], [1.0, 0, 0, 0])
            s.spawn_block(0, 1)  # recycles row 3
            if pkg == "port":
                assert len(s._staging) == 2
            s.step()
            out[pkg, native] = (s.read_state("n"), s.dropped_messages)
    _assert_paths_match(out)
    assert out["port", True][0].tolist() == [0, 0, 0, 0, 1, 1, 0, 0]


def test_both_staging_paths_restore_the_same_state(tmp_path):
    """Checkpoint, then tells that are staged but never flushed, then a
    crash: each path's restore replays the journal to the same state, on
    both packages, and the restored system's stager starts empty."""
    out = {}
    for native in (True, False):
        crashed = _systems(native)
        restored = _systems(native)
        for pkg in ("port", "ref"):
            d = tmp_path / f"ckpt-{pkg}-{native}"
            s = crashed[pkg]
            s.spawn_block(0, 8)
            s.tell_journal = _journal(pkg, d / "wal.log")
            s.tell([0, 1], [1.0, 0, 0, 0])
            s.step()
            path = s.checkpoint(str(d))
            s.tell([2, 2, 7], [5.0, 0, 0, 0])  # staged at the crash
            s.tell_journal.close()
            r = restored[pkg]
            r.spawn_block(0, 8)
            r.tell([6], [9.0, 0, 0, 0])  # staged before the restore: dropped
            journal = _journal(pkg, d / "wal.log")
            r.restore(path, journal)
            journal.close()
            r.step()
            out[pkg, native] = (r.read_state("n"), r.read_state("s"))
    _assert_paths_match(out)
    assert out["port", True][0].tolist() == [1, 1, 2, 0, 0, 0, 0, 1]
