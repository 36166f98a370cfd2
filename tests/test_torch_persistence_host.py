"""The host tier of the port's persistence (akka_tpu_torch.persistence:
journal and snapshot plugins, PersistentActor, AtLeastOnceDelivery,
EventSourcedBehavior, event and snapshot adapters, persistence query) on
the CPU, side by side with the JAX package's.

A port of 18 scenarios of tests/test_persistence.py (all but
`test_slab_snapshot_roundtrip`, whose counterpart is in
tests/test_torch_persistence.py) and the 8 of
tests/test_persistence_adapter.py: each is written once, runs on both
packages, and the port's trace must equal the reference's. The TCKs of
both packages run on the port's plugins. Then the files: a FileJournal
directory and a LocalSnapshotStore written by either package and read by
the other (the port's reads import no module of the JAX package), and a
record whose class the port cannot resolve, which raises and leaves the
log's bytes alone.

Every system starts through the `systems` fixture
(tests/torch_host_fixture.py), which asserts `await_termination(10.0)` and
that no thread is left; every wait is at most 10 s; every journal and
snapshot directory lies under tmp_path.
"""

import dataclasses
import os
import pickle
import sys
import tempfile
import time

import pytest

from torch_host_fixture import (QUIET, WAIT, Systems, package,
                                side_by_side)

MAX = 2**63 - 1
INMEM_SNAPSHOTS = {"akka": {**QUIET["akka"], "persistence": {
    "snapshot-store": {"plugin": "akka.persistence.snapshot-store.inmem"}}}}


@pytest.fixture()
def systems():
    s = Systems()
    try:
        yield s
    finally:
        s.close()


# ------------------------------------------------------- TCK (both TCKs)

TCKS = (package("akka_tpu").persistence, package("akka_tpu_torch").persistence)


def test_journal_tck_inmem():
    for tck in TCKS:
        tck.journal_tck(package("akka_tpu_torch").persistence.InMemJournal)


def test_journal_tck_file(tmp_path):
    T = package("akka_tpu_torch").persistence
    counter = [0]

    def fresh():
        counter[0] += 1
        return T.FileJournal(str(tmp_path / f"j{counter[0]}"))
    for tck in TCKS:
        tck.journal_tck(fresh)


def test_journal_tck_testkit_journal():
    T = package("akka_tpu_torch").persistence
    for tck in TCKS:
        tck.journal_tck(T.PersistenceTestKitJournal)


def test_snapshot_tck_inmem():
    T = package("akka_tpu_torch").persistence
    for tck in TCKS:
        tck.snapshot_store_tck(T.InMemSnapshotStore)


def test_snapshot_tck_local(tmp_path):
    T = package("akka_tpu_torch").persistence
    counter = [0]

    def fresh():
        counter[0] += 1
        return T.LocalSnapshotStore(str(tmp_path / f"s{counter[0]}"))
    for tck in TCKS:
        tck.snapshot_store_tck(fresh)


def _survives_reopen(P, systems, tmp_path):
    M = P.persistence
    d = str(tmp_path / f"jj-{P.name}")
    j = M.FileJournal(d)
    j.write_atomic(M.AtomicWrite((M.PersistentRepr("a", 1, "p"),
                                  M.PersistentRepr("b", 2, "p"))))
    j2 = M.FileJournal(d)  # fresh process equivalent
    got = []
    j2.replay("p", 1, MAX, MAX, got.append)
    return [[r.payload for r in got], j2.highest_sequence_nr("p", 0),
            j2.persistence_ids()]


def test_file_journal_survives_reopen(systems, tmp_path):
    assert side_by_side(_survives_reopen, systems, tmp_path) == \
        [["a", "b"], 2, ["p"]]


# ------------------------------------------------ classic PersistentActor

_classes = {}


def classes(P):
    """The scenarios' persistent actors, one set per package."""
    if P.name in _classes:
        return _classes[P.name]
    M = P.persistence

    class Counter(M.PersistentActor):
        def __init__(self, pid: str, probe=None):
            super().__init__()
            self._pid = pid
            self.count = 0
            self.probe = probe

        @property
        def persistence_id(self) -> str:
            return self._pid

        def receive_recover(self, message):
            if isinstance(message, M.SnapshotOffer):
                self.count = message.snapshot
            elif isinstance(message, M.RecoveryCompleted):
                if self.probe:
                    self.probe.tell(("recovered", self.count), self.self_ref)
            elif isinstance(message, int):
                self.count += message
            else:
                return NotImplemented

        def receive_command(self, message):
            if message == "get":
                self.sender.tell(self.count, self.self_ref)
            elif isinstance(message, int):
                def handler(ev):
                    self.count += ev
                    if self.probe:
                        self.probe.tell(("persisted", ev, self.count),
                                        self.self_ref)
                self.persist(message, handler)
            elif message == "snap":
                self.save_snapshot(self.count)
            elif isinstance(message, M.SaveSnapshotSuccess):
                if self.probe:
                    self.probe.tell(("snapped",
                                     message.metadata.sequence_nr),
                                    self.self_ref)
            else:
                return NotImplemented

    out = _classes[P.name] = {"Counter": Counter}
    return out


def _probe(P, system):
    return P.testkit.TestProbe(system)


def _persist_and_recover(P, systems):
    Counter = classes(P)["Counter"]
    system = systems.classic(P, "persist", INMEM_SNAPSHOTS)
    probe = _probe(P, system)
    ref = system.actor_of(P.Props.create(Counter, "c1", probe.ref), "c1")
    trace = [probe.receive_one(WAIT)]
    for i in (1, 2, 3):
        ref.tell(i, probe.ref)
    trace += [probe.receive_one(WAIT) for _ in range(3)]
    # restart: a fresh incarnation replays the journal
    system.stop(ref)
    probe.watch(ref)
    probe.expect_terminated(ref, WAIT)
    ref2 = system.actor_of(P.Props.create(Counter, "c1", probe.ref), "c1b")
    trace.append(probe.receive_one(WAIT))
    ref2.tell("get", probe.ref)
    trace.append(probe.receive_one(WAIT))
    return trace


def test_persist_and_recover(systems):
    assert side_by_side(_persist_and_recover, systems) == [
        ("recovered", 0), ("persisted", 1, 1), ("persisted", 2, 3),
        ("persisted", 3, 6), ("recovered", 6), 6]


def _stash_while_persisting(P, systems):
    """Commands sent while a persist is in flight are processed after the
    handler (reference Eventsourced stash :218-233)."""
    order = []

    class Tracker(P.persistence.PersistentActor):
        @property
        def persistence_id(self):
            return "tracker"

        def receive_recover(self, message):
            pass

        def receive_command(self, message):
            if message == "a":
                order.append("cmd-a")
                self.persist("ev-a", lambda ev: order.append("handler-a"))
            else:
                order.append(f"cmd-{message}")
                self.sender.tell("done", self.self_ref)

    system = systems.classic(P, "persist", INMEM_SNAPSHOTS)
    probe = _probe(P, system)
    ref = system.actor_of(P.Props.create(Tracker))
    ref.tell("a", probe.ref)
    ref.tell("b", probe.ref)  # arrives while ev-a's write is in flight
    probe.expect_msg("done", WAIT)
    return order


def test_stash_while_persisting_preserves_order(systems):
    assert side_by_side(_stash_while_persisting, systems) == \
        ["cmd-a", "handler-a", "cmd-b"]


def _snapshot_speeds_recovery(P, systems):
    Counter = classes(P)["Counter"]
    system = systems.classic(P, "persist", INMEM_SNAPSHOTS)
    probe = _probe(P, system)
    ref = system.actor_of(P.Props.create(Counter, "c2", probe.ref))
    probe.receive_one(WAIT)  # recovered
    for _ in range(5):
        ref.tell(1, probe.ref)
        probe.receive_one(WAIT)
    ref.tell("snap", probe.ref)
    snapped = probe.receive_one(WAIT)
    ref.tell(1, probe.ref)   # one event after the snapshot
    probe.receive_one(WAIT)
    system.actor_of(P.Props.create(Counter, "c2", probe.ref))
    return [snapped, probe.receive_one(WAIT)]


def test_snapshot_speeds_recovery(systems):
    assert side_by_side(_snapshot_speeds_recovery, systems) == \
        [("snapped", 5), ("recovered", 6)]


def _persist_failure_stops(P, systems):
    M = P.persistence
    failing = M.PersistenceTestKitJournal()
    M.Persistence.register_journal_plugin(
        "test.failing-journal", lambda sys_, cfg: failing)

    class Failing(classes(P)["Counter"]):
        journal_plugin_id = "test.failing-journal"

    system = systems.classic(P, "persist", INMEM_SNAPSHOTS)
    probe = _probe(P, system)
    ref = system.actor_of(P.Props.create(Failing, "f1", probe.ref))
    trace = [probe.receive_one(WAIT)]
    probe.watch(ref)
    failing.set_policy(M.FailNextN(1))
    ref.tell(1, probe.ref)
    probe.expect_terminated(ref, WAIT)
    return trace + ["terminated"]


def test_persist_failure_stops_actor(systems):
    assert side_by_side(_persist_failure_stops, systems) == \
        [("recovered", 0), "terminated"]


def _persist_rejection(P, systems):
    M = P.persistence
    rejecting = M.PersistenceTestKitJournal()
    M.Persistence.register_journal_plugin(
        "test.rejecting-journal", lambda sys_, cfg: rejecting)

    class Rejecting(classes(P)["Counter"]):
        journal_plugin_id = "test.rejecting-journal"

    system = systems.classic(P, "persist", INMEM_SNAPSHOTS)
    probe = _probe(P, system)
    ref = system.actor_of(P.Props.create(Rejecting, "r1", probe.ref))
    trace = [probe.receive_one(WAIT)]
    rejecting.set_policy(M.RejectNextN(1))
    ref.tell(1, probe.ref)     # rejected: no handler call, no state change
    ref.tell(2, probe.ref)     # accepted
    trace.append(probe.receive_one(WAIT))
    ref.tell("get", probe.ref)
    return trace + [probe.receive_one(WAIT)]


def test_persist_rejection_keeps_actor_running(systems):
    assert side_by_side(_persist_rejection, systems) == \
        [("recovered", 0), ("persisted", 2, 2), 2]


def _at_least_once(P, systems):
    M = P.persistence

    class Sender(M.AtLeastOnceDelivery):
        redeliver_interval = 0.2

        def __init__(self, dest):
            super().__init__()
            self.dest = dest

        @property
        def persistence_id(self):
            return "alod-sender"

        def receive_recover(self, message):
            pass

        def receive_command(self, message):
            if message == "send":
                self.persist("msg-sent", lambda ev: self.deliver(
                    self.dest, lambda did: ("payload", did)))
            elif isinstance(message, tuple) and message[0] == "confirm":
                self.persist(("confirmed", message[1]),
                             lambda ev: self.confirm_delivery(ev[1]))
            elif message == "unconfirmed?":
                self.sender.tell(self.number_of_unconfirmed, self.self_ref)

    system = systems.classic(P, "persist", INMEM_SNAPSHOTS)
    probe = _probe(P, system)
    ref = system.actor_of(P.Props.create(Sender, probe.ref))
    ref.tell("send", probe.ref)
    first = probe.receive_one(WAIT)
    second = probe.receive_one(WAIT)  # not confirmed: redelivered
    assert second == first
    ref.tell(("confirm", first[1]), probe.ref)

    def unconfirmed():
        try:
            return P.ask_sync(ref, "unconfirmed?", timeout=2.0)
        except Exception:  # noqa: BLE001
            return -1
    P.testkit.await_condition(lambda: unconfirmed() == 0, max_time=WAIT)
    time.sleep(0.5)  # no more redeliveries after the confirm
    late = []
    while True:
        try:
            late.append(probe.receive_one(0.05))
        except AssertionError:
            break
    return [first, second, [m for m in late if m != first]]


def test_at_least_once_delivery_redelivers_until_confirm(systems):
    first, second, other = side_by_side(_at_least_once, systems)
    assert first[0] == "payload" and second == first and other == []


# ---------------------------------------------- typed EventSourcedBehavior

def _typed_counter(P, systems):
    M, probe_system = P.persistence, systems.classic(P, "persist",
                                                     INMEM_SNAPSHOTS)
    system = probe_system
    probe = _probe(P, system)

    def command_handler(state, cmd):
        if cmd[0] == "add":
            return M.Effect.persist(("added", cmd[1])).then_reply(
                cmd[2], lambda s: ("total", s))
        if cmd[0] == "get":
            return M.Effect.reply(cmd[1], ("total", state))
        return M.Effect.unhandled()

    def event_handler(state, event):
        return state + event[1] if event[0] == "added" else state

    def make():
        return M.EventSourcedBehavior(
            M.PersistenceId.of("Counter", "t1"), 0, command_handler,
            event_handler,
            retention=M.RetentionCriteria.snapshot_every_n(100))

    ref = system.actor_of(P.props_from_behavior(make()), "typed-counter")
    ref.tell(("add", 5, probe.ref))
    trace = [probe.receive_one(WAIT)]
    ref.tell(("add", 7, probe.ref))
    trace.append(probe.receive_one(WAIT))
    # recovery in a fresh incarnation
    ref2 = system.actor_of(P.props_from_behavior(make()), "typed-counter2")
    ref2.tell(("get", probe.ref))
    return trace + [probe.receive_one(WAIT)]


def test_typed_event_sourced_counter(systems):
    assert side_by_side(_typed_counter, systems) == \
        [("total", 5), ("total", 12), ("total", 12)]


def _typed_stop_and_none(P, systems):
    M = P.persistence
    system = systems.classic(P, "persist", INMEM_SNAPSHOTS)
    probe = _probe(P, system)

    def command_handler(state, cmd):
        if cmd == "stop":
            return M.Effect.stop()
        if cmd == "noop":
            return M.Effect.none().then_run(
                lambda s: probe.ref.tell(("ran", s), None))
        return M.Effect.unhandled()

    beh = M.EventSourcedBehavior(M.PersistenceId.of_unique_id("stopper"), 0,
                                 command_handler, lambda s, e: s)
    ref = system.actor_of(P.props_from_behavior(beh))
    ref.tell("noop")
    trace = [probe.receive_one(WAIT)]
    probe.watch(ref)
    ref.tell("stop")
    probe.expect_terminated(ref, WAIT)
    return trace + ["terminated"]


def test_typed_effect_stop_and_none(systems):
    assert side_by_side(_typed_stop_and_none, systems) == \
        [("ran", 0), "terminated"]


def _typed_supervised_restart(P, systems):
    """A supervised restart re-runs recovery from the journal, not the
    crashed incarnation's in-memory state (Running.scala restart)."""
    M, T = P.persistence, P.typed
    system = systems.classic(P, "persist", INMEM_SNAPSHOTS)
    probe = _probe(P, system)

    def ch(state, cmd):
        if cmd[0] == "add":
            return M.Effect.persist(("added", cmd[1])).then_reply(
                cmd[2], lambda s: ("total", s))
        if cmd[0] == "boom":
            raise RuntimeError("kaboom")
        if cmd[0] == "get":
            return M.Effect.reply(cmd[1], ("total", state))
        return M.Effect.unhandled()

    beh = M.EventSourcedBehavior(M.PersistenceId.of("Sup", "s1"), 0, ch,
                                 lambda s, e: s + e[1])
    sup = T.Behaviors.supervise(beh).on_failure(
        T.SupervisorStrategy.restart(), RuntimeError)
    ref = system.actor_of(P.props_from_behavior(sup), "sup-es")
    ref.tell(("add", 3, probe.ref))
    trace = [probe.receive_one(WAIT)]
    ref.tell(("boom",))
    ref.tell(("get", probe.ref))
    trace.append(probe.receive_one(WAIT))
    ref.tell(("add", 4, probe.ref))
    return trace + [probe.receive_one(WAIT)]


def test_typed_supervised_restart_rereplays_journal(systems):
    assert side_by_side(_typed_supervised_restart, systems) == \
        [("total", 3), ("total", 3), ("total", 7)]


def _atomic_rejection(P, systems, tmp_path):
    """An unserializable event in an AtomicWrite rejects the whole batch
    with nothing written (all-or-nothing)."""
    M = P.persistence
    j = M.FileJournal(str(tmp_path / f"aj-{P.name}"))
    bad = M.AtomicWrite((M.PersistentRepr("fine", 1, "p"),
                         M.PersistentRepr(lambda: None, 2, "p")))
    rejected = j.write_atomic(bad) is not None
    got = []
    j.replay("p", 1, MAX, MAX, got.append)
    return [rejected, got, j.highest_sequence_nr("p", 0)]


def test_file_journal_atomic_rejection(systems, tmp_path):
    assert side_by_side(_atomic_rejection, systems, tmp_path) == \
        [True, [], 0]


# ------------------------------------------------------ persistence query

def _query_current_and_live(P, systems):
    M = P.persistence
    system = systems.classic(P, "persist", INMEM_SNAPSHOTS)
    probe = _probe(P, system)
    ref = system.actor_of(P.Props.create(classes(P)["Counter"], "q1",
                                         probe.ref))
    probe.receive_one(WAIT)
    for i in (1, 2):
        ref.tell(i, probe.ref)
        probe.receive_one(WAIT)
    rj = M.PersistenceQuery.get(system).read_journal_for()
    envs = rj.current_events_by_persistence_id("q1")
    trace = ["q1" in rj.current_persistence_ids(),
             [(e.event, e.sequence_nr) for e in envs]]
    live = rj.events_by_persistence_id("q1")
    trace.append([e.event for e in live.drain()])
    ref.tell(9, probe.ref)
    probe.receive_one(WAIT)
    nxt = live.poll(WAIT)
    live.close()
    return trace + [nxt.event]


def test_query_current_and_live(systems):
    assert side_by_side(_query_current_and_live, systems) == \
        [True, [(1, 1), (2, 2)], [1, 2], 9]


def _query_by_tag(P, systems):
    M = P.persistence

    class Tagger(M.PersistentActor):
        @property
        def persistence_id(self):
            return "tagger-1"

        def receive_recover(self, message):
            pass

        def receive_command(self, message):
            self.persist(M.Tagged.of(message, "blue"),
                         lambda ev: self.sender.tell("ok", self.self_ref))

    system = systems.classic(P, "persist", INMEM_SNAPSHOTS)
    probe = _probe(P, system)
    ref = system.actor_of(P.Props.create(Tagger))
    for e in ("e1", "e2"):
        ref.tell(e, probe.ref)
        probe.expect_msg("ok", WAIT)
    rj = M.PersistenceQuery.get(system).read_journal_for()
    by_tag = rj.current_events_by_tag("blue", M.NoOffset)
    # a replay of the actor sees untagged payloads
    replayed = rj.current_events_by_persistence_id("tagger-1")
    return [[(e.event, e.offset.value) for e in by_tag],
            [e.event for e in replayed]]


def test_query_events_by_tag(systems):
    assert side_by_side(_query_by_tag, systems) == \
        [[("e1", 1), ("e2", 2)], ["e1", "e2"]]


# ----------------------------- tests/test_persistence_adapter.py (8)

@dataclasses.dataclass(frozen=True)
class ItemAdded:          # domain event
    item: str


@dataclasses.dataclass(frozen=True)
class Wrapped:            # journal model (detached from the domain)
    inner: str


@dataclasses.dataclass(frozen=True)
class BulkAdded:          # legacy journal record
    items: tuple


_ids = [0]


def _plugin_id(name):
    _ids[0] += 1
    return f"test.adapter-{name}-{_ids[0]}"


def _adapter_config(journal_plugin_id, snapshot_dir=None):
    snap = {"plugin": "akka.persistence.snapshot-store.local",
            "local": {"dir": snapshot_dir}} if snapshot_dir else \
        {"plugin": "akka.persistence.snapshot-store.inmem"}
    return {"akka": {**QUIET["akka"], "persistence": {
        "journal": {"plugin": journal_plugin_id}, "snapshot-store": snap}}}


_adapters = {}


def adapters(P):
    """The adapter scenarios' EventAdapters, one set per package."""
    if P.name in _adapters:
        return _adapters[P.name]
    M = P.persistence

    class WrappingAdapter(M.EventAdapter):
        """domain ItemAdded <-> journal Wrapped."""

        def manifest(self, event):
            return "wrapped-v1"

        def to_journal(self, event):
            return Wrapped(event.item)

        def from_journal(self, event, manifest):
            assert manifest == "wrapped-v1"
            return M.EventSeq.single(ItemAdded(event.inner))

    class SplitAdapter(M.EventAdapter):
        def from_journal(self, event, manifest):
            return M.EventSeq.many([ItemAdded(i) for i in event.items])

    class TaggingAdapter(M.EventAdapter):
        def to_journal(self, event):
            return M.Tagged(Wrapped(event.item), frozenset({"items"}))

        def from_journal(self, event, manifest):
            return M.EventSeq.single(ItemAdded(event.inner))

    class ListToDict(M.SnapshotAdapter):
        def to_journal(self, state):
            return state

        def from_journal(self, stored):
            return {"items": list(stored)} if isinstance(stored, list) \
                else stored

    out = _adapters[P.name] = dict(
        WrappingAdapter=WrappingAdapter, SplitAdapter=SplitAdapter,
        TaggingAdapter=TaggingAdapter, ListToDict=ListToDict)
    return out


def _most_specific(P, systems):
    M = P.persistence

    class Base:
        pass

    class Mid(Base):
        pass

    class Leaf(Mid):
        pass

    base_a, mid_a = M.EventAdapter(), M.EventAdapter()
    reg = M.EventAdapters({Base: base_a, Mid: mid_a})
    return [reg.get(Leaf) is mid_a, reg.get(Mid) is mid_a,
            reg.get(Base) is base_a, reg.get(int).to_journal(7)]


def test_event_adapters_most_specific_class_wins(systems):
    assert side_by_side(_most_specific, systems) == [True, True, True, 7]


def _event_seq(P, systems):
    S = P.persistence.EventSeq
    return [S.empty().events, S.single(1).events, S.many([1, 2]).events]


def test_event_seq_shapes(systems):
    assert side_by_side(_event_seq, systems) == [[], [1], [1, 2]]


def _cart_handlers(M):
    def command_handler(state, cmd):
        if isinstance(cmd, tuple) and cmd[0] == "add":
            return M.Effect.persist(ItemAdded(cmd[1]))
        return M.Effect.reply(cmd, tuple(state))

    def event_handler(state, event):
        assert isinstance(event, ItemAdded), event  # domain model only
        return state + [event.item]
    return command_handler, event_handler


def _cart(P, system, pid, entity, name="cart", **kw):
    M = P.persistence
    ch, eh = _cart_handlers(M)
    return system.actor_of(P.props_from_behavior(M.EventSourcedBehavior(
        M.PersistenceId.of("Cart", entity), [], ch, eh,
        journal_plugin_id=pid, **kw)), name)


def _ask_state(P, system, ref):
    probe = _probe(P, system)
    ref.tell(probe.ref)
    return probe.receive_one(WAIT)


def _detaches(P, systems, tmp_path):
    M, A = P.persistence, adapters(P)
    d = str(tmp_path / f"j-{P.name}")
    pid = _plugin_id("wrap")
    M.Persistence.register_journal_plugin(pid,
                                          lambda _s, _c: M.FileJournal(d))
    system = systems.classic(P, "adapter", _adapter_config(pid))
    M.Persistence.get(system).register_event_adapters(
        pid, M.EventAdapters({ItemAdded: A["WrappingAdapter"]()}))
    ref = _cart(P, system, pid, "w1")
    ref.tell(("add", "apple"))
    ref.tell(("add", "pear"))
    trace = [_ask_state(P, system, ref)]
    systems.close_one(system)
    # what was stored is the journal model, not the domain event
    stored = []
    M.FileJournal(d).replay("Cart|w1", 1, MAX, MAX, stored.append)
    trace.append([(r.payload, r.manifest) for r in stored])
    # a fresh system with the same adapter recovers the domain model
    system2 = systems.classic(P, "adapter", _adapter_config(pid))
    M.Persistence.get(system2).register_event_adapters(
        pid, M.EventAdapters({Wrapped: A["WrappingAdapter"](),
                              ItemAdded: A["WrappingAdapter"]()}))
    return trace + [_ask_state(P, system2, _cart(P, system2, pid, "w1"))]


def test_adapter_detaches_domain_model_and_restores_on_replay(
        systems, tmp_path):
    assert side_by_side(_detaches, systems, tmp_path) == [
        ("apple", "pear"),
        [(Wrapped("apple"), "wrapped-v1"), (Wrapped("pear"), "wrapped-v1")],
        ("apple", "pear")]


def _upcasts(P, systems, tmp_path):
    """An old journal holds a combined record; the read adapter fans it
    out (EventAdapter.scala fromJournal EventSeq-many semantics)."""
    M, A = P.persistence, adapters(P)
    d = str(tmp_path / f"j-{P.name}")
    old = M.FileJournal(d)
    assert old.write_atomic(M.AtomicWrite([
        M.PersistentRepr(BulkAdded(("a", "b", "c")), 1, "Cart|u1")])) is None
    pid = _plugin_id("split")
    M.Persistence.register_journal_plugin(pid,
                                          lambda _s, _c: M.FileJournal(d))
    system = systems.classic(P, "adapter", _adapter_config(pid))
    M.Persistence.get(system).register_event_adapters(
        pid, M.EventAdapters({BulkAdded: A["SplitAdapter"]()}))
    return _ask_state(P, system, _cart(P, system, pid, "u1"))


def test_adapter_upcasts_one_stored_record_to_many_events(systems,
                                                          tmp_path):
    assert side_by_side(_upcasts, systems, tmp_path) == ("a", "b", "c")


def _tagging(P, systems, tmp_path):
    """An adapter returning Tagged attaches query tags on the write path,
    and the typed tagger's tags join them."""
    M, A = P.persistence, adapters(P)
    d = str(tmp_path / f"j-{P.name}")
    pid = _plugin_id("tag")
    M.Persistence.register_journal_plugin(pid,
                                          lambda _s, _c: M.FileJournal(d))
    system = systems.classic(P, "adapter", _adapter_config(pid))
    M.Persistence.get(system).register_event_adapters(
        pid, M.EventAdapters({ItemAdded: A["TaggingAdapter"](),
                              Wrapped: A["TaggingAdapter"]()}))
    ref = _cart(P, system, pid, "t1",
                tagger=lambda ev: frozenset({"by-tagger"}))
    ref.tell(("add", "apple"))
    trace = [_ask_state(P, system, ref)]
    plugin = M.Persistence.get(system).journal_plugin_for(pid)
    for tag in ("items", "by-tagger"):
        trace.append([(o, r.payload) for o, r in
                      plugin.events_by_tag(tag, 0)])
    return trace


def test_tagging_adapter_composes_with_query(systems, tmp_path):
    state, items, by_tagger = side_by_side(_tagging, systems, tmp_path)
    assert state == ("apple",)
    assert [p for _, p in items] == [Wrapped("apple")]
    assert [p for _, p in by_tagger] == [Wrapped("apple")]


def _snapshot_adapter(P, systems, tmp_path):
    """Behavior A snapshots old-format state (a list); behavior B declares
    a SnapshotAdapter upcasting list -> dict and recovers from A's
    snapshot (typed/SnapshotAdapterSpec semantics)."""
    M, A = P.persistence, adapters(P)
    jdir = str(tmp_path / f"j-{P.name}")
    sdir = str(tmp_path / f"s-{P.name}")
    pid = _plugin_id("snap")
    M.Persistence.register_journal_plugin(
        pid, lambda _s, _c: M.FileJournal(jdir))

    def ch_old(state, cmd):
        if isinstance(cmd, tuple) and cmd[0] == "add":
            return M.Effect.persist(ItemAdded(cmd[1]))
        return M.Effect.reply(cmd, state)

    system = systems.classic(P, "adapter", _adapter_config(pid, sdir))
    ref = system.actor_of(P.props_from_behavior(M.EventSourcedBehavior(
        M.PersistenceId.of("Cart", "s1"), [], ch_old,
        lambda st, ev: st + [ev.item],
        retention=M.RetentionCriteria.snapshot_every_n(1),
        journal_plugin_id=pid)), "cart")
    ref.tell(("add", "apple"))
    trace = [_ask_state(P, system, ref)]
    systems.close_one(system)

    system2 = systems.classic(P, "adapter", _adapter_config(pid, sdir))
    ref = system2.actor_of(P.props_from_behavior(M.EventSourcedBehavior(
        M.PersistenceId.of("Cart", "s1"), {"items": []},
        lambda state, cmd: M.Effect.reply(cmd, state),
        lambda st, ev: {"items": st["items"] + [ev.item]},
        journal_plugin_id=pid, snapshot_adapter=A["ListToDict"]())),
        "cart")
    return trace + [_ask_state(P, system2, ref)]


def test_snapshot_adapter_upcasts_old_snapshot(systems, tmp_path):
    assert side_by_side(_snapshot_adapter, systems, tmp_path) == \
        [["apple"], {"items": ["apple"]}]


def _typed_event_adapter(P, systems, tmp_path):
    """A per-behavior typed EventAdapter (persistence-typed
    EventAdapter.scala): write-side detachment and read-side restore by
    the behavior itself, with no journal-level registry."""
    M, A = P.persistence, adapters(P)
    d = str(tmp_path / f"j-{P.name}")
    pid = _plugin_id("typed-ea")
    M.Persistence.register_journal_plugin(pid,
                                          lambda _s, _c: M.FileJournal(d))
    system = systems.classic(P, "adapter", _adapter_config(pid))
    ref = _cart(P, system, pid, "tea1", event_adapter=A["WrappingAdapter"]())
    ref.tell(("add", "kiwi"))
    trace = [_ask_state(P, system, ref)]
    systems.close_one(system)
    stored = []
    M.FileJournal(d).replay("Cart|tea1", 1, MAX, MAX, stored.append)
    trace.append([(r.payload, r.manifest) for r in stored])
    system2 = systems.classic(P, "adapter", _adapter_config(pid))
    ref = _cart(P, system2, pid, "tea1", event_adapter=A["WrappingAdapter"]())
    return trace + [_ask_state(P, system2, ref)]


def test_typed_event_adapter_on_behavior(systems, tmp_path):
    assert side_by_side(_typed_event_adapter, systems, tmp_path) == \
        [("kiwi",), [(Wrapped("kiwi"), "wrapped-v1")], ("kiwi",)]


def _late_registration(P, systems, tmp_path):
    M = P.persistence
    pid = _plugin_id("late")
    M.Persistence.register_journal_plugin(
        pid, lambda _s, _c: M.FileJournal(str(tmp_path / f"j-{P.name}")))
    system = systems.classic(P, "adapter", _adapter_config(pid))
    M.Persistence.get(system).journal_for(pid)  # the journal has started
    with pytest.raises(RuntimeError, match="already started"):
        M.Persistence.get(system).register_event_adapters(
            pid, M.EventAdapters())
    return ["refused"]


def test_late_adapter_registration_rejected(systems, tmp_path):
    side_by_side(_late_registration, systems, tmp_path)


# --------------------------------------- files across the two packages

def _write_journal(M, d):
    j = M.FileJournal(d)
    assert j.write_atomic(M.AtomicWrite((
        M.PersistentRepr(("added", 5), 1, "Cart|a", writer_uuid="w"),
        M.PersistentRepr(M.Tagged(ItemAdded("apple"), frozenset({"fruit"})),
                         2, "Cart|a", manifest="m2", writer_uuid="w"),
        M.PersistentRepr({"n": 3, "x": 0.5}, 3, "Cart|a",
                         writer_uuid="w")))) is None
    assert j.write_atomic(M.AtomicWrite((
        M.PersistentRepr(M.Tagged("pear", frozenset({"fruit", "green"})),
                         1, "Cart|b", writer_uuid="w"),))) is None
    j.delete_to("Cart|a", 1)


def _read_journal(M, d):
    j = M.FileJournal(d)
    out = {"ids": j.persistence_ids(),
           "highest": [j.highest_sequence_nr(p, 0) for p in
                       ("Cart|a", "Cart|b", "Cart|none")]}
    for pid in ("Cart|a", "Cart|b"):
        got = []
        j.replay(pid, 1, MAX, MAX, got.append)
        out[pid] = [(r.payload, r.sequence_nr, r.persistence_id, r.manifest,
                     r.writer_uuid, r.deleted) for r in got]
    for tag in ("fruit", "green"):
        out[tag] = [(o, r.payload, r.sequence_nr, r.persistence_id)
                    for o, r in j.events_by_tag(tag, 0)]
    return out


@pytest.fixture()
def no_reference_class_loaded(monkeypatch):
    """Record every class the port's unpickler resolves; the test then
    asserts none came from a module of the JAX package, nor from jax or a
    library built on it."""
    from akka_tpu_torch.persistence import journal as tj
    from akka_tpu_torch.serialization import records
    resolved = []
    find = tj._PortUnpickler.find_class

    def spy(self, module, name):
        cls = find(self, module, name)
        resolved.append((module, getattr(cls, "__module__", "")))
        return cls

    monkeypatch.setattr(tj._PortUnpickler, "find_class", spy)
    yield resolved
    for asked, got in resolved:
        assert not (got == "akka_tpu" or got.startswith("akka_tpu.")), \
            (asked, got)
        assert got.split(".")[0] not in records._REFUSED_ROOTS, (asked, got)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_file_journal_read_by_the_other_package(tmp_path, writer,
                                                no_reference_class_loaded):
    """A FileJournal directory written by either package reads back in
    the other with the same events, sequence numbers, manifests, tags,
    highest sequence numbers and deleted-to."""
    ref, port = (package(n).persistence for n in ("akka_tpu",
                                                  "akka_tpu_torch"))
    W, R = (ref, port) if writer == "ref" else (port, ref)
    d = str(tmp_path / "j")
    _write_journal(W, d)
    want = _read_journal(W, d)
    assert want["Cart|a"][0][1] == 2  # deleted-to 1 holds
    assert _read_journal(R, d) == want
    if writer == "ref":
        assert any(a.startswith("akka_tpu.") for a, _ in
                   no_reference_class_loaded), "mapped the reference's paths"
    # a second write by the reader lands after the writer's records
    R.FileJournal(d).write_atomic(R.AtomicWrite((
        R.PersistentRepr("plum", 4, "Cart|a"),)))
    for M in (ref, port):
        got = []
        M.FileJournal(d).replay("Cart|a", 1, MAX, MAX, got.append)
        assert [r.sequence_nr for r in got] == [2, 3, 4]


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_local_snapshot_store_read_by_the_other_package(
        tmp_path, writer, no_reference_class_loaded):
    ref, port = (package(n).persistence for n in ("akka_tpu",
                                                  "akka_tpu_torch"))
    W, R = (ref, port) if writer == "ref" else (port, ref)
    d = str(tmp_path / "s")
    w = W.LocalSnapshotStore(d)
    for n in (3, 7):
        w.save(W.SnapshotMetadata("Cart|a", n, 100.0 + n),
               {"items": [ItemAdded("apple")] * n, "n": n})
    sel = W.SnapshotSelectionCriteria
    r = R.LocalSnapshotStore(d)
    for crit in (R.SnapshotSelectionCriteria.latest(),
                 R.SnapshotSelectionCriteria(max_sequence_nr=5)):
        got = r.load("Cart|a", crit)
        want = w.load("Cart|a", sel(max_sequence_nr=crit.max_sequence_nr))
        assert (got.metadata.sequence_nr, got.snapshot) == \
            (want.metadata.sequence_nr, want.snapshot)
        assert got.metadata.timestamp == pytest.approx(
            want.metadata.timestamp)
    assert r.load("Cart|none", R.SnapshotSelectionCriteria.latest()) is None


def test_unresolvable_record_class_raises_and_keeps_the_log(tmp_path):
    """A record whose class the port cannot resolve (here a CRDT of the
    JAX package's ddata, which the port does not have yet) makes the
    port's FileJournal raise ImportError on open; the log's bytes stay as
    they were (the reference would read it as a torn tail)."""
    from akka_tpu.ddata.crdt import GCounter
    ref, port = (package(n).persistence for n in ("akka_tpu",
                                                  "akka_tpu_torch"))
    d = str(tmp_path / "j")
    j = ref.FileJournal(d)
    j.write_atomic(ref.AtomicWrite((ref.PersistentRepr("ok", 1, "p"),)))
    j.write_atomic(ref.AtomicWrite((ref.PersistentRepr(
        GCounter(), 2, "p"),)))
    logs = {n: open(os.path.join(d, n), "rb").read()
            for n in os.listdir(d)}
    with pytest.raises(ImportError, match="akka_tpu_torch.ddata"):
        port.FileJournal(d)
    with pytest.raises(port.UnresolvedRecordClass):
        list(port.scan_record_log(j._pid_path("p")))
    assert {n: open(os.path.join(d, n), "rb").read()
            for n in os.listdir(d)} == logs
    # a garbled tail is still a torn tail, truncated as before
    path = j._pid_path("q")
    with open(path, "wb") as f:
        blob = pickle.dumps(port.PersistentRepr("ok", 1, "q"), protocol=4)
        f.write(len(blob).to_bytes(8, "little") + blob + b"\x05\x00garbage")
    assert port.repair_record_log(path) == 9


@pytest.mark.parametrize("module", ["jax.numpy", "jaxlib.xla_client",
                                    "flax.core", "optax", "orbax.checkpoint",
                                    "chex"])
def test_a_record_naming_a_jax_library_is_refused(module):
    """A record naming a class of jax or of a library that imports it is
    refused before its module is imported."""
    from akka_tpu_torch.serialization import records
    root = module.split(".")[0]

    def loaded():
        return {m for m in sys.modules if m.split(".")[0] == root}

    before = loaded()
    with pytest.raises(records.UnresolvedRecordClass, match="jax"):
        records.load_record(f"c{module}\nThing\n.".encode())
    assert loaded() == before


def test_a_record_whose_import_loads_jax_is_refused(tmp_path, monkeypatch):
    """A record naming a class whose module imports jax, in a process
    without jax, is refused: the port never keeps a class that brought
    jax in."""
    from akka_tpu_torch.serialization import records
    (tmp_path / "needs_jax_probe.py").write_text(
        "import sys, types\n"
        "sys.modules['jax'] = types.ModuleType('jax_probe_stub')\n"
        "class Thing:\n    pass\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    try:
        with pytest.raises(records.UnresolvedRecordClass, match="loaded jax"):
            records.load_record(b"cneeds_jax_probe\nThing\n.")
    finally:
        sys.modules.pop("needs_jax_probe", None)
        if getattr(sys.modules.get("jax"), "__name__", "") == \
                "jax_probe_stub":
            del sys.modules["jax"]


def test_unresolvable_snapshot_class_raises(tmp_path):
    """A snapshot that names a class the port cannot resolve fails the
    load (LoadSnapshotFailed through the actor) instead of falling back
    to an older snapshot."""
    from akka_tpu.ddata.crdt import GCounter
    ref, port = (package(n).persistence for n in ("akka_tpu",
                                                  "akka_tpu_torch"))
    d = str(tmp_path / "s")
    ref.LocalSnapshotStore(d).save(ref.SnapshotMetadata("p", 1, 1.0), "old")
    ref.LocalSnapshotStore(d).save(ref.SnapshotMetadata("p", 2, 2.0),
                                   GCounter())
    with pytest.raises(ImportError):
        port.LocalSnapshotStore(d).load(
            "p", port.SnapshotSelectionCriteria.latest())


def test_relative_plugin_dirs_root_in_the_temp_directory(
        systems, tmp_path, monkeypatch):
    """The default file journal with its relative `journal` dir roots
    under tempfile.gettempdir() (TMPDIR), per system name."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    P = package("akka_tpu_torch")
    M = P.persistence
    system = systems.classic(P, "reldir", {"akka": {
        **QUIET["akka"], "persistence": {
            "journal": {"plugin": "akka.persistence.journal.file"},
            "snapshot-store": {
                "plugin": "akka.persistence.snapshot-store.local"}}}})
    ext = M.Persistence.get(system)
    plugin = ext.journal_plugin_for()
    assert isinstance(plugin, M.FileJournal)
    assert plugin.dir == str(tmp_path / f"akka-tpu-{system.name}" /
                             "journal")
    ext.snapshot_store_for()
    assert isinstance(ext._snapshot_plugins[M.SNAPSHOT_LOCAL],
                      M.LocalSnapshotStore)
