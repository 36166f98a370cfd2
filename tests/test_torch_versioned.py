"""The port's schema-evolution serializer
(akka_tpu_torch.serialization.versioned) on the CPU, side by side with the
JAX package's: a port of the 6 scenarios of
tests/test_serialization_versioned.py (versioned manifests, migrations,
renames, refusals, a v1 journal replayed and recovered by a v2
application), and the serializer's bytes held equal across the two
packages, and a journal of versioned payloads written by the JAX package
and replayed by the port.

Every system starts through the `systems` fixture
(tests/torch_host_fixture.py), which asserts `await_termination(10.0)` and
that no thread is left; every wait is at most 10 s; journal directories lie
under tmp_path.
"""

from dataclasses import dataclass

import pytest

from torch_host_fixture import (QUIET, WAIT, Systems, package,
                                side_by_side)


@pytest.fixture()
def systems():
    s = Systems()
    try:
        yield s
    finally:
        s.close()


# -- v1 application: flat event ----------------------------------------------

@dataclass(frozen=True)
class ItemAddedV1:
    product_id: str
    qty: int


# -- v2 application: nested item + renamed class ------------------------------

@dataclass(frozen=True)
class ItemAppended:  # renamed from ItemAdded in "v2 of the app"
    item: dict  # {"id": ..., "quantity": ...}


_migrations = {}


def migration(P):
    if P.name not in _migrations:
        class ItemAddedMigration(P.serialization.SchemaMigration):
            current_version = 2

            def transform_class_name(self, from_version, name):
                return "ItemAppended" if from_version < 2 else name

            def transform(self, from_version, payload):
                if from_version < 2:
                    payload = {"item": {"id": payload["product_id"],
                                        "quantity": payload["qty"]}}
                return payload
        _migrations[P.name] = ItemAddedMigration
    return _migrations[P.name]()


def v1_serialization(P):
    S = P.serialization
    ser = S.VersionedJsonSerializer()
    ser.register_type(ItemAddedV1, name="ItemAdded")
    s = S.Serialization(allow_pickle=False)
    s.add_binding(ItemAddedV1, ser)
    return s


def v2_serialization(P):
    S = P.serialization
    ser = S.VersionedJsonSerializer()
    ser.register_type(ItemAppended)
    ser.register_migration("ItemAdded", migration(P))
    ser.register_migration("ItemAppended", migration(P))
    s = S.Serialization(allow_pickle=False)
    s.add_binding(ItemAppended, ser)
    return s


def _roundtrip(P, systems):
    s = v1_serialization(P)
    sid, manifest, data = s.serialize(ItemAddedV1("apple", 3))
    return [sid, manifest, data, s.deserialize(sid, manifest, data)]


def test_roundtrip_same_version(systems):
    sid, manifest, data, back = side_by_side(_roundtrip, systems)
    assert manifest == "ItemAdded#1" and sid == 7
    assert data == b'{"product_id":"apple","qty":3}'
    assert back == ItemAddedV1("apple", 3)


def _migrates(P, systems):
    sid, manifest, data = v1_serialization(P).serialize(
        ItemAddedV1("pear", 2))
    return v2_serialization(P).deserialize(sid, manifest, data)


def test_v1_payload_migrates_into_v2_shape(systems):
    assert side_by_side(_migrates, systems) == \
        ItemAppended(item={"id": "pear", "quantity": 2})


def _newer_refused(P, systems):
    err = P.serialization.SerializationError
    s1 = v1_serialization(P)
    # a known type stamped with a future version: refused (no downgrades)
    with pytest.raises(err, match="NEWER"):
        s1.deserialize(7, "ItemAdded#2", b'{"product_id":"x","qty":1}')
    # a type this (old) node has never heard of: also a clean failure
    s2 = v2_serialization(P)
    sid, manifest, data = s2.serialize(ItemAppended({"id": "x",
                                                     "quantity": 1}))
    with pytest.raises(err, match="unregistered"):
        s1.deserialize(sid, manifest, data)
    return [manifest, data]


def test_newer_version_is_refused(systems):
    assert side_by_side(_newer_refused, systems)[0] == "ItemAppended#2"


def _unregistered(P, systems):
    ser = P.serialization.VersionedJsonSerializer()
    with pytest.raises(P.serialization.SerializationError,
                       match="not registered"):
        ser.to_binary(ItemAddedV1("x", 1))
    with pytest.raises(P.serialization.SerializationError,
                       match="non-dataclass"):
        ser.register_type(int)
    return ["refused"]


def test_unregistered_type_fails_fast(systems):
    side_by_side(_unregistered, systems)


def _write_v1(P, d, pid):
    M = P.persistence
    j1 = M.FileJournal(d, serialization=v1_serialization(P))
    assert j1.write_atomic(M.AtomicWrite([
        M.PersistentRepr(ItemAddedV1("apple", 3), 1, pid),
        M.PersistentRepr(ItemAddedV1("pear", 2), 2, pid)])) is None


def _replay_v2(P, d, pid):
    j2 = P.persistence.FileJournal(d, serialization=v2_serialization(P))
    replayed = []
    j2.replay(pid, 1, 10, 100, lambda r: replayed.append(r.payload))
    return replayed


def _v1_journal_replays(P, systems, tmp_path):
    """Events written by the v1 app recover in the v2 app through the
    migration (the JacksonMigration journal-upgrade story)."""
    d = str(tmp_path / f"jv-{P.name}")
    _write_v1(P, d, "cart-1")
    return _replay_v2(P, d, "cart-1")


def test_v1_journal_replays_into_v2_behavior(systems, tmp_path):
    assert side_by_side(_v1_journal_replays, systems, tmp_path) == [
        ItemAppended(item={"id": "apple", "quantity": 3}),
        ItemAppended(item={"id": "pear", "quantity": 2})]


def _v1_recovers_typed(P, systems, tmp_path):
    """An EventSourcedBehavior in a v2 system recovers its state from a
    journal the v1 system wrote."""
    M = P.persistence
    d = str(tmp_path / f"jfull-{P.name}")
    _write_v1(P, d, "Cart|c9")
    plugin_id = "test.versioned-journal"
    M.Persistence.register_journal_plugin(
        plugin_id, lambda _system, _cfg: M.FileJournal(
            d, serialization=v2_serialization(P)))
    system = systems.classic(P, "versioned-upgrade", {"akka": {
        **QUIET["akka"], "persistence": {
            "journal": {"plugin": plugin_id},
            "snapshot-store": {
                "plugin": "akka.persistence.snapshot-store.inmem"}}}})
    probe = P.testkit.TestProbe(system)

    def event_handler(state, event):
        # the v2 handler understands only the v2 event shape
        assert isinstance(event, ItemAppended), event
        return state + [(event.item["id"], event.item["quantity"])]

    beh = M.EventSourcedBehavior(M.PersistenceId.of("Cart", "c9"), [],
                                 lambda state, cmd: M.Effect.reply(
                                     cmd, ("cart", state)), event_handler)
    ref = system.actor_of(P.props_from_behavior(beh), "cart")
    ref.tell(probe.ref)
    return probe.receive_one(WAIT)


def test_v1_journal_recovers_typed_behavior_in_v2_system(systems, tmp_path):
    assert side_by_side(_v1_recovers_typed, systems, tmp_path) == \
        ("cart", [("apple", 3), ("pear", 2)])


# ----------------------------------------------- across the two packages

def test_versioned_bytes_are_the_same_in_both_packages():
    """Every payload serializes to the same manifest and bytes in both
    packages, and each package reads the other's."""
    ref, port = package("akka_tpu"), package("akka_tpu_torch")
    events = [ItemAddedV1("apple", 3), ItemAddedV1("péar", -2),
              ItemAppended({"id": "x", "quantity": [1, 2.5, None]})]
    out = {}
    for P in (ref, port):
        s1, s2 = v1_serialization(P), v2_serialization(P)
        out[P.name] = [s1.serialize(e) for e in events[:2]] + \
            [s2.serialize(events[2])]
    assert out["akka_tpu"] == out["akka_tpu_torch"]
    for P, Q in ((ref, port), (port, ref)):
        for (sid, man, data), want in zip(out[P.name], events):
            s = v1_serialization(Q) if man.endswith("#1") else \
                v2_serialization(Q)
            assert s.deserialize(sid, man, data) == want


def test_versioned_journal_written_by_the_reference(tmp_path):
    """A v1 journal of versioned payloads written by the JAX package
    replays through the port's v2 serializer into the v2 shape. (The
    other way does not cross: the port stores its own `_SerializedPayload`
    envelope class, which the reference's FileJournal does not unwrap;
    ROADMAP C2 records it.)"""
    ref, port = package("akka_tpu"), package("akka_tpu_torch")
    d = str(tmp_path / "jv")
    _write_v1(ref, d, "cart-x")
    assert _replay_v2(port, d, "cart-x") == _replay_v2(ref, d, "cart-x") \
        == [ItemAppended(item={"id": "apple", "quantity": 3}),
            ItemAppended(item={"id": "pear", "quantity": 2})]
