"""The port's remember-entities stores (akka_tpu_torch.sharding.remember:
in-proc, journal and ddata, and `make_remember_entities_store`) on the
CPU, held to the JAX package's: tests/test_remember_entities_stores.py's
8 cases, each written once over a package namespace and run on both
packages through `side_by_side` (tests/torch_remote_fixture.py). The
conformance cases run against each of the three stores (the ddata store
on a one-node cluster of each package, on its own in-proc wire); the
respawn cases build the reference's region on one of its virtual devices
and the port's on the CPU. The port's trace (remembered ids, placements,
truncation, the factory's kinds and refusals) must equal the
reference's, and each test also asserts the trace's values.

Every system starts through the `nodes` fixture. Every wait is at most
10 s.
"""

import importlib
import os

import pytest

from torch_remote_fixture import SHARDING_CLUSTER, WAIT, Nodes, side_by_side

KINDS = ("inproc", "journal", "ddata")


@pytest.fixture()
def nodes():
    n = Nodes()
    try:
        yield n
    finally:
        n.close()


def ns(P):
    P.sharding = importlib.import_module(f"{P.name}.sharding")
    P.device = importlib.import_module(f"{P.name}.sharding.device")
    P.gateway = importlib.import_module(f"{P.name}.gateway")
    return P


def ddata_system(P, nodes):
    """A one-node cluster system of package P, Up."""
    s = nodes.node("re-store", "inproc", P=P, provider="cluster",
                   cluster=SHARDING_CLUSTER)
    c = P.cluster.Cluster.get(s)
    c.join(str(s.provider.local_address))
    P.testkit.await_condition(lambda: any(
        m.status.value == "Up" for m in c.state.members), max_time=WAIT)
    return s


def store_pair(P, nodes, kind, root, prefix):
    """(store, fresh handle factory, close): the factory opens a second
    handle on the same substrate, the restarted region's view."""
    S = P.sharding
    if kind == "inproc":
        S.InProcRememberEntitiesStore.reset()
        return (S.InProcRememberEntitiesStore(),
                S.InProcRememberEntitiesStore,
                S.InProcRememberEntitiesStore.reset)
    if kind == "journal":
        path = os.path.join(root, P.name, "remember.journal")
        store = S.JournalRememberEntitiesStore(path)
        return (store, lambda: S.JournalRememberEntitiesStore(path),
                store.close)
    s = ddata_system(P, nodes)
    return (S.DDataRememberEntitiesStore(s, key_prefix=prefix),
            lambda: S.DDataRememberEntitiesStore(s, key_prefix=prefix),
            lambda: None)


def on_each(scenario):
    """A side-by-side scenario over one store kind."""
    def run(P, nodes, kind, root):
        P = ns(P)
        store, fresh, close = store_pair(P, nodes, kind, root,
                                         f"re-{scenario.__name__}")
        try:
            return scenario(P, nodes, store, fresh)
        finally:
            close()
    return run


# -------------------------------------------------------------- conformance
@on_each
def _add_remove_get(P, nodes, store, fresh):
    out = [sorted(store.remembered("Counter", "0"))]
    store.add("Counter", "0", "a")
    store.add("Counter", "0", "b")
    store.add("Counter", "1", "c")
    store.add("Other", "0", "d")  # namespaced by (type, shard)
    store.remove("Counter", "0", "b")
    return out + [sorted(store.remembered(t, s)) for t, s in (
        ("Counter", "0"), ("Counter", "1"), ("Other", "0"))]


@pytest.mark.parametrize("kind", KINDS)
def test_store_add_remove_get(nodes, kind, tmp_path):
    assert side_by_side(_add_remove_get, nodes, kind, str(tmp_path)) == [
        [], ["a"], ["c"], ["d"]]


@on_each
def _idempotent(P, nodes, store, fresh):
    for _ in range(3):
        store.add("Counter", "0", "a")  # re-add: no-op, no duplicate
    out = [sorted(store.remembered("Counter", "0"))]
    store.remove("Counter", "0", "missing")  # remove absent: no-op
    store.remove("Counter", "0", "a")
    store.remove("Counter", "0", "a")  # re-remove: no-op
    return out + [sorted(store.remembered("Counter", "0"))]


@pytest.mark.parametrize("kind", KINDS)
def test_store_idempotent_ops(nodes, kind, tmp_path):
    assert side_by_side(_idempotent, nodes, kind, str(tmp_path)) == [
        ["a"], []]


@on_each
def _fresh_handle(P, nodes, store, fresh):
    """The restart seam: a second handle on the same substrate reads
    exactly what the first one flushed."""
    store.add("Counter", "0", "x")
    store.add("Counter", "0", "y")
    store.remove("Counter", "0", "y")
    twin = fresh()
    try:
        return sorted(twin.remembered("Counter", "0"))
    finally:
        if isinstance(twin, P.sharding.JournalRememberEntitiesStore):
            twin.close()


@pytest.mark.parametrize("kind", KINDS)
def test_store_fresh_handle_sees_prior_adds(nodes, kind, tmp_path):
    assert side_by_side(_fresh_handle, nodes, kind, str(tmp_path)) == ["x"]


@on_each
def _concurrent_start(P, nodes, store, fresh):
    """Two regions starting at once against one store (the multi-node
    boot race): the adds of both threads all land."""
    errors = []

    def boot(node: int) -> None:
        try:
            for i in range(16):
                store.add("Counter", str(i % 2), f"n{node}-e{i}")
                store.add("Counter", "0", "shared")  # contended id
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    ts = [nodes.thread(lambda n=n: boot(n)) for n in (0, 1)]
    for t in ts:
        t.join(WAIT)
    return [[repr(e) for e in errors],
            sorted(store.remembered("Counter", "0")
                   | store.remembered("Counter", "1"))]


@pytest.mark.parametrize("kind", KINDS)
def test_store_concurrent_region_start(nodes, kind, tmp_path):
    errors, got = side_by_side(_concurrent_start, nodes, kind,
                               str(tmp_path))
    assert errors == []
    assert got == sorted({f"n{n}-e{i}" for n in (0, 1) for i in range(16)}
                         | {"shared"})


def _compact_and_torn_tail(P, nodes, root):
    S = ns(P).sharding
    path = os.path.join(root, P.name, "remember.journal")
    store = S.JournalRememberEntitiesStore(path)
    for i in range(8):
        store.add("Counter", "0", f"e{i}")
    store.remove("Counter", "0", "e0")
    kept = store.compact()
    store.close()
    with open(path, "ab") as f:  # a crash-torn trailing record
        f.write((1 << 20).to_bytes(8, "little") + b"torn")
    twin = S.JournalRememberEntitiesStore(path)
    try:
        return [kept, twin.truncated_bytes,
                sorted(twin.remembered("Counter", "0"))]
    finally:
        twin.close()


def test_journal_store_compact_and_torn_tail(nodes, tmp_path):
    assert side_by_side(_compact_and_torn_tail, nodes, str(tmp_path)) == [
        7, 12, [f"e{i}" for i in range(1, 8)]]


def _factory(P, nodes, root):
    S = ns(P).sharding
    make, Settings = S.make_remember_entities_store, \
        S.ClusterShardingSettings
    out = [make(Settings()),
           type(make(Settings(remember_entities=True))).__name__]
    st = make(Settings(remember_entities=True,
                       remember_entities_store="journal",
                       remember_entities_dir=os.path.join(root, P.name)))
    out += [type(st).__name__, os.path.basename(st.path)]
    st.close()
    for bad in (dict(remember_entities_store="journal"),
                dict(remember_entities_store="ddata"),
                dict(remember_entities_store="nope")):
        with pytest.raises(ValueError) as e:
            make(Settings(remember_entities=True, **bad))
        out.append(str(e.value))
    s = ddata_system(P, nodes)
    out.append(type(make(Settings(remember_entities=True,
                                  remember_entities_store="ddata"),
                         system=s)).__name__)
    return out


def test_settings_factory_resolution(nodes, tmp_path):
    assert side_by_side(_factory, nodes, str(tmp_path)) == [
        None, "InProcRememberEntitiesStore", "JournalRememberEntitiesStore",
        "remember_entities.journal",
        "remember_entities_store='journal' needs remember_entities_dir",
        "remember_entities_store='ddata' needs the ActorSystem",
        "unknown remember_entities_store 'nope'",
        "DDataRememberEntitiesStore"]


# ------------------------------------------------------------ region respawn
def respawn_roundtrip(P, store_a, fresh_store, type_name):
    """A first region registers entities through spec.remember_store; a
    fresh region on a fresh handle (opened after the adds, like a
    restarted process) respawns them all with no client traffic, each at
    the row it had. The reference's region on one virtual device, the
    port's on the CPU."""
    kw = dict(n_shards=2, entities_per_shard=16, n_devices=1,
              payload_width=4)
    dev = {"device": "cpu"} if P.name == "akka_tpu_torch" else {}
    D = P.device
    r1 = D.DeviceShardRegion(D.DeviceEntity(
        type_name, P.gateway.counter_behavior(4), **kw,
        remember_store=store_a), **dev)
    ids = {f"re-{type_name}-{i}" for i in range(6)}
    rows = {e: r1.entity_ref(e).row for e in sorted(ids)}
    store_b = fresh_store()
    r2 = D.DeviceShardRegion(D.DeviceEntity(
        type_name, P.gateway.counter_behavior(4), **kw,
        remember_store=store_b), **dev)
    r2._respawn_remembered()
    got = set()
    for shard in range(2):
        got.update(r2._entities[shard])
    return store_b, [sorted(got) == sorted(ids),
                     {e: r2.entity_ref(e).row for e in ids} == rows,
                     r2.stats()["entities"] >= len(ids), sorted(rows.items())]


def _respawn_journal(P, nodes, root):
    S = ns(P).sharding
    path = os.path.join(root, P.name, "remember.journal")
    a = S.JournalRememberEntitiesStore(path)
    b = None
    try:
        b, trace = respawn_roundtrip(
            P, a, lambda: S.JournalRememberEntitiesStore(path),
            "re-journal")
        return trace
    finally:
        a.close()
        if b is not None:
            b.close()


def test_respawn_remembered_from_journal_store(nodes, tmp_path):
    trace = side_by_side(_respawn_journal, nodes, str(tmp_path))
    assert trace[:3] == [True, True, True]


def _respawn_ddata(P, nodes):
    S = ns(P).sharding
    s = ddata_system(P, nodes)
    _, trace = respawn_roundtrip(P, S.DDataRememberEntitiesStore(s),
                                 lambda: S.DDataRememberEntitiesStore(s),
                                 "re-ddata")
    return trace


def test_respawn_remembered_from_ddata_store(nodes):
    trace = side_by_side(_respawn_ddata, nodes)
    assert trace[:3] == [True, True, True]
