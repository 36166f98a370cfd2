"""The users of ddata's replicator in the port, on the CPU, held to the
JAX package's: the remember-entities store (`DDataRememberEntitiesStore`,
akka_tpu_torch/sharding/remember.py, the reference's class of
akka_tpu/sharding/region.py), the gateway's `ReadReplicaCache` fed by
the replicator, and a device region restored on another node from the
replicated ids. Each scenario is written once over a package namespace
and runs on both packages through `side_by_side`
(tests/torch_remote_fixture.py), each package's cluster nodes on its own
in-proc transport with the reference's fast ddata settings; the port's
trace must equal the reference's.

Two cases hold what the port does differently (ROADMAP, deliberate
differences and section C): a replica cache whose system cannot run the
replicator raises where the reference falls back to its local mode, and
a region that lost its `entities.log` re-hosts the replicated ids at the
rows they had (the store records each id's row beside its ORSet), so its
WAL replays onto the right entities, whichever nodes' regions allocated
them; the reference sorts them and can swap two entities' totals.

Every system starts through the `nodes` fixture. Every wait is at most
10 s.
"""

import importlib
import itertools
import os
import shutil

import pytest

from torch_remote_fixture import WAIT, Nodes, config, side_by_side

DDATA_CLUSTER = {"gossip-interval": "0.05s",
                 "leader-actions-interval": "0.05s",
                 "unreachable-nodes-reaper-interval": "0.1s",
                 "failure-detector": {"heartbeat-interval": "0.1s",
                                      "acceptable-heartbeat-pause": "2s"},
                 "distributed-data": {
                     "gossip-interval": "0.1s",
                     "notify-subscribers-interval": "0.05s",
                     "pruning-interval": "0.3s",
                     "delta-crdt": {"delta-propagation-interval": "0.05s"}}}


@pytest.fixture()
def nodes(monkeypatch):
    # the reference writes its snapshots as orbax directories whenever
    # orbax imports; its .npz form is the one the port shares
    from akka_tpu.persistence import slab_snapshot as jslab
    monkeypatch.setattr(jslab, "_try_orbax", lambda: None)
    n = Nodes()
    try:
        yield n
    finally:
        n.close()


def ns(P):
    def m(sub):
        return importlib.import_module(f"{P.name}.{sub}")
    P.ddata = m("ddata")
    P.remember = m("sharding.remember" if P.name == "akka_tpu_torch"
                   else "sharding.region")
    P.replica = m("gateway.replica")
    P.device = m("sharding.device")
    P.ingress = m("gateway.ingress")
    return P


def cluster(P, nodes, n, stem):
    cfg = config("inproc", provider="cluster", cluster=DDATA_CLUSTER)
    systems = []
    for i in range(n):
        if P.name == "akka_tpu_torch":
            s = nodes.port_system(f"{stem}{i}", cfg)
        else:
            s = P.ActorSystem.create(f"{stem}{i}", cfg)
            nodes.ref_nodes.append(s)
            nodes.ref_clusters.append((s, P.cluster.Cluster.get(s)))
        systems.append(s)
    clusters = [P.cluster.Cluster.get(s) for s in systems]
    for c in clusters:
        c.join(str(systems[0].provider.local_address))
    P.testkit.await_condition(
        lambda: all(sum(1 for m in c.state.members
                        if m.status.value == "Up") == n for c in clusters),
        max_time=WAIT)
    return systems


# ------------------------------------------------ the remember store
def _remember(P, nodes):
    P = ns(P)
    systems = cluster(P, nodes, 3, "rm")
    stores = [P.remember.DDataRememberEntitiesStore(s) for s in systems]
    for e in ("a", "b", "c"):
        stores[0].add("Counter", "0", e)
    stores[1].add("Counter", "1", "x")
    stores[0].remove("Counter", "0", "b")

    def view(st):
        return [sorted(st.remembered("Counter", sh)) for sh in "012"]
    want = [["a", "c"], ["x"], []]
    P.testkit.await_condition(lambda: all(view(st) == want
                                          for st in stores), max_time=WAIT)
    return [view(st) for st in stores]


def test_ddata_remember_store_replicates_ids(nodes):
    """Ids added on one node are remembered on every node (one ORSet per
    type and shard); a removal travels too."""
    assert side_by_side(_remember, nodes) == [[["a", "c"], ["x"], []]] * 3


# ------------------------------------------------ the replica cache
def _replica(P, nodes):
    P = ns(P)
    systems = cluster(P, nodes, 2, "rp")
    steps = [5]
    caches = [P.replica.ReadReplicaCache(lambda: steps[0], system=s)
              for s in systems]
    caches[0].publish_wave({"e1": 3.5, "e2": -1.25})
    steps[0] = 9
    caches[0].publish_wave({"e1": 4.0, "e3": 0.5})

    def peer():
        with caches[1]._lock:
            return dict(caches[1]._replica)
    want = {"e1": (4.0, 9), "e2": (-1.25, 5), "e3": (0.5, 9)}
    P.testkit.await_condition(lambda: peer() == want, max_time=WAIT)
    for _ in range(4):      # promote e1 on the peer, then serve it
        served = caches[1].try_read("e1")
    return [sorted(peer().items()), served,
            caches[0].stats()["replicated"], caches[1].stats()["publishes"]]


def test_replica_cache_fed_by_the_replicator(nodes):
    """A wave's totals published on node 0 reach node 1's cache through
    the replicator alone, with their step stamps; node 1 serves a hot
    entity from it."""
    assert side_by_side(_replica, nodes) == [
        [("e1", (4.0, 9)), ("e2", (-1.25, 5)), ("e3", (0.5, 9))],
        (4.0, 0), True, 0]


def test_replica_cache_refuses_a_system_without_a_cluster(nodes):
    """A local system has no cluster for the replicator: the reference's
    cache falls back to its local mode without a word, the port's raises
    ValueError."""
    from akka_tpu.gateway.replica import ReadReplicaCache as JReplica

    from akka_tpu_torch.gateway.replica import ReadReplicaCache
    quiet = {"akka": {"stdout-loglevel": "OFF"}}
    t, j = nodes.systems("no-cluster", quiet)
    assert JReplica(lambda: 0, system=j).stats()["replicated"] == 0
    with pytest.raises(ValueError, match="ddata replicator") as e:
        ReadReplicaCache(lambda: 0, system=t)
    assert "Cluster requires" in str(e.value)


# ------------------------------------ a region restored from the ORSets
def _spec(P, store):
    return P.device.DeviceEntity(
        "counter", P.ingress.counter_behavior(4), n_shards=2,
        entities_per_shard=16, spare_blocks=2, remember_store=store)


def _region(P, store):
    kw = {"device": "cpu"} if P.name == "akka_tpu_torch" else {}
    return P.device.DeviceShardRegion(_spec(P, store), **kw)


def _restore(P, nodes, root, writers=1):
    """Node 0's region takes two waves with a checkpoint between them;
    node 1 restores a fresh region from a copy of node 0's directory
    without entities.log, so the ids first used after the checkpoint
    come only from the replicated ORSets. With two writers, node 1's
    region then allocates three more ids of the shard, their add dots
    node 1's and numbered on from node 1's own last dot, as a process of
    its own numbers them (the counter is one per process, and node 0's
    dots have run ahead of it), and a third region on node 0
    restores from a copy of node 1's directory without entities.log."""
    P = ns(P)
    systems = cluster(P, nodes, 2, f"rr{writers}")
    stores = [P.remember.DDataRememberEntitiesStore(s) for s in systems]
    r0 = _region(P, stores[0])
    d0, d1, d2 = (os.path.join(root, P.name, n) for n in ("n0", "n1", "n2"))
    r0.attach_journal(d0)
    # three ids of one shard first used after the checkpoint, in reverse
    # name order
    by_shard = {}
    for i in range(40):
        by_shard.setdefault(r0.shard_of(f"e{i:02d}"), []).append(f"e{i:02d}")
    late = sorted(by_shard[0][:3], reverse=True)
    early = by_shard[0][3:5] + by_shard[1][:2]
    late2 = sorted(by_shard[0][5:8], reverse=True)
    oracle = {}

    def wave(region, asks):
        for eid, v in asks:
            ref = region.entity_ref(eid)
            region.ask(ref.shard, ref.index, [v])
            oracle[eid] = oracle.get(eid, 0.0) + v

    def restored(store, src, dst):
        """A fresh region over `store` on a copy of `src` without
        entities.log, once `store` holds every id of the oracle."""
        def replicated():
            return [sorted(store.remembered("counter", sh)) for sh in "01"]
        want = [sorted(e for e in oracle if r0.shard_of(e) == sh)
                for sh in (0, 1)]
        P.testkit.await_condition(lambda: replicated() == want,
                                  max_time=WAIT)
        shutil.copytree(src, dst)
        os.remove(os.path.join(dst, "entities.log"))
        region = _region(P, store)
        region.attach_journal(dst)
        region.restore()
        return region, want

    wave(r0, [(e, 1.0 + i) for i, e in enumerate(early)])
    r0.checkpoint()
    wave(r0, [(e, 10.0 * (i + 1)) for i, e in enumerate(late)]
         + [(early[0], 0.5)])
    rows = {e: r0.entity_ref(e).index for e in oracle}
    r1, want = restored(stores[1], d0, d1)
    if writers == 2:
        probe = P.testkit.TestProbe(systems[1])
        stores[1].replicator.tell(P.ddata.Get(
            stores[1]._key("counter", "0"), P.ddata.ReadLocal()), probe.ref)
        own = probe.receive_one(WAIT).data.vvector.version_at(stores[1].node)
        vv = importlib.import_module(f"{P.name}.ddata.version_vector")
        counter, vv._counter = vv._counter, itertools.count(own + 1)
        try:
            wave(r1, [(e, 100.0 * (i + 1)) for i, e in enumerate(late2)]
                 + [(late[0], 0.25)])
        finally:
            vv._counter = counter
        rows.update({e: r1.entity_ref(e).index for e in late2})
        r1, want = restored(stores[0], d1, d2)
    ids = [sorted(r1._entities[sh]) for sh in (0, 1)]
    rows1 = {e: r1.entity_ref(e).index for e in oracle}
    totals = {}
    for e in oracle:
        ref = r1.entity_ref(e)
        totals[e] = float(r1.ask(ref.shard, ref.index, [0.0])[0])
    return [ids == want, rows1 == rows, totals == oracle,
            sum(totals.values()) == sum(oracle.values())]


def test_region_restores_replicated_ids_at_their_rows(nodes, tmp_path):
    """Both packages re-host every replicated id and conserve the sum.
    The port re-hosts each id at the row it had, so every total equals
    the oracle; the reference sorts the late ids into other rows and the
    WAL's tells, which name rows, land on the wrong entities."""
    traces = {}
    for name in ("akka_tpu", "akka_tpu_torch"):
        from torch_remote_fixture import package
        traces[name] = _restore(package(name), nodes, str(tmp_path))
    assert traces["akka_tpu_torch"] == [True, True, True, True]
    assert traces["akka_tpu"] == [True, False, False, True]


def test_region_restores_ids_of_two_writers_at_their_rows(nodes, tmp_path):
    """As above, with the shard's ids allocated by regions on two nodes
    (add dots of two writers, whose counters interleave): the port
    re-hosts each id at its recorded row, and every total equals the
    oracle; the reference sorts the ids not in the checkpoint."""
    traces = {}
    for name in ("akka_tpu", "akka_tpu_torch"):
        from torch_remote_fixture import package
        traces[name] = _restore(package(name), nodes, str(tmp_path),
                                writers=2)
    assert traces["akka_tpu_torch"] == [True, True, True, True]
    assert traces["akka_tpu"] == [True, False, False, True]
