"""The port's replicated state (akka_tpu_torch.ddata: version vectors,
the CRDTs, the durable store and the replicator) on the CPU, held to the
JAX package's: the host cases of tests/test_ddata.py, each written once
over a package namespace and run on both packages. A CRDT case returns a
trace of plain values (the two packages' classes differ); a replicator
case runs three cluster nodes of each package over that package's own
in-proc transport (`side_by_side`, tests/torch_remote_fixture.py) with
the reference's fast gossip and ddata settings. The port's trace must
equal the reference's, and each test also asserts the trace's values.
The tensor-bank cases of tests/test_ddata.py are held in
tests/test_torch_ddata_tensor.py.

Also held here: a durable directory written by the JAX package reads
into the port as equal port CRDTs. tests/test_ddata.py's 10k-entry delta
budget case is in tests/test_torch_crdt_codec.py. The replicator's users in the port
(the remember-entities store, the gateway's replica cache) are held in
tests/test_torch_ddata_region.py.

Every system starts through the `nodes` fixture. Every wait is at most
10 s.
"""

import importlib
import os
import random
import time

import pytest

from torch_remote_fixture import WAIT, Nodes, config, package, side_by_side

N1, N2, N3 = "n1", "n2", "n3"
PACKAGES = ("akka_tpu", "akka_tpu_torch")

# the reference's settings (tests/test_ddata.py FAST)
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
def nodes():
    n = Nodes()
    try:
        yield n
    finally:
        n.close()


def ddata(name: str):
    """Package `name`'s ddata package (its crdt, replicator and durable
    modules are attributes of it)."""
    return importlib.import_module(f"{name}.ddata")


def both(scenario, *args):
    """Run a CRDT scenario on both packages' ddata; the traces must be
    equal. Returns the port's trace."""
    traces = {name: scenario(ddata(name), *args) for name in PACKAGES}
    assert traces["akka_tpu_torch"] == traces["akka_tpu"], traces
    return traces["akka_tpu_torch"]


# --------------------------------------------------------- version vector
def _vv(D):
    VV, O = D.VersionVector, D.Ordering
    v1 = VV.empty().increment(N1)
    v2 = v1.increment(N2)
    a = VV.empty().increment(N1)
    b = VV.empty().increment(N2)
    m = a.merge(b)
    return [v1.compare_to(v2) == O.BEFORE, v2.compare_to(v1) == O.AFTER,
            v1.compare_to(v1) == O.SAME, a.compare_to(b) == O.CONCURRENT,
            m.is_after(a) and m.is_after(b)]


def test_version_vector_ordering():
    assert both(_vv) == [True] * 5


# ---------------------------------------------------------------- counters
def _gcounter(D):
    a = D.GCounter.empty().increment(N1, 3)
    b = D.GCounter.empty().increment(N2, 5)
    a2 = a.increment(N1, 2)
    try:
        a.increment(N1, -1)
        refused = None
    except ValueError as e:
        refused = type(e).__name__
    return [a.merge(b).value, b.merge(a).value, a.merge(b).merge(b).value,
            a2.merge(a).value, refused]


def test_gcounter_merge_idempotent_commutative():
    assert both(_gcounter) == [8, 8, 8, 5, "ValueError"]


def _gcounter_delta(D):
    a = D.GCounter.empty().increment(N1, 1).increment(N1, 2)
    d = a.delta
    other = D.GCounter.empty().increment(N2, 7)
    return [d.value, other.merge_delta(d).value, a.reset_delta().delta]


def test_gcounter_delta():
    assert both(_gcounter_delta) == [3, 10, None]


def _pncounter(D):
    c = D.PNCounter.empty().increment(N1, 10).decrement(N1, 3) \
        .decrement(N2, 2)
    other = D.PNCounter.empty().increment(N2, 1)
    pruned = c.prune(N2, N1)
    return [c.value, c.merge(other).value, pruned.value,
            sorted(pruned.modified_by_nodes())]


def test_pncounter():
    assert both(_pncounter) == [5, 6, 5, [N1]]


# -------------------------------------------------------------------- sets
def _gset(D):
    m = D.GSet.empty().add("x").add("y").merge(D.GSet.empty().add("z"))
    return [sorted(m.elements), "x" in m]


def test_gset():
    assert both(_gset) == [["x", "y", "z"], True]


def _orset_add_remove(D):
    s = D.ORSet.empty().add(N1, "a").add(N1, "b").remove(N1, "a")
    return [sorted(s.elements), sorted(s.merge(s).elements)]


def test_orset_add_remove():
    assert both(_orset_add_remove) == [["b"], ["b"]]


def _orset_add_wins(D):
    base = D.ORSet.empty().add(N1, "x")
    r1, r2 = base.remove(N1, "x"), base.add(N2, "x")
    return [sorted(r1.merge(r2).elements), sorted(r2.merge(r1).elements)]


def test_orset_add_wins_over_concurrent_remove():
    assert both(_orset_add_wins) == [["x"], ["x"]]


def _orset_remove_propagates(D):
    base = D.ORSet.empty().add(N1, "x").add(N1, "y")
    removed = base.remove(N1, "x")
    return [sorted(base.merge(removed).elements),
            sorted(removed.merge(base).elements)]


def test_orset_remove_propagates():
    assert both(_orset_remove_propagates) == [["y"], ["y"]]


def _orset_prune(D):
    p = D.ORSet.empty().add(N1, "a").add(N2, "b").prune(N2, N1)
    return [sorted(p.elements), sorted(p.modified_by_nodes())]


def test_orset_prune():
    assert both(_orset_prune) == [["a", "b"], [N1]]


# ------------------------------------------------- registers, flag, maps
def _flag_lww(D):
    r1 = D.LWWRegister.create(N1, "v1", clock=lambda c, v: 1)
    r2 = r1.with_value(N2, "v2", clock=lambda c, v: 2)
    ra, rb = D.LWWRegister(N1, "a", 5), D.LWWRegister(N2, "b", 5)
    return [D.Flag.empty().merge(D.Flag.empty().switch_on()).enabled,
            r1.merge(r2).value, r2.merge(r1).value, ra.merge(rb).value,
            rb.merge(ra).value]


def test_flag_and_lww():
    assert both(_flag_lww) == [True, "v2", "v2", "a", "a"]


def _ormap_and_friends(D):
    m = D.ORMap.empty().put(N1, "k1", D.GCounter.empty().increment(N1, 2))
    m2 = D.ORMap.empty().put(N2, "k1", D.GCounter.empty().increment(N2, 3))
    merged = m.merge(m2)
    mm = (D.ORMultiMap.empty().add_binding(N1, "k", 1)
          .add_binding(N1, "k", 2).remove_binding(N1, "k", 1))
    pm = D.PNCounterMap.empty().increment(N1, "a", 3).decrement(N1, "a", 1)
    lm = D.LWWMap.empty().put(N1, "k", "v", clock=lambda c, v: 1)
    lm2 = lm.put(N2, "k", "w", clock=lambda c, v: 2)
    return [merged.get("k1").value, "k1" in merged.remove(N1, "k1"),
            sorted(mm.get("k")), pm.get("a"),
            pm.merge(D.PNCounterMap.empty().increment(N2, "a", 1)).get("a"),
            lm.merge(lm2).get("k")]


def test_ormap_and_friends():
    assert both(_ormap_and_friends) == [5, False, [2], 2, 3, "w"]


# ----------------------------------------------------------- durable store
def _durable(D, root):
    d = os.path.join(root, D.__name__.split(".")[0])
    store = D.DurableStore(d)
    store.store("counter", D.GCounter.empty().increment(N1, 42))
    store.store("set", D.GSet.empty().add("x"))
    loaded = D.DurableStore(d).load_all()
    store.delete("counter")
    return [loaded["counter"].value, sorted(loaded["set"].elements),
            sorted(D.DurableStore(d).load_all())]


def test_durable_store_roundtrip(tmp_path):
    assert both(_durable, str(tmp_path)) == [42, ["x"], ["set"]]


def test_durable_store_written_by_the_reference_reads_into_the_port(
        tmp_path):
    """A durable directory the JAX package wrote with plain CRDTs reads
    into the port as equal port CRDTs; a file whose class the port
    cannot resolve (a module neither package has) raises
    UnresolvedRecordClass and keeps its bytes."""
    from torch_host_fixture import class_of_no_package

    from akka_tpu_torch.serialization.records import UnresolvedRecordClass
    J, T = ddata("akka_tpu"), ddata("akka_tpu_torch")

    def values(D):
        return {"c": D.GCounter.empty().increment(N1, 4).increment(N2, 1),
                "s": D.ORSet.empty().add(N1, "a").add(N2, "b")
                .remove(N1, "a").reset_delta(),
                "m": D.PNCounterMap.empty().increment(N1, "e", 3)
                .reset_delta(),
                "f": D.Flag.empty().switch_on()}

    d = str(tmp_path / "dur")
    for k, v in values(J).items():
        J.DurableStore(d).store(k, v)
    got = T.DurableStore(d).load_all()
    assert got == values(T)
    assert {type(v).__module__ for v in got.values()} == \
        {"akka_tpu_torch.ddata.crdt"}
    with class_of_no_package() as Absent:
        J.DurableStore(d).store("x", Absent("e", 1))
    before = {n: open(os.path.join(d, n), "rb").read()
              for n in os.listdir(d)}
    with pytest.raises(UnresolvedRecordClass,
                       match="akka_tpu_torch.no_such_module"):
        T.DurableStore(d).load_all()
    assert {n: open(os.path.join(d, n), "rb").read()
            for n in os.listdir(d)} == before


# ------------------------------------------------- op-based ORSet deltas
def _orset_add_delta(D):
    s = D.ORSet.empty()
    for e in ("a", "b", "c", "d", "e"):
        s = s.add("n1", e).reset_delta()
    s2 = s.add("n1", "f")
    op = s2.delta
    return [isinstance(op, D.crdt.ORSetAddDeltaOp),
            sorted(op.underlying.element_map),
            list(op.underlying.vvector.nodes()),
            s.reset_delta().merge_delta(op).elements == s2.elements]


def test_orset_add_delta_ships_only_the_touched_element():
    assert both(_orset_add_delta) == [True, ["f"], ["n1"], True]


def _orset_coalesce(D):
    op = D.ORSet.empty().add("n1", "x").add("n1", "y").add("n1", "z").delta
    return [isinstance(op, D.crdt.ORSetAddDeltaOp),
            sorted(op.underlying.element_map),
            sorted(D.ORSet.empty().merge_delta(op).elements)]


def test_orset_consecutive_adds_coalesce_into_one_op():
    assert both(_orset_coalesce) == [True, ["x", "y", "z"], ["x", "y", "z"]]


def _orset_remove_delta(D):
    a = D.ORSet.empty().add("n1", "e").reset_delta()
    rm_op = a.remove("n1", "e").delta
    readded = a.add("n2", "e").reset_delta()
    return ["e" in readded.merge_delta(rm_op).elements,
            "e" in a.merge_delta(rm_op).elements]


def test_orset_remove_delta_wins_only_over_observed_adds():
    assert both(_orset_remove_delta) == [True, False]


def _orset_group(D):
    group = D.ORSet.empty().add("n1", "x").remove("n1", "x") \
        .add("n1", "y").delta
    return [isinstance(group, D.crdt.ORSetDeltaGroup),
            sorted(D.ORSet.empty().merge_delta(group).elements)]


def test_orset_mixed_ops_group_in_order():
    assert both(_orset_group) == [True, ["y"]]


def _orset_first_sight(D):
    op = D.ORSet.empty().add("n1", "only").delta
    return sorted(op.zero().merge_delta(op).elements)


def test_orset_delta_first_sight_applies_against_zero():
    assert both(_orset_first_sight) == ["only"]


def _orset_clear(D):
    base = D.ORSet.empty().add("n1", "a").add("n1", "b").reset_delta()
    op = base.clear().delta
    return [isinstance(op, D.crdt.ORSetFullStateDeltaOp),
            sorted(base.merge_delta(op).elements)]


def test_orset_clear_ships_full_state_op():
    assert both(_orset_clear) == [True, []]


# ------------------------------------------- op-based ORMap-family deltas
def _ormap_update_delta(D):
    m = D.PNCounterMap.empty()
    for i in range(50):
        m = m.increment("n1", f"k{i}", i + 1).reset_delta()
    m2 = m.increment("n1", "k3", 5)
    op = m2.delta
    replica = m.merge_delta(op)
    return [isinstance(op, D.crdt.ORMapUpdateDeltaOp), sorted(op.values),
            replica.get("k3"), replica.entries == m2.entries]


def test_ormap_update_delta_ships_only_the_touched_entry():
    assert both(_ormap_update_delta) == [True, ["k3"], 9, True]


def _ormap_coalesce(D):
    op = (D.PNCounterMap.empty().increment("n1", "a", 1)
          .increment("n1", "a", 2).increment("n1", "b", 3)).delta
    fresh = op.zero().merge_delta(op)
    return [isinstance(op, D.crdt.ORMapUpdateDeltaOp), sorted(op.values),
            fresh.get("a"), fresh.get("b")]


def test_ormap_consecutive_updates_coalesce_into_one_op():
    assert both(_ormap_coalesce) == [True, ["a", "b"], 3, 3]


def _ormap_zero_tag(D):
    out = []
    pm = D.PNCounterMap.empty().increment("n1", "k", 7)
    mm = D.ORMultiMap.empty().add_binding("n1", "k", "v")
    lm = D.LWWMap.empty().put("n1", "k", "v", clock=lambda c, v: 1)
    for m in (pm, mm, lm):
        fresh = m.delta.zero().merge_delta(m.delta)
        out.append((type(fresh).__name__, fresh.get("k")))
    return out


def test_ormap_delta_first_sight_reconstructs_wrapper_from_zero_tag():
    assert both(_ormap_zero_tag) == [("PNCounterMap", 7),
                                     ("ORMultiMap", frozenset({"v"})),
                                     ("LWWMap", "v")]


def _ormap_group(D):
    m = (D.ORMap.empty()
         .put("n1", "a", D.GCounter.empty().increment("n1", 1))
         .remove("n1", "a")
         .put("n1", "b", D.GCounter.empty().increment("n1", 2)))
    return [isinstance(m.delta, D.crdt.ORMapDeltaGroup),
            sorted(D.ORMap.empty().merge_delta(m.delta).entries)]


def test_ormap_mixed_ops_group_in_order():
    assert both(_ormap_group) == [True, ["b"]]


def _ormap_put_put(D):
    base = D.LWWMap.empty().put("a", "k", "v0", clock=lambda c, v: 1) \
        .reset_delta()
    pa = base.put("a", "k", "va", clock=lambda c, v: 2)
    pb = base.put("b", "k", "vb", clock=lambda c, v: 3)
    return [base.merge_delta(pa.delta).merge_delta(pb.delta).get("k"),
            base.merge_delta(pb.delta).merge_delta(pa.delta).get("k"),
            pa.reset_delta().merge(pb.reset_delta()).get("k")]


def test_ormap_concurrent_put_put_same_key_converges():
    assert both(_ormap_put_put) == ["vb"] * 3


def _ormultimap_remove_rebind(D):
    base = D.ORMultiMap.empty().add_binding("a", "k", "x").reset_delta()
    ra, rb = base.remove("a", "k"), base.add_binding("b", "k", "y")
    return [base.merge_delta(ra.delta).merge_delta(rb.delta).entries,
            base.merge_delta(rb.delta).merge_delta(ra.delta).entries,
            ra.reset_delta().merge(rb.reset_delta()).entries]


def test_ormultimap_concurrent_remove_vs_rebind_converges():
    assert both(_ormultimap_remove_rebind) == [{"k": frozenset({"y"})}] * 3


def _interleavings(D):
    """The reference's property: random op interleavings on 3 replicas,
    synced by op deltas, converge to the full-state merge; the trace is
    each family's converged entries (one seeded stream per package)."""
    rng = random.Random(1405)
    nodes = ["n1", "n2", "n3"]
    out = []

    def run(make_empty, mutate):
        states = {n: make_empty() for n in nodes}
        pending = {n: [] for n in nodes}
        for _ in range(90):
            n = rng.choice(nodes)
            s = mutate(rng, n, states[n].reset_delta())
            if s.delta is not None:
                pending[n].append(s.delta)
            states[n] = s
            if rng.random() < 0.3:
                src = rng.choice(nodes)
                for dst in nodes:
                    if dst is src:
                        continue
                    acc = states[dst].reset_delta()
                    for d in pending[src]:
                        acc = acc.merge_delta(d)
                    states[dst] = acc
        conv = states["n1"].reset_delta()
        for n in ("n2", "n3"):
            conv = conv.merge(states[n].reset_delta())
        fix = all(states[n].reset_delta().merge(conv).entries == conv.entries
                  for n in nodes)
        out.append((fix, sorted((k, plain(v))
                                for k, v in conv.entries.items())))

    def plain(v):
        if hasattr(v, "elements"):
            v = v.elements
        return sorted(v) if isinstance(v, (set, frozenset)) else v

    def mut_multimap(rng, n, s):
        k = f"k{rng.randrange(5)}"
        r = rng.random()
        if r < 0.5:
            return s.add_binding(n, k, rng.randrange(8))
        if r < 0.7:
            vs = s.get(k)
            return s.remove_binding(n, k, sorted(vs)[0]) if vs else s
        if r < 0.85:
            return s.put(n, k, [rng.randrange(8)])
        return s.remove(n, k)

    def mut_counter(rng, n, s):
        k = f"k{rng.randrange(5)}"
        return (s.increment(n, k, rng.randrange(1, 4)) if rng.random() < 0.7
                else s.decrement(n, k, 1))

    def mut_lww(rng, n, s):
        k = f"k{rng.randrange(5)}"
        t = [0]

        def clock(c, v):
            t[0] = max(c, t[0]) + 1
            return t[0]
        if rng.random() < 0.8:
            return s.put(n, k, rng.randrange(100), clock=clock)
        return s.remove(n, k) if s.get(k) is not None else s

    def mut_ormap(rng, n, s):
        k = f"k{rng.randrange(5)}"
        if rng.random() < 0.8:
            return s.updated(n, k, D.ORSet.empty(),
                             lambda o: o.add(n, rng.randrange(8)))
        return s.remove(n, k)

    run(D.ORMultiMap.empty, mut_multimap)
    run(D.PNCounterMap.empty, mut_counter)
    run(D.LWWMap.empty, mut_lww)
    run(D.ORMap.empty, mut_ormap)
    return out


def test_ormap_family_op_vs_full_parity_random_interleavings():
    trace = both(_interleavings)
    assert [fix for fix, _ in trace] == [True] * 4
    assert all(entries for _, entries in trace)


# ------------------------------------------------------------- replicator
def ns(P):
    """The remote fixture's namespace of package P with its ddata."""
    P.ddata = ddata(P.name)
    P.replicator = P.ddata.replicator
    return P


def _cluster(P, nodes, n=3, stem="dd", extra=None):
    """n cluster nodes of package P with the reference's ddata settings,
    joined and all Up; their DistributedData extensions."""
    cfg = config("inproc", provider="cluster", cluster=DDATA_CLUSTER)
    cfg["akka"].update(extra or {})
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
    first = str(systems[0].provider.local_address)
    for c in clusters:
        c.join(first)
    P.testkit.await_condition(
        lambda: all(sum(1 for m in c.state.members
                        if m.status.value == "Up") == n for c in clusters),
        max_time=WAIT)
    return systems, [P.ddata.DistributedData.get(s) for s in systems]


def _node_id(P, system):
    return P.replicator.unique_node_id(
        P.cluster.Cluster.get(system).self_unique_address)


def _get(P, system, dd, key, timeout=2.0):
    p = P.testkit.TestProbe(system)
    dd.replicator.tell(P.ddata.Get(key, P.ddata.ReadLocal()), p.ref)
    try:
        return p.receive_one(timeout)
    except AssertionError:
        return None


def _gossip_convergence(P, nodes):
    P = ns(P)
    D = P.ddata
    systems, dd = _cluster(P, nodes)
    key, nid = D.Key("counter"), _node_id(P, systems[0])
    probe = P.testkit.TestProbe(systems[0])
    dd[0].replicator.tell(D.Update(key, D.GCounter.empty(), D.WriteLocal(),
                                   lambda c: c.increment(nid, 5)), probe.ref)
    ok = type(probe.expect_msg_class(D.UpdateSuccess, 3.0)).__name__

    def everywhere():
        got = [_get(P, systems[i], dd[i], key) for i in (1, 2)]
        return all(isinstance(m, D.GetSuccess) and m.data.value == 5
                   for m in got)
    P.testkit.await_condition(everywhere, max_time=WAIT)
    return [ok, [_get(P, s, d, key).data.value for s, d in zip(systems, dd)]]


def test_replicator_update_and_gossip_convergence(nodes):
    assert side_by_side(_gossip_convergence, nodes) == [
        "UpdateSuccess", [5, 5, 5]]


def _majority(P, nodes):
    P = ns(P)
    D = P.ddata
    systems, dd = _cluster(P, nodes)
    key, nid0 = D.Key("orset"), _node_id(P, systems[0])
    p0 = P.testkit.TestProbe(systems[0])
    dd[0].replicator.tell(D.Update(key, D.ORSet.empty(),
                                   D.WriteMajority(3.0),
                                   lambda s: s.add(nid0, "alpha")), p0.ref)
    p0.expect_msg_class(D.UpdateSuccess, 5.0)
    p1 = P.testkit.TestProbe(systems[1])
    dd[1].replicator.tell(D.Get(key, D.ReadMajority(3.0)), p1.ref)
    return sorted(p1.expect_msg_class(D.GetSuccess, 5.0).data.elements)


def test_replicator_write_majority_read_majority(nodes):
    assert side_by_side(_majority, nodes) == ["alpha"]


def _write_all(P, nodes):
    P = ns(P)
    D = P.ddata
    systems, dd = _cluster(P, nodes)
    key = D.Key("flag")
    p = P.testkit.TestProbe(systems[2])
    dd[2].replicator.tell(D.Update(key, D.Flag.empty(), D.WriteAll(5.0),
                                   lambda f: f.switch_on()), p.ref)
    p.expect_msg_class(D.UpdateSuccess, 6.0)
    return [_get(P, s, d, key).data.enabled for s, d in zip(systems, dd)]


def test_replicator_write_all_read_local(nodes):
    assert side_by_side(_write_all, nodes) == [True, True, True]


def _subscribe(P, nodes):
    P = ns(P)
    D = P.ddata
    systems, dd = _cluster(P, nodes)
    key = D.Key("subbed")
    sub = P.testkit.TestProbe(systems[1])
    dd[1].replicator.tell(D.Subscribe(key, sub.ref), None)
    nid0 = _node_id(P, systems[0])
    p = P.testkit.TestProbe(systems[0])
    dd[0].replicator.tell(D.Update(key, D.PNCounter.empty(), D.WriteLocal(),
                                   lambda c: c.increment(nid0, 9)), p.ref)
    p.expect_msg_class(D.UpdateSuccess, 3.0)
    changed = sub.expect_msg_class(D.Changed, WAIT)
    return [changed.key == key, changed.data.value]


def test_replicator_subscribe_changed(nodes):
    assert side_by_side(_subscribe, nodes) == [True, 9]


def _notfound_delete(P, nodes):
    P = ns(P)
    D = P.ddata
    systems, dd = _cluster(P, nodes)
    p = P.testkit.TestProbe(systems[0])
    dd[0].replicator.tell(D.Get(D.Key("missing"), D.ReadLocal()), p.ref)
    trace = [type(p.receive_one(2.0)).__name__]
    key, nid = D.Key("doomed"), _node_id(P, systems[0])
    dd[0].replicator.tell(D.Update(key, D.GCounter.empty(), D.WriteAll(5.0),
                                   lambda c: c.increment(nid, 1)), p.ref)
    p.expect_msg_class(D.UpdateSuccess, 6.0)
    dd[0].replicator.tell(D.Delete(key, D.WriteAll(5.0)), p.ref)
    p.expect_msg_class(D.DeleteSuccess, 6.0)
    trace.append([type(_get(P, s, d, key)).__name__
                  for s, d in zip(systems, dd)])
    dd[0].replicator.tell(D.Delete(key, D.WriteLocal()), p.ref)
    return trace + [type(p.receive_one(2.0)).__name__]


def test_replicator_get_notfound_and_delete(nodes):
    assert side_by_side(_notfound_delete, nodes) == [
        "NotFound", ["GetDataDeleted"] * 3, "DataDeleted"]


def _prunes(P, nodes):
    P = ns(P)
    D = P.ddata
    systems, dd = _cluster(P, nodes)
    key = D.Key("pruned-counter")
    for i in range(3):
        p = P.testkit.TestProbe(systems[i])
        nid = _node_id(P, systems[i])
        dd[i].replicator.tell(
            D.Update(key, D.GCounter.empty(), D.WriteAll(5.0),
                     lambda c, nid=nid: c.increment(nid, 1)), p.ref)
        p.expect_msg_class(D.UpdateSuccess, 6.0)
    gone = _node_id(P, systems[2])
    systems[2].terminate()
    assert systems[2].await_termination(WAIT)
    P.cluster.Cluster.get(systems[0]).down(gone)
    P.testkit.await_condition(
        lambda: all(gone not in [str(m.address) for m in
                                 P.cluster.Cluster.get(s).state.members]
                    for s in systems[:2]), max_time=WAIT)

    def pruned():
        got = [_get(P, systems[i], dd[i], key) for i in (0, 1)]
        return all(isinstance(m, D.GetSuccess) and m.data.value == 3
                   and gone not in m.data.modified_by_nodes() for m in got)
    P.testkit.await_condition(pruned, max_time=WAIT)
    return [_get(P, systems[i], dd[i], key).data.value for i in (0, 1)]


def test_replicator_prunes_removed_node_without_double_count(nodes):
    assert side_by_side(_prunes, nodes) == [3, 3]


def _delta_gap(P, nodes):
    P = ns(P)
    D = P.ddata
    systems, dd = _cluster(P, nodes)
    key, me = D.Key("gapset"), _node_id(P, systems[0])
    probe = P.testkit.TestProbe(systems[0])
    dd[0].replicator.tell(D.Update(key, D.ORSet.empty(), D.WriteLocal(),
                                   modify=lambda s: s.add(me, "a")),
                          probe.ref)
    probe.fish_for_message(lambda m: isinstance(m, D.UpdateSuccess), 5.0)
    s_b = D.ORSet.empty().add(me, "x").reset_delta().add(me, "b")
    dd[1].replicator.tell(
        P.replicator._DeltaPropagation(
            {key.id: (99, s_b.delta)},
            from_addr=str(systems[0].provider.local_address),
            origin_uid="forged-origin"), dd[0].replicator)

    def on_1():
        got = _get(P, systems[1], dd[1], key, 1.0)
        return got.data.elements if isinstance(got, D.GetSuccess) else None
    P.testkit.await_condition(lambda: on_1() == frozenset({"a"}),
                              max_time=WAIT)
    return sorted(on_1())


def test_delta_gap_falls_back_to_gossip_without_data_loss(nodes):
    assert side_by_side(_delta_gap, nodes) == ["a"]


def _remote_delete(P, nodes):
    P = ns(P)
    D, R = P.ddata, P.replicator
    systems, dd = _cluster(P, nodes)
    key, me = D.Key("churned"), _node_id(P, systems[0])
    p = P.testkit.TestProbe(systems[0])
    dd[0].replicator.tell(D.Update(key, D.ORSet.empty(), D.WriteAll(5.0),
                                   modify=lambda s: s.add(me, "a")), p.ref)
    p.expect_msg_class(D.UpdateSuccess, 6.0)
    dd[0].replicator.tell(D.Delete(key, D.WriteAll(5.0)), p.ref)
    p.expect_msg_class(D.DeleteSuccess, 6.0)

    def cursors(rep):
        return (any(pr[2] == key.id for pr in rep._delta_seen)
                or any(pr[2] == key.id for pr in rep._delta_gapped))

    def pruned():
        for i in (1, 2):
            rep = dd[i].replicator.cell.actor
            if rep.data.get(key.id) != R.DELETED or cursors(rep) \
                    or key.id in rep.deltas or key.id in rep.delta_seq:
                return False
        return True
    P.testkit.await_condition(pruned, max_time=WAIT)
    stale = D.ORSet.empty().add(me, "zombie")
    dd[1].replicator.tell(
        R._Gossip({key.id: stale}, want_keys=(),
                  from_addr=str(systems[0].provider.local_address),
                  tombstones={}, delta_seq={key.id: 7},
                  origin_uid="stale-uid"), dd[0].replicator)
    got = _get(P, systems[1], dd[1], key, 3.0)
    return [type(got).__name__, cursors(dd[1].replicator.cell.actor)]


def test_remote_delete_prunes_delta_cursors(nodes):
    assert side_by_side(_remote_delete, nodes) == ["GetDataDeleted", False]


def _ships_op_deltas(P, nodes):
    P = ns(P)
    D = P.ddata
    systems, dd = _cluster(P, nodes)
    key, me = D.Key("hotmap"), _node_id(P, systems[0])
    p = P.testkit.TestProbe(systems[0])
    dd[0].replicator.tell(
        D.Update(key, D.PNCounterMap.empty(), D.WriteLocal(),
                 modify=lambda m: m.increment(me, "ent-1", 5)), p.ref)
    p.expect_msg_class(D.UpdateSuccess, 5.0)
    acc = dd[0].replicator.cell.actor.deltas.get(key.id)
    op = acc is None or isinstance(acc, D.crdt.ORMapDeltaOp)

    def converged():
        got = [_get(P, systems[i], dd[i], key, 1.0) for i in (1, 2)]
        return all(isinstance(m, D.GetSuccess)
                   and isinstance(m.data, D.PNCounterMap)
                   and m.data.get("ent-1") == 5 for m in got)
    P.testkit.await_condition(converged, max_time=WAIT)
    return [op, converged()]


def test_replicator_ships_ormap_op_deltas(nodes):
    assert side_by_side(_ships_op_deltas, nodes) == [True, True]


def _histograms(P, nodes):
    P = ns(P)
    D = P.ddata
    systems, dd = _cluster(P, nodes, 2, "ddm", {"metrics": {"enabled": True}})
    me, key = _node_id(P, systems[0]), D.Key("sized")
    p = P.testkit.TestProbe(systems[0])

    def fill(m):
        for i in range(64):
            m = m.increment(me, f"k{i}", 1)
        return m
    dd[0].replicator.tell(D.Update(key, D.PNCounterMap.empty(),
                                   D.WriteLocal(), modify=fill), p.ref)
    p.expect_msg_class(D.UpdateSuccess, 5.0)
    time.sleep(0.3)  # the first delta tick flushes the bulk fill
    for _ in range(3):
        dd[0].replicator.tell(
            D.Update(key, D.PNCounterMap.empty(), D.WriteLocal(),
                     modify=lambda m: m.increment(me, "k1", 1)), p.ref)
        p.expect_msg_class(D.UpdateSuccess, 5.0)
        time.sleep(0.2)
    snap = systems[0].metrics_registry.snapshot()["histograms"]
    sizes, ratios = snap["ddata_gossip_payload_bytes"], \
        snap["ddata_delta_vs_full"]
    return [sizes["count"] >= 2 and sizes["p50"] > 0, ratios["count"] >= 1,
            ratios["p50"] <= 0.5]


def test_replicator_gossip_size_histograms(nodes):
    assert side_by_side(_histograms, nodes) == [True, True, True]


def test_increment_many_equals_the_increments_in_turn(monkeypatch):
    """Port-only: `PNCounterMap.increment_many` (one copy of the map for a
    batch, which the gateway's replica feed publishes with) gives the
    state and the delta of `increment`/`decrement` called in turn, each
    version vector numbered alike."""
    import itertools
    D = ddata("akka_tpu_torch")
    monkeypatch.setattr(D.version_vector, "_counter", itertools.count(1))
    base = D.PNCounterMap.empty()
    for i in range(40):
        base = base.increment(N1, f"e{i}", i + 1)
    base = base.reset_delta().increment(N2, "e0", 2)   # a pending delta
    changes = [(f"e{i % 40}", (-1) ** i * (i + 1)) for i in range(0, 90, 7)]
    changes += [("new", 5), ("e3", -4)]
    monkeypatch.setattr(D.version_vector, "_counter", itertools.count(100))
    one = base
    for k, n in changes:
        one = one.increment(N1, k, n) if n >= 0 else \
            one.decrement(N1, k, -n)
    monkeypatch.setattr(D.version_vector, "_counter", itertools.count(100))
    many = base.increment_many(N1, changes)
    assert many == one and many.delta == one.delta
    assert many.entries == one.entries and many.get("new") == 5
