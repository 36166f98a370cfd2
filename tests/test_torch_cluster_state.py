"""The pure functions of the port's remoting and cluster membership held
to the JAX package's on the same inputs, on the CPU, with no thread and
no socket: vector clocks, member transitions, gossip merge, convergence
and leader, the reachability table, the split-brain strategies,
`stable_hash` and the heartbeat ring, `mangle`, and `WireEnvelope` bytes
both ways. The reference's unit tests of tests/test_cluster.py run on
both packages.

Inputs are built in the reference's types from a numpy seed and
converted field by field into the port's (`to_port`); results of both
sides are compared as plain values (`plain`), so every case is exact.
"""

from types import SimpleNamespace

import numpy as np
import pytest

from akka_tpu import cluster as jc
from akka_tpu.cluster import daemon as jdaemon
from akka_tpu.cluster import reachability as jreach
from akka_tpu.remote import deploy as jdeploy
from akka_tpu.remote import failure_detector as jfd
from akka_tpu.remote import transport as jtransport
from akka_tpu.utils import hashing as jhash

from akka_tpu_torch import cluster as tc
from akka_tpu_torch.actor.path import validate_path_element
from akka_tpu_torch.cluster import daemon as tdaemon
from akka_tpu_torch.cluster import reachability as treach
from akka_tpu_torch.remote import deploy as tdeploy
from akka_tpu_torch.remote import failure_detector as tfd
from akka_tpu_torch.remote import transport as ttransport
from akka_tpu_torch.utils import hashing as thash

STATUSES = [s.name for s in jc.MemberStatus]


# ------------------------------------------------------------ conversion
def to_port(x):
    """A reference cluster value as the port's, field by field."""
    if isinstance(x, jc.UniqueAddress):
        return tc.UniqueAddress(x.address_str, x.uid)
    if isinstance(x, jc.MemberStatus):
        return tc.MemberStatus[x.name]
    if isinstance(x, jc.Member):
        return tc.Member(to_port(x.unique_address), to_port(x.status),
                         frozenset(x.roles), x.up_number)
    if isinstance(x, jc.VectorClock):
        return tc.VectorClock(dict(x.versions))
    if isinstance(x, jreach.Record):
        return treach.Record(to_port(x.observer), to_port(x.subject),
                             treach.ReachabilityStatus[x.status.name],
                             x.version)
    if isinstance(x, jc.Reachability):
        return tc.Reachability([to_port(r) for r in x.records.values()])
    if isinstance(x, jc.Gossip):
        return tc.Gossip(
            members=tuple(to_port(m) for m in x.members),
            seen=frozenset(to_port(n) for n in x.seen),
            reachability=to_port(x.reachability),
            version=to_port(x.version),
            tombstones=frozenset(to_port(n) for n in x.tombstones))
    if isinstance(x, (list, tuple)):
        return type(x)(to_port(v) for v in x)
    if isinstance(x, (set, frozenset)):
        return type(x)(to_port(v) for v in x)
    return x


def plain(x):
    """A cluster value of either package as plain Python values."""
    name = type(x).__name__
    if name == "UniqueAddress":
        return ("ua", x.address_str, x.uid)
    if name == "MemberStatus":
        return x.name
    if name == "Member":
        return ("m", plain(x.unique_address), x.status.name,
                tuple(sorted(x.roles)), x.up_number)
    if name == "VectorClock":
        return ("vc", tuple(sorted(x.versions.items())))
    if name == "Ordering":
        return x.name
    if name == "Reachability":
        return ("r", tuple(sorted(
            (plain(r.observer), plain(r.subject), r.status.name, r.version)
            for r in x.records.values())))
    if name == "Gossip":
        return ("g", tuple(plain(m) for m in x.members),
                tuple(sorted(plain(n) for n in x.seen)),
                plain(x.reachability), plain(x.version),
                tuple(sorted(plain(n) for n in x.tombstones)))
    if name == "Decision":
        return ("d", tuple(sorted(plain(n) for n in x.down_nodes)), x.retry)
    if isinstance(x, (list, tuple)):
        return tuple(plain(v) for v in x)
    if isinstance(x, (set, frozenset)):
        return tuple(sorted(plain(v) for v in x))
    return x


def both(fn, *ref_args):
    """fn(package module, reachability module, *args) on the reference's
    inputs and on their port conversions; the plain results must be
    equal. Returns the reference's result."""
    want = fn(jc, jreach, *ref_args)
    got = fn(tc, treach, *to_port(list(ref_args)))
    assert plain(got) == plain(want), (plain(got), plain(want))
    return want


def nodes_of(k, seed=0):
    rng = np.random.default_rng(seed)
    uids = rng.integers(1, 1 << 40, k)
    return [jc.UniqueAddress(f"akka://s@h:{2550 + i}", int(u))
            for i, u in enumerate(uids)]


def random_gossip(rng, nodes, bumps=4):
    g = jc.Gossip()
    for i, n in enumerate(nodes):
        status = jc.MemberStatus[STATUSES[int(rng.integers(0, 6))]]
        roles = frozenset({"dc-default"} | (
            {"worker"} if rng.random() < 0.5 else set()))
        g = g.with_member(jc.Member(n, status, roles, up_number=i + 1))
    for _ in range(bumps):
        g = g.bump(nodes[int(rng.integers(len(nodes)))])
    for n in nodes:
        if rng.random() < 0.6:
            g = g.seen_by(n)
    r = g.reachability
    for _ in range(int(rng.integers(0, 4))):
        o, s = rng.choice(len(nodes), 2, replace=False)
        op = ("unreachable", "reachable", "terminated")[int(rng.integers(3))]
        r = getattr(r, op)(nodes[o], nodes[s])
    from dataclasses import replace
    return replace(g, reachability=r)


# ------------------------------------- tests/test_cluster.py's unit tests
@pytest.mark.parametrize("fd", [jfd, tfd], ids=["ref", "port"])
def test_phi_never_overflows_with_wide_pause_window(fd):
    for pause in (3.0, 6.6, 10.0, 60.0):
        t = [0.0]
        det = fd.PhiAccrualFailureDetector(
            acceptable_heartbeat_pause=pause, min_std_deviation=0.1,
            clock=lambda: t[0])
        for _ in range(5):
            det.heartbeat()
            t[0] += 0.1
        assert det.phi(t[0]) <= 0.1
        assert det.is_available_at(t[0])
        assert det.phi(t[0] + pause + 30.0) > 16.0
        assert not det.is_available_at(t[0] + pause + 30.0)


def test_vector_clock_ordering():
    def scenario(C, R):
        a = C.VectorClock().bump("n1")
        b = a.bump("n2")
        c1, c2 = a.bump("n1"), a.bump("n2")
        merged = c1.merge(c2)
        return (a.compare(b), b.compare(a), a.compare(a.merge(a)),
                c1.compare(c2), c1.compare(merged), c2.compare(merged))

    out = both(scenario)
    assert plain(out) == ("BEFORE", "AFTER", "SAME", "CONCURRENT",
                          "BEFORE", "BEFORE")


def test_vector_clock_random_compare_merge_prune():
    rng = np.random.default_rng(1)
    names = [f"n{i}" for i in range(5)]
    clocks = []
    for _ in range(12):
        vc = jc.VectorClock()
        for _ in range(int(rng.integers(0, 6))):
            vc = vc.bump(names[int(rng.integers(5))])
        clocks.append(vc)

    def scenario(C, R, clocks):
        out = []
        for x in clocks:
            for y in clocks:
                out.append((x.compare(y), x.merge(y), x == y))
            out.append(x.prune("n0"))
        return out

    both(scenario, clocks)


def test_member_transitions():
    """The whole transition table: which copy_with raise, on both."""
    n = nodes_of(1)[0]

    def scenario(C, R, n):
        out = []
        for a in C.MemberStatus:
            for b in C.MemberStatus:
                try:
                    C.Member(n, a).copy_with(b, up_number=3)
                    out.append((a, b, True))
                except ValueError:
                    out.append((a, b, False))
        m = C.Member(n, C.MemberStatus.JOINING)
        for s in ("UP", "LEAVING", "EXITING", "REMOVED"):
            m = m.copy_with(C.MemberStatus[s], up_number=1)
        out.append(m)
        return out

    out = both(scenario, n)
    assert (jc.MemberStatus.UP, jc.MemberStatus.JOINING, False) in out


def test_member_ordering_and_age():
    nodes = nodes_of(6, seed=2)
    rng = np.random.default_rng(2)
    members = [jc.Member(n, jc.MemberStatus.UP, up_number=int(u))
               for n, u in zip(nodes, rng.integers(1, 4, len(nodes)))]

    def scenario(C, R, members):
        return (sorted(members),
                [[a.is_older_than(b) for b in members] for a in members],
                [m.data_center for m in members])

    both(scenario, members)


def test_gossip_merge_prefers_later_status():
    n1, n2 = nodes_of(2)

    def scenario(C, R, n1, n2):
        g1 = (C.Gossip().with_member(C.Member(n1, C.MemberStatus.UP,
                                              up_number=1))
              .with_member(C.Member(n2, C.MemberStatus.JOINING)).bump(n1))
        g2 = g1.with_member(C.Member(n2, C.MemberStatus.UP,
                                     up_number=2)).bump(n2)
        merged = g1.merge(g2)
        return merged, merged.member(n2).status

    assert both(scenario, n1, n2)[1] is jc.MemberStatus.UP


@pytest.mark.parametrize("seed", range(4))
def test_gossip_random_merge_convergence_leader(seed):
    rng = np.random.default_rng(10 + seed)
    nodes = nodes_of(5, seed=seed)
    g1, g2 = random_gossip(rng, nodes), random_gossip(rng, nodes)
    gone = jc.Member(nodes[4], jc.MemberStatus.DOWN)

    def scenario(C, R, g1, g2, nodes, gone):
        merged = g1.merge(g2)
        pruned = merged.without_member(gone)
        return (merged, g1.compare(g2), pruned,
                pruned.with_member(gone),   # a tombstone is not revived
                [merged.convergence(n) for n in nodes],
                [merged.convergence(n, dc="default") for n in nodes],
                merged.youngest_up_number,
                g1.only_seen_by(nodes[0]))

    merged = both(scenario, g1, g2, nodes, gone)[0]
    for g in (g1, g2, merged):
        for n in nodes:
            for dc in (None, "default"):
                want = g.leader(n, dc=dc)
                if want is None:   # the port's repair: an Exiting leader
                    want = _exiting_leader(g, n)
                got = to_port(g).leader(to_port(n), dc=dc)
                assert plain(got) == plain(want)


def _exiting_leader(g, self_node):
    """The port's leader where the reference has none: the lowest
    reachable Exiting member (Akka's MembershipState.leaderOf)."""
    pool = [m for m in g.members if m.status is jc.MemberStatus.EXITING
            and (m.unique_address == self_node
                 or g.reachability.is_reachable(m.unique_address))]
    return min(pool).unique_address if pool else None


def test_leader_of_members_all_exiting():
    """Every member left at once: the reference has no leader, so nobody
    removes them; the port's lowest reachable Exiting member leads (a
    deliberate difference, ROADMAP C)."""
    nodes = nodes_of(3, seed=7)
    g = jc.Gossip()
    for i, n in enumerate(nodes):
        g = g.with_member(jc.Member(n, jc.MemberStatus.EXITING,
                                    up_number=i + 1))
    g = g.bump(nodes[0])
    assert all(g.leader(n) is None for n in nodes)
    tg = to_port(g)
    lowest = to_port(min(nodes))
    assert all(tg.leader(to_port(n)) == lowest for n in nodes)
    r = tg.reachability.unreachable(to_port(nodes[1]), lowest)
    from dataclasses import replace
    tg = replace(tg, reachability=r)
    assert tg.leader(lowest) == lowest          # self always counts
    assert tg.leader(to_port(nodes[1])) == min(to_port(nodes[1:]))


def test_reachability_table():
    n1, n2, n3 = nodes_of(3)

    def scenario(C, R, n1, n2, n3):
        r = C.Reachability().unreachable(n1, n2)
        a = (r.is_reachable(n2), r.is_reachable_by(n1, n2))
        r = r.reachable(n1, n2).terminated(n3, n1)
        b = (r.is_reachable(n2), r.all_unreachable, r.is_all_reachable,
             r.all_unreachable_from(n3))
        return a, b, r, r.remove([n3]), r.merge(C.Reachability()
                                                .unreachable(n2, n3))

    a, b, *_ = both(scenario, n1, n2, n3)
    assert a == (False, False) and b[0] is True


@pytest.mark.parametrize("seed", range(3))
def test_reachability_random_ops(seed):
    rng = np.random.default_rng(20 + seed)
    nodes = nodes_of(4, seed=seed)
    ops = [(("unreachable", "reachable", "terminated")[int(rng.integers(3))],
            *rng.choice(4, 2, replace=False).tolist()) for _ in range(12)]

    def scenario(C, R, nodes, ops):
        r, trace = C.Reachability(), []
        for op, o, s in ops:
            r = getattr(r, op)(nodes[o], nodes[s])
            trace.append((r, r.all_unreachable,
                          [r.is_reachable(n) for n in nodes]))
        return trace

    both(scenario, nodes, ops)


# ----------------------------------------------------- split-brain resolver
def _members(k):
    return [jc.Member(jc.UniqueAddress(f"akka://s@h:{i}", i),
                      jc.MemberStatus.UP, up_number=i)
            for i in range(1, k + 1)]


def test_keep_majority_majority_side_survives():
    ms = _members(5)
    unreachable = {ms[3].unique_address, ms[4].unique_address}

    def scenario(C, R, ms, unreachable):
        return C.KeepMajority().decide(ms, unreachable, ms[0].unique_address)

    assert set(both(scenario, ms, unreachable).down_nodes) == unreachable


def test_keep_majority_minority_side_downs_itself():
    ms = _members(5)
    unreachable = {m.unique_address for m in ms[:3]}

    def scenario(C, R, ms, unreachable):
        return C.KeepMajority().decide(ms, unreachable, ms[3].unique_address)

    assert set(both(scenario, ms, unreachable).down_nodes) == {
        ms[3].unique_address, ms[4].unique_address}


def test_static_quorum():
    ms = _members(5)

    def scenario(C, R, ms):
        return (C.StaticQuorum(3).decide(ms, {ms[4].unique_address},
                                         ms[0].unique_address),
                C.StaticQuorum(3).decide(
                    ms, {m.unique_address for m in ms[:3]},
                    ms[3].unique_address))

    first, second = both(scenario, ms)
    assert set(first.down_nodes) == {ms[4].unique_address}
    assert set(second.down_nodes) == {ms[3].unique_address,
                                      ms[4].unique_address}


@pytest.mark.parametrize("seed", range(4))
def test_downing_strategies_random_partitions(seed):
    """KeepMajority, StaticQuorum, KeepOldest and DownAll decide the same
    on random member sets and partitions, seen from every node."""
    rng = np.random.default_rng(30 + seed)
    k = int(rng.integers(2, 8))
    ms = [jc.Member(n, jc.MemberStatus.UP, up_number=int(u))
          for n, u in zip(nodes_of(k, seed=seed),
                          rng.permutation(k) + 1)]
    parts = [{m.unique_address for m in ms if rng.random() < p}
             for p in (0.2, 0.5, 0.8)]
    parts.append({ms[0].unique_address})

    def scenario(C, R, ms, parts):
        out = []
        for unreachable in parts:
            for me in ms:
                for s in (C.KeepMajority(), C.StaticQuorum(k // 2 + 1),
                          C.KeepOldest(True), C.KeepOldest(False),
                          C.DownAll()):
                    out.append(s.decide(ms, set(unreachable),
                                        me.unique_address))
        return out

    both(scenario, ms, parts)


def test_strategy_from_config():
    from akka_tpu.config import Config as JConfig

    from akka_tpu_torch.config import Config as TConfig
    for strat, extra in (("keep-majority", {}), ("down-all", {}),
                         ("static-quorum", {"static-quorum":
                                            {"quorum-size": 3}}),
                         ("keep-oldest", {"keep-oldest":
                                          {"down-if-alone": False}})):
        d = {"active-strategy": strat, **extra}
        j = jc.sbr.strategy_from_config(JConfig(d))
        t = tc.sbr.strategy_from_config(TConfig(d))
        assert type(t).__name__ == type(j).__name__
        assert vars(t) == vars(j)
    # lease-majority: the reference's factory over LeaseProvider, built
    # lazily (the lease is made when the resolver first decides), and
    # refused without a system in both packages
    d = {"active-strategy": "lease-majority",
         "lease-majority": {"acquire-lease-delay-for-minority": "1.5s"}}
    node = SimpleNamespace(name="sbr-node")
    j = jc.sbr.strategy_from_config(JConfig(d), node, "owner-a")
    t = tc.sbr.strategy_from_config(TConfig(d), node, "owner-a")
    assert type(t).__name__ == type(j).__name__ == "LeaseMajority"

    def state(s):
        return {k: v for k, v in vars(s).items() if k != "_lease_factory"}
    assert state(t) == state(j) and state(t)["_lease"] is None
    assert callable(t._lease_factory)
    for pkg, C in (("ref", JConfig), ("port", TConfig)):
        sbr = jc.sbr if pkg == "ref" else tc.sbr
        with pytest.raises(ValueError, match="needs the actor system"):
            sbr.strategy_from_config(C(d))


# ------------------------------------------------ hashing and the ring
def test_stable_hash_values():
    keys = ["", "a", "akka://s@h:1", ("akka://s@h:1", 7), 42, -1, 3.5,
            (1, "x", (2, 3)), frozenset(), None, b"raw"]
    rng = np.random.default_rng(4)
    keys += [("akka://sys@10.0.0.%d:2552" % i, int(u))
             for i, u in enumerate(rng.integers(0, 1 << 62, 16))]
    assert [thash.stable_hash(k) for k in keys] == \
        [jhash.stable_hash(k) for k in keys]
    strs = [str(k) for k in keys]
    assert [thash.stable_hash_str(s) for s in strs] == \
        [jhash.stable_hash_str(s) for s in strs]
    assert all(0 <= thash.stable_hash(k) < 1 << 64 for k in keys)


class _Cluster:
    def __init__(self, k):
        self.settings = {"monitored_by_nr_of_members": k}


def _ring(daemon_mod, gossip, self_node, k):
    """The daemon's heartbeat targets, without an actor context."""
    d = object.__new__(daemon_mod.ClusterCoreDaemon)
    d.gossip, d.self_node, d.dc = gossip, self_node, "default"
    d.cluster = _Cluster(k)
    d._cross_dc = {"monitoring_members": 2, "interval_factor": 3}
    return d._neighbors(), d._cross_dc_targets()


@pytest.mark.parametrize("k", [1, 2, 5])
def test_heartbeat_ring(k):
    """Every node's monitored neighbours (the stable_hash ring,
    ClusterCoreDaemon._neighbors) are the reference's."""
    nodes = nodes_of(7, seed=k)
    g = jc.Gossip()
    for i, n in enumerate(nodes):
        st = jc.MemberStatus.UP if i != 3 else jc.MemberStatus.DOWN
        g = g.with_member(jc.Member(n, st, frozenset({"dc-default"}),
                                    up_number=i + 1))
    tg = to_port(g)
    for n in nodes:
        want = _ring(jdaemon, g, n, k)
        got = _ring(tdaemon, tg, to_port(n), k)
        assert plain(got) == plain(want)


# ------------------------------------------------------ deploy and the wire
def test_mangle_roundtrip_is_valid_path_element():
    paths = ["akka://sysA@local:1/user/worker#12345",
             "akka://a@127.0.0.1:2552/user/p/rc", "akka://x/user/é/ü"]
    for p in paths:
        assert tdeploy.mangle(p) == jdeploy.mangle(p)
        validate_path_element(tdeploy.mangle(p))
    from akka_tpu.actor.path import Address as JAddress

    from akka_tpu_torch.actor.path import Address as TAddress
    got = tdeploy.deployed_path_for(TAddress.parse("akka://b@h:1"), paths[0])
    want = jdeploy.deployed_path_for(JAddress.parse("akka://b@h:1"),
                                     paths[0])
    assert got.to_serialization_format() == want.to_serialization_format()


def _envelopes(seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(24):
        md = None
        if i % 3 == 1:
            md = {int(k): rng.bytes(int(rng.integers(0, 9)))
                  for k in rng.choice(np.arange(1, 32), 3, replace=False)}
        out.append(dict(
            recipient=f"akka://s@h:{i}/user/a{i}/é",
            sender=None if i % 2 else f"akka://t@h:9/temp/${i}",
            serializer_id=int(rng.integers(-1, 100)),
            manifest="m" * (i % 4), payload=rng.bytes(int(rng.integers(0, 64))),
            is_system=bool(i % 5 == 0),
            seq=None if i % 4 else int(rng.integers(1, 1 << 40)),
            ack=None if i % 3 else int(rng.integers(0, 1 << 40)),
            from_address=f"akka://s@h:{i}", from_uid=int(rng.integers(
                -(1 << 62), 1 << 62)),
            lane=("ordinary", "control", "large")[i % 3], metadata=md))
    return out


def test_wire_envelope_bytes_both_ways():
    """to_bytes is byte-identical between the packages for the same
    fields, and each package's from_bytes reads the other's bytes."""
    for fields in _envelopes(5):
        j = jtransport.WireEnvelope(**fields)
        t = ttransport.WireEnvelope(**fields)
        jb, tb = j.to_bytes(), t.to_bytes()
        assert tb == jb
        assert vars(ttransport.WireEnvelope.from_bytes(jb)) == vars(t)
        assert vars(jtransport.WireEnvelope.from_bytes(tb)) == vars(j)


def test_wire_envelope_rejects_bad_frames():
    env = ttransport.WireEnvelope(recipient="r", sender=None,
                                  serializer_id=2, manifest="",
                                  payload=b"payload")
    data = env.to_bytes()
    for bad in (b"\x00\x00" + data[2:], data[:2] + b"\x09" + data[3:],
                data[:-2]):
        for mod in (jtransport, ttransport):
            with pytest.raises(ValueError):
                mod.WireEnvelope.from_bytes(bad)
