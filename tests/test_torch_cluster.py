"""The port's cluster membership (akka_tpu_torch.cluster) live on the CPU,
held to the JAX package's: tests/test_cluster.py's 4 multi-node
scenarios (a three-node cluster forms with one agreed leader, member-up
callbacks and events, a graceful leave, a crash detected and downed by
the split-brain resolver), each written once over a package namespace
and run on both packages through `side_by_side`
(tests/torch_remote_fixture.py): three nodes of one package over its own
in-proc transport, with the reference's fast gossip settings
(akka_tpu_torch.testkit.cluster.FAST_MEMBERSHIP: gossip 0.05 s,
heartbeat 0.1 s, acceptable pause 2 s, keep-majority stable after 1 s).
The port's trace (member statuses by node, the leader, callbacks and
events, removals) must equal the reference's, and each test also asserts
the trace's values. Its unit tests (vector clocks, members, gossip,
reachability, the strategies) run side by side with the reference in
tests/test_torch_cluster_state.py.

Every system starts through the `nodes` fixture. Every wait is at most
10 s.
"""

import pytest

from akka_tpu_torch.testkit.cluster import FAST_MEMBERSHIP

from torch_remote_fixture import WAIT, Nodes, norm, side_by_side


@pytest.fixture()
def nodes():
    n = Nodes()
    try:
        yield n
    finally:
        n.close()


def _three(P, nodes):
    systems = [nodes.node(f"cl{i}", P=P, provider="cluster",
                          cluster=FAST_MEMBERSHIP) for i in range(3)]
    return systems, [P.cluster.Cluster.get(s) for s in systems]


def _up_count(P, cluster):
    return sum(1 for m in cluster.state.members
               if m.status is P.cluster.MemberStatus.UP)


def _members(cluster):
    """A node's view: (address without its port, status), sorted."""
    return sorted((norm(m.address_str), m.status.value)
                  for m in cluster.state.members)


def _form(P, systems, clusters):
    first = str(systems[0].provider.local_address)
    for c in clusters:
        c.join(first)
    P.testkit.await_condition(
        lambda: all(_up_count(P, c) == 3 for c in clusters),
        max_time=WAIT, message=f"states: {[c.state for c in clusters]}")


def _forms(P, nodes):
    systems, clusters = _three(P, nodes)
    _form(P, systems, clusters)
    leaders = {c.state.leader for c in clusters}
    lowest = min(m.unique_address for m in clusters[0].state.members)
    return [[_members(c) for c in clusters], len(leaders),
            leaders == {lowest}, norm(lowest.address_str)]


def test_three_node_cluster_forms(nodes):
    views, n_leaders, lowest_leads, leader = side_by_side(_forms, nodes)
    up = [(f"akka://cl{i}@local", "Up") for i in range(3)]
    assert views == [up] * 3
    assert (n_leaders, lowest_leads, leader) == (1, True, "akka://cl0@local")


def _member_up(P, nodes):
    systems, clusters = _three(P, nodes)
    first = str(systems[0].provider.local_address)
    ups, seen = [], []
    clusters[1].register_on_member_up(lambda: ups.append("up"))
    clusters[1].subscribe(seen.append, P.cluster.MemberUp,
                          initial_state=False)
    clusters[0].join(first)
    clusters[1].join(first)
    P.testkit.await_condition(lambda: ups == ["up"], max_time=WAIT)
    P.testkit.await_condition(lambda: len(seen) >= 2, max_time=WAIT)
    return [list(ups), sorted({type(e).__name__ for e in seen}),
            sorted({norm(e.member.address_str) for e in seen})]


def test_member_up_callback_and_events(nodes):
    assert side_by_side(_member_up, nodes) == [
        ["up"], ["MemberUp"], ["akka://cl0@local", "akka://cl1@local"]]


def _leave(P, nodes):
    systems, clusters = _three(P, nodes)
    _form(P, systems, clusters)
    clusters[2].leave()
    P.testkit.await_condition(
        lambda: _up_count(P, clusters[0]) == 2
        and len(clusters[0].state.members) == 2, max_time=WAIT)
    return [_members(clusters[0]), clusters[2].await_removed(WAIT)]


def test_graceful_leave(nodes):
    assert side_by_side(_leave, nodes) == [
        [("akka://cl0@local", "Up"), ("akka://cl1@local", "Up")], True]


def _crash(P, nodes):
    systems, clusters = _three(P, nodes)
    _form(P, systems, clusters)
    crashed = str(systems[2].provider.local_address)
    # hard-kill node 2: transport gone, no goodbye
    systems[2].provider.shutdown_transport()
    systems[2].terminate()
    # survivors: unreachable, keep-majority downs it after stable-after,
    # the leader removes it (while node 2's own leave waits out its
    # timeout: nobody is left to remove it)
    P.testkit.await_condition(
        lambda: all(len(c.state.members) == 2 for c in clusters[:2]),
        max_time=WAIT, message=f"states: {[c.state for c in clusters[:2]]}")
    assert systems[2].await_termination(WAIT)
    return [[_members(c) for c in clusters[:2]],
            [crashed in {m.address_str for m in c.state.members}
             for c in clusters[:2]]]


def test_crash_detected_and_downed_by_sbr(nodes):
    views, still_there = side_by_side(_crash, nodes)
    survivors = [("akka://cl0@local", "Up"), ("akka://cl1@local", "Up")]
    assert views == [survivors] * 2
    assert still_there == [False, False]
