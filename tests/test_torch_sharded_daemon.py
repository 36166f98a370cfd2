"""The port's ShardedDaemonProcess (akka_tpu_torch.sharding.daemon_process)
on the CPU, held to the JAX package's: tests/test_sharded_daemon.py's 3
cases, each written once over a package namespace and run on both
packages through `side_by_side` (tests/torch_remote_fixture.py), each
package's nodes on its own in-proc transport with the reference's fast
settings. The port's trace (worker starts, replies, the ids each region
hosts through the churn, in order) must equal the reference's, and each
test also asserts the trace's values.

Every system starts through the `nodes` fixture. Every wait is at most
10 s (the reference's 15-30 s waits are cut to 10 s; each step lands in
a few seconds at most).
"""

import importlib

import pytest

from torch_remote_fixture import SHARDING_CLUSTER, WAIT, Nodes, side_by_side


@pytest.fixture()
def nodes():
    n = Nodes()
    try:
        yield n
    finally:
        n.close()


def ns(P):
    P.sharding = importlib.import_module(f"{P.name}.sharding")
    P.typed = importlib.import_module(f"{P.name}.typed")
    P.sharding_kit = importlib.import_module(f"{P.name}.testkit.sharding")
    return P


def worker(P, system_name, starts):
    """Worker behavior factory: records each start's index, answers
    ("who", ref) with (system, index), crashes on "boom"."""
    B = P.typed.Behaviors

    def factory(index):
        def setup(ctx):
            starts.append(index)

            def on_message(_ctx, msg):
                if isinstance(msg, tuple) and msg[0] == "who":
                    msg[1].tell((system_name, index))
                elif msg == "boom":
                    raise RuntimeError(f"worker {index} crash")
                return B.same
            return B.receive(on_message)
        return B.setup(setup)
    return factory


def node(P, nodes, name, join=None):
    s = nodes.node(name, "inproc", P=P, provider="cluster",
                   cluster=SHARDING_CLUSTER)
    P.cluster.Cluster.get(s).join(join or str(s.provider.local_address))
    return s


def up(P, systems, n):
    P.testkit.await_condition(lambda: all(
        sum(m.status.value == "Up"
            for m in P.cluster.Cluster.get(s).state.members) == n
        for s in systems), max_time=WAIT)


def daemon(P, s, name, n, starts, interval):
    return P.sharding.ShardedDaemonProcess.get(s).init(
        name, n, worker(P, str(s.name), starts),
        settings=P.sharding.ShardedDaemonProcessSettings(
            keep_alive_interval=interval))


def _all_start(P, nodes):
    P = ns(P)
    s = node(P, nodes, "sdp0")
    up(P, [s], 1)
    starts = []
    daemon(P, s, "ingest", 5, starts, 0.3)
    P.testkit.await_condition(lambda: sorted(set(starts)) == [0, 1, 2, 3, 4],
                              max_time=WAIT)
    return sorted(set(starts))


def test_all_instances_start_without_messages(nodes):
    assert side_by_side(_all_start, nodes) == [0, 1, 2, 3, 4]


def _revive(P, nodes):
    P = ns(P)
    s = node(P, nodes, "sdp0")
    up(P, [s], 1)
    starts = []
    daemon(P, s, "revive", 3, starts, 0.2)
    P.testkit.await_condition(lambda: sorted(set(starts)) == [0, 1, 2],
                              max_time=WAIT)
    sharding = P.sharding.ClusterShardingTyped.get(s)
    key = P.sharding.EntityTypeKey("sharded-daemon-process-revive")
    sharding.entity_ref_for(key, "1").tell("boom")
    # the next keep-alive ping restarts index 1 (a second start entry)
    P.testkit.await_condition(lambda: starts.count(1) >= 2, max_time=WAIT)
    probe = P.testkit.TestProbe(s)
    got = []

    def alive_again():
        sharding.entity_ref_for(key, "1").tell(("who", probe.ref))
        try:
            got.append(probe.receive_one(1.0))
        except (AssertionError, P.testkit.AssertionFailure):
            return False
        return got[-1] == ("sdp0", 1)
    P.testkit.await_condition(alive_again, max_time=WAIT)
    return [starts.count(1) >= 2, got[-1]]


def test_crashed_instance_is_revived_by_keep_alive(nodes):
    assert side_by_side(_revive, nodes) == [True, ("sdp0", 1)]


def _rehome(P, nodes):
    """Singleton-per-index through churn: workers spread over two nodes,
    collapse onto the survivor when one terminates, and spread again
    when a fresh node joins."""
    P = ns(P)
    N = 4
    every = {str(i) for i in range(N)}
    trace = []

    def ids(region, probe):
        return P.sharding_kit.region_entity_ids(region, probe)

    def spread(a, b):
        def ok():
            ea, eb = ids(*a), ids(*b)
            return (ea is not None and eb is not None and ea | eb == every
                    and not ea & eb and bool(ea) and bool(eb))
        P.testkit.await_condition(ok, max_time=WAIT)

    s0 = node(P, nodes, "sdpA")
    first = str(s0.provider.local_address)
    up(P, [s0], 1)
    r0 = (daemon(P, s0, "churn", N, [], 0.2), P.testkit.TestProbe(s0))
    P.testkit.await_condition(lambda: ids(*r0) == every, max_time=WAIT)
    trace.append("started on one node")

    s1 = node(P, nodes, "sdpB", first)
    up(P, [s0, s1], 2)
    r1 = (daemon(P, s1, "churn", N, [], 0.2), P.testkit.TestProbe(s1))
    spread(r0, r1)
    trace.append("spread over two")

    # node B terminates: its workers rehome to A, each index still one
    s1.terminate()
    trace.append(s1.await_termination(WAIT))
    P.testkit.await_condition(lambda: ids(*r0) == every, max_time=WAIT)
    trace.append("rehomed to the survivor")

    s2 = node(P, nodes, "sdpC", first)
    up(P, [s0, s2], 2)
    r2 = (daemon(P, s2, "churn", N, [], 0.2), P.testkit.TestProbe(s2))
    spread(r0, r2)
    trace.append("spread to the new node")
    return trace


def test_workers_rehome_across_leave_and_join(nodes):
    assert side_by_side(_rehome, nodes) == [
        "started on one node", "spread over two", True,
        "rehomed to the survivor", "spread to the new node"]
