"""Leases in the port (akka_tpu_torch.cluster_tools.lease) and what stands
on them: the file lease, the split-brain resolver's lease-majority, the
join-time config check, the lease-guarded singleton and the device
region's rebalance. On the CPU, held to the JAX package's:
tests/test_lease_integration.py's 10 cases, each written once over a
package namespace and run on both packages through `side_by_side`
(tests/torch_remote_fixture.py), each package's nodes on its own in-proc
transport, each package's leases in its own process-global table. The
port's trace (acquire outcomes, members, refusals, singleton starts,
rebalance outcomes) must equal the reference's, and each test also
asserts the trace's values.

The reference's timing windows are dilated by its machine load
(`akka_tpu.testkit.dilation`; the port's copy is
`akka_tpu_torch.testkit.dilation`); here both packages run the
reference's undilated values. Every
heartbeat a scenario starts is stopped before it returns, every system
and thread starts through the `nodes` fixture, and every wait is at most
10 s.
"""

import copy
import importlib
import time

import numpy as np
import pytest

from torch_remote_fixture import WAIT, Nodes, config, package, side_by_side

LEASE_CLUSTER = {"gossip-interval": "0.05s",
                 "leader-actions-interval": "0.05s",
                 "unreachable-nodes-reaper-interval": "0.1s",
                 "failure-detector": {"heartbeat-interval": "0.1s",
                                      "acceptable-heartbeat-pause": "2s"},
                 "split-brain-resolver": {
                     "active-strategy": "lease-majority",
                     "stable-after": "1s",
                     "lease-majority": {
                         "lease-name": "sbr-test-lease",
                         "lease-implementation": "in-proc",
                         "heartbeat-timeout": "2s",
                         "acquire-lease-delay-for-minority": 2.0}}}


@pytest.fixture()
def nodes():
    n = Nodes()
    try:
        yield n
    finally:
        n.close()


def ns(P):
    """The remote fixture's namespace of package P with its lease module,
    its in-proc lease table emptied."""
    P.lease = importlib.import_module(f"{P.name}.cluster_tools.lease")
    P.singleton = importlib.import_module(
        f"{P.name}.cluster_tools.singleton")
    P.lease.InProcLease.reset_all()
    return P


def lease_config(strategy: str = "lease-majority") -> dict:
    cluster = copy.deepcopy(LEASE_CLUSTER)
    cluster["split-brain-resolver"]["active-strategy"] = strategy
    return config("inproc", provider="cluster", cluster=cluster)


def system(P, nodes, name, cfg):
    if P.name == "akka_tpu_torch":
        return nodes.port_system(name, cfg)
    s = P.ActorSystem.create(name, cfg)
    nodes.ref_nodes.append(s)
    nodes.ref_clusters.append((s, P.cluster.Cluster.get(s)))
    return s


def up_count(P, cluster) -> int:
    return sum(1 for m in cluster.state.members
               if m.status is P.cluster.MemberStatus.UP)


def settings(P, hb: float, ttl: float):
    return P.lease.TimeoutSettings(heartbeat_interval=hb,
                                   heartbeat_timeout=ttl)


# --------------------------------------------------------------- FileLease
def _contention(P, nodes, root):
    P = ns(P)
    L = P.lease
    L.FileLease.directory = f"{root}/{P.name}"
    t = settings(P, 10.0, 0.5)
    a = L.FileLease(L.LeaseSettings("l1", "owner-a", t))
    b = L.FileLease(L.LeaseSettings("l1", "owner-b", t))
    trace = [a.acquire(), b.acquire(), a.check_lease(), b.check_lease()]
    a._stop_heartbeat()      # the owner dies
    time.sleep(0.7)          # its TTL expires
    return trace + [b.acquire(), a.check_lease(), b.release()]


def test_file_lease_contention_and_takeover(nodes, tmp_path, monkeypatch):
    for name in ("akka_tpu", "akka_tpu_torch"):
        monkeypatch.setattr(importlib.import_module(
            f"{name}.cluster_tools.lease").FileLease, "directory",
            str(tmp_path))
    assert side_by_side(_contention, nodes, str(tmp_path)) == [
        True, False, True, False, True, False, True]


def _single_winner(P, nodes, root):
    P = ns(P)
    L = P.lease
    L.FileLease.directory = f"{root}/{P.name}"
    dead = L.FileLease(L.LeaseSettings("race", "corpse", settings(P, 30.0,
                                                                   0.2)))
    assert dead.acquire()
    dead._stop_heartbeat()
    time.sleep(0.3)          # expired
    import threading
    winners, leases = [], []
    barrier = threading.Barrier(8)

    def contend(i):
        lease = L.FileLease(L.LeaseSettings("race", f"owner-{i}",
                                            settings(P, 30.0, 5.0)))
        leases.append(lease)
        barrier.wait()
        if lease.acquire():
            winners.append(i)

    threads = [nodes.thread(lambda i=i: contend(i)) for i in range(8)]
    for th in threads:
        th.join(WAIT)
    for lease in leases:
        lease._stop_heartbeat()
    return len(winners)


def test_file_lease_expired_takeover_single_winner(nodes, tmp_path,
                                                   monkeypatch):
    """Eight threads race to take over an expired lease: the flock makes
    the read-check-write atomic, so exactly one wins."""
    for name in ("akka_tpu", "akka_tpu_torch"):
        monkeypatch.setattr(importlib.import_module(
            f"{name}.cluster_tools.lease").FileLease, "directory",
            str(tmp_path))
    assert side_by_side(_single_winner, nodes, str(tmp_path)) == 1


def _reacquire(P, nodes, root):
    P = ns(P)
    L = P.lease
    L.FileLease.directory = f"{root}/{P.name}"
    a = L.FileLease(L.LeaseSettings("l2", "me", settings(P, 10.0, 5.0)))
    trace = [a.acquire(), a.acquire()]
    return trace + [a.release()]


def test_file_lease_reacquire_own(nodes, tmp_path, monkeypatch):
    for name in ("akka_tpu", "akka_tpu_torch"):
        monkeypatch.setattr(importlib.import_module(
            f"{name}.cluster_tools.lease").FileLease, "directory",
            str(tmp_path))
    assert side_by_side(_reacquire, nodes, str(tmp_path)) == [
        True, True, True]


# --------------------------------------------------------- lease-majority
def _partition(P, nodes, then_release: bool):
    """Three nodes; node 2 is cut off from 0 and 1 in both directions.
    Whichever side takes the SBR lease survives; the other downs
    itself. With `then_release`, an outside owner takes the lease once
    the winner has released it after the resolution."""
    P = ns(P)
    L = P.lease
    systems = [system(P, nodes, f"lc{i}", lease_config()) for i in range(3)]
    clusters = [P.cluster.Cluster.get(s) for s in systems]
    first = str(systems[0].provider.local_address)
    for c in clusters:
        c.join(first)
    P.testkit.await_condition(lambda: all(up_count(P, c) == 3
                                          for c in clusters),
                              max_time=WAIT, message="cluster did not form")
    addrs = [f"local:{s.provider.local_address.port}" for s in systems]
    fi = P.transport.InProcTransport.fault_injector
    for i in (0, 1):
        fi.blackhole(addrs[i], addrs[2])
        fi.blackhole(addrs[2], addrs[i])
    P.testkit.await_condition(
        lambda: all(len(c.state.members) == 2 for c in clusters[:2]),
        max_time=WAIT, message="majority never pruned")
    trace = [[len(c.state.members) for c in clusters[:2]],
             clusters[2].await_removed(WAIT)]
    if then_release:
        probe = L.InProcLease(L.LeaseSettings("sbr-test-lease", "probe",
                                              settings(P, 10.0, 2.0)))
        P.testkit.await_condition(probe.acquire, max_time=WAIT,
                                  message="SBR lease never released")
        trace.append(probe.release())
    # the SBR leases' heartbeats end at their next beat
    L.InProcLease.reset_all()
    return trace


# The reference keeps these two in its slow tier (9-11 s a package, the
# failure detector's pause and the resolver's windows); so do their twins
# (ROADMAP's test rules: heavier cases go to the slow tier).
@pytest.mark.slow
def test_lease_majority_sbr_resolves_partition(nodes):
    assert side_by_side(_partition, nodes, False) == [[2, 2], True]


@pytest.mark.slow
def test_sbr_releases_lease_after_resolution(nodes):
    """The winning side releases the SBR lease once the resolution has
    settled, or the next partition's majority could not take it."""
    assert side_by_side(_partition, nodes, True) == [[2, 2], True, True]


# ----------------------------------------------------- join config check
def _incompatible(P, nodes):
    P = ns(P)
    a = system(P, nodes, "cfgA", lease_config("keep-majority"))
    b = system(P, nodes, "cfgB", lease_config("down-all"))
    warnings = []
    log = importlib.import_module(f"{P.name}.event.logging")
    b.event_stream.subscribe(lambda e: warnings.append(e.message),
                             log.Warning)
    seed = str(a.provider.local_address)
    ca, cb = P.cluster.Cluster.get(a), P.cluster.Cluster.get(b)
    ca.join(seed)
    P.testkit.await_condition(lambda: up_count(P, ca) == 1, max_time=WAIT)
    cb.join(seed)
    P.testkit.await_condition(lambda: cb.join_refused_reason is not None,
                              max_time=WAIT, message="join never refused")
    return ["incompatible" in cb.join_refused_reason,
            any("refused" in w for w in warnings), up_count(P, ca)]


def test_incompatible_config_refused_on_join(nodes):
    assert side_by_side(_incompatible, nodes) == [True, True, 1]


def _compatible(P, nodes):
    P = ns(P)
    a = system(P, nodes, "cfgC", lease_config())
    b = system(P, nodes, "cfgD", lease_config())
    seed = str(a.provider.local_address)
    ca, cb = P.cluster.Cluster.get(a), P.cluster.Cluster.get(b)
    ca.join(seed)
    cb.join(seed)
    P.testkit.await_condition(
        lambda: up_count(P, ca) == 2 and up_count(P, cb) == 2,
        max_time=WAIT, message="same-config nodes failed to join")
    return [up_count(P, ca), up_count(P, cb)]


def test_compatible_config_still_joins(nodes):
    assert side_by_side(_compatible, nodes) == [2, 2]


# --------------------------------------------------- singleton lease guard
def _singleton_waits(P, nodes):
    P = ns(P)
    L, S = P.lease, P.singleton
    started = []

    class TheOne(P.Actor):
        def pre_start(self):
            started.append(1)

        def receive(self, message):
            pass

    blocker = L.InProcLease(L.LeaseSettings(
        "single-singleton-one", "blocker", settings(P, 0.1, 1.0)))
    trace = [blocker.acquire()]
    s = system(P, nodes, "single", lease_config())
    c = P.cluster.Cluster.get(s)
    c.join(str(s.provider.local_address))
    P.testkit.await_condition(lambda: up_count(P, c) == 1, max_time=WAIT)
    s.actor_of(P.Props.create(
        S.ClusterSingletonManager, P.Props.create(TheOne),
        S.ClusterSingletonSettings(singleton_name="one", use_lease=True,
                                   lease_name="single-singleton-one")),
        "one-manager")
    time.sleep(1.0)
    trace.append(list(started))      # held elsewhere: not started
    blocker.release()
    P.testkit.await_condition(lambda: len(started) == 1, max_time=WAIT,
                              message="singleton never started")
    return trace + [list(started)]


def test_singleton_waits_for_lease(nodes):
    assert side_by_side(_singleton_waits, nodes) == [True, [], [1]]


def _steps_down(P, nodes):
    P = ns(P)
    L, S = P.lease, P.singleton
    alive = []

    class TheOne(P.Actor):
        def pre_start(self):
            alive.append(self)

        def post_stop(self):
            alive.remove(self)

        def receive(self, message):
            pass

    s = system(P, nodes, "stepdown", lease_config())
    c = P.cluster.Cluster.get(s)
    c.join(str(s.provider.local_address))
    P.testkit.await_condition(lambda: up_count(P, c) == 1, max_time=WAIT)
    s.actor_of(P.Props.create(
        S.ClusterSingletonManager, P.Props.create(TheOne),
        S.ClusterSingletonSettings(singleton_name="sd", use_lease=True,
                                   lease_name="stepdown-lease")),
        "sd-manager")
    P.testkit.await_condition(lambda: len(alive) == 1, max_time=WAIT,
                              message="singleton never started")
    trace = [len(alive)]
    # a stalled holder: its record expires and a rival takes the lease
    with L.InProcLease._lock:
        L.InProcLease._table["stepdown-lease"].deadline = 0.0
    rival = L.InProcLease(L.LeaseSettings("stepdown-lease", "rival",
                                          settings(P, 0.2, 30.0)))
    trace.append(rival.acquire())
    P.testkit.await_condition(lambda: len(alive) == 0, max_time=WAIT,
                              message="singleton kept running")
    trace.append(len(alive))
    rival.release()
    P.testkit.await_condition(lambda: len(alive) == 1, max_time=WAIT,
                              message="singleton never came back")
    return trace + [len(alive)]


def test_singleton_steps_down_on_lease_loss(nodes):
    assert side_by_side(_steps_down, nodes) == [1, True, 0, 1]


# ------------------------------------------------- device shard rebalance
def _entity(P):
    """The reference's `lease-ent` behavior in package P."""
    if P.name == "akka_tpu_torch":
        import torch

        from akka_tpu_torch.batched import Emit, behavior

        @behavior("lease-ent", {"n": ((), torch.int32)})
        def ent(state, inbox, ctx):
            return {"n": state["n"] + inbox.count}, Emit.none(1, 4)
        return ent
    import jax.numpy as jnp

    from akka_tpu.batched import Emit, behavior

    @behavior("lease-ent", {"n": ((), jnp.int32)})
    def ent(state, inbox, ctx):
        return {"n": state["n"] + inbox.count}, Emit.none(1, 4)
    return ent


def _rebalance(P, nodes):
    P = ns(P)
    L = P.lease
    dev = importlib.import_module(f"{P.name}.sharding.device")
    t = settings(P, 0.1, 1.0)
    coordinator = L.InProcLease(L.LeaseSettings("shard-coord", "region", t))
    kw = {"device": "cpu"} if P.name == "akka_tpu_torch" else {}
    region = dev.DeviceShardRegion(dev.DeviceEntity(
        "lease-ent", _entity(P), n_shards=4, entities_per_shard=4,
        n_devices=2, lease=coordinator), **kw)
    other = L.InProcLease(L.LeaseSettings("shard-coord", "other", t))
    L.InProcLease.reset_all()
    trace = [other.acquire()]
    try:
        region.rebalance(0)
        trace.append("rebalanced")
    except RuntimeError as e:
        trace.append(("refused", "lease" in str(e)))
    other.release()
    region.rebalance(0)      # the lease is free: the region takes it
    trace.append(coordinator.check_lease())
    coordinator.release()
    L.InProcLease.reset_all()
    return trace + [int(np.asarray(region.system.n_shards))]


def test_device_rebalance_requires_lease(nodes):
    assert side_by_side(_rebalance, nodes) == [
        True, ("refused", True), True, 2]
