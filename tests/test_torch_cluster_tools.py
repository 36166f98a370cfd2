"""The port's cluster tools (akka_tpu_torch.cluster_tools: singleton,
distributed pub-sub, lease, discovery, metrics, the cluster client) on
the CPU, held to the JAX package's: tests/test_cluster_tools.py's 12
cases and tests/test_parity_breadth.py::test_cluster_client_roundtrip,
each written once over a package namespace and run on both packages
through `side_by_side` (tests/torch_remote_fixture.py), each package's
nodes on its own in-proc transport with the reference's fast settings.
The port's trace (replies, hosts, acks, lease outcomes, lookups,
weights) must equal the reference's, and each test also asserts the
trace's values.

Port-only cases: the device probe of the metrics collector reads the
card through torch.cuda and refuses to run without one (the reference's
probe reads jax and swallows every error), and every lease heartbeat
thread is joined.

No DNS query leaves the process: the DNS cases resolve through a stub
of `socket.getaddrinfo` in each package's resolver thread. Every system
starts through the `nodes` fixture. Every wait is at most 10 s.
"""

import importlib
import socket
import threading
import time

import pytest

from torch_remote_fixture import WAIT, Nodes, config, package, side_by_side

# the reference's settings (tests/test_cluster_tools.py FAST)
TOOLS_CLUSTER = {"gossip-interval": "0.05s",
                 "leader-actions-interval": "0.05s",
                 "unreachable-nodes-reaper-interval": "0.1s",
                 "failure-detector": {"heartbeat-interval": "0.1s",
                                      "acceptable-heartbeat-pause": "2s"},
                 "pub-sub": {"gossip-interval": "0.05s"}}


@pytest.fixture()
def nodes():
    n = Nodes()
    try:
        yield n
    finally:
        n.close()


def ns(P):
    """The remote fixture's namespace of package P with its cluster
    tools."""
    P.tools = importlib.import_module(f"{P.name}.cluster_tools")
    for sub in ("lease", "metrics", "pubsub", "singleton", "client",
                "discovery"):
        setattr(P, sub, importlib.import_module(
            f"{P.name}.cluster_tools.{sub}"))
    return P


def system(P, nodes, name, cfg):
    """One system of package P through the fixture."""
    if P.name == "akka_tpu_torch":
        return nodes.port_system(name, cfg)
    s = P.ActorSystem.create(name, cfg)
    provider = cfg["akka"]["actor"].get("provider")
    if provider is None:
        nodes.ref_systems.append(s)   # a local system: no wire to end
        return s
    nodes.ref_nodes.append(s)
    if provider == "cluster":
        nodes.ref_clusters.append((s, P.cluster.Cluster.get(s)))
    return s


def _three(P, nodes):
    cfg = config("inproc", provider="cluster", cluster=TOOLS_CLUSTER)
    systems = [system(P, nodes, f"ct{i}", cfg) for i in range(3)]
    clusters = [P.cluster.Cluster.get(s) for s in systems]
    first = str(systems[0].provider.local_address)
    for c in clusters:
        c.join(first)
    P.testkit.await_condition(
        lambda: all(sum(1 for m in c.state.members
                        if m.status.value == "Up") == 3 for c in clusters),
        max_time=WAIT)
    return systems, clusters


_ECHO = {}


def echo(P):
    if P.name not in _ECHO:
        class Echo(P.Actor):
            def receive(self, message):
                if message == "ping":
                    self.sender.tell(("pong", str(self.context.system.name)),
                                     self.self_ref)
                else:
                    self.sender.tell(message, self.self_ref)
        _ECHO[P.name] = Echo
    return _ECHO[P.name]


# ---------------------------------------------------------------- singleton
def _singleton_oldest(P, nodes):
    P = ns(P)
    systems, _ = _three(P, nodes)
    settings = P.singleton.ClusterSingletonSettings(singleton_name="echo")
    for s in systems:
        s.actor_of(P.Props.create(P.singleton.ClusterSingletonManager,
                                  P.Props.create(echo(P)), settings),
                   "echo-manager")
    probe = P.testkit.TestProbe(systems[2])
    proxy = systems[2].actor_of(P.Props.create(
        P.singleton.ClusterSingletonProxy, "/user/echo-manager", settings),
        "echo-proxy")
    proxy.tell("ping", probe.ref)
    return list(probe.receive_one(5.0))


def test_singleton_runs_on_oldest_and_proxy_routes(nodes):
    # hosted on the oldest node, the first to join
    assert side_by_side(_singleton_oldest, nodes) == ["pong", "ct0"]


def _hand_over(P, nodes):
    P = ns(P)
    S = P.singleton
    systems, clusters = _three(P, nodes)
    settings = S.ClusterSingletonSettings(singleton_name="echo",
                                          hand_over_retry_interval=0.1)
    for s in systems:
        s.actor_of(P.Props.create(S.ClusterSingletonManager,
                                  P.Props.create(echo(P)), settings),
                   "echo-manager")
    probe = P.testkit.TestProbe(systems[2])
    proxy = systems[2].actor_of(P.Props.create(
        S.ClusterSingletonProxy, "/user/echo-manager",
        S.ClusterSingletonSettings(singleton_name="echo",
                                   singleton_identification_interval=0.1)),
        "echo-proxy")
    proxy.tell("ping", probe.ref)
    trace = [probe.receive_one(5.0)[1]]
    clusters[0].leave()

    def moved():
        proxy.tell("ping", probe.ref)
        try:
            return probe.receive_one(1.0)[1] == "ct1"
        except AssertionError:
            return False
    P.testkit.await_condition(moved, max_time=WAIT)
    return trace + ["ct1"]


def test_singleton_hand_over_on_leave(nodes):
    assert side_by_side(_hand_over, nodes) == ["ct0", "ct1"]


# ------------------------------------------------------------------ pub-sub
def _topic_nodes(P, mediator, system_, topic):
    probe = P.testkit.TestProbe(system_)
    mediator.tell(P.pubsub.GetRegistryState(), probe.ref)
    return probe.receive_one(2.0).get(f"topic:{topic}", [])


def _publish(P, nodes):
    P = ns(P)
    T = P.tools
    systems, _ = _three(P, nodes)
    meds = [T.DistributedPubSub.get(s).mediator for s in systems]
    probes = [P.testkit.TestProbe(s) for s in systems]
    for med, probe in zip(meds[1:], probes[1:]):
        med.tell(T.Subscribe("news", probe.ref))
    acks = [type(p.receive_one(5.0)).__name__ for p in probes[1:]]
    P.testkit.await_condition(
        lambda: len(_topic_nodes(P, meds[0], systems[0], "news")) == 2,
        max_time=WAIT)
    meds[0].tell(T.Publish("news", "flash"))
    return acks + [p.receive_one(5.0) for p in probes[1:]]


def test_pubsub_publish_reaches_remote_subscribers(nodes):
    assert side_by_side(_publish, nodes) == [
        "SubscribeAck", "SubscribeAck", "flash", "flash"]


def _send(P, nodes):
    P = ns(P)
    T = P.tools
    systems, _ = _three(P, nodes)
    meds = [T.DistributedPubSub.get(s).mediator for s in systems]
    meds[1].tell(T.Put(systems[1].actor_of(P.Props.create(echo(P)), "svc")))

    def registered():
        p = P.testkit.TestProbe(systems[0])
        meds[0].tell(T.Send("/user/svc", "ping", local_affinity=True), p.ref)
        try:
            return p.receive_one(1.0)[0] == "pong"
        except AssertionError:
            return False
    P.testkit.await_condition(registered, max_time=WAIT)
    meds[2].tell(T.Put(systems[2].actor_of(P.Props.create(echo(P)), "svc")))
    probe0 = P.testkit.TestProbe(systems[0])

    def reached_both():
        meds[0].tell(T.SendToAll("/user/svc", "ping"), probe0.ref)
        hosts = set()
        try:
            for _ in range(2):
                hosts.add(probe0.receive_one(1.0)[1])
        except AssertionError:
            pass
        return hosts == {"ct1", "ct2"}
    P.testkit.await_condition(reached_both, max_time=WAIT)
    return ["ct1", "ct2"]


def test_pubsub_send_routes_to_registered_path(nodes):
    assert side_by_side(_send, nodes) == ["ct1", "ct2"]


# -------------------------------------------------------------------- lease
def _mutual_exclusion(P, nodes):
    P = ns(P)
    L = P.lease
    L.InProcLease.reset_all()
    t = L.TimeoutSettings(heartbeat_interval=10.0, heartbeat_timeout=0.3)
    a = L.InProcLease(L.LeaseSettings("shard-0", "ownerA", t))
    b = L.InProcLease(L.LeaseSettings("shard-0", "ownerB", t))
    lost = []
    trace = [a.acquire(lost.append), a.check_lease(), b.acquire()]
    time.sleep(0.4)   # a's TTL expires: its heartbeat is 10 s apart
    trace += [b.acquire(), b.check_lease(), a.check_lease(), lost,
              b.release()]
    a._stop_heartbeat()   # a lost the lease: end its heartbeat
    L.InProcLease.reset_all()
    return trace


def test_lease_mutual_exclusion_and_expiry(nodes):
    assert side_by_side(_mutual_exclusion, nodes) == [
        True, True, False, True, True, False, [None], True]


def _provider(P, nodes):
    P = ns(P)
    L = P.lease
    s = system(P, nodes, "lp", {"akka": {"stdout-loglevel": "OFF",
                                         "actor": {}}})
    provider = L.LeaseProvider.get(s)
    lease = provider.get_lease("my-lease", "akka.coordination.lease", "me")
    again = provider.get_lease("my-lease", "akka.coordination.lease", "me")
    L.InProcLease.reset_all()
    return [type(lease).__name__, again is lease]


def test_lease_provider_extension(nodes):
    assert side_by_side(_provider, nodes) == ["InProcLease", True]


def test_lease_heartbeat_threads_are_joined():
    """Port only: `release()` and `_stop_heartbeat()` join a lease's
    heartbeat thread, and a system's termination stops the heartbeats of
    the leases its provider handed out (the reference chains a Timer per
    beat and joins none)."""
    from akka_tpu_torch import ActorSystem
    from akka_tpu_torch.cluster_tools import lease as L
    L.InProcLease.reset_all()
    before = set(threading.enumerate())
    t = L.TimeoutSettings(heartbeat_interval=0.05, heartbeat_timeout=5.0)
    a = L.InProcLease(L.LeaseSettings("joined", "a", t))
    assert a.acquire()
    beat = [th for th in threading.enumerate() if th not in before]
    assert [th.name for th in beat] == ["lease-joined"]
    time.sleep(0.2)
    assert a.check_lease() and beat[0].is_alive()
    assert a.release() and not beat[0].is_alive()
    s = ActorSystem.create("lp-joined", {"akka": {"stdout-loglevel": "OFF"}})
    try:
        held = L.LeaseProvider.get(s).get_lease(
            "held", "akka.coordination.lease", "me")
        assert held.acquire()
    finally:
        s.terminate()
        assert s.await_termination(WAIT)
    # the provider's lease is stopped, not released: it expires by its TTL
    assert not [th for th in threading.enumerate()
                if th not in before and th.name.startswith("lease-")]
    assert held.check_lease()
    L.InProcLease.reset_all()


# ---------------------------------------------------------------- discovery
def _config_discovery(P, nodes):
    P = ns(P)
    cfg = {"akka": {"stdout-loglevel": "OFF", "actor": {},
                    "discovery": {"method": "config", "config": {
                        "services": {"web": {"endpoints": [
                            "10.0.0.1:8080", "10.0.0.2:8080"]}}}}}}
    s = system(P, nodes, "disc", cfg)
    d = P.tools.Discovery.get(s).discovery
    res = d.lookup(P.tools.Lookup("web"))
    return [[(t.host, t.port) for t in res.addresses],
            d.lookup(P.tools.Lookup("nope")).addresses]


def test_config_service_discovery(nodes):
    assert side_by_side(_config_discovery, nodes) == [
        [("10.0.0.1", 8080), ("10.0.0.2", 8080)], ()]


def stub_resolver(monkeypatch):
    """Answer getaddrinfo from a table: localhost on both loopbacks, any
    other name fails as an unknown host does."""
    def getaddrinfo(host, port, *args, **kwargs):
        if host != "localhost":
            raise socket.gaierror(socket.EAI_NONAME, "unknown host")
        return [(socket.AF_INET6, socket.SOCK_STREAM, 6, "",
                 ("::1", port, 0, 0)),
                (socket.AF_INET, socket.SOCK_STREAM, 6, "",
                 ("127.0.0.1", port)),
                (socket.AF_INET, socket.SOCK_STREAM, 6, "",
                 ("127.0.0.1", port))]
    monkeypatch.setattr(socket, "getaddrinfo", getaddrinfo)


def _dns(P, nodes):
    P = ns(P)
    d = P.tools.DnsServiceDiscovery()
    res = d.lookup(P.tools.Lookup("localhost", port_name="9090"))
    return [[(t.host, t.port) for t in res.addresses],
            d.lookup(P.tools.Lookup("no-such-host.invalid")).addresses]


def test_dns_service_discovery(nodes, monkeypatch):
    stub_resolver(monkeypatch)
    # resolved targets in the resolver's order, duplicates dropped
    assert side_by_side(_dns, nodes) == [
        [("::1", 9090), ("127.0.0.1", 9090)], ()]


def _dns_from_config(P, nodes):
    P = ns(P)
    s = system(P, nodes, "discdns", {"akka": {
        "stdout-loglevel": "OFF", "actor": {}, "discovery": {"method": "dns"}}})
    return type(P.tools.Discovery.get(s).discovery).__name__


def test_dns_method_selectable_from_config(nodes):
    assert side_by_side(_dns_from_config, nodes) == "DnsServiceDiscovery"


# ------------------------------------------------------------------ metrics
def _ewma(P, nodes):
    P = ns(P)
    alpha = P.tools.EWMA.alpha_for(half_life=1.0, collect_interval=1.0)
    e = P.tools.EWMA(0.0, alpha) + 10.0
    return [abs(alpha - 0.5) < 1e-9, abs(e.value - 5.0) < 1e-9]


def test_ewma_decays_toward_new_value(nodes):
    assert side_by_side(_ewma, nodes) == [True, True]


def _samples_host(P, nodes):
    P = ns(P)
    M = P.metrics
    s = M.MetricsCollector().sample()
    return [M.CPU_COMBINED in s or M.HEAP_MEMORY_MAX in s,
            sorted(k for k in s if k.startswith("device"))]


def test_metrics_collector_samples_host(nodes):
    assert side_by_side(_samples_host, nodes) == [True, []]


def _selectors(P, nodes):
    P = ns(P)
    M = P.metrics
    nm = M.NodeMetrics("a", 0.0, {
        M.CPU_COMBINED: M.Metric(M.CPU_COMBINED, 0.25, None),
        M.HEAP_MEMORY_USED: M.Metric(M.HEAP_MEMORY_USED, 250.0, None),
        M.HEAP_MEMORY_MAX: M.Metric(M.HEAP_MEMORY_MAX, 1000.0, None)})
    return [M.CpuMetricsSelector().capacity({"a": nm})["a"],
            M.MemoryMetricsSelector().capacity({"a": nm})["a"],
            M.CpuMetricsSelector().weights({"a": nm})["a"] >= 1]


def test_capacity_selectors(nodes):
    assert side_by_side(_selectors, nodes) == [0.75, 0.75, True]


@pytest.mark.skipif(
    __import__("torch").cuda.is_available(),
    reason="the refusal needs a machine without a CUDA card")
def test_device_probe_refuses_without_a_card():
    """Port only: with the device probe on (`probe_device`, the config's
    `akka.cluster.metrics.probe-device`), the collector and the extension
    refuse to start without a card instead of sampling nothing."""
    from akka_tpu_torch import ActorSystem
    from akka_tpu_torch.cluster_tools import metrics as M
    with pytest.raises(RuntimeError, match="CUDA card"):
        M.MetricsCollector(probe_device=True)
    with pytest.raises(RuntimeError, match="CUDA card"):
        M.device_memory()
    s = ActorSystem.create("probe", {"akka": {
        "stdout-loglevel": "OFF",
        "cluster": {"metrics": {"probe-device": "on"}}}})
    try:
        with pytest.raises(RuntimeError, match="CUDA card"):
            M.ClusterMetricsExtension.get(s)
    finally:
        s.terminate()
        assert s.await_termination(WAIT)


# ------------------------------------------------------------ cluster client
def _cluster_client(P, nodes):
    P = ns(P)
    C = P.client
    cluster_sys = system(P, nodes, "ccsrv", config(
        "inproc", provider="cluster",
        cluster={"gossip-interval": "0.05s",
                 "leader-actions-interval": "0.05s"}))
    client_sys = system(P, nodes, "ccext", config("inproc"))
    P.cluster.Cluster.get(cluster_sys).join(
        str(cluster_sys.provider.local_address))

    class Service(P.Actor):
        def receive(self, message):
            self.sender.tell(("served", message), self.self_ref)

    svc = cluster_sys.actor_of(P.Props.create(Service), "the-service")
    C.ClusterClientReceptionist.get(cluster_sys).register_service(svc)
    contact = str(cluster_sys.provider.local_address)
    client = client_sys.actor_of(P.Props.create(
        C.ClusterClient,
        C.ClusterClientSettings(initial_contacts=(contact,))), "client")
    # sent before the client has established contact: buffered, then sent
    return [P.ask_sync(client, C.Send("/user/the-service", "hello"),
                       timeout=WAIT, system=client_sys),
            P.ask_sync(client, C.SendToAll("/user/the-service", "all"),
                       timeout=WAIT, system=client_sys)]


def test_cluster_client_roundtrip(nodes):
    assert side_by_side(_cluster_client, nodes) == [
        ("served", "hello"), ("served", "all")]
