"""Remote deployment and cluster-aware routers of the port
(akka_tpu_torch.remote.deploy, akka_tpu_torch.cluster.routing) on the
CPU, held to the JAX package's: tests/test_remote_deploy.py's 17
scenarios (deployer lookups, deployment by Props and by config, remote
deathwatch, daemon supervision, the recipe and registration gates,
`mangle`, remote children's names and selections; cluster router pools
and groups over a two-node cluster: spanning, roles, least-loaded
spread, a downed node's routees removed), each written once over a
package namespace and run on both packages through `side_by_side`
(tests/torch_remote_fixture.py), each package's nodes on its own
in-proc transport. The port's trace (replies, where each actor runs,
Terminated events, routee counts and homes) must equal the
reference's, and each test also asserts the trace's values. One case
runs on the port alone: a Watch of a deployed actor that has stopped, a
fault of the reference's daemon that the port repairs (ROADMAP C).

Every system starts through the `nodes` fixture. Every wait is at most
10 s.
"""

from types import SimpleNamespace

import pytest

from akka_tpu_torch.testkit.cluster import FAST_MEMBERSHIP

from torch_remote_fixture import WAIT, Nodes, addr_of, package, side_by_side

# the reference's router cluster settings (tests/test_remote_deploy.py:
# the default split-brain resolver, stable after 20 s)
ROUTER_CLUSTER = {k: v for k, v in FAST_MEMBERSHIP.items()
                  if k != "split-brain-resolver"}
ROUTER_CLUSTER["unreachable-nodes-reaper-interval"] = "0.2s"


@pytest.fixture()
def nodes():
    n = Nodes()
    try:
        yield n
    finally:
        n.close()


_CLASSES = {}


def classes(P):
    """The deployable actor classes of package P, registered once with
    its remote deployer."""
    if P.name in _CLASSES:
        return _CLASSES[P.name]

    @P.deploy.register_deployable
    class WhereAmI(P.Actor):
        def __init__(self, tag="?"):
            super().__init__()
            self.tag = tag

        def receive(self, message):
            if message == "where":
                self.sender.tell(
                    (self.tag, str(self.context.system.name),
                     self.self_ref.path.to_serialization_format()),
                    self.self_ref)
            elif message == "boom":
                raise RuntimeError("boom")
            else:
                self.sender.tell(("echo", message), self.self_ref)

    @P.deploy.register_deployable
    class SpawnerParent(P.Actor):
        """Spawns/stops a remote-deployed child named 'rc' on demand."""

        def __init__(self, remote_addr):
            super().__init__()
            self.remote_addr = remote_addr

        def receive(self, message):
            if message == "spawn":
                self.context.actor_of(
                    P.Props.create(WhereAmI, "rc-child").with_deploy(
                        P.Deploy(scope=P.RemoteScope(self.remote_addr))),
                    "rc")
                self.sender.tell("spawned")
            elif message == "stop-child":
                child = self.context.child("rc")
                if child is not None:
                    self.context.stop(child)
                self.sender.tell("stopping")
            elif message == "has-child":
                self.sender.tell(self.context.child("rc") is not None)

    _CLASSES[P.name] = SimpleNamespace(WhereAmI=WhereAmI,
                                       SpawnerParent=SpawnerParent)
    return _CLASSES[P.name]


def _pair(P, nodes):
    return nodes.node("depA", P=P), nodes.node("depB", P=P)


def _remote(P, addr):
    return P.Deploy(scope=P.RemoteScope(addr))


def _where(reply):
    """A `where` reply as a trace entry: tag, system, and whether the
    path is under the remote daemon of depB."""
    tag, sysname, path = reply
    return (tag, sysname, "/remote/" in path, "akka://depB" in path)


# ----------------------------------------------------- deployer config
def _lookup(P, nodes):
    class S:
        pass

    s = S()
    s.config = P.config.Config({"akka": {"actor": {"deployment": {
        "/service": {"remote": "akka://other@h:1"},
        "/workers/*": {"dispatcher": "blocking-io-dispatcher"},
        "/pool": {"router": "round-robin-pool", "nr-of-instances": 3},
    }}}})
    d = P.actor_deploy.Deployer(s)
    return [d.lookup(["service"]).scope.address,
            d.lookup(["workers", "w7"]).dispatcher,
            d.lookup(["pool"]).router_config.nr_of_instances,
            d.lookup(["nothing"]), d.lookup(["service", "child"])]


def test_deployer_lookup_literal_and_wildcard(nodes):
    assert side_by_side(_lookup, nodes) == [
        "akka://other@h:1", "blocking-io-dispatcher", 3, None, None]


def _fallback(P, nodes):
    a = P.Deploy(scope=P.RemoteScope("akka://x@h:1"))
    b = P.Deploy(dispatcher="d1", scope=P.actor_deploy.NO_SCOPE)
    merged = a.with_fallback(b)
    return [type(merged.scope).__name__, merged.scope.address,
            merged.dispatcher]


def test_deploy_with_fallback_merge(nodes):
    assert side_by_side(_fallback, nodes) == [
        "RemoteScope", "akka://x@h:1", "d1"]


# --------------------------------------------- programmatic remote deploy
def _via_props(P, nodes):
    a, b = _pair(P, nodes)
    ref = a.actor_of(P.Props.create(classes(P).WhereAmI, "t1").with_deploy(
        _remote(P, addr_of(b))), "worker")
    return [_where(P.ask_sync(ref, "where", timeout=WAIT, system=a)),
            P.ask_sync(ref, 42, timeout=WAIT, system=a)]


def test_remote_deploy_via_props(nodes):
    # the actor runs on b, under its remote daemon
    assert side_by_side(_via_props, nodes) == [
        ("t1", "depB", True, True), ("echo", 42)]


def _via_config(P, nodes):
    b = nodes.node("depB2", P=P)
    a = nodes.node("depA2", P=P, actor={
        "deployment": {"/cfg-worker": {"remote": addr_of(b)}}})
    ref = a.actor_of(P.Props.create(classes(P).WhereAmI, "cfg"),
                     "cfg-worker")
    return list(P.ask_sync(ref, "where", timeout=WAIT, system=a)[:2])


def test_remote_deploy_via_config(nodes):
    assert side_by_side(_via_config, nodes) == ["cfg", "depB2"]


def _watchable(P, nodes):
    a, b = _pair(P, nodes)
    ref = a.actor_of(P.Props.create(classes(P).WhereAmI).with_deploy(
        _remote(P, addr_of(b))), "mortal")
    trace = [P.ask_sync(ref, "where", timeout=WAIT, system=a)[1]]
    seen = []

    class Watcher(P.Actor):
        def pre_start(self):
            self.context.watch(ref)

        def receive(self, message):
            if isinstance(message, P.Terminated):
                seen.append(message)

    a.actor_of(P.Props.create(Watcher), "watcher")
    deployed = b.provider.remote_daemon.cell.child(ref.path.name)
    a_addr = a.provider.local_address
    # the Watcher's Watch has reached b once the deployed child lists it
    # (a's parent watches the child too: its Watch alone is not enough)
    P.testkit.await_condition(
        lambda: any(w.path.address == a_addr
                    and w.path.elements == ("user", "watcher")
                    for w in deployed.cell._watched_by), max_time=WAIT)
    ref.stop()
    P.testkit.await_condition(lambda: len(seen) == 1, max_time=WAIT,
                              message="no Terminated for a deployed actor")
    t = seen[0]
    return trace + [t.actor.path == ref.path, t.existence_confirmed,
                    t.address_terminated]


def test_remote_deployed_actor_watchable_and_stoppable(nodes):
    assert side_by_side(_watchable, nodes) == ["depB", True, True, False]


def test_watch_of_a_stopped_deployed_actor_yields_terminated(nodes):
    """Port only: the port repairs a fault of the reference's daemon
    (ROADMAP C), which buffers a message for a child it does not have and
    drops a Watch with it after 5 s. A Watch of a deployed actor that has
    already stopped is answered at once, and a Watch of a child that was
    never created when its buffer's deadline passes, each with
    Terminated(existence_confirmed=False)."""
    P = package("akka_tpu_torch")
    a, b = _pair(P, nodes)
    ref = a.actor_of(P.Props.create(classes(P).WhereAmI).with_deploy(
        _remote(P, addr_of(b))), "short-lived")
    assert P.ask_sync(ref, "where", timeout=WAIT, system=a)[1] == "depB"
    daemon = b.provider.remote_daemon.cell
    ref.stop()
    P.testkit.await_condition(lambda: daemon.child(ref.path.name) is None,
                              max_time=WAIT)
    never = a.provider.resolve_actor_ref(
        f"{addr_of(b)}/remote/{P.deploy.mangle('akka://depA/user/never')}")
    seen = []

    class Watcher(P.Actor):
        def __init__(self, target):
            super().__init__()
            self.target = target

        def pre_start(self):
            self.context.watch(self.target)

        def receive(self, message):
            if isinstance(message, P.Terminated):
                seen.append((self.self_ref.path.name,
                             message.actor.path == self.target.path,
                             message.existence_confirmed))

    a.actor_of(P.Props.create(Watcher, never), "w-never")
    a.actor_of(P.Props.create(Watcher, ref), "w-stopped")
    P.testkit.await_condition(lambda: len(seen) == 2, max_time=WAIT,
                              message="a Watch of a dead child was lost")
    # the stopped child's Watch is answered at once, the unborn child's
    # when its buffer's 5 s deadline passes
    assert seen == [("w-stopped", True, False), ("w-never", True, False)]


def _restarts(P, nodes):
    a, b = _pair(P, nodes)
    ref = a.actor_of(P.Props.create(classes(P).WhereAmI, "sup").with_deploy(
        _remote(P, addr_of(b))), "crashy")
    first = P.ask_sync(ref, "where", timeout=WAIT, system=a)
    ref.tell("boom")  # the daemon's supervision restarts it on b
    second = P.ask_sync(ref, "where", timeout=WAIT, system=a)
    return [_where(first), _where(second), first[2] == second[2]]


def test_remote_deploy_restarts_on_failure(nodes):
    # restarted in place: the same path, the same incarnation
    assert side_by_side(_restarts, nodes) == [
        ("sup", "depB", True, True), ("sup", "depB", True, True), True]


def _requires_recipe(P, nodes):
    a, b = _pair(P, nodes)
    try:
        a.actor_of(P.Props.from_factory(
            lambda: classes(P).WhereAmI()).with_deploy(
                _remote(P, addr_of(b))), "norecipe")
    except Exception as e:   # noqa: BLE001 — its type enters the trace
        return ["raised", type(e).__name__]
    return ["deployed"]


def test_remote_deploy_requires_recipe(nodes):
    assert side_by_side(_requires_recipe, nodes)[0] == "raised"


def _unregistered(P, nodes):
    a, b = _pair(P, nodes)

    class Local(P.Actor):  # not registered, defined inside a function
        def receive(self, message):
            self.sender.tell("hi", self.self_ref)

    dead = []
    b.event_stream.subscribe(dead.append, P.DeadLetter)
    a.actor_of(P.Props.create(Local).with_deploy(_remote(P, addr_of(b))),
               "refused")

    def refused():
        return [d for d in dead
                if "refusing to deploy" in repr(getattr(d, "message", ""))]

    P.testkit.await_condition(lambda: bool(refused()), max_time=WAIT)
    return [type(refused()[0].message).__name__]


def test_unregistered_class_is_refused(nodes):
    assert len(side_by_side(_unregistered, nodes)) == 1


ORIGIN = "akka://sysA@local:1/user/worker#12345"


def _mangle(P, nodes):
    name = P.deploy.mangle(ORIGIN)
    P.path.validate_path_element(name)
    return [name]


def test_mangle_roundtrip_is_valid_path_element(nodes):
    import base64
    (name,) = side_by_side(_mangle, nodes)
    assert base64.urlsafe_b64decode(name + "=" * (-len(name) % 4)) == \
        ORIGIN.encode()


def _child_name_freed(P, nodes):
    a, b = _pair(P, nodes)
    parent = a.actor_of(P.Props.create(classes(P).SpawnerParent,
                                       addr_of(b)), "sp-parent")

    def ask(m):
        return P.ask_sync(parent, m, timeout=WAIT, system=a)

    trace = [ask("spawn"), ask("has-child"), ask("stop-child")]
    P.testkit.await_condition(lambda: ask("has-child") is False,
                              max_time=WAIT,
                              message="remote child name never freed")
    return trace + [ask("has-child"), ask("spawn")]


def test_remote_child_name_freed_after_termination(nodes):
    """A terminated remote-deployed child leaves the parent's remote
    children: its name can be used again."""
    assert side_by_side(_child_name_freed, nodes) == [
        "spawned", True, "stopping", False, "spawned"]


def _selection(P, nodes):
    a, b = _pair(P, nodes)
    parent = a.actor_of(P.Props.create(classes(P).SpawnerParent,
                                       addr_of(b)), "sel-parent")
    trace = [P.ask_sync(parent, "spawn", timeout=WAIT, system=a)]
    sel = a.actor_selection("akka://depA/user/sel-parent/rc")
    return trace + [_where(P.ask_sync(sel, "where", timeout=WAIT,
                                      system=a))]


def test_selection_resolves_remote_deployed_child(nodes):
    """A selection of the child's logical /user path reaches the
    remote-deployed actor."""
    assert side_by_side(_selection, nodes) == [
        "spawned", ("rc-child", "depB", True, True)]


# ------------------------------------------------ cluster-aware routers
def _two_node_cluster(P, nodes):
    systems = [nodes.node(f"crt{i}", P=P, provider="cluster",
                          cluster=ROUTER_CLUSTER) for i in range(2)]
    clusters = [P.cluster.Cluster.get(s) for s in systems]
    seed = str(systems[0].provider.local_address)
    for c in clusters:
        c.join(seed)
    up = P.cluster.MemberStatus.UP
    P.testkit.await_condition(
        lambda: all(sum(1 for m in c.state.members if m.status is up) == 2
                    for c in clusters),
        max_time=WAIT, message="2-node cluster did not form")
    return systems, clusters


def _routee_count(P, system, router_ref):
    return len(P.ask_sync(router_ref, P.router.GetRoutees(), timeout=WAIT,
                          system=system).routees)


def _homes(P, system, router, n):
    return sorted({P.ask_sync(router, "where", timeout=WAIT,
                              system=system)[1] for _ in range(n)})


def _pool(P, nodes, total, per_node, roles=None):
    (a, _b), _ = _two_node_cluster(P, nodes)
    settings = P.cluster.ClusterRouterPoolSettings(
        total_instances=total, max_instances_per_node=per_node,
        **({} if roles is None else {"use_roles": frozenset(roles)}))
    router = a.actor_of(P.Props.create(classes(P).WhereAmI, "pool")
                        .with_router(P.cluster.ClusterRouterPool(
                            P.router.RoundRobinPool(0), settings)),
                        f"pool-{total}-{per_node}")
    return a, router


def _spans(P, nodes):
    a, router = _pool(P, nodes, 4, 2)
    P.testkit.await_condition(lambda: _routee_count(P, a, router) == 4,
                              max_time=WAIT,
                              message="pool did not reach 4 routees")
    return [_routee_count(P, a, router), _homes(P, a, router, 8)]


def test_cluster_router_pool_spans_nodes(nodes):
    assert side_by_side(_spans, nodes) == [4, ["crt0", "crt1"]]


def _roles(P, nodes):
    a, router = _pool(P, nodes, 4, 2, roles={"gpu"})
    # the router has taken its initial state and the Up events by now
    return [_routee_count(P, a, router), _routee_count(P, a, router)]


def test_cluster_router_pool_respects_roles(nodes):
    assert side_by_side(_roles, nodes) == [0, 0]


def _group(P, nodes):
    systems, _ = _two_node_cluster(P, nodes)
    a = systems[0]
    for s in systems:
        s.actor_of(P.Props.create(classes(P).WhereAmI, f"svc-{s.name}"),
                   "svc")
    router = a.actor_of(P.Props.create(classes(P).WhereAmI).with_router(
        P.cluster.ClusterRouterGroup(
            P.router.RoundRobinGroup(["/user/svc"]),
            P.cluster.ClusterRouterGroupSettings(
                total_instances=2, routees_paths=("/user/svc",)))),
        "span-group")
    P.testkit.await_condition(lambda: _routee_count(P, a, router) == 2,
                              max_time=WAIT,
                              message="group did not pick up both nodes")
    return [_routee_count(P, a, router), _homes(P, a, router, 6)]


def test_cluster_router_group_selects_remote_paths(nodes):
    assert side_by_side(_group, nodes) == [2, ["crt0", "crt1"]]


def _validated(P, nodes):
    C, out = P.cluster, []
    for make in (lambda: C.ClusterRouterPoolSettings(total_instances=0),
                 lambda: C.ClusterRouterPoolSettings(
                     total_instances=4, max_instances_per_node=0),
                 lambda: C.ClusterRouterGroupSettings(total_instances=0)):
        try:
            make()
            out.append("accepted")
        except Exception as e:   # noqa: BLE001 — its type enters the trace
            out.append(type(e).__name__)
    return out


def test_cluster_router_pool_settings_validated(nodes):
    assert side_by_side(_validated, nodes) == ["ValueError"] * 3


def _spreads(P, nodes):
    a, router = _pool(P, nodes, 2, 2)
    P.testkit.await_condition(lambda: _routee_count(P, a, router) == 2,
                              max_time=WAIT,
                              message="pool did not reach 2 routees")
    return [_routee_count(P, a, router), _homes(P, a, router, 6)]


def test_cluster_router_pool_spreads_least_loaded(nodes):
    """With total < nodes * per-node max, routees spread one per node."""
    assert side_by_side(_spreads, nodes) == [2, ["crt0", "crt1"]]


def _shrinks(P, nodes):
    (a, b), clusters = _two_node_cluster(P, nodes)
    router = a.actor_of(P.Props.create(classes(P).WhereAmI).with_router(
        P.cluster.ClusterRouterPool(
            P.router.RoundRobinPool(0), P.cluster.ClusterRouterPoolSettings(
                total_instances=2, max_instances_per_node=1))),
        "shrink-pool")
    P.testkit.await_condition(lambda: _routee_count(P, a, router) == 2,
                              max_time=WAIT, message="pool did not fill")
    trace = [_routee_count(P, a, router)]
    clusters[0].down(str(b.provider.local_address))
    P.testkit.await_condition(lambda: _routee_count(P, a, router) == 1,
                              max_time=WAIT,
                              message="downed node's routee not removed")
    return trace + [_routee_count(P, a, router), _homes(P, a, router, 3)]


def test_cluster_router_removes_downed_node(nodes):
    assert side_by_side(_shrinks, nodes) == [2, 1, ["crt0"]]
