"""The port's host tier of cluster sharding (akka_tpu_torch.sharding:
ShardRegion, Shard, ShardCoordinator under a ClusterSingletonManager, the
ClusterSharding extension and the typed facade) on the CPU, held to the
JAX package's: tests/test_sharding.py's 6 cases and
tests/test_device_sharding.py::test_init_device_via_typed_api, each
written once over a package namespace and run on both packages through
`side_by_side` (tests/torch_remote_fixture.py), each package's nodes on
its own in-proc transport with the reference's fast settings
(`retry_interval` 0.1, `rebalance_interval` 0.3). The port's trace
(replies, hosts, acks, remembered ids, in order) must equal the
reference's, and each test also asserts the trace's values.

Every system starts through the `nodes` fixture. Every wait is at most
10 s and polls with `await_condition` (the reference's 20 s rebalance
waits are cut to 10 s; the rebalance lands in well under a second).
"""

import importlib
from concurrent.futures import Future

import pytest

from torch_remote_fixture import (SHARDING_CLUSTER, WAIT, Nodes, package,
                                  side_by_side)


@pytest.fixture()
def nodes():
    n = Nodes()
    try:
        yield n
    finally:
        n.close()


def ns(P):
    """The remote fixture's namespace of package P with sharding, the
    typed API and the device region."""
    for attr, sub in (("sharding", "sharding"), ("typed", "typed"),
                      ("device", "sharding.device"),
                      ("gateway", "gateway")):
        setattr(P, attr, importlib.import_module(f"{P.name}.{sub}"))
    P.InProcStore = P.sharding.InProcRememberEntitiesStore
    P.InProcStore.reset()
    return P


def settings(P, **kw):
    base = dict(number_of_shards=8, retry_interval=0.1,
                rebalance_interval=0.3)
    base.update(kw)
    return P.sharding.ClusterShardingSettings(**base)


def cluster_nodes(P, nodes, n: int, stem: str = "sh"):
    """n provider = cluster nodes on the in-proc wire, all joined to the
    first and Up on every node."""
    systems = [nodes.node(f"{stem}{i}", "inproc", P=P, provider="cluster",
                          cluster=SHARDING_CLUSTER) for i in range(n)]
    clusters = [P.cluster.Cluster.get(s) for s in systems]
    first = str(systems[0].provider.local_address)
    for c in clusters:
        c.join(first)
    P.testkit.await_condition(
        lambda: all(sum(m.status.value == "Up" for m in c.state.members)
                    == n for c in clusters), max_time=WAIT)
    return systems, clusters


_COUNTER = {}


def counter(P):
    """Per-entity counter of package P: replies (system name, count)."""
    if P.name not in _COUNTER:
        class Counter(P.Actor):
            def __init__(self):
                super().__init__()
                self.count = 0

            def receive(self, message):
                if message == "inc":
                    self.count += 1
                elif message == "get":
                    self.sender.tell((str(self.context.system.name),
                                      self.count), self.self_ref)
                elif message == "passivate":
                    self.context.parent.tell(P.sharding.Passivate(),
                                             self.self_ref)
                else:
                    return NotImplemented
        _COUNTER[P.name] = Counter
    return _COUNTER[P.name]


def reply_when(P, probe, send, want, wait: float = 1.0):
    """Poll: send(), then True once the next reply satisfies want()."""
    def ok():
        send()
        try:
            return want(probe.receive_one(wait))
        except (AssertionError, P.testkit.AssertionFailure):
            return False
    P.testkit.await_condition(ok, max_time=WAIT)


# ------------------------------------------------------ allocation strategy
def _least_shard(P, nodes):
    s = ns(P).sharding.LeastShardAllocationStrategy(
        rebalance_threshold=1, max_simultaneous_rebalance=3)
    current = {"r1": ["a", "b", "c"], "r2": ["d"], "r3": []}
    return [s.allocate_shard("r1", "x", current),
            sorted(s.rebalance(current, set())),
            sorted(s.rebalance({"r1": ["a"], "r2": []}, set())),
            sorted(s.rebalance(current, {"m1", "m2", "m3"}))]


def test_least_shard_allocation(nodes):
    # the least-loaded region; moves off the most loaded until within the
    # threshold; nothing within it or with the in-flight limit reached
    assert side_by_side(_least_shard, nodes) == ["r3", ["a", "b"], [], []]


# ------------------------------------------------------ single-node hosting
def _keep_state(P, nodes):
    P = ns(P)
    (s,), _ = cluster_nodes(P, nodes, 1)
    E = P.sharding.ShardingEnvelope
    region = P.sharding.ClusterSharding.get(s).start(
        "counters", P.Props.create(counter(P)), settings(P))
    probe = P.testkit.TestProbe(s)
    for _ in range(3):
        region.tell(E("e1", "inc"), probe.ref)
    region.tell(E("e2", "inc"), probe.ref)
    got = []
    reply_when(P, probe, lambda: region.tell(E("e1", "get"), probe.ref),
               lambda r: r[1] == 3 and not got.append(tuple(r)))
    region.tell(E("e2", "get"), probe.ref)
    got.append(tuple(probe.receive_one(5.0)))
    return got


def test_entities_receive_and_keep_state(nodes):
    assert side_by_side(_keep_state, nodes) == [("sh0", 3), ("sh0", 1)]


def _start_and_passivate(P, nodes):
    P = ns(P)
    (s,), _ = cluster_nodes(P, nodes, 1)
    S = P.sharding
    region = S.ClusterSharding.get(s).start(
        "counters", P.Props.create(counter(P)), settings(P))
    probe = P.testkit.TestProbe(s)
    region.tell(S.StartEntity("e9"), probe.ref)
    ack = probe.expect_msg_class(S.StartEntityAck, timeout=5.0)
    trace = [type(ack).__name__, ack.entity_id]
    # passivate, then a new message restarts it with fresh state
    region.tell(S.ShardingEnvelope("e9", "inc"), probe.ref)
    region.tell(S.ShardingEnvelope("e9", "passivate"), probe.ref)
    reply_when(P, probe,
               lambda: region.tell(S.ShardingEnvelope("e9", "get"),
                                   probe.ref),
               lambda r: r[1] == 0 and not trace.append(tuple(r)))
    return trace


def test_start_entity_and_passivation(nodes):
    assert side_by_side(_start_and_passivate, nodes) == [
        "StartEntityAck", "e9", ("sh0", 0)]


# ------------------------------------ multi-node: forwarding and rebalance
def _forward_and_rebalance(P, nodes):
    P = ns(P)
    systems, _ = cluster_nodes(P, nodes, 2)
    E = P.sharding.ShardingEnvelope
    regions = [P.sharding.ClusterSharding.get(s).start(
        "counters", P.Props.create(counter(P)), settings(P))
        for s in systems]
    probe0 = P.testkit.TestProbe(systems[0])
    probe1 = P.testkit.TestProbe(systems[1])
    # drive all 8 shards from node 0; the rebalance spreads them
    for i in range(32):
        regions[0].tell(E(f"e{i}", "inc"), probe0.ref)

    def spread():
        hosts = set()
        for i in range(32):
            regions[1].tell(E(f"e{i}", "get"), probe1.ref)
        try:
            for _ in range(32):
                hosts.add(probe1.receive_one(2.0)[0])
        except (AssertionError, P.testkit.AssertionFailure):
            return False
        return hosts == {"sh0", "sh1"}
    P.testkit.await_condition(spread, max_time=WAIT)
    # the entity answers from wherever it now lives; a rebalanced entity
    # restarts fresh (state continuity needs persistence/remember-entities)
    regions[1].tell(E("e5", "get"), probe1.ref)
    host, count = probe1.receive_one(5.0)
    return ["spread", host in ("sh0", "sh1"), count in (0, 1)]


def test_cross_node_forwarding_and_rebalance(nodes):
    assert side_by_side(_forward_and_rebalance, nodes) == [
        "spread", True, True]


def _remember_after_rebalance(P, nodes):
    P = ns(P)
    systems, _ = cluster_nodes(P, nodes, 2)
    st = settings(P, number_of_shards=2, remember_entities=True)
    store = P.InProcStore()
    regions = [P.sharding.ClusterSharding.get(s).start(
        "rem", P.Props.create(counter(P)), st, store=store)
        for s in systems]
    probe = P.testkit.TestProbe(systems[0])
    regions[0].tell(P.sharding.ShardingEnvelope("r1", "inc"), probe.ref)
    P.testkit.await_condition(
        lambda: any(store.remembered("rem", str(s)) == {"r1"}
                    for s in range(2)), max_time=WAIT)
    out = [(str(s), sorted(store.remembered("rem", str(s))))
           for s in range(2)]
    P.InProcStore.reset()
    return out


def test_remember_entities_restart_after_rebalance(nodes):
    trace = side_by_side(_remember_after_rebalance, nodes)
    # r1's shard (by the stable hash both packages share) remembers it
    assert sorted(ids for _, ids in trace) == [[], ["r1"]]


def failing_store(P, system, when: str):
    """An in-proc store whose first add of "bad" fails. The reference's
    Shard calls `add`, which raises. The port's calls `add_async`: with
    `when` "at once" the default Future is done already; with "later" the
    system's scheduler makes each add of "bad" 50 ms on, so the refusal
    comes after the Shard has moved on."""
    class FailingStore(P.InProcStore):
        refused = False

        def add(self, type_name, shard_id, entity_id):
            if entity_id == "bad" and not self.refused:
                self.refused = True
                raise RuntimeError("remember write refused")
            super().add(type_name, shard_id, entity_id)

        def add_async(self, type_name, shard_id, entity_id):
            if when == "at once" or entity_id != "bad":
                return super().add_async(type_name, shard_id, entity_id)
            out = Future()

            def later():
                try:
                    out.set_result(self.add(type_name, shard_id, entity_id))
                except RuntimeError as e:
                    out.set_exception(e)
            system.scheduler.schedule_once(0.05, later)
            return out
    return FailingStore()


def refusing_region(P, nodes, when):
    """One node, a region of 2 remembered shards over `failing_store`,
    and a probe. By the stable hash "good" lives in shard 1, "ok" and
    "bad" in shard 0."""
    (s,), _ = cluster_nodes(P, nodes, 1)
    store = failing_store(P, s, when)
    region = P.sharding.ClusterSharding.get(s).start(
        "refusing", P.Props.create(counter(P)),
        settings(P, number_of_shards=2, remember_entities=True),
        store=store)
    return region, store, P.testkit.TestProbe(s)


def entity_ids(P, region, probe):
    region.tell(P.sharding.GetShardRegionState(), probe.ref)
    state = probe.expect_msg_class(P.sharding.CurrentShardRegionState,
                                   timeout=5.0)
    return sorted(e for sh in state.shards for e in sh.entity_ids)


def _failed_remember_write(P, nodes, when):
    """A failed remember-entities write crashes the Shard, as the
    reference's synchronous write does: the entity whose write failed
    stops and is not remembered, and its next message starts it afresh;
    the other shard's entity keeps its state."""
    P = ns(P)
    region, store, probe = refusing_region(P, nodes, when)
    E = P.sharding.ShardingEnvelope
    region.tell(E("good", "inc"), probe.ref)
    region.tell(E("good", "get"), probe.ref)
    trace = [tuple(probe.receive_one(5.0))]
    region.tell(E("bad", "inc"), probe.ref)
    # once the write is refused, "bad" runs until its Shard restarts
    P.testkit.await_condition(
        lambda: store.refused and entity_ids(P, region, probe) == ["good"],
        max_time=WAIT)
    trace.append([sorted(store.remembered("refusing", str(sh)))
                  for sh in range(2)])
    region.tell(E("good", "get"), probe.ref)
    trace.append(tuple(probe.receive_one(5.0)))
    region.tell(E("bad", "get"), probe.ref)
    trace.append(tuple(probe.receive_one(5.0)))
    # the second write of "bad" lands 50 ms on where `when` is "later"
    P.testkit.await_condition(
        lambda: store.remembered("refusing", "0") == {"bad"}, max_time=WAIT)
    trace.append([sorted(store.remembered("refusing", str(sh)))
                  for sh in range(2)])
    P.InProcStore.reset()
    return trace


@pytest.mark.parametrize("when", ["at once", "later"])
def test_failed_remember_write_restarts_the_shard(nodes, when):
    assert side_by_side(_failed_remember_write, nodes, when) == [
        ("sh0", 1), [[], ["good"]], ("sh0", 1), ("sh0", 0),
        [["bad"], ["good"]]]


# ------------------------------------------------------------ typed facade
def typed_counter(P, entity_id: str):
    B = P.typed.Behaviors

    def behavior(count=0):
        def on_message(ctx, msg):
            if isinstance(msg, tuple) and msg[0] == "get":
                msg[1].tell((entity_id, count))
                return B.same
            if msg == "inc":
                return behavior(count + 1)
            return B.same
        return B.receive(on_message)
    return behavior()


def _typed_entity_ref(P, nodes):
    P = ns(P)
    (s,), _ = cluster_nodes(P, nodes, 1)
    S = P.sharding
    key = S.EntityTypeKey("typed-counters")
    sharding = S.ClusterShardingTyped.get(s)
    sharding.init(S.Entity(key, lambda ctx: typed_counter(P, ctx.entity_id),
                           settings=settings(P)))
    ref = sharding.entity_ref_for(key, "alice")
    probe = P.testkit.TestProbe(s)
    ref.tell("inc")
    ref.tell("inc")
    got = []
    reply_when(P, probe, lambda: ref.tell(("get", probe.ref)),
               lambda r: r == ("alice", 2) and not got.append(r))
    return [repr(ref), sharding.shard_region(key) is ref.region, *got]


def test_typed_entity_ref(nodes):
    assert side_by_side(_typed_entity_ref, nodes) == [
        "EntityRef(typed-counters/alice)", True, ("alice", 2)]


def _init_device(P, nodes):
    """The reference's region on one of its virtual devices, the port's
    on the CPU (`device="cpu"`, a port addition)."""
    P = ns(P)
    s = P.ActorSystem.create("devshard", {"akka": {
        "stdout-loglevel": "OFF", "log-dead-letters": 0}})
    (nodes.port_systems if P.name == "akka_tpu_torch"
     else nodes.ref_systems).append(s)
    sharding = P.sharding.ClusterShardingTyped.get(s)
    spec = P.device.DeviceEntity("api-counters",
                                 P.gateway.counter_behavior(4), n_shards=4,
                                 entities_per_shard=8, n_devices=1)
    kw = {"device": "cpu"} if P.name == "akka_tpu_torch" else {}
    region = sharding.init_device(spec, **kw)
    ref = region.entity_ref("e-1")
    ref.tell([1.0, 0, 0, 0])
    region.run(1)
    region.block_until_ready()
    return [sharding.device_region("api-counters") is region,
            (ref.shard, ref.index), float(ref.read_state("total"))]


def test_init_device_via_typed_api(nodes):
    trace = side_by_side(_init_device, nodes)
    assert trace[0] is True and trace[2] == 1.0


# ------------------------- a reference fault the port repairs (section C)
def _ddata_shards_on_a_small_pool(P, nodes):
    """One node whose default dispatcher has 2 threads; a region with the
    ddata remember store (1 s timeout); StartEntity for 16 ids of 4
    shards. Returns how many acks came within 3 s."""
    P = ns(P)
    s = nodes.node("pool2", "inproc", P=P, provider="cluster",
                   cluster=SHARDING_CLUSTER, actor={"default-dispatcher": {
                       "thread-pool-executor": {"fixed-pool-size": 2}}})
    c = P.cluster.Cluster.get(s)
    c.join(str(s.provider.local_address))
    P.testkit.await_condition(lambda: any(
        m.status.value == "Up" for m in c.state.members), max_time=WAIT)
    store = P.sharding.DDataRememberEntitiesStore(s, timeout=1.0)
    region = P.sharding.ClusterSharding.get(s).start(
        "pool2", P.Props.create(counter(P)),
        settings(P, number_of_shards=4, remember_entities=True,
                 remember_entities_store="ddata"), store=store)
    probe = P.testkit.TestProbe(s)
    for i in range(16):
        region.tell(P.sharding.StartEntity(f"e{i}"), probe.ref)
    acked = set()
    try:
        for _ in range(16):
            acked.add(probe.receive_one(3.0).entity_id)
    except (AssertionError, P.testkit.AssertionFailure):
        pass
    return len(acked)


def test_ddata_remembering_shards_do_not_park_the_dispatcher(nodes):
    """The reference's Shard asks the ddata store synchronously in
    pre_start and on each new entity: with as many shards starting as the
    dispatcher has threads, every thread waits on a replicator that has
    none left, and each wait runs out (here 1 s; 5 s by default). The
    port's Shard reads and writes the store through its futures: every
    StartEntity is acked."""
    assert _ddata_shards_on_a_small_pool(package("akka_tpu_torch"),
                                         nodes) == 16
    assert _ddata_shards_on_a_small_pool(package("akka_tpu"), nodes) < 16


def _restart_beside_a_remembered_entity(P, nodes):
    """"ok" and "bad" share shard 0; the write of "bad" fails at once.
    Returns "ok"'s reply once it has restarted afresh (None if it has not
    within 2 s) and the entities the region then reports."""
    P = ns(P)
    region, _, probe = refusing_region(P, nodes, "at once")
    E = P.sharding.ShardingEnvelope
    region.tell(E("ok", "inc"), probe.ref)
    region.tell(E("ok", "get"), probe.ref)
    assert tuple(probe.receive_one(5.0)) == ("sh0", 1)
    region.tell(E("bad", "inc"), probe.ref)
    got = []

    def restarted():
        region.tell(E("ok", "get"), probe.ref)
        try:
            r = tuple(probe.receive_one(0.5))
        except (AssertionError, P.testkit.AssertionFailure):
            return False
        return r[1] == 0 and not got.append(r)
    try:
        P.testkit.await_condition(restarted, max_time=2.0)
    except (AssertionError, P.testkit.AssertionFailure):
        got.append(None)
    trace = [got[0], entity_ids(P, region, probe)]
    P.InProcStore.reset()
    return trace


def test_a_restarted_shard_restarts_its_remembered_entities(nodes):
    """Reference fault (ROADMAP section C): the restarted Shard re-creates
    its remembered entities in pre_start while the children that
    pre_restart stopped may still hold their names. The reference's cell
    waits only for children already terminating, so actor_of raises, and
    the Shard stops for good with the region still routing to it. The
    port's cell waits for every child it asked to stop (the reference's
    ChildrenContainer.shallDie), and "ok" restarts afresh."""
    assert _restart_beside_a_remembered_entity(
        package("akka_tpu_torch"), nodes) == [("sh0", 0), ["ok"]]
    assert _restart_beside_a_remembered_entity(
        package("akka_tpu"), nodes) == [None, []]
