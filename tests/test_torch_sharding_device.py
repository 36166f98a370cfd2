"""Host sharding in front of a device region, on the port alone (the
reference's typed entities cannot answer an `EntityRef.ask`, ROADMAP
section C): the CPU form of `chip_smoke.py`'s sharding_paths at a small
size. Two provider = cluster nodes on the in-proc wire; node 0 holds a
`ClusterShardingTyped.init_device` counter region (4 shards x 16 rows,
`device="cpu"`) behind an `AskBatcher` and a host front registered with
the cluster Receptionist; `Account` entities (typed, 8 host shards) run
on both nodes, each owning one device row: an add asks the front
(`ctx.ask`, the future piped back, no dispatcher thread blocks) and
answers with the row's total after the add.

- Asks through `entity_ref_for` on either node: every reply and every
  device row equals a host oracle of running totals; the reference's
  `EntityRef.ask` of a typed entity, for comparison, is never answered.
- Remembered host entities (the ddata store) after node 1 leaves: the
  ids it hosted restart on node 0 once their shards are asked for again,
  `remembered_rows` gives them no row, and the device region's rows under
  the same key prefix are unchanged.

Every system starts through the `nodes` fixture. Every wait is at most
10 s.
"""

import numpy as np
import pytest

from torch_remote_fixture import SHARDING_CLUSTER, WAIT, Nodes, package

import akka_tpu_torch.sharding as S
from akka_tpu_torch import Actor, Props
from akka_tpu_torch.cluster import Cluster
from akka_tpu_torch.gateway import counter_behavior
from akka_tpu_torch.pattern.ask import pipe
from akka_tpu_torch.testkit import TestProbe, await_condition
from akka_tpu_torch.testkit.sharding import region_entity_ids
from akka_tpu_torch.typed import Behaviors, ServiceKey
from akka_tpu_torch.typed.receptionist import Receptionist

# the reference's sharding membership settings, with the replicator at
# the fast settings of the reference's ddata tests
CLUSTER = {**SHARDING_CLUSTER,
           "distributed-data": {
               "gossip-interval": "0.1s",
               "notify-subscribers-interval": "0.05s",
               "delta-crdt": {"delta-propagation-interval": "0.05s"}}}
FRONT = ServiceKey("device-front")
ACCOUNT = S.EntityTypeKey("Account")
HOST_SHARDS = 8
D_SHARDS, D_ROWS = 4, 16          # the device region: 4 x 16 rows


@pytest.fixture()
def nodes():
    n = Nodes()
    try:
        yield n
    finally:
        n.close()


class Front(Actor):
    """Node 0's front of the device region: ("add", id, v, reply_to)
    resolves the id's row and pipes the batcher's reply, the row's total
    after the add, to reply_to."""

    def __init__(self, region, batcher):
        super().__init__()
        self.region, self.batcher = region, batcher

    def receive(self, message):
        _, eid, v, reply_to = message
        ref = self.region.entity_ref(eid)
        fut = self.batcher.submit(ref.shard, ref.index, [v, 0.0, 0.0, 0.0])
        out = type(fut)()
        fut.add_done_callback(lambda f: out.set_exception(f.exception())
                              if f.exception() is not None
                              else out.set_result(float(f.result()[0])))
        pipe(out, reply_to, self.self_ref)


def account(entity_id: str, front):
    """An Account entity: ("add", v, reply_to) asks the front and answers
    ("total", id, total) or ("failed", id, error)."""
    def on_message(ctx, msg):
        if msg[0] == "add":
            _, v, reply_to = msg
            ctx.ask(front, lambda r: ("add", entity_id, v, r),
                    lambda rep, err: ("added", rep, err, reply_to),
                    timeout=WAIT)
        elif msg[0] == "added":
            _, total, err, reply_to = msg
            reply_to.tell(("total", entity_id, total) if err is None
                          else ("failed", entity_id, repr(err)))
        return Behaviors.same
    return Behaviors.receive(on_message)


def settings():
    return S.ClusterShardingSettings(
        number_of_shards=HOST_SHARDS, retry_interval=0.1,
        rebalance_interval=0.3, remember_entities=True,
        remember_entities_store="ddata")


def two_nodes(nodes):
    systems = [nodes.node(f"shd{i}", "inproc", provider="cluster",
                          cluster=CLUSTER) for i in range(2)]
    clusters = [Cluster.get(s) for s in systems]
    for c in clusters:
        c.join(str(systems[0].provider.local_address))
    await_condition(lambda: all(
        sum(m.status.value == "Up" for m in c.state.members) == 2
        for c in clusters), max_time=WAIT)
    return systems, clusters


def account_ids(region, n_per_shard: int = D_ROWS):
    """The first n_per_shard ids acct-0, acct-1, ... of each device shard,
    so that the region's rows hold them all."""
    by_shard = {s: [] for s in range(D_SHARDS)}
    k = 0
    while any(len(v) < n_per_shard for v in by_shard.values()):
        eid = f"acct-{k}"
        ids = by_shard[region.shard_of(eid)]
        if len(ids) < n_per_shard:
            ids.append(eid)
        k += 1
    return sorted(i for v in by_shard.values() for i in v)


def stack(nodes, remember_store=False):
    """The two nodes, the device region on node 0 (with the ddata
    remember store if asked), its batcher and front, and the Account
    type on both nodes. Returns (systems, clusters, region, batcher,
    regions, shardings)."""
    systems, clusters = two_nodes(nodes)
    store = S.DDataRememberEntitiesStore(systems[0]) if remember_store \
        else None
    region = S.ClusterShardingTyped.get(systems[0]).init_device(
        S.DeviceEntity("counter", counter_behavior(4), n_shards=D_SHARDS,
                       entities_per_shard=D_ROWS, n_devices=1,
                       spare_blocks=2, mailbox_slots=0,
                       remember_store=store), device="cpu")
    batcher = S.AskBatcher(region, max_batch=D_SHARDS * D_ROWS)
    front = systems[0].actor_of(Props.create(Front, region, batcher),
                                "front")
    Receptionist.get(systems[0]).register(FRONT, front)
    shardings, regions = [], []
    for s in systems:
        probe = TestProbe(s)

        def found():
            Receptionist.get(s).find(FRONT, probe.ref)
            return probe.receive_one(WAIT).service_instances
        await_condition(lambda: len(found()) == 1, max_time=WAIT)
        (ref,) = found()
        sh = S.ClusterShardingTyped.get(s)
        regions.append(sh.init(S.Entity(
            ACCOUNT, lambda ctx, ref=ref: account(ctx.entity_id, ref),
            settings=settings())))
        shardings.append(sh)
    return systems, clusters, region, batcher, regions, shardings


def settle(regions, systems, ids) -> list:
    """Start every id (StartEntity through node 0's region, again at each
    poll: a shard handed off by a rebalance comes back on demand) until
    the regions host them all with their shard counts within one of each
    other: the coordinator then has nothing to rebalance, so no entity is
    handed off, with its reply lost, while asks are in flight. Returns
    each region's ids."""
    probes = [TestProbe(s) for s in systems]
    hosted = []

    def balanced():
        for eid in ids:
            regions[0].tell(S.StartEntity(eid))
        shards = []
        hosted[:] = []
        for r, p in zip(regions, probes):
            r.tell(S.GetShardRegionState(), p.ref)
            try:
                state = p.receive_one(WAIT)
            except AssertionError:
                return False
            shards.append(len(state.shards))
            hosted.append({e for sh in state.shards for e in sh.entity_ids})
        return (set().union(*hosted) == set(ids)
                and max(shards) - min(shards) <= 1)
    await_condition(balanced, max_time=WAIT)
    return hosted


def ask_round(shardings, ids, rng, oracle) -> list:
    """One round of concurrent asks, one per id, the ids dealt in turn to
    the nodes' `entity_ref_for`; every reply held to the oracle. Returns
    the replies' ids by the node that asked."""
    vals = rng.integers(1, 100, len(ids)).astype(float)
    futs = []
    for k, (eid, v) in enumerate(zip(ids, vals)):
        ref = shardings[k % len(shardings)].entity_ref_for(ACCOUNT, eid)
        futs.append((eid, v, ref.ask(lambda r, v=v: ("add", float(v), r),
                                     timeout=WAIT)))
    for eid, v, f in futs:
        oracle[eid] = oracle.get(eid, 0.0) + v
        assert f.result(WAIT) == ("total", eid, oracle[eid])
    return [eid for eid, _, _ in futs]


def device_totals(region, ids) -> dict:
    rows = np.asarray([region.entity_ref(e).row for e in ids])
    return dict(zip(ids, map(float, region.system.read_state("total",
                                                             rows))))


def test_typed_sharding_in_front_of_a_device_region(nodes):
    systems, _, region, batcher, regions, shardings = stack(nodes)
    try:
        ids = account_ids(region)
        assert len(ids) == D_SHARDS * D_ROWS
        hosted = settle(regions, systems, ids)
        # the entities live on both nodes: the asks cross the wire
        assert all(hosted) and not hosted[0] & hosted[1]
        rng = np.random.default_rng(11)
        oracle: dict = {}
        for _ in range(3):
            picks = [ids[i] for i in rng.permutation(len(ids))[:32]]
            ask_round(shardings, picks, rng, oracle)
        assert device_totals(region, sorted(oracle)) == oracle
        assert batcher.stats()["asks"] == 3 * 32
        assert settle(regions, systems, ids) == hosted
    finally:
        batcher.close()


def test_reference_entity_ref_ask_of_a_typed_entity_is_not_answered(nodes):
    """The reference wraps an ask's message as it is: a typed entity sees
    no sender and the message carries no reply ref, so the ask times
    out."""
    P = package("akka_tpu")
    import akka_tpu.sharding as JS
    from akka_tpu.cluster import Cluster as JCluster
    from akka_tpu.typed import Behaviors as JB
    s = nodes.node("ref-shd", "inproc", P=P, provider="cluster",
                   cluster=CLUSTER)
    c = JCluster.get(s)
    c.join(str(s.provider.local_address))
    P.testkit.await_condition(lambda: any(
        m.status.value == "Up" for m in c.state.members), max_time=WAIT)
    seen = []
    key = JS.EntityTypeKey("Account")
    sh = JS.ClusterShardingTyped.get(s)
    sh.init(JS.Entity(key, lambda ctx: JB.receive(
        lambda _c, m: seen.append(m) or JB.same)))
    fut = sh.entity_ref_for(key, "a").ask(("add", 1.0), timeout=0.5)
    with pytest.raises(Exception, match="timed out"):
        fut.result(WAIT)
    assert seen == [("add", 1.0)]


def test_remembered_host_entities_restart_after_a_node_leaves(nodes):
    systems, clusters, region, batcher, regions, shardings = stack(
        nodes, remember_store=True)
    try:
        store = S.DDataRememberEntitiesStore(systems[0])
        ids = account_ids(region, 8)
        on_1 = settle(regions, systems, ids)[1]
        assert on_1
        rng = np.random.default_rng(11)
        oracle: dict = {}
        ask_round(shardings, ids, rng, oracle)
        dev_rows = {sh: store.remembered_rows("counter", str(sh))
                    for sh in range(D_SHARDS)}
        assert sorted(e for r in dev_rows.values() for e in r) == ids
        probes = [TestProbe(s) for s in systems]
        # node 0's replica of the host ORSets holds every Account id, with
        # no row
        await_condition(lambda: set().union(*(
            store.remembered("Account", str(sh))
            for sh in range(HOST_SHARDS))) == set(ids), max_time=WAIT)
        host_rows = {}
        for sh in range(HOST_SHARDS):
            host_rows.update(store.remembered_rows("Account", str(sh)))
        assert host_rows == dict.fromkeys(ids)

        # node 1 leaves and terminates
        leaving = str(systems[1].provider.local_address)
        clusters[1].leave(leaving)
        await_condition(lambda: leaving not in {
            m.address_str for m in clusters[0].state.members},
            max_time=WAIT)
        systems[1].terminate()
        assert systems[1].await_termination(WAIT)
        # one StartEntity per shard node 1 hosted: the rest of its ids
        # restart because they are remembered
        extract = S.make_default_extract_shard_id(HOST_SHARDS)
        kicked = {}
        for eid in sorted(on_1):
            kicked.setdefault(extract(S.StartEntity(eid)), eid)

        def home():
            # again at each poll: until the coordinator has freed node
            # 1's shards, a StartEntity may go to the dead region
            for eid in kicked.values():
                regions[0].tell(S.StartEntity(eid))
            return on_1 <= (region_entity_ids(regions[0], probes[0])
                            or set())
        await_condition(home, max_time=WAIT)
        restarted = on_1 - set(kicked.values())
        assert restarted
        assert {sh: store.remembered_rows("counter", str(sh))
                for sh in range(D_SHARDS)} == dev_rows
        # node 0 alone serves the next round
        ask_round(shardings[:1], ids, rng, oracle)
        assert device_totals(region, ids) == oracle
    finally:
        batcher.close()
