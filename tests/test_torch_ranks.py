"""The port's ranked meshes (akka_tpu_torch.parallel, over a
torch.distributed process group) against the reference (akka_tpu, D of
the conftest's 8 virtual CPU devices) and the port's one-card system, on
the CPU.

Ranks run as gloo threads of this process (tests/torch_rank_fixture.py),
each on device="cpu", building its own system inside its thread. Every
rank makes the same calls, as the reference's SPMD program does, and
every rank's reads are held to the reference's and to the one-card
system's: integer fields bit-identical, float32 within rtol 1e-4 / atol
1e-3 (ROADMAP's tolerance), on every rank. Systems hold at most 64 rows
on 4 shards, laid out as 2 ranks x 2 slots and 4 ranks x 1 slot; the
reference runs each scenario once, on 4 devices (module-scoped cache).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # tiny tensors: spare the other test workers

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec

import akka_tpu.batched as jb
import akka_tpu.persistence.slab_snapshot as j_snapshot
from akka_tpu.actor.supervision import Directive as JDirective
from akka_tpu.batched.sharded import ShardedBatchedSystem as JSharded
from akka_tpu.ddata import tensor as jt
from akka_tpu.models import baseline_benches as jbb

import torch.distributed as dist

import akka_tpu_torch.batched as tb
from akka_tpu_torch.batched import MeshAutoscaler, MeshSentinel
from akka_tpu_torch.batched.sharded import ShardedBatchedSystem as TSharded
from akka_tpu_torch.config import Config
from akka_tpu_torch.ddata import tensor as tt
from akka_tpu_torch.models import baseline_benches as tbb
from akka_tpu_torch.parallel import (ShardSlot, make_mesh, make_mesh_2d,
                                     mesh as tmesh)
from akka_tpu_torch.utils.carry import (SHARDED_FIELDS, load_numpy_carry,
                                        numpy_carry)
from torch_rank_fixture import run_ranks

RTOL, ATOL = 1e-4, 1e-3
P = 4
D = 4                        # shards of every system here
LAYOUTS = [2, 4]             # world sizes: 2 ranks x 2 slots, 4 x 1
ATT_KEYS = ("flags", "mail_dropped", "dead_letters", "step",
            "exchange_dropped")
PER_SHARD = ("mail_dropped_per_shard", "dropped_per_shard",
             "progress_per_shard")


# -------------------------------------------- behaviors, both packages

@jb.behavior("hop_slots", {"received": ((), jnp.int32),
                           "acc": ((), jnp.float32)}, inbox="slots")
def j_hop_slots(state, mb, ctx):
    got, acc = mb.fold((jnp.int32(0), jnp.float32(0)),
                       lambda c, t, p: (c[0] + 1, c[1] + p[0] * (t + 1)))
    return ({"received": state["received"] + got,
             "acc": state["acc"] + acc},
            jb.Emit.single((ctx.actor_id + 9) % ctx.n_actors, mb.payload[0],
                           1, P, when=got > 0, mtype=mb.types[0] + 1))


@tb.behavior("hop_slots", {"received": ((), torch.int32),
                           "acc": ((), torch.float32)}, inbox="slots")
def t_hop_slots(state, mb, ctx):
    got, acc = mb.fold((torch.zeros_like(state["received"]),
                        torch.zeros_like(state["acc"])),
                       lambda c, t, p: (c[0] + 1,
                                        c[1] + p[:, 0].float() * (t + 1)))
    return ({"received": state["received"] + got,
             "acc": state["acc"] + acc},
            tb.Emit.single((ctx.actor_id + 9) % ctx.n_actors,
                           mb.payload[:, 0], 1, P, when=got > 0,
                           mtype=mb.types[:, 0] + 1))


@jb.behavior("spam", {"seen": ((), jnp.int32)}, always_on=True)
def j_spam(state, inbox, ctx):
    return ({"seen": state["seen"] + inbox.count},
            jb.Emit.single(ctx.actor_id % 3, jnp.array([1, 2, 0, 0]), 1, P))


@tb.behavior("spam", {"seen": ((), torch.int32)}, always_on=True)
def t_spam(state, inbox, ctx):
    return ({"seen": state["seen"] + inbox.count},
            tb.Emit.single(ctx.actor_id % 3, [1, 2, 0, 0], 1, P))


@jb.behavior("flaky", {"acc": ((), jnp.float32), "hits": ((), jnp.int32)},
             supervisor=jb.LaneSupervisor(JDirective.RESTART,
                                          max_nr_of_retries=1,
                                          min_backoff_steps=1,
                                          max_backoff_steps=2))
def j_flaky(state, inbox, ctx):
    fail = (ctx.actor_id % 9 == 4) & (state["hits"] >= 1)
    return ({"acc": state["acc"] + inbox.sum[0],
             "hits": state["hits"] + inbox.count, "_failed": fail},
            jb.Emit.single((ctx.actor_id + 7) % ctx.n_actors, inbox.sum, 1,
                           P, when=inbox.count > 0))


@tb.behavior("flaky", {"acc": ((), torch.float32), "hits": ((), torch.int32)},
             supervisor=tb.LaneSupervisor(tb.Directive.RESTART,
                                          max_nr_of_retries=1,
                                          min_backoff_steps=1,
                                          max_backoff_steps=2))
def t_flaky(state, inbox, ctx):
    fail = (ctx.actor_id % 9 == 4) & (state["hits"] >= 1)
    return ({"acc": state["acc"] + inbox.sum[:, 0],
             "hits": state["hits"] + inbox.count, "_failed": fail},
            tb.Emit.single((ctx.actor_id + 7) % ctx.n_actors, inbox.sum, 1,
                           P, when=inbox.count > 0))


# --------------------------------------------------------------- scenarios
# A scenario: (reference behaviors, port behaviors, capacity, system
# kwargs (both packages; `jdtype`/`tdtype` the payload dtype), script).
# The script drives a system with public calls and calls `snap(s, tag)`
# at each checkpoint; every call is one every rank makes alike.

def steps(s, n):
    """n single-step runs (the reference compiles one program per run
    length; one length keeps its compiles few)."""
    for _ in range(n):
        s.run(1)


def _strays(s):
    """Rows addressed outside their shard (a rebalance moved their
    recipients), written into the global carry."""
    c = numpy_carry(s) if isinstance(s, TSharded) else jax_carry(s)
    ml, sc = s.m_local, s.spill_cap
    for shard, row, dst in ((0, 0, 9), (0, 1, 30), (3, 2, 1), (2, 0, 8)):
        i = shard * ml + sc + row
        c["inbox_dst"][i] = dst
        c["inbox_payload"][i] = [2.0 + row, 0, 0, 0]
        c["inbox_valid"][i] = True
    if isinstance(s, TSharded):
        load_numpy_carry(s, c)
    else:
        load_jax_carry(s, c)


def ring_stray(s, snap):
    """The cross-shard ring (every token crosses a shard), a host tell,
    then stray rows forwarded in the hand-off step, which is entered and
    left."""
    seed = jbb.seed_ring_full if isinstance(s, JSharded) else \
        tbb.seed_ring_full
    seed(s)
    steps(s, 2)
    snap(s, "seeded, 2 steps")
    s.tell(17, [5.0, 0, 0, 0])
    s.run(1)
    _strays(s)
    s.enter_stray_mode()
    snap(s, "stray mode entered")
    exits = [s.exit_stray_mode()]
    while not exits[-1] and len(exits) < 5:
        s.run(1)
        exits.append(s.exit_stray_mode())
    assert exits[0] is False and exits[-1] is True, exits
    steps(s, 2)
    snap(s, f"stray mode left: {exits}")


def slots_bf16(s, snap):
    """Bounded 2-slot mailboxes (spill_capacity=0, K2's mode), bf16
    payloads, typed messages riding the exchange."""
    for dst in (0, 1, 9, 9, 9, 20, 31, 0):
        s.tell(dst, [float(dst % 5 + 1), 0, 0, 0], 1)
    steps(s, 3)
    snap(s, "bounded slots")
    s.tell(5, [3.0, 0, 0, 0], 2)
    steps(s, 2)
    snap(s, "bounded slots, more")


def overflow_int32(s, snap):
    """A pair capacity of 2: every shard sends its rows to shard 0, int32
    payloads."""
    steps(s, 2)
    snap(s, "overflowed")
    assert s.total_dropped > 0
    s.run(1)
    snap(s, "overflowed again")


def supervised(s, snap):
    """In-step supervision, the metric slab, the latch bit and the host
    fault helpers."""
    for i in range(0, 64, 3):
        s.tell(i, [1.0, 0, 0, 0])
    s.run(1)
    steps(s, 3)
    snap(s, "four steps")
    assert s.supervision_counts["failed"] > 0
    assert s.read_attention()["any_latched"]
    s.clear_failed([4])
    s.stop_block([5, 6])
    s.restart_rows([13], {"acc": 2.5})
    s.run(1)
    snap(s, "host helpers")


def _xshard(pkg):
    return (jbb if pkg == "j" else tbb).make_crossshard_behavior(64 // D)


SCENARIOS = {
    "ring_stray": (lambda: [_xshard("j")], lambda: [_xshard("t")], 64,
                   dict(reroute_strays=True, host_inbox_per_shard=8),
                   ring_stray),
    "slots_bf16": (lambda: [j_hop_slots], lambda: [t_hop_slots], 64,
                   dict(mailbox_slots=2, spill_capacity=0,
                        host_inbox_per_shard=8, jdtype=jnp.bfloat16,
                        tdtype=torch.bfloat16), slots_bf16),
    "overflow_int32": (lambda: [j_spam], lambda: [t_spam], 64,
                       dict(remote_capacity_per_pair=2, jdtype=jnp.int32,
                            tdtype=torch.int32), overflow_int32),
    "supervised": (lambda: [j_flaky], lambda: [t_flaky], 64,
                   dict(metrics_enabled=True, attention_latch_col="hits"),
                   supervised),
}


# ------------------------------------------------------------ observations

def jax_carry(s):
    out = {f"state/{c}": np.array(jax.device_get(v))
           for c, v in s.state.items()}
    for f in SHARDED_FIELDS:
        out[f] = np.array(jax.device_get(getattr(s, f)))
    out["host/next_row"] = np.asarray(s._next_row, np.int64)
    out["host/step"] = np.asarray(s._host_step, np.int64)
    return out


def load_jax_carry(s, arrays):
    shard = NamedSharding(s.mesh, PartitionSpec(s.axis))
    s.state = {c: jax.device_put(jnp.asarray(arrays[f"state/{c}"]), shard)
               for c in s.state}
    for f in SHARDED_FIELDS:
        spec = shard if f != "step_count" else \
            NamedSharding(s.mesh, PartitionSpec())
        setattr(s, f, jax.device_put(jnp.asarray(arrays[f]), spec))


def observe(s, tag):
    """Everything a caller reads (on a ranked system, each read is a
    collective every rank makes alike)."""
    port = isinstance(s, TSharded)
    words = s.read_attention()
    out = {"tag": tag,
           "carry": numpy_carry(s) if port else jax_carry(s),
           "att": [words[k] for k in ATT_KEYS],
           "per_shard": [np.asarray(words[k]) for k in PER_SHARD],
           "dropped": np.asarray(s.dropped_per_shard),
           "mailbox": np.asarray(s.mailbox_overflow_per_shard),
           "totals": (s.total_dropped, s.mailbox_overflow),
           "sup": s.supervision_counts,
           "failed": np.asarray(s.failed_rows())}
    if s.metrics_on:
        out["metrics"] = {k: np.asarray(v)
                          for k, v in s.read_metrics().items()}
    return out


def assert_same(want, got, ctx):
    assert want["tag"] == got["tag"], ctx
    ctx = f"{ctx} [{got['tag']}]"
    w, g = want["carry"], got["carry"]
    assert sorted(w) == sorted(g), ctx
    for k in w:
        a, b = np.asarray(w[k]), np.asarray(g[k])
        assert a.shape == b.shape, (ctx, k, a.shape, b.shape)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{ctx} {k}")
        else:
            np.testing.assert_array_equal(b, a, err_msg=f"{ctx} {k}")
    assert got["att"] == want["att"], ctx
    for a, b in zip(want["per_shard"], got["per_shard"]):
        np.testing.assert_array_equal(b, a, err_msg=ctx)
    for k in ("dropped", "mailbox", "failed"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{ctx} {k}")
    assert got["totals"] == want["totals"], ctx
    assert got["sup"] == want["sup"], ctx
    assert sorted(got.get("metrics", {})) == sorted(want.get("metrics", {}))
    for k, v in want.get("metrics", {}).items():
        np.testing.assert_array_equal(got["metrics"][k], v,
                                      err_msg=f"{ctx} metrics {k}")


def drive(s, script):
    snaps = []
    script(s, lambda x, tag: snaps.append(observe(x, tag)))
    return snaps


def build(pkg, name, mesh=None, backend=None):
    jbeh, tbeh, cap, kw, _ = SCENARIOS[name]
    kw = dict(kw)
    jdt, tdt = kw.pop("jdtype", jnp.float32), kw.pop("tdtype", torch.float32)
    if pkg == "j":
        s = JSharded(capacity=cap, behaviors=jbeh(), n_devices=D,
                     payload_width=P, payload_dtype=jdt, **kw)
        b = s.behaviors[0]
    else:
        s = TSharded(capacity=cap, behaviors=tbeh(), mesh=mesh, n_devices=D,
                     payload_width=P, payload_dtype=tdt, device="cpu",
                     delivery_backend=backend, **kw)
        b = s.behaviors[0]
    s.spawn_block(b, cap)
    return s


_REFERENCE = {}


@pytest.fixture(scope="module")
def reference():
    """The reference's run of each scenario on 4 devices, once."""
    def get(name):
        if name not in _REFERENCE:
            _REFERENCE[name] = drive(build("j", name), SCENARIOS[name][4])
        return _REFERENCE[name]
    return get


# ------------------------------------------------------- the system, ranks

# both delivery backends' CPU paths (ops/segment.py) where delivery is
# the scenario's subject: K1's plain version ("cuda") and the ranked
# kernels in reduce mode, K2's and the ranked kernels in bounded slots
CASES = [("ring_stray", "cuda"), ("ring_stray", "ranked"),
         ("slots_bf16", "cuda"), ("slots_bf16", "ranked"),
         ("overflow_int32", "cuda"), ("supervised", "cuda")]


@pytest.mark.parametrize("world", LAYOUTS, ids=lambda w: f"w{w}")
@pytest.mark.parametrize("name,backend", CASES,
                         ids=[f"{n}-{b}" for n, b in CASES])
def test_ranked_system_matches_reference_and_one_card(name, backend, world,
                                                      reference):
    """The same scenario on the reference (4 devices), the port's one-card
    4-slot system and W gloo ranks of D / W slots each: every rank reads
    the same carry, attention words, drops, supervision counts and
    metric slab as both."""
    want = reference(name)
    script = SCENARIOS[name][4]
    one_card = drive(build("t", name, backend=backend), script)
    for w, g in zip(want, one_card):
        assert_same(w, g, f"{name} one card")

    def rank(r, group):
        mesh = make_mesh(D, device="cpu", group=group)
        s = build("t", name, mesh=mesh, backend=backend)
        assert (s.local_shards, s.shard0) == (D // world, r * D // world)
        assert s.state[next(iter(s.state))].shape[0] == 64 // world
        return drive(s, script)

    for r, snaps in enumerate(run_ranks(world, rank, f"{name}-{backend}-"
                                        f"{world}")):
        assert len(snaps) == len(want)
        for w, g in zip(want, snaps):
            assert_same(w, g, f"{name} {backend} rank {r}/{world}")


# ------------------------------------------------------------ carried state

@pytest.fixture
def npz_reference(monkeypatch):
    """The reference writes `.npz` snapshots (its orbax path off)."""
    monkeypatch.setattr(j_snapshot, "_try_orbax", lambda: None)


def test_reference_snapshot_restores_onto_ranks(tmp_path, npz_reference):
    """A snapshot the reference wrote on 4 devices restores onto 2 ranks x
    2 slots, which run on equal to the reference."""
    ref = build("j", "ring_stray")
    jbb.seed_ring_full(ref)
    ref.run(3)
    path = ref.checkpoint(str(tmp_path))
    ref.run(3)
    want = observe(ref, "after")

    def rank(r, group):
        s = build("t", "ring_stray", mesh=make_mesh(D, device="cpu",
                                                    group=group))
        assert s.restore(path) == 3
        steps(s, 3)
        return observe(s, "after")

    for r, got in enumerate(run_ranks(2, rank, "ref-to-ranks")):
        assert_same(want, got, f"reference snapshot, rank {r}")


def test_ranked_snapshot_restores_into_one_card_and_reference(
        tmp_path, npz_reference):
    """A snapshot written from 2 ranks (rank 0 writes the global tree)
    restores into the port's one-card system and into the reference, and
    all three run on equal; re-sharded onto 4 ranks x 1 slot from a
    2-shard one-card snapshot, ranks run on equal to the one-card 4-shard
    system restored from it."""
    d = str(tmp_path / "ranked")

    def rank(r, group):
        s = build("t", "ring_stray", mesh=make_mesh(D, device="cpu",
                                                    group=group))
        tbb.seed_ring_full(s)
        steps(s, 3)
        path = s.checkpoint(d)
        steps(s, 2)
        return path, observe(s, "after")

    outs = run_ranks(2, rank, "ranks-to-one")
    path = outs[0][0]
    assert [p for p, _ in outs] == [path, path]
    one, ref = build("t", "ring_stray"), build("j", "ring_stray")
    assert one.restore(path) == 3
    assert ref.restore(path) == 3
    for s in (one, ref):
        steps(s, 2)
    want = observe(ref, "after")
    assert_same(want, observe(one, "after"), "ranked snapshot, one card")
    for r, (_, got) in enumerate(outs):
        assert_same(want, got, f"ranked snapshot, rank {r}")

    two = TSharded(capacity=64, behaviors=[_xshard_for(2)], n_devices=2,
                   payload_width=P, host_inbox_per_shard=8, device="cpu")
    two.spawn_block(0, 64)
    tbb.seed_ring_full(two)
    two.run(2)
    path2 = two.checkpoint(str(tmp_path / "two"))

    def resharded(group=None):
        s = TSharded(capacity=64, behaviors=[_xshard_for(2)],
                     mesh=make_mesh(D, device="cpu", group=group),
                     payload_width=P, host_inbox_per_shard=8, device="cpu")
        s.spawn_block(0, 64)
        assert s.restore(path2) == 2
        steps(s, 3)
        return observe(s, "resharded")

    want = resharded()
    for r, got in enumerate(run_ranks(4, lambda r, g: resharded(g),
                                      "reshard")):
        assert_same(want, got, f"re-sharded 2 -> 4 ranks, rank {r}")


def _xshard_for(d):
    """The cross-shard entity of a 64-row system on d shards (every token
    hops 64 / d rows)."""
    return tbb.make_crossshard_behavior(64 // d)


# ------------------------------------------------------------------ banks

RNG = np.random.default_rng(18)


def _banks():
    """A uint32 max bank, a PN pair and an "or" set, one replica per
    device of 4, each replica different."""
    g = RNG.integers(0, 2 ** 32, (D, 16, 3), dtype=np.uint64) \
        .astype(np.uint32)
    pn = RNG.integers(0, 2 ** 32, (D, 8, 2, 3), dtype=np.uint64) \
        .astype(np.uint32)
    gs = RNG.random((D, 8, 5)) < 0.3
    return {"gcounter": (g, "max"), "pncounter": (pn, "max"),
            "gset": (gs, "or")}


def _torch_bank(a: np.ndarray) -> torch.Tensor:
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32).copy()).view(torch.uint32)
    return torch.from_numpy(a.copy())


def _host(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.uint32:
        return t.view(torch.int32).numpy().view(np.uint32)
    return t.numpy()


def test_banks_converge_across_ranks():
    """converge_over_mesh across 4 ranks (one replica each) equals the
    reference's one pmax over 4 devices, in the reference's dtypes;
    replicate_bank lays each rank's replica out on its card; the values
    (gcounter_value, pncounter_value) agree."""
    banks = _banks()
    jmesh = jax.sharding.Mesh(np.asarray(jax.devices()[:D]), ("replica",))
    want = {}
    for name, (a, op) in banks.items():
        stacked = jax.device_put(
            jnp.asarray(a), NamedSharding(jmesh, PartitionSpec("replica")))
        want[name] = np.asarray(jax.device_get(
            jt.converge_over_mesh(stacked, jmesh, op=op)))
    rep = np.asarray(jax.device_get(jt.replicate_bank(
        jnp.asarray(banks["gcounter"][0][1]), jmesh)))

    def rank(r, group):
        mesh = make_mesh(D, axis_name="replica", device="cpu", group=group)
        out = {}
        for name, (a, op) in banks.items():
            local = _torch_bank(a[r:r + 1])
            out[name] = _host(tt.converge_over_mesh(local, mesh, op=op))
        out["replicated"] = _host(tt.replicate_bank(
            _torch_bank(banks["gcounter"][0][1]), mesh))
        out["g_value"] = _host(tt.gcounter_value(
            _torch_bank(out["gcounter"][0])))
        out["pn_value"] = tt.pncounter_value(
            _torch_bank(out["pncounter"][0])).numpy()
        return out

    for r, got in enumerate(run_ranks(D, rank, "banks")):
        for name in banks:
            assert got[name].dtype == want[name].dtype, name
            np.testing.assert_array_equal(got[name], want[name][r:r + 1],
                                          err_msg=f"{name} rank {r}")
        np.testing.assert_array_equal(got["replicated"], rep[r:r + 1])
        np.testing.assert_array_equal(got["g_value"], np.asarray(
            jt.gcounter_value(jnp.asarray(want["gcounter"][0]))))
        np.testing.assert_array_equal(got["pn_value"], np.asarray(
            jt.pncounter_value(jnp.asarray(want["pncounter"][0]))))


def test_banks_over_a_2d_mesh_of_ranks():
    """make_mesh_2d lays the replica axis across the group's ranks: 2
    ranks x 2 replicas each, merged locally, then across ranks."""
    a, _ = _banks()["gcounter"]
    want = a.max(axis=0)

    def rank(r, group):
        mesh = make_mesh_2d(1, D, ("shards", "replica"), device="cpu",
                            group=group)
        assert [s.rank for s in mesh.slots] == [0, 0, 1, 1]
        assert mesh.local_slots == mesh.slots[2 * r:2 * r + 2]
        return _host(tt.converge_over_mesh(_torch_bank(a[2 * r:2 * r + 2]),
                                           mesh))

    for r, got in enumerate(run_ranks(2, rank, "banks-2d")):
        np.testing.assert_array_equal(got, np.stack([want, want]))


# ---------------------------------------------------------------- meshes

def test_ranked_mesh_layout_and_refusals():
    """A group's slots are ordered by rank, each rank holding as many;
    Mesh.device is this rank's card; slots of several ranks without a
    group, an uneven split, or a rank whose slots lie on two cards are
    refused."""
    def rank(r, group):
        m = make_mesh(6, device="cpu", group=group)
        with pytest.raises(ValueError, match="divide"):
            make_mesh(5, device="cpu", group=group)
        with pytest.raises(ValueError, match="ordered by rank"):
            make_mesh(devices=[ShardSlot(0, torch.device("cpu"), 1),
                               ShardSlot(1, torch.device("cpu"), 0)],
                      group=group)
        two = make_mesh(devices=[
            ShardSlot(0, torch.device("cuda", 0), 0),
            ShardSlot(1, torch.device("cuda", 1), 0),
            ShardSlot(2, torch.device("cpu"), 1),
            ShardSlot(3, torch.device("cpu"), 1)], group=group)
        if r == 0:
            with pytest.raises(NotImplementedError,
                               match="one card per process"):
                two.device
        else:
            assert two.device == torch.device("cpu")
        return ([s.rank for s in m.slots], m.local_slots, m.rank,
                m.world_size, m.device, m.ranks.backend)

    cpu = torch.device("cpu")
    out = run_ranks(2, rank, "mesh")
    for r, (ranks, local, rk, w, dev, backend) in enumerate(out):
        assert ranks == [0, 0, 0, 1, 1, 1]
        assert local == tuple(ShardSlot(i, cpu, r)
                              for i in range(3 * r, 3 * r + 3))
        assert (rk, w, dev, backend) == (r, 2, cpu, "gloo")
    with pytest.raises(ValueError, match="process group"):
        make_mesh(devices=[ShardSlot(0, cpu), ShardSlot(1, cpu, 1)])


def test_failover_across_ranks_is_a10_3(tmp_path):
    """The sentinel, the autoscaler's pool, the region's failover and its
    wall-clock wave formers (the continuous scheduler, the ask batcher)
    over a mesh of ranks raise naming ROADMAP A10.3; a rank whose own slots lie
    on two cards raises naming the one-process-per-card rule."""
    from akka_tpu_torch.gateway import counter_behavior
    from akka_tpu_torch.sharding import (AskBatcher,
                                         ContinuousWaveScheduler,
                                         DeviceEntity, DeviceShardRegion)
    cpu = torch.device("cpu")

    def rank(r, group):
        mesh = make_mesh(2, device="cpu", group=group)
        with pytest.raises(NotImplementedError, match="A10.3"):
            MeshSentinel(16, [t_spam], checkpoint_dir=str(tmp_path / "s"),
                         devices=list(mesh.slots))
        region = DeviceShardRegion(DeviceEntity(
            "c", counter_behavior(P), n_shards=2, entities_per_shard=8,
            payload_width=P), mesh=mesh, device="cpu")
        region.attach_journal(str(tmp_path / "r"))
        region.checkpoint()
        with pytest.raises(NotImplementedError, match="A10.3"):
            region.failover(list(mesh.local_slots))
        with pytest.raises(NotImplementedError, match="A10.3"):
            ContinuousWaveScheduler(region)
        with pytest.raises(NotImplementedError, match="A10.3"):
            AskBatcher(region)
        return r

    assert run_ranks(2, rank, "a10-3") == [0, 1]
    one = MeshSentinel(16, [t_spam], checkpoint_dir=str(tmp_path / "one"),
                       n_devices=2, payload_width=P, device="cpu")
    try:
        with pytest.raises(NotImplementedError, match="A10.3"):
            MeshAutoscaler(one, device_pool=[ShardSlot(0, cpu),
                                             ShardSlot(1, cpu, 1)])
        with pytest.raises(NotImplementedError,
                           match="one card per process"):
            MeshAutoscaler(one, device_pool=[
                ShardSlot(0, torch.device("cuda", 0)),
                ShardSlot(1, torch.device("cuda", 1))])
    finally:
        one.shutdown()
    with pytest.raises(NotImplementedError, match="one card per process"):
        TSharded(capacity=8, behaviors=[t_spam], mesh=make_mesh(devices=[
            ShardSlot(0, torch.device("cuda", 0)),
            ShardSlot(1, torch.device("cuda", 1))]), device="cpu")


# ------------------------------------------------------------------ init

@pytest.fixture
def recorded_init(monkeypatch):
    """dist.init_process_group and destroy_process_group record their
    arguments instead of binding a socket or setting a default group; the
    module's flag starts (and is left) clear."""
    calls = []
    monkeypatch.setattr(tmesh, "_distributed_initialized", False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: calls.append(("init", a, kw)))
    monkeypatch.setattr(dist, "destroy_process_group",
                        lambda *a, **kw: calls.append(("destroy",)))
    monkeypatch.setattr(dist, "is_initialized",
                        lambda: sum(c[0] == "init" for c in calls)
                        > sum(c[0] == "destroy" for c in calls))
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    yield calls
    assert not dist.distributed_c10d.GroupMember.WORLD, \
        "a default process group was left behind"


def test_initialize_distributed_is_idempotent(recorded_init, monkeypatch):
    """One init_process_group over tcp://<address> (gloo for the CPU),
    True the first time, False after; the process id and count fall back
    to RANK and WORLD_SIZE; no address is torch's env://; CUDA without a
    card raises before anything is initialized; shutdown destroys it."""
    calls = recorded_init
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.initialize_distributed("127.0.0.1:29500", 2, 0)
    with pytest.raises(ValueError, match="RANK"):
        tmesh.initialize_distributed("127.0.0.1:29500", 2, device="cpu")
    assert calls == []
    assert tmesh.initialize_distributed("127.0.0.1:29500", 2, 1,
                                        device="cpu")
    assert not tmesh.initialize_distributed("127.0.0.1:29500", 2, 1,
                                            device="cpu")
    assert calls == [("init", ("gloo",), {
        "init_method": "tcp://127.0.0.1:29500", "world_size": 2,
        "rank": 1})]
    assert tmesh.shutdown_distributed()
    assert not tmesh.shutdown_distributed()
    assert calls[1:] == [("destroy",)]
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert tmesh.initialize_distributed(None, device="cpu")
    assert calls[2] == ("init", ("gloo",), {
        "init_method": "env://", "world_size": 4, "rank": 3})
    assert tmesh.shutdown_distributed()


def test_config_hook_reads_the_references_keys(recorded_init):
    """maybe_initialize_distributed_from_config: a disabled (or absent)
    config reaches nothing; an enabled one initializes once with the
    reference's keys and the port's `device`."""
    calls = recorded_init
    assert not tmesh.maybe_initialize_distributed_from_config(None)
    assert not tmesh.maybe_initialize_distributed_from_config(Config(
        {"akka": {"jax-distributed": {"enabled": False,
                                      "coordinator-address": "x:1"}}}))
    assert calls == []
    cfg = Config({"akka": {"jax-distributed": {
        "enabled": True, "coordinator-address": "127.0.0.1:4000",
        "num-processes": 3, "process-id": 2, "device": "cpu"}}})
    assert tmesh.maybe_initialize_distributed_from_config(cfg)
    assert not tmesh.maybe_initialize_distributed_from_config(cfg)
    assert calls == [("init", ("gloo",), {
        "init_method": "tcp://127.0.0.1:4000", "world_size": 3,
        "rank": 2})]
    assert tmesh.shutdown_distributed()


def test_rank_group_wire_dtypes():
    """The collectives' wire: uint32 travels as its int32 bits through
    all_to_all and all_gather (gloo refuses uint32), and all_reduce of
    uint32 is refused (banks reduce an int64 copy)."""
    def rank(r, group):
        g = make_mesh(2, device="cpu", group=group).ranks
        src = torch.tensor([r, 2 ** 31 + r, 7, 2 ** 32 - 1 - r],
                           dtype=torch.int64).to(torch.uint32)
        out = torch.empty_like(src)
        g.all_to_all(out, src)
        gathered = g.all_gather(src)
        with pytest.raises(TypeError, match="uint32"):
            g.all_reduce(src)
        flags = g.any(torch.tensor([r == 1, False]))
        return (out.to(torch.int64).tolist(),
                gathered.to(torch.int64).tolist(), flags.tolist())

    out = run_ranks(2, rank, "wire")
    assert out[0][0] == [0, 2 ** 31, 1, 2 ** 31 + 1]
    assert out[1][0] == [7, 2 ** 32 - 1, 7, 2 ** 32 - 2]
    assert out[0][1] == out[1][1] == [0, 2 ** 31, 7, 2 ** 32 - 1,
                                      1, 2 ** 31 + 1, 7, 2 ** 32 - 2]
    assert out[0][2] == out[1][2] == [True, False]

