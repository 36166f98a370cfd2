"""The reference's bench topologies as batched-behavior 'models'.

Port of `akka_tpu/models/baseline_benches.py`:
- ring:   every actor holds one token and forwards it to the next each step
- fan_in: 1M leaves -> 1k collectors, every leaf sending every step
  (both compile their fixed wiring to a StaticTopology by default, as the
  reference does: the ring to a roll, the fan-in to a reshape-sum;
  static=False delivers dynamically, through the ring-mailbox kernel)
- cross_shard (bench config 5): 256 logical shards x 4096 entities on a
  ShardedBatchedSystem, every token forwarded to the same slot of the next
  shard, so all traffic rides the exchange
- router (bench config 4): a RoundRobinPool of 100k routees fed by 2^20
  producers every step, as a hand-written index map (`build_router`) or
  through `routing.batched.BatchedRouter` (`build_router_api`); the
  (id + step) term keeps it off the static-topology compiler, so it
  delivers dynamically (through the ring-mailbox kernel on a card)
- ping_pong (bench config 1): two actors bouncing one token
- ring_slots, cross_shard_slots: the ring and the cross-shard ring over
  ordered per-message mailboxes (port-side additions that put the bounded
  slots mailbox on the main path)
"""

from __future__ import annotations

import numpy as np
import torch

from ..batched import BatchedSystem, Emit, behavior
from ..batched.sharded import ShardedBatchedSystem
from ..ops.segment import StaticTopology

PAYLOAD_W = 4


@behavior("ring", {"received": ((), torch.int32)})
def ring_behavior(state, inbox, ctx):
    nxt = (ctx.actor_id + 1) % ctx.n_actors
    return ({"received": state["received"] + inbox.count},
            Emit.single(nxt, inbox.sum, 1, PAYLOAD_W, when=inbox.count > 0))


def make_block_ring_behavior(n: int):
    """The ring over a block of n actors spawned first (rows 0..n-1): each
    forwards its token to (id + 1) % n. A ring spawned through a runtime
    handle wraps at its own block's end, so it never feeds the promise
    rows placed after the block (ring_behavior wraps at capacity)."""

    @behavior(f"ring{n}", {"received": ((), torch.int32)})
    def ring_n(state, inbox, ctx):
        return ({"received": state["received"] + inbox.count},
                Emit.single((ctx.actor_id + 1) % n, inbox.sum, 1, PAYLOAD_W,
                            when=inbox.count > 0))

    return ring_n


def make_fan_in_leaf(n_collectors: int = 1000):
    """Leaf behavior sending [1, 0, 0, 0] to collector `id % n_collectors`
    every step."""

    @behavior(f"leaf{n_collectors}", {}, always_on=True)
    def fan_in_leaf(state, inbox, ctx):
        dst = ctx.actor_id % n_collectors
        return {}, Emit.single(dst, [1.0, 0.0, 0.0, 0.0], 1, PAYLOAD_W,
                               when=ctx.actor_id >= n_collectors)

    return fan_in_leaf


@behavior("collector", {"total": ((), torch.float32),
                        "msgs": ((), torch.int32)})
def fan_in_collector(state, inbox, ctx):
    return ({"total": state["total"] + inbox.sum[:, 0],
             "msgs": state["msgs"] + inbox.count},
            Emit.none(ctx.actor_id.shape[0], 1, PAYLOAD_W,
                      device=ctx.actor_id.device))


def build_ring(n: int = 1 << 20, static: bool = True, delivery: str = "auto",
               device=None, **kwargs) -> BatchedSystem:
    """n-actor ring; static=True compiles its wiring (kind "shift").
    `kwargs` go to BatchedSystem (delivery_backend, payload_dtype, ...)."""
    topo = None
    if static:
        dst_table = ((np.arange(n, dtype=np.int64) + 1) % n)[:, None]
        topo = StaticTopology.from_dst_table(dst_table)
    sys = BatchedSystem(capacity=n, behaviors=[ring_behavior],
                        payload_width=PAYLOAD_W, host_inbox=8,
                        delivery=delivery, device=device, topology=topo,
                        **kwargs)
    sys.spawn_block(ring_behavior, n)
    return sys


def seed_ring_full(sys) -> None:
    """Every actor holds one token [1, 0, 0, 0] (a sharded system's tokens
    go through `seed_sharded_ring`)."""
    if isinstance(sys, ShardedBatchedSystem):
        seed_sharded_ring(sys)
        return
    n = sys.capacity
    dst = torch.arange(n, dtype=torch.int32, device=sys.device)
    payload = torch.zeros((n, PAYLOAD_W), dtype=torch.float32,
                          device=sys.device)
    payload[:, 0] = 1.0
    sys.seed_inbox(dst, payload)


def seed_sharded_ring(sys: ShardedBatchedSystem) -> None:
    """One token [1, 0, 0, 0] per actor, written straight into each shard's
    self-chunk of the exchange region: shard s's row r at inbox row
    s * m_local + spill_cap + s * pair_cap + r (on a ranked mesh, each
    rank its own shards', at their places in its block)."""
    ln, ml = sys.local_n, sys.m_local
    r = min(ln, sys.pair_cap)
    local = torch.arange(sys.local_shards, dtype=torch.int64,
                         device=sys.device)[:, None]
    shard = local + sys.shard0
    rows = torch.arange(r, dtype=torch.int64, device=sys.device)[None, :]
    idx = (local * ml + sys.spill_cap + shard * sys.pair_cap + rows) \
        .reshape(-1)
    sys.inbox_dst[idx] = (shard * ln + rows).reshape(-1).to(torch.int32)
    sys.inbox_payload[idx, 0] = 1.0
    sys.inbox_valid[idx] = True


@behavior("ring_slots", {"received": ((), torch.int32)}, inbox="slots")
def ring_slots_behavior(state, mailbox, ctx):
    """The ring over ordered mailboxes: count the slot-resident messages
    (Mailbox.fold) and forward the oldest one's payload."""
    got = mailbox.fold(torch.zeros_like(state["received"]),
                       lambda c, t, p: c + 1)
    nxt = (ctx.actor_id + 1) % ctx.n_actors
    return ({"received": state["received"] + got},
            Emit.single(nxt, mailbox.payload[:, 0], 1, PAYLOAD_W,
                        when=got > 0))


def build_ring_slots(n: int = 1 << 20, slots: int = 2, device=None,
                     **kwargs) -> BatchedSystem:
    """n-actor ring over bounded S-slot mailboxes (spill_capacity=0, the
    ring-mailbox kernel's mode). `kwargs` go to BatchedSystem."""
    sys = BatchedSystem(capacity=n, behaviors=[ring_slots_behavior],
                        payload_width=PAYLOAD_W, host_inbox=8,
                        mailbox_slots=slots, spill_capacity=0,
                        device=device, **kwargs)
    sys.spawn_block(ring_slots_behavior, n)
    return sys


def build_fan_in(n_leaves: int = 1 << 20, n_collectors: int = 1000,
                 static: bool = True, device=None,
                 **kwargs) -> BatchedSystem:
    """n_leaves leaves -> n_collectors collectors (rows [0, n_collectors)).
    Capacity rounds up to a multiple of n_collectors, as in the reference,
    so that static=True compiles the wiring to kind "mod" (a reshape-sum)
    and not "csr"; the padding rows are never spawned."""
    n = n_leaves + n_collectors
    if n % n_collectors:
        n += n_collectors - n % n_collectors
    topo = None
    if static:
        ids = np.arange(n, dtype=np.int64)
        dst_table = np.where(ids >= n_collectors, ids % n_collectors,
                             -1)[:, None]
        topo = StaticTopology.from_dst_table(dst_table)
    leaf = make_fan_in_leaf(n_collectors)
    sys = BatchedSystem(capacity=n, behaviors=[fan_in_collector, leaf],
                        payload_width=PAYLOAD_W, host_inbox=8, device=device,
                        topology=topo, **kwargs)
    sys.spawn_block(fan_in_collector, n_collectors)
    sys.spawn_block(leaf, n_leaves)
    return sys


def make_router_producer(routee_base: int, n_routees: int):
    """RoundRobinPool semantics as an index map applied at emission: each
    producer's successive messages hit successive routees. The (id +
    step) term keeps the static-topology compiler off on purpose: this
    bench measures dynamic delivery."""

    @behavior(f"producer{n_routees}", {}, always_on=True)
    def producer(state, inbox, ctx):
        dst = routee_base + (ctx.actor_id + ctx.step) % n_routees
        return {}, Emit.single(dst, [1.0, 0.0, 0.0, 0.0], 1, PAYLOAD_W,
                               when=ctx.actor_id >= routee_base + n_routees)

    return producer


@behavior("routee", {"hits": ((), torch.int32)})
def routee(state, inbox, ctx):
    return ({"hits": state["hits"] + inbox.count},
            Emit.none(ctx.actor_id.shape[0], 1, PAYLOAD_W,
                      device=ctx.actor_id.device))


def _router(producer, n_producers: int, n_routees: int, device,
            **kwargs) -> BatchedSystem:
    sys = BatchedSystem(capacity=n_routees + n_producers,
                        behaviors=[routee, producer],
                        payload_width=PAYLOAD_W, host_inbox=8,
                        device=device, **kwargs)
    sys.spawn_block(routee, n_routees)
    sys.spawn_block(producer, n_producers)
    return sys


def build_router(n_producers: int = 1 << 20, n_routees: int = 100_000,
                 device=None, **kwargs) -> BatchedSystem:
    """Bench config 4: a RoundRobin router pool of n_routees routees (rows
    [0, n_routees)), the producers (the rest) telling every step.
    `kwargs` go to BatchedSystem."""
    return _router(make_router_producer(0, n_routees), n_producers,
                   n_routees, device, **kwargs)


def make_router_api_producer(routee_base: int, n_routees: int):
    """make_router_producer's traffic through the public routing seam: the
    routee row comes from `BatchedRouter.route` (round-robin). Still
    dynamic: the step term keeps the static-topology compiler off."""
    from ..routing.batched import BatchedRouter

    router = BatchedRouter("round-robin", routee_base, n_routees)

    @behavior(f"producer-api{n_routees}", {}, always_on=True)
    def producer(state, inbox, ctx):
        dst = router.route(ctx.actor_id, ctx.step)
        return {}, Emit.single(dst, [1.0, 0.0, 0.0, 0.0], 1, PAYLOAD_W,
                               when=ctx.actor_id >= routee_base + n_routees)

    return producer


def build_router_api(n_producers: int = 1 << 20, n_routees: int = 100_000,
                     device=None, **kwargs) -> BatchedSystem:
    """build_router, but the producers emit through BatchedRouter (bench
    config 'router-api'). `kwargs` go to BatchedSystem."""
    return _router(make_router_api_producer(0, n_routees), n_producers,
                   n_routees, device, **kwargs)


def build_ping_pong(device=None, **kwargs) -> BatchedSystem:
    """Bench config 1: two actors, each forwarding what it receives to the
    other (seed one with a host tell). `kwargs` go to BatchedSystem."""

    @behavior("pp", {"hits": ((), torch.int32)})
    def pp(state, inbox, ctx):
        return ({"hits": state["hits"] + inbox.count},
                Emit.single(1 - ctx.actor_id, inbox.sum, 1, PAYLOAD_W,
                            when=inbox.count > 0))

    sys = BatchedSystem(capacity=2, behaviors=[pp], payload_width=PAYLOAD_W,
                        host_inbox=8, device=device, **kwargs)
    sys.spawn_block(pp, 2)
    return sys


def make_crossshard_behavior(local_n: int):
    """Entity forwarding its token to the same slot in the next shard:
    every message crosses the exchange."""

    @behavior("xshard", {"received": ((), torch.int32)})
    def xshard(state, inbox, ctx):
        nxt = (ctx.actor_id + local_n) % ctx.n_actors
        return ({"received": state["received"] + inbox.count},
                Emit.single(nxt, inbox.sum, 1, PAYLOAD_W,
                            when=inbox.count > 0))

    return xshard


def make_crossshard_slots_behavior(local_n: int):
    """The cross-shard entity over ordered mailboxes: count the
    slot-resident messages (Mailbox.fold) and forward the oldest one's
    payload to the same slot in the next shard."""

    @behavior("xshard_slots", {"received": ((), torch.int32)},
              inbox="slots")
    def xshard_slots(state, mailbox, ctx):
        got = mailbox.fold(torch.zeros_like(state["received"]),
                           lambda c, t, p: c + 1)
        nxt = (ctx.actor_id + local_n) % ctx.n_actors
        return ({"received": state["received"] + got},
                Emit.single(nxt, mailbox.payload[:, 0], 1, PAYLOAD_W,
                            when=got > 0))

    return xshard_slots


def _cross_shard(make, n_shards: int, entities_per_shard: int, n_devices,
                 device, **kwargs) -> ShardedBatchedSystem:
    n = n_shards * entities_per_shard
    d = 1 if n_devices is None else n_devices
    if n % d:
        n += d - n % d
    b = make(n // d)
    sys = ShardedBatchedSystem(capacity=n, behaviors=[b], n_devices=d,
                               payload_width=PAYLOAD_W,
                               host_inbox_per_shard=8, device=device,
                               **kwargs)
    sys.spawn_block(b, n)
    return sys


def build_cross_shard(n_shards: int = 256, entities_per_shard: int = 4096,
                      n_devices=None, device=None,
                      **kwargs) -> ShardedBatchedSystem:
    """Bench config 5: n_shards logical shards x entities_per_shard
    entities folded onto `n_devices` shards of the shard axis (default 1,
    one card), with cross-shard tells: every tell hops one shard, so all
    traffic rides the exchange. `kwargs` go to ShardedBatchedSystem."""
    return _cross_shard(make_crossshard_behavior, n_shards,
                        entities_per_shard, n_devices, device, **kwargs)


def build_cross_shard_slots(n_shards: int = 256,
                            entities_per_shard: int = 4096, n_devices=None,
                            slots: int = 2, device=None,
                            **kwargs) -> ShardedBatchedSystem:
    """The cross-shard ring over bounded S-slot mailboxes (spill_capacity=0,
    the ring-mailbox kernel's mode). `kwargs` go to ShardedBatchedSystem."""
    return _cross_shard(make_crossshard_slots_behavior, n_shards,
                        entities_per_shard, n_devices, device,
                        mailbox_slots=slots, spill_capacity=0, **kwargs)
