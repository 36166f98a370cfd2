"""The reference's bench topologies as batched-behavior 'models'.

Port of `akka_tpu/models/baseline_benches.py`, dynamic delivery only (the
path the ring-mailbox kernel is on; StaticTopology is not ported yet):
- ring:   every actor holds one token and forwards it to the next each step
- fan_in: 1M leaves -> 1k collectors, every leaf sending every step
- ring_slots: the ring over ordered per-message mailboxes (a port-side
  addition that puts the bounded slots mailbox on the main path)
"""

from __future__ import annotations

import torch

from ..batched import BatchedSystem, Emit, behavior

PAYLOAD_W = 4


@behavior("ring", {"received": ((), torch.int32)})
def ring_behavior(state, inbox, ctx):
    nxt = (ctx.actor_id + 1) % ctx.n_actors
    return ({"received": state["received"] + inbox.count},
            Emit.single(nxt, inbox.sum, 1, PAYLOAD_W, when=inbox.count > 0))


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


def build_ring(n: int = 1 << 20, static: bool = False, delivery: str = "auto",
               device=None, **kwargs) -> BatchedSystem:
    """n-actor ring. `kwargs` go to BatchedSystem (delivery_backend,
    mailbox_slots, ...)."""
    if static:
        raise NotImplementedError("StaticTopology is not ported yet; "
                                  "use static=False")
    sys = BatchedSystem(capacity=n, behaviors=[ring_behavior],
                        payload_width=PAYLOAD_W, host_inbox=8,
                        delivery=delivery, device=device, **kwargs)
    sys.spawn_block(ring_behavior, n)
    return sys


def seed_ring_full(sys: BatchedSystem) -> None:
    """Every actor holds one token [1, 0, 0, 0]."""
    n = sys.capacity
    dst = torch.arange(n, dtype=torch.int32, device=sys.device)
    payload = torch.zeros((n, PAYLOAD_W), dtype=torch.float32,
                          device=sys.device)
    payload[:, 0] = 1.0
    sys.seed_inbox(dst, payload)


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
                 static: bool = False, device=None,
                 **kwargs) -> BatchedSystem:
    """n_leaves leaves -> n_collectors collectors (rows [0, n_collectors)).
    Capacity rounds up to a multiple of n_collectors, as in the reference;
    the padding rows are never spawned."""
    if static:
        raise NotImplementedError("StaticTopology is not ported yet; "
                                  "use static=False")
    n = n_leaves + n_collectors
    if n % n_collectors:
        n += n_collectors - n % n_collectors
    leaf = make_fan_in_leaf(n_collectors)
    sys = BatchedSystem(capacity=n, behaviors=[fan_in_collector, leaf],
                        payload_width=PAYLOAD_W, host_inbox=8, device=device,
                        **kwargs)
    sys.spawn_block(fan_in_collector, n_collectors)
    sys.spawn_block(leaf, n_leaves)
    return sys
