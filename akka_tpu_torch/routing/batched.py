"""Routing logics as index maps: the batched/device tier.

Port of `akka_tpu/routing/batched.py` (commit 001ef4f). RoundRobin = iota
mod n; Random = drawn or hashed; ConsistentHash = hash of the key mod n.
They produce destination-id tensors that batched behaviors emit, so a
100k-routee RoundRobinPool routes entirely on the device (BASELINE config
4).

Where the reference's `BatchedRouter.route` is scalar JAX under vmap, the
port's takes the step's tensors: `[n]` keys, one row per actor, and the
device step scalar. It is pure tensor arithmetic (no host copy, no sync),
so a behavior that calls it stays capturable as a CUDA graph.

The hashes mix in uint32, as the reference's do, through the int64
helpers of utils/u32.py; `_fnv1a`, `consistent_hash_dst` and every logic
of `route` give routee rows bit-identical to the reference's. `random_dst`
draws from a `torch.Generator` where the reference takes a PRNG key: it
meets the same contract (shape, int32, range), not the same draws.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils.u32 import MASK32, mul32, u32

_FNV_OFFSET = 2166136261
_FNV_PRIME = 16777619
_KNUTH = 2654435761


def round_robin_dst(n_messages: int, routee_base: int, n_routees: int,
                    offset=0, device=None) -> torch.Tensor:
    """int32 [n_messages] destination ids round-robin over routees
    [routee_base, routee_base + n_routees), starting at `offset` (an int
    or a device scalar)."""
    if isinstance(offset, torch.Tensor):
        device = offset.device if device is None else device
        offset = offset.to(torch.int32)
    idx = torch.arange(n_messages, dtype=torch.int32, device=device)
    return routee_base + (idx + offset) % n_routees


def random_dst(generator: torch.Generator, n_messages: int,
               routee_base: int, n_routees: int) -> torch.Tensor:
    """int32 [n_messages] destination ids drawn uniformly from
    [routee_base, routee_base + n_routees) on the generator's device."""
    return routee_base + torch.randint(
        0, n_routees, (n_messages,), generator=generator,
        dtype=torch.int32, device=generator.device)


def _fnv1a(x) -> torch.Tensor:
    """32-bit FNV-1a-style mix of integer keys, byte by byte, as int64
    values in [0, 2^32) (the reference returns them as uint32)."""
    x = u32(x)
    h = _FNV_OFFSET
    for shift in (0, 8, 16, 24):
        h = mul32(h ^ ((x >> shift) & 0xFF), _FNV_PRIME)
    return h


def consistent_hash_dst(keys, routee_base: int,
                        n_routees: int) -> torch.Tensor:
    """Map int32 hash keys to stable routee destinations (int32)."""
    return routee_base + (_fnv1a(keys) % n_routees).to(torch.int32)


def broadcast_dst(n_routees: int, routee_base: int,
                  device=None) -> torch.Tensor:
    """All routees (use with out_degree = n_routees emissions)."""
    return routee_base + torch.arange(n_routees, dtype=torch.int32,
                                      device=device)


class BatchedRouter:
    """Router as an index map: the device tier's `Router.route` seam, a
    fan-out that never goes through a router mailbox or leaves the step.
    The logic names mirror the reference's pool types (RoundRobinPool,
    RandomPool, ConsistentHashingPool). Round-robin keys on (sender,
    step), so each producer's successive messages walk successive
    routees."""

    LOGICS = ("round-robin", "random", "consistent-hash")

    def __init__(self, logic: str, routee_base: int, n_routees: int):
        if logic not in self.LOGICS:
            raise ValueError(f"unknown routing logic {logic!r}; "
                             f"one of {self.LOGICS}")
        if n_routees <= 0:
            raise ValueError("n_routees must be > 0")
        self.logic = logic
        self.routee_base = routee_base
        self.n_routees = n_routees

    def route(self, key, step=0) -> torch.Tensor:
        """int32 routee rows, one per key. `key` identifies the sender (or
        is the hash key for consistent-hash): an int32 tensor, one row per
        actor, or a host int; `step` (a device scalar or an int) advances
        round-robin and random."""
        key = torch.as_tensor(key).to(torch.int32)
        if self.logic == "round-robin":
            if isinstance(step, torch.Tensor):
                step = step.to(torch.int32)
            idx = (key + step) % self.n_routees
        elif self.logic == "random":
            # the Knuth multiplicative constant exceeds int32: mix in uint32
            s = u32(step) if isinstance(step, torch.Tensor) \
                else int(step) & MASK32
            mixed = (mul32(u32(key), _KNUTH) + s) & MASK32
            idx = (_fnv1a(mixed) % self.n_routees).to(torch.int32)
        else:  # consistent-hash: stable in `key`, step-independent
            idx = (_fnv1a(key) % self.n_routees).to(torch.int32)
        return self.routee_base + idx
