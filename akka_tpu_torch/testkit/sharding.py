"""Sharding test helpers shared by in-proc and multi-process suites.

A copy of `akka_tpu/testkit/sharding.py` at commit 5834bbc (host code, no
jax; the port keeps its own copy of every module it needs)."""

from __future__ import annotations

from typing import Optional, Set


def region_entity_ids(region, probe, timeout: float = 4.0
                      ) -> Optional[Set[str]]:
    """Poll-safe GetShardRegionState read: drain stale replies first (a
    previous poll's late answer must not desync this one), wait past the
    region's internal per-shard aggregation timeout, and return None on a
    miss so await_condition-style loops retry instead of erroring.

    The reply may legitimately be PARTIAL (the region sends what it has at
    its own timeout) — callers comparing against a full id set must treat
    a short set as 'retry', which the None-or-set contract supports."""
    from .probe import AssertionFailure
    while True:
        try:
            probe.receive_one(0.01)
        except (AssertionError, AssertionFailure):
            break
    from ..sharding import GetShardRegionState
    region.tell(GetShardRegionState(), probe.ref)
    try:
        state = probe.receive_one(timeout)
    except (AssertionError, AssertionFailure):
        return None
    ids: Set[str] = set()
    for shard in state.shards:
        ids |= set(shard.entity_ids)
    return ids
