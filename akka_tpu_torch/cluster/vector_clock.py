"""Vector clocks for gossip versioning.

A copy of `akka_tpu/cluster/vector_clock.py` at commit 56e9e23 (host code, no jax;
the port keeps its own copy of every module it needs).

Reference parity: akka-cluster/src/main/scala/akka/cluster/VectorClock.scala
(:73) — node->counter map; comparisons Before/After/Same/Concurrent; merge
takes elementwise max; `:+` bumps this node's counter; pruning removes nodes.
"""

from __future__ import annotations

from enum import Enum
from typing import Dict, Mapping


class Ordering(Enum):
    BEFORE = "Before"
    AFTER = "After"
    SAME = "Same"
    CONCURRENT = "Concurrent"


class VectorClock:
    __slots__ = ("versions",)

    def __init__(self, versions: Mapping[str, int] | None = None):
        self.versions: Dict[str, int] = dict(versions or {})

    def bump(self, node: str) -> "VectorClock":
        v = dict(self.versions)
        v[node] = v.get(node, 0) + 1
        return VectorClock(v)

    def merge(self, other: "VectorClock") -> "VectorClock":
        v = dict(self.versions)
        for node, n in other.versions.items():
            if n > v.get(node, 0):
                v[node] = n
        return VectorClock(v)

    def prune(self, node: str) -> "VectorClock":
        v = dict(self.versions)
        v.pop(node, None)
        return VectorClock(v)

    def compare(self, other: "VectorClock") -> Ordering:
        lt = gt = False
        for node in set(self.versions) | set(other.versions):
            a = self.versions.get(node, 0)
            b = other.versions.get(node, 0)
            if a < b:
                lt = True
            elif a > b:
                gt = True
            if lt and gt:
                return Ordering.CONCURRENT
        if lt:
            return Ordering.BEFORE
        if gt:
            return Ordering.AFTER
        return Ordering.SAME

    def is_before(self, other: "VectorClock") -> bool:
        return self.compare(other) is Ordering.BEFORE

    def is_after(self, other: "VectorClock") -> bool:
        return self.compare(other) is Ordering.AFTER

    def is_concurrent(self, other: "VectorClock") -> bool:
        return self.compare(other) is Ordering.CONCURRENT

    def __eq__(self, other: object) -> bool:
        return isinstance(other, VectorClock) and self.compare(other) is Ordering.SAME

    def __hash__(self) -> int:
        return hash(frozenset(self.versions.items()))

    def __repr__(self) -> str:
        inner = ", ".join(f"{n}->{c}" for n, c in sorted(self.versions.items()))
        return f"VectorClock({inner})"
