"""Version vectors: causality tracking for CRDTs.

A copy of `akka_tpu/ddata/version_vector.py` at commit c056b95 (host code,
no jax; the port keeps its own copy of every module it needs).

Reference parity: akka-distributed-data/src/main/scala/akka/cluster/ddata/
VersionVector.scala — node -> monotonically increasing counter; compare
yields Before / After / Same / Concurrent; `+` increments this node's entry;
merge is the pairwise max. The reference specialises One/ManyVersionVector
for allocation; here a single immutable dict-backed class suffices (the host
control plane is not the hot path — bulk CRDT merges ride the tensor kernels
in akka_tpu_torch/ddata/tensor.py instead).
"""

from __future__ import annotations

import itertools
from enum import Enum
from typing import Dict, Iterable, Optional, Tuple


class Ordering(Enum):
    BEFORE = "Before"
    AFTER = "After"
    SAME = "Same"
    CONCURRENT = "Concurrent"


_counter = itertools.count(1)


class VersionVector:
    """Immutable version vector (reference: VersionVector.scala:73)."""

    __slots__ = ("versions",)

    def __init__(self, versions: Optional[Dict[str, int]] = None):
        object.__setattr__(self, "versions", dict(versions or {}))

    def __setattr__(self, *a):  # immutability guard
        raise AttributeError("VersionVector is immutable")

    def __getstate__(self):  # pickle despite the immutability guard
        return self.versions

    def __setstate__(self, state):
        object.__setattr__(self, "versions", state)

    @staticmethod
    def empty() -> "VersionVector":
        return _EMPTY

    @staticmethod
    def one(node: str, version: int) -> "VersionVector":
        return VersionVector({node: version})

    def is_empty(self) -> bool:
        return not self.versions

    def increment(self, node: str) -> "VersionVector":
        """`+`: bump `node`'s counter (reference uses a global monotonic
        timestamp to keep increments unique across merges; a per-node
        monotonic counter has the same causal properties)."""
        v = dict(self.versions)
        v[node] = max(v.get(node, 0), next(_counter))
        return VersionVector(v)

    def version_at(self, node: str) -> int:
        return self.versions.get(node, 0)

    def contains(self, node: str) -> bool:
        return node in self.versions

    def merge(self, other: "VersionVector") -> "VersionVector":
        v = dict(self.versions)
        for node, n in other.versions.items():
            if v.get(node, 0) < n:
                v[node] = n
        return VersionVector(v)

    def compare_to(self, other: "VersionVector") -> Ordering:
        lt = gt = False
        for node in set(self.versions) | set(other.versions):
            a, b = self.versions.get(node, 0), other.versions.get(node, 0)
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

    def is_before(self, other: "VersionVector") -> bool:
        return self.compare_to(other) == Ordering.BEFORE

    def is_after(self, other: "VersionVector") -> bool:
        return self.compare_to(other) == Ordering.AFTER

    def is_same(self, other: "VersionVector") -> bool:
        return self.compare_to(other) == Ordering.SAME

    def is_concurrent(self, other: "VersionVector") -> bool:
        return self.compare_to(other) == Ordering.CONCURRENT

    def prune(self, removed: str, collapse_into: str) -> "VersionVector":
        """Move `removed`'s entry onto `collapse_into` (RemovedNodePruning)."""
        if removed not in self.versions:
            return self
        v = dict(self.versions)
        v.pop(removed)
        out = VersionVector(v)
        return out.increment(collapse_into)

    def needs_pruning_from(self, removed: str) -> bool:
        return removed in self.versions

    def nodes(self) -> Iterable[str]:
        return self.versions.keys()

    def __eq__(self, other):
        return isinstance(other, VersionVector) and self.versions == other.versions

    def __hash__(self):
        return hash(tuple(sorted(self.versions.items())))

    def __repr__(self):
        inner = ", ".join(f"{n} -> {v}" for n, v in sorted(self.versions.items()))
        return f"VersionVector({inner})"


_EMPTY = VersionVector()
