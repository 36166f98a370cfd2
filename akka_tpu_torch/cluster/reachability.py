"""Reachability table: per-observer unreachable records, merged via gossip.

A copy of `akka_tpu/cluster/reachability.py` at commit 56e9e23 (host code, no jax;
the port keeps its own copy of every module it needs).

Reference parity: akka-cluster/src/main/scala/akka/cluster/Reachability.scala —
rows of (observer, subject, status, version); a subject is unreachable if ANY
observer currently marks it unreachable; merge keeps the freshest row per
(observer, subject).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Dict, FrozenSet, Iterable, Set, Tuple

from .member import UniqueAddress


class ReachabilityStatus(Enum):
    REACHABLE = "Reachable"
    UNREACHABLE = "Unreachable"
    TERMINATED = "Terminated"


@dataclass(frozen=True)
class Record:
    observer: UniqueAddress
    subject: UniqueAddress
    status: ReachabilityStatus
    version: int


class Reachability:
    __slots__ = ("records",)

    def __init__(self, records: Iterable[Record] = ()):
        # keep only the freshest record per (observer, subject)
        table: Dict[Tuple[UniqueAddress, UniqueAddress], Record] = {}
        for r in records:
            key = (r.observer, r.subject)
            cur = table.get(key)
            if cur is None or r.version > cur.version:
                table[key] = r
        self.records = table

    def _next_version(self, observer: UniqueAddress) -> int:
        return 1 + max((r.version for (o, _), r in self.records.items()
                        if o == observer), default=0)

    def unreachable(self, observer: UniqueAddress,
                    subject: UniqueAddress) -> "Reachability":
        rec = Record(observer, subject, ReachabilityStatus.UNREACHABLE,
                     self._next_version(observer))
        return Reachability(list(self.records.values()) + [rec])

    def reachable(self, observer: UniqueAddress,
                  subject: UniqueAddress) -> "Reachability":
        rec = Record(observer, subject, ReachabilityStatus.REACHABLE,
                     self._next_version(observer))
        return Reachability(list(self.records.values()) + [rec])

    def terminated(self, observer: UniqueAddress,
                   subject: UniqueAddress) -> "Reachability":
        rec = Record(observer, subject, ReachabilityStatus.TERMINATED,
                     self._next_version(observer))
        return Reachability(list(self.records.values()) + [rec])

    def merge(self, other: "Reachability") -> "Reachability":
        return Reachability(list(self.records.values()) +
                            list(other.records.values()))

    def remove(self, nodes: Iterable[UniqueAddress]) -> "Reachability":
        gone = set(nodes)
        return Reachability(r for r in self.records.values()
                            if r.observer not in gone and r.subject not in gone)

    def is_reachable(self, subject: UniqueAddress) -> bool:
        return subject not in self.all_unreachable

    def is_reachable_by(self, observer: UniqueAddress,
                        subject: UniqueAddress) -> bool:
        r = self.records.get((observer, subject))
        return r is None or r.status is ReachabilityStatus.REACHABLE

    @property
    def all_unreachable(self) -> FrozenSet[UniqueAddress]:
        return frozenset(r.subject for r in self.records.values()
                         if r.status is not ReachabilityStatus.REACHABLE)

    def all_unreachable_from(self, observer: UniqueAddress) -> FrozenSet[UniqueAddress]:
        return frozenset(r.subject for (o, _), r in self.records.items()
                         if o == observer
                         and r.status is not ReachabilityStatus.REACHABLE)

    @property
    def is_all_reachable(self) -> bool:
        return not self.all_unreachable

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Reachability) and self.records == other.records

    def __repr__(self) -> str:
        bad = [f"{r.observer.address_str}!{r.subject.address_str}"
               for r in self.records.values()
               if r.status is not ReachabilityStatus.REACHABLE]
        return f"Reachability(unreachable=[{', '.join(bad)}])"
