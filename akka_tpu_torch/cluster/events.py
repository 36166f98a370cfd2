"""Cluster domain events published on the event stream.

A copy of `akka_tpu/cluster/events.py` at commit 56e9e23 (host code, no jax;
the port keeps its own copy of every module it needs).

Reference parity: akka-cluster/src/main/scala/akka/cluster/ClusterEvent.scala —
MemberJoined/MemberWeaklyUp/MemberUp/MemberLeft/MemberExited/MemberRemoved/
MemberDowned, UnreachableMember/ReachableMember, LeaderChanged,
CurrentClusterState snapshot for subscribe-with-initial-state.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import FrozenSet, Optional, Tuple

from .member import Member, MemberStatus, UniqueAddress


class ClusterDomainEvent:
    pass


@dataclass(frozen=True)
class MemberEvent(ClusterDomainEvent):
    member: Member


@dataclass(frozen=True)
class MemberJoined(MemberEvent):
    pass


@dataclass(frozen=True)
class MemberWeaklyUp(MemberEvent):
    pass


@dataclass(frozen=True)
class MemberUp(MemberEvent):
    pass


@dataclass(frozen=True)
class MemberLeft(MemberEvent):
    pass


@dataclass(frozen=True)
class MemberExited(MemberEvent):
    pass


@dataclass(frozen=True)
class MemberDowned(MemberEvent):
    pass


@dataclass(frozen=True)
class MemberRemoved(MemberEvent):
    previous_status: MemberStatus = MemberStatus.REMOVED


@dataclass(frozen=True)
class ReachabilityEvent(ClusterDomainEvent):
    member: Member


@dataclass(frozen=True)
class UnreachableMember(ReachabilityEvent):
    pass


@dataclass(frozen=True)
class ReachableMember(ReachabilityEvent):
    pass


@dataclass(frozen=True)
class LeaderChanged(ClusterDomainEvent):
    leader: Optional[UniqueAddress]


@dataclass(frozen=True)
class CurrentClusterState(ClusterDomainEvent):
    """Snapshot sent on subscribe (reference: ClusterEvent.CurrentClusterState)."""
    members: Tuple[Member, ...] = ()
    unreachable: FrozenSet[Member] = frozenset()
    leader: Optional[UniqueAddress] = None
    seen_by: FrozenSet[UniqueAddress] = frozenset()

    @property
    def up_members(self) -> Tuple[Member, ...]:
        return tuple(m for m in self.members if m.status is MemberStatus.UP)
