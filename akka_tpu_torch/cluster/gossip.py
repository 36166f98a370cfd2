"""Gossip state: members + seen-set + reachability, versioned by vector clock.

A copy of `akka_tpu/cluster/gossip.py` at commit 56e9e23 (host code, no jax;
the port keeps its own copy of every module it needs). One repair:
`leader()` falls back to the lowest reachable Exiting member when no
member of a leader status is left (Akka's MembershipState.leaderOf takes
any reachable member that is not Down), so that members who all leave at
once are removed; the reference's stay Exiting, and each waits out the 5 s
bound of its leave at shutdown.

Reference parity: akka-cluster/src/main/scala/akka/cluster/Gossip.scala
(members sorted set, overview.seen, overview.reachability, version) and
MembershipState.convergence (cluster/MembershipState.scala:56): convergence
when every Up/Leaving member has seen this gossip version and no members are
unreachable (unreachable Down/Exiting members don't block).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import FrozenSet, Iterable, Optional, Tuple

from .member import Member, MemberStatus, UniqueAddress
from .reachability import Reachability
from .vector_clock import Ordering, VectorClock

# statuses counted for convergence seen-set (reference: Gossip.convergence)
_CONVERGENCE_STATUSES = {MemberStatus.UP, MemberStatus.LEAVING}
# statuses whose unreachability doesn't block convergence
_CONVERGENCE_SKIP_UNREACHABLE = {MemberStatus.DOWN, MemberStatus.EXITING}


@dataclass(frozen=True)
class Gossip:
    members: Tuple[Member, ...] = ()
    seen: FrozenSet[UniqueAddress] = frozenset()
    reachability: Reachability = field(default_factory=Reachability)
    version: VectorClock = field(default_factory=VectorClock)
    # removed members, kept so merges with stale gossip can't resurrect them
    # (reference: Gossip.tombstones, Gossip.scala)
    tombstones: FrozenSet[UniqueAddress] = frozenset()

    # -- membership ----------------------------------------------------------
    def member(self, node: UniqueAddress) -> Optional[Member]:
        for m in self.members:
            if m.unique_address == node:
                return m
        return None

    def has_member(self, node: UniqueAddress) -> bool:
        return self.member(node) is not None

    def with_member(self, member: Member) -> "Gossip":
        if member.unique_address in self.tombstones:
            return self
        others = tuple(m for m in self.members if m != member)
        return replace(self, members=tuple(sorted(others + (member,))))

    def without_member(self, member: Member) -> "Gossip":
        return replace(
            self,
            members=tuple(m for m in self.members if m != member),
            seen=frozenset(s for s in self.seen if s != member.unique_address),
            reachability=self.reachability.remove([member.unique_address]),
            version=self.version.prune(_vnode(member.unique_address)),
            tombstones=self.tombstones | {member.unique_address})

    # -- seen-set ------------------------------------------------------------
    def seen_by(self, node: UniqueAddress) -> "Gossip":
        return replace(self, seen=self.seen | {node})

    def only_seen_by(self, node: UniqueAddress) -> "Gossip":
        return replace(self, seen=frozenset({node}))

    # -- versioning ----------------------------------------------------------
    def bump(self, node: UniqueAddress) -> "Gossip":
        return replace(self, version=self.version.bump(_vnode(node)))

    def merge(self, other: "Gossip") -> "Gossip":
        """(reference: Gossip.merge — vclock merge, member union keeping the
        'larger' lifecycle status, reachability merge, empty seen)"""
        version = self.version.merge(other.version)
        tombstones = self.tombstones | other.tombstones
        by_addr = {}
        for m in self.members + other.members:
            if m.unique_address in tombstones:
                continue
            cur = by_addr.get(m.unique_address)
            by_addr[m.unique_address] = m if cur is None else _pick_highest(cur, m)
        members = tuple(sorted(by_addr.values()))
        return Gossip(members=members, seen=frozenset(),
                      reachability=self.reachability.merge(
                          other.reachability).remove(tombstones),
                      version=version, tombstones=tombstones)

    def compare(self, other: "Gossip") -> Ordering:
        return self.version.compare(other.version)

    # -- convergence + leader (reference: MembershipState.scala:56) -----------
    def convergence(self, self_node: UniqueAddress,
                    dc: Optional[str] = None) -> bool:
        """With `dc`, PER-DC convergence (the reference's MembershipState
        convergence over dcMembers): only members of that DC must have seen
        the gossip, and only that DC's unreachables block — a cross-DC
        partition must not freeze a healthy DC's leader."""
        unreachable = {n for n in self.reachability.all_unreachable
                       if n != self_node}
        for n in unreachable:
            m = self.member(n)
            if m is not None and m.status not in _CONVERGENCE_SKIP_UNREACHABLE \
                    and (dc is None or m.data_center == dc):
                return False
        for m in self.members:
            if dc is not None and m.data_center != dc:
                continue
            if m.status in _CONVERGENCE_STATUSES and m.unique_address not in self.seen:
                return False
        return True

    def leader(self, self_node: UniqueAddress,
               dc: Optional[str] = None) -> Optional[UniqueAddress]:
        """First reachable member allowed to lead (reference:
        MembershipState.leader — Up/Leaving preferred, else Joining/WeaklyUp).
        With `dc`, the PER-DATA-CENTER leader (MembershipState.leaderOf over
        the dcMembers subset): every DC runs its own leader actions."""
        pool = self.members if dc is None else [
            m for m in self.members if m.data_center == dc]
        candidates = [m for m in pool
                      if m.status in (MemberStatus.UP, MemberStatus.LEAVING)
                      and (m.unique_address == self_node
                           or self.reachability.is_reachable(m.unique_address))]
        if not candidates:
            candidates = [m for m in pool
                          if m.status in (MemberStatus.JOINING, MemberStatus.WEAKLY_UP)
                          and (m.unique_address == self_node
                               or self.reachability.is_reachable(m.unique_address))]
        if not candidates:
            # the port's repair (MembershipState.leaderOf falls back to any
            # reachable member that is not Down): when every member left
            # is Exiting, the lowest leads and removes them; the
            # reference's members would stay Exiting with no leader
            candidates = [m for m in pool
                          if m.status is MemberStatus.EXITING
                          and (m.unique_address == self_node
                               or self.reachability.is_reachable(m.unique_address))]
        return min(candidates).unique_address if candidates else None

    @property
    def youngest_up_number(self) -> int:
        nums = [m.up_number for m in self.members if m.up_number < 2**31 - 1]
        return max(nums, default=0)

    def __repr__(self) -> str:
        ms = ", ".join(f"{m.address_str}:{m.status.value}" for m in self.members)
        return f"Gossip([{ms}], seen={len(self.seen)}, {self.version!r})"


def _vnode(node: UniqueAddress) -> str:
    return f"{node.address_str}-{node.uid}"


_STATUS_RANK = {MemberStatus.JOINING: 0, MemberStatus.WEAKLY_UP: 1,
                MemberStatus.UP: 2, MemberStatus.LEAVING: 3,
                MemberStatus.EXITING: 4, MemberStatus.DOWN: 5,
                MemberStatus.REMOVED: 6}


def _pick_highest(a: Member, b: Member) -> Member:
    """Merge two views of the same member: furthest-along lifecycle wins
    (reference: Member.highestPriorityOf)."""
    ra, rb = _STATUS_RANK[a.status], _STATUS_RANK[b.status]
    if ra == rb:
        return a if a.up_number <= b.up_number else b
    return a if ra > rb else b
