"""Cluster members: unique address + status lifecycle + ordering.

A copy of `akka_tpu/cluster/member.py` at commit 56e9e23 (host code, no jax;
the port keeps its own copy of every module it needs).

Reference parity: akka-cluster/src/main/scala/akka/cluster/Member.scala —
MemberStatus lifecycle Joining→(WeaklyUp)→Up→Leaving→Exiting→Removed plus
Down; `allowedTransitions`; Member ordering by address; `isOlderThan` by
up-number (age).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from enum import Enum
from typing import FrozenSet, Optional, Tuple

from ..actor.path import Address


class MemberStatus(Enum):
    JOINING = "Joining"
    WEAKLY_UP = "WeaklyUp"
    UP = "Up"
    LEAVING = "Leaving"
    EXITING = "Exiting"
    DOWN = "Down"
    REMOVED = "Removed"


# (reference: Member.scala allowedTransitions table)
ALLOWED_TRANSITIONS = {
    MemberStatus.JOINING: {MemberStatus.WEAKLY_UP, MemberStatus.UP,
                           MemberStatus.DOWN, MemberStatus.REMOVED},
    MemberStatus.WEAKLY_UP: {MemberStatus.UP, MemberStatus.LEAVING,
                             MemberStatus.DOWN, MemberStatus.REMOVED},
    MemberStatus.UP: {MemberStatus.LEAVING, MemberStatus.DOWN, MemberStatus.REMOVED},
    MemberStatus.LEAVING: {MemberStatus.EXITING, MemberStatus.DOWN, MemberStatus.REMOVED},
    MemberStatus.EXITING: {MemberStatus.REMOVED, MemberStatus.DOWN},
    MemberStatus.DOWN: {MemberStatus.REMOVED},
    MemberStatus.REMOVED: set(),
}


@dataclass(frozen=True, order=True)
class UniqueAddress:
    """Address + per-incarnation uid (reference: cluster/Member.scala
    UniqueAddress) — a restarted node is a different member."""
    address_str: str = field(compare=True)
    uid: int = field(compare=True)

    @property
    def address(self) -> Address:
        return Address.parse(self.address_str)

    def __repr__(self) -> str:
        return f"UniqueAddress({self.address_str}#{self.uid})"


@dataclass(frozen=True)
class Member:
    unique_address: UniqueAddress
    status: MemberStatus = MemberStatus.JOINING
    roles: FrozenSet[str] = frozenset()
    up_number: int = 2**31 - 1  # set when promoted to Up; age ordering

    @property
    def address(self) -> Address:
        return self.unique_address.address

    @property
    def address_str(self) -> str:
        return self.unique_address.address_str

    @property
    def data_center(self) -> str:
        """The member's data center, encoded as a `dc-<name>` role exactly
        like the reference (cluster/Member.scala dataCenter: the DC rides
        the roles set with the ClusterSettings.DcRolePrefix). Deterministic
        under multiple dc- roles (sorted) — though Cluster.__init__ rejects
        user roles with the reserved prefix, wire data is untrusted."""
        dcs = sorted(r for r in self.roles if r.startswith("dc-"))
        return dcs[0][3:] if dcs else "default"

    def copy_with(self, status: MemberStatus, up_number: Optional[int] = None) -> "Member":
        if status not in ALLOWED_TRANSITIONS[self.status] and status != self.status:
            raise ValueError(f"invalid transition {self.status} -> {status} for {self}")
        return replace(self, status=status,
                       up_number=self.up_number if up_number is None else up_number)

    def is_older_than(self, other: "Member") -> bool:
        """(reference: Member.isOlderThan — by up-number, ties by address)"""
        if self.up_number != other.up_number:
            return self.up_number < other.up_number
        return self.unique_address < other.unique_address

    def __lt__(self, other: "Member") -> bool:
        return self.unique_address < other.unique_address

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Member) and self.unique_address == other.unique_address

    def __hash__(self) -> int:
        return hash(self.unique_address)

    def __repr__(self) -> str:
        return f"Member({self.address_str}, {self.status.value})"
