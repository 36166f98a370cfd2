"""Split-brain resolver: downing strategies applied after a stable period.

A copy of `akka_tpu/cluster/sbr.py` at commit 56e9e23 (host code, no jax;
the port keeps its own copy of every module it needs). One change:
`strategy_from_config` refuses `lease-majority`, whose lease provider
(`cluster_tools/lease.py`) comes with ROADMAP A12.3; `LeaseMajority`
itself takes any lease factory.

Reference parity: akka-cluster/src/main/scala/akka/cluster/sbr/
SplitBrainResolver.scala (:96 actor, :134 stable-after logic, :536 strategy
selection) and sbr/DowningStrategy.scala — keep-majority, static-quorum,
keep-oldest, down-all. A side that decides it lost downs ITSELF (both sides
decide independently and deterministically, so exactly one survives).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, FrozenSet, List, Optional, Set

from ..actor.actor import Actor
from .events import (ClusterDomainEvent, MemberEvent, ReachabilityEvent,
                     ReachableMember, UnreachableMember)
from .member import Member, MemberStatus, UniqueAddress

_CONSIDERED = {MemberStatus.UP, MemberStatus.LEAVING, MemberStatus.EXITING}


@dataclass
class Decision:
    down_nodes: List[UniqueAddress]
    # True = not decided yet; the resolver must keep the deadline armed and
    # re-invoke on the next tick (lease-majority's minority delay)
    retry: bool = False


class DowningStrategy:
    """`decide` sees members (considered statuses only), the unreachable set,
    and this node; returns the nodes THIS side should down."""

    def decide(self, members: List[Member], unreachable: Set[UniqueAddress],
               self_node: UniqueAddress) -> Decision:
        raise NotImplementedError

    @staticmethod
    def _sides(members, unreachable):
        reachable = [m for m in members if m.unique_address not in unreachable]
        lost = [m for m in members if m.unique_address in unreachable]
        return reachable, lost

    @staticmethod
    def _down_side(side) -> Decision:
        return Decision([m.unique_address for m in side])


class KeepMajority(DowningStrategy):
    """(reference: DowningStrategy.KeepMajority — ties broken by lowest
    address, which is deterministic on both sides)"""

    def decide(self, members, unreachable, self_node):
        reachable, lost = self._sides(members, unreachable)
        if not lost:
            return Decision([])
        if len(reachable) > len(lost):
            return self._down_side(lost)
        if len(reachable) < len(lost):
            return self._down_side(reachable)  # we lost; down our own side
        # tie: the side holding the lowest address survives
        lowest = min(m.unique_address for m in members)
        if any(m.unique_address == lowest for m in reachable):
            return self._down_side(lost)
        return self._down_side(reachable)


class StaticQuorum(DowningStrategy):
    def __init__(self, quorum_size: int):
        self.quorum_size = quorum_size

    def decide(self, members, unreachable, self_node):
        reachable, lost = self._sides(members, unreachable)
        if not lost:
            return Decision([])
        if len(reachable) >= self.quorum_size:
            return self._down_side(lost)
        return self._down_side(reachable)


class KeepOldest(DowningStrategy):
    def __init__(self, down_if_alone: bool = True):
        self.down_if_alone = down_if_alone

    def decide(self, members, unreachable, self_node):
        reachable, lost = self._sides(members, unreachable)
        if not lost or not members:
            return Decision([])
        oldest = min(members, key=lambda m: (m.up_number, m.unique_address))
        oldest_is_here = any(m.unique_address == oldest.unique_address
                             for m in reachable)
        if oldest_is_here:
            if self.down_if_alone and len(reachable) == 1 and len(lost) >= 1:
                return self._down_side(reachable)  # oldest alone: sacrifice it
            return self._down_side(lost)
        return self._down_side(reachable)


class DownAll(DowningStrategy):
    def decide(self, members, unreachable, self_node):
        return Decision([m.unique_address for m in members])


class LeaseMajority(DowningStrategy):
    """The side that ACQUIRES the lease survives (reference:
    SplitBrainResolver.scala:45-55 acquire/release plumbing +
    DowningStrategy.LeaseMajority): only each side's lowest-address
    reachable node races for the lease — on success it downs the other
    side, on failure it downs its OWN side; the rest of its side follows
    the downing through gossip. The MINORITY side delays its acquire
    attempt (the reference's acquire-lease-delay-for-minority) so a
    symmetric partition deterministically favors the majority instead of
    a coin-flip race. Works across real processes with the `file` lease
    backend."""

    def __init__(self, lease_factory, acquire_delay_for_minority: float = 2.0):
        # factory: () -> Lease — deferred so the owner name can carry the
        # node address and the lease is only created when SBR fires
        self._lease_factory = lease_factory
        self._lease = None
        self.acquire_delay_for_minority = acquire_delay_for_minority
        self._deferred_until: Optional[float] = None

    def decide(self, members, unreachable, self_node):
        reachable, lost = self._sides(members, unreachable)
        if not lost or not reachable:
            return Decision([])
        decider = min(m.unique_address for m in reachable)
        if self_node != decider:
            return Decision([])  # our side's decider acts; downs gossip in
        is_minority = len(reachable) < len(lost) or (
            len(reachable) == len(lost)
            and min(m.unique_address for m in members) not in
            {m.unique_address for m in reachable})
        if is_minority:
            now = time.monotonic()
            if self._deferred_until is None:
                self._deferred_until = now + self.acquire_delay_for_minority
            if now < self._deferred_until:
                return Decision([], retry=True)  # majority gets a head start
        self._deferred_until = None
        if self._lease is None:
            self._lease = self._lease_factory()
        if self._lease.acquire():
            return self._down_side(lost)
        return self._down_side(reachable)

    def reset(self) -> None:
        """Partition healed without a decision: clear the episode state so
        the NEXT partition's minority delay starts fresh (a stale expired
        _deferred_until would skip the delay entirely)."""
        self._deferred_until = None

    def release(self) -> None:
        if self._lease is not None:
            self._lease.release()


def strategy_from_config(cfg, system=None, self_owner: str = ""
                         ) -> DowningStrategy:
    """(reference: SplitBrainResolver.scala:536 strategy selection)"""
    name = cfg.get_string("active-strategy", "keep-majority")
    if name == "keep-majority":
        return KeepMajority()
    if name == "static-quorum":
        return StaticQuorum(cfg.get_int("static-quorum.quorum-size", 1))
    if name == "keep-oldest":
        return KeepOldest(cfg.get_bool("keep-oldest.down-if-alone", True))
    if name == "down-all":
        return DownAll()
    if name == "lease-majority":
        # the lease provider is cluster_tools/lease.py, which the port
        # has not yet (LeaseMajority itself takes any lease factory)
        raise ValueError(
            "split-brain-resolver active-strategy lease-majority: its "
            "lease provider (cluster_tools) is not ported (ROADMAP A12.3)")
    raise ValueError(f"unknown split-brain-resolver strategy {name!r}")


class SplitBrainResolver(Actor):
    """Subscribes to reachability events; after `stable_after` seconds of an
    unchanged unreachable set, applies the strategy and downs the losers."""

    class _Tick:
        pass

    def __init__(self, cluster, strategy: DowningStrategy, stable_after: float,
                 tick_interval: float = 0.25):
        super().__init__()
        self.cluster = cluster
        self.strategy = strategy
        self.stable_after = stable_after
        self.tick_interval = tick_interval
        self._unreachable: Set[UniqueAddress] = set()
        self._deadline: Optional[float] = None
        self._task = None
        # when a lease-backed strategy acquires, release it AFTER a safety
        # margin (reference: SplitBrainResolver.scala:45-55 releases the
        # lease once the resolution settles; releasing immediately would
        # let the doomed side acquire and down the survivors, holding it
        # forever poisons the NEXT partition's decision)
        self._release_at: Optional[float] = None

    def pre_start(self) -> None:
        self._sub = lambda e: self.self_ref.tell(e)
        self.context.system.event_stream.subscribe(self._sub, ReachabilityEvent)
        self._task = self.context.system.scheduler.schedule_tell_with_fixed_delay(
            self.tick_interval, self.tick_interval, self.self_ref, self._Tick())

    def post_stop(self) -> None:
        self.context.system.event_stream.unsubscribe(self._sub)
        if self._task is not None:
            self._task.cancel()

    def _reset_strategy(self) -> None:
        """Any reachability change restarts the stability window — stateful
        strategies (lease-majority's minority acquire delay) must restart
        their episode state WITH it, or a flap mid-delay would let the
        delay expire unobserved and reinstate the symmetric lease race."""
        reset = getattr(self.strategy, "reset", None)
        if reset is not None:
            reset()

    def receive(self, message: Any):
        if isinstance(message, UnreachableMember):
            # SBR is PER-DC (the reference's SBR only acts within its own
            # data center; cross-DC unreachability — e.g. a DCN partition
            # between slices — must NOT down an independently-healthy DC)
            my_dc = getattr(self.cluster, "self_data_center", "default")
            if message.member.data_center != my_dc:
                return None
            self._unreachable.add(message.member.unique_address)
            self._deadline = time.monotonic() + self.stable_after
            self._reset_strategy()
        elif isinstance(message, ReachableMember):
            self._unreachable.discard(message.member.unique_address)
            self._deadline = (time.monotonic() + self.stable_after
                              if self._unreachable else None)
            self._reset_strategy()
        elif isinstance(message, self._Tick):
            if (self._deadline is not None and self._unreachable
                    and time.monotonic() >= self._deadline):
                self._act()
            if self._release_at is not None \
                    and time.monotonic() >= self._release_at:
                self._release_at = None
                release = getattr(self.strategy, "release", None)
                if release is not None:
                    release()
        else:
            return NotImplemented
        return None

    def _act(self) -> None:
        state = self.cluster.state
        my_dc = getattr(self.cluster, "self_data_center", "default")
        members = [m for m in state.members if m.status in _CONSIDERED
                   and m.data_center == my_dc]
        if not members:
            self._deadline = None
            return
        decision = self.strategy.decide(
            members, set(self._unreachable), self.cluster.self_unique_address)
        if decision.retry:
            # not decided yet (minority acquire delay): re-check next tick
            self._deadline = time.monotonic() + self.tick_interval
            return
        for node in decision.down_nodes:
            self.cluster.down(node.address_str)
        if decision.down_nodes and hasattr(self.strategy, "release"):
            # hold the lease past the losing side's own decision window,
            # then free it for future partitions
            self._release_at = time.monotonic() + 2 * self.stable_after + 2.0
        self._deadline = None
        self._unreachable -= set(decision.down_nodes)
