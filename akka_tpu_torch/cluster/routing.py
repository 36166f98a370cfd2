"""Cluster-aware routers: routees follow cluster membership.

A copy of `akka_tpu/cluster/routing.py` at commit 56e9e23 (host code, no jax;
the port keeps its own copy of every module it needs).

Reference parity: akka-cluster/src/main/scala/akka/cluster/routing/ —
ClusterRouterPool / ClusterRouterGroup wrap a local Pool/Group with
ClusterRouterPoolSettings / ClusterRouterGroupSettings (totalInstances,
maxInstancesPerNode, routeesPaths, allowLocalRoutees, useRoles;
ClusterRouterConfigBase.scala), and ClusterRouterActor subscribes to
MemberEvent/ReachabilityEvent to add/remove routees as nodes come and go
(ClusterRouterActor in ClusterRouterConfig.scala: addRoutees on MemberUp,
removeMember on MemberRemoved, unregister on UnreachableMember).

TPU-first shape: pool routees are deployed onto members through the remote
daemon (remote/deploy.py — the recipe travels, not a closure); group routees
are remote-path selections. The routing decision itself stays the local
RoutingLogic — an index choice, no extra hop.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Tuple

from ..actor.deploy import Deploy, RemoteScope
from ..actor.path import Address
from ..actor.props import Props
from ..routing.router import (ActorRefRoutee, ActorSelectionRoutee, Routee,
                              Router, RouterConfig)
from ..routing.routed_cell import RouterActor
from .events import (CurrentClusterState, MemberEvent, MemberRemoved,
                     MemberUp, MemberWeaklyUp, ReachabilityEvent,
                     ReachableMember, UnreachableMember)
from .member import Member, MemberStatus


@dataclass(frozen=True)
class ClusterRouterPoolSettings:
    """(reference: ClusterRouterPoolSettings in ClusterRouterConfig.scala)"""
    total_instances: int
    max_instances_per_node: int = 1
    allow_local_routees: bool = True
    use_roles: frozenset = frozenset()

    def __post_init__(self):
        # reference throws IllegalArgumentException for both
        if self.total_instances <= 0:
            raise ValueError("total_instances of cluster router must be > 0")
        if self.max_instances_per_node <= 0:
            raise ValueError(
                "max_instances_per_node of cluster router must be > 0")


@dataclass(frozen=True)
class ClusterRouterGroupSettings:
    """(reference: ClusterRouterGroupSettings)"""
    total_instances: int
    routees_paths: Tuple[str, ...] = ()
    allow_local_routees: bool = True
    use_roles: frozenset = frozenset()

    def __post_init__(self):
        if self.total_instances <= 0:
            raise ValueError("total_instances of cluster router must be > 0")


@dataclass(frozen=True)
class ClusterRouterConfig(RouterConfig):
    """Wraps a local RouterConfig; routees managed by ClusterRouterActor."""
    local: Optional[RouterConfig] = None
    cluster_settings: Any = None

    # RoutedActorCell consults this to pick the managing actor
    router_actor_class = None  # set below (forward ref)

    def create_router(self, system) -> Router:
        return self.local.create_router(system)

    @property
    def is_group(self) -> bool:
        return isinstance(self.cluster_settings, ClusterRouterGroupSettings)


def ClusterRouterPool(pool: RouterConfig,
                      settings: ClusterRouterPoolSettings) -> ClusterRouterConfig:
    if pool.is_group:
        raise ValueError("ClusterRouterPool needs a Pool config")
    return ClusterRouterConfig(
        logic_factory=pool.logic_factory,
        supervisor_strategy=pool.supervisor_strategy,
        local=pool, cluster_settings=settings)


def ClusterRouterGroup(group: RouterConfig,
                       settings: ClusterRouterGroupSettings) -> ClusterRouterConfig:
    paths = settings.routees_paths or group.paths
    if not paths:
        raise ValueError("ClusterRouterGroup needs routees_paths")
    settings = replace(settings, routees_paths=tuple(paths))
    return ClusterRouterConfig(
        logic_factory=group.logic_factory,
        local=group, cluster_settings=settings)


from ..routing.router import RouterManagementMessage


@dataclass(frozen=True)
class _ClusterEvent(RouterManagementMessage):
    """Wrapper so membership events reach the managing actor's mailbox instead
    of being routed to routees (RoutedActorCell.send_message routes everything
    that is not a management message)."""
    event: Any


class ClusterRouterActor(RouterActor):
    """Manages routees against live membership (reference:
    ClusterRouterActor: cluster.subscribe in preStart, addMember/removeMember
    on events, fully-filled check on each change)."""

    def __init__(self, router_config: ClusterRouterConfig):
        super().__init__(router_config)
        self.settings = router_config.cluster_settings
        # node address string -> routees we created/selected there
        self.node_routees: Dict[str, List[Routee]] = {}
        self.cluster = None
        self._sub = None

    # -- membership plumbing -------------------------------------------------
    def pre_start(self) -> None:
        from .cluster import Cluster
        self.cluster = Cluster.get(self.context.system)
        me = self.self_ref

        def forward(event):
            me.tell(_ClusterEvent(event))

        self._sub = forward
        self.cluster.subscribe(forward, MemberEvent, ReachabilityEvent,
                               initial_state=True)

    def post_stop(self) -> None:
        if self.cluster is not None and self._sub is not None:
            self.cluster.unsubscribe(self._sub)

    # -- eligibility ---------------------------------------------------------
    def _eligible(self, member: Member) -> bool:
        if member.status not in (MemberStatus.UP, MemberStatus.WEAKLY_UP):
            return False
        # never (re)deploy onto a node currently marked unreachable — the
        # reference's availableNodes excludes them; without this, the
        # backfill after _remove_node would put routees straight back.
        # Compare by unique_address: an event-snapshot Member can differ
        # from the gossip snapshot in status/up_number (ADVICE r3)
        if member.unique_address in {m.unique_address
                                     for m in self.cluster.state.unreachable}:
            return False
        roles = frozenset(self.settings.use_roles)
        if roles and not roles.issubset(member.roles):
            return False
        is_self = (member.unique_address == self.cluster.self_unique_address)
        if is_self and not self.settings.allow_local_routees:
            return False
        return True

    def _member_addr(self, member: Member) -> str:
        return member.unique_address.address_str

    # -- routee management ---------------------------------------------------
    def _capacity_left(self) -> int:
        total = sum(len(v) for v in self.node_routees.values())
        return max(self.settings.total_instances - total, 0)

    def _node_limit(self) -> int:
        if self.router_config.is_group:
            return len(self.settings.routees_paths)
        return self.settings.max_instances_per_node

    def _add_one(self, member: Member) -> bool:
        """Deploy exactly one routee onto `member`'s node. False when the
        node is already at its per-node limit or total capacity is hit."""
        addr = self._member_addr(member)
        existing = self.node_routees.get(addr, [])
        if len(existing) >= self._node_limit() or self._capacity_left() <= 0:
            return False
        cell = self._rcell
        if self.router_config.is_group:
            path = self.settings.routees_paths[len(existing)]
            # full address form even for self: the provider resolves our
            # own address back to local refs (provider.resolve_actor_ref)
            r: Routee = ActorSelectionRoutee(f"{addr}{path}",
                                             self.context.system)
        else:
            is_self = (member.unique_address == self.cluster.self_unique_address)
            props = cell.routee_props
            if not is_self:
                props = props.with_deploy(Deploy(scope=RemoteScope(addr)))
            child = cell.actor_of(props)
            self.context.watch(child)
            r = ActorRefRoutee(child)
        self.node_routees.setdefault(addr, []).append(r)
        cell.router.add_routee(r)
        return True

    def _add_member(self, member: Member) -> None:
        """A node became usable: resume filling (the reference's addMember
        registers the node then deploys via selectDeploymentTarget)."""
        if self._eligible(member):
            self._fill()

    def _remove_node(self, addr: str) -> None:
        routees = self.node_routees.pop(addr, None)
        if not routees:
            return
        cell = self._rcell
        for r in routees:
            cell.router.remove_routee(r)
            ref = getattr(r, "ref", None)
            if ref is not None:
                self.context.unwatch(ref)
                ref.stop()
        # backfill onto remaining nodes (fully-filled check parity)
        self._fill()

    def _fill(self, members=None) -> None:
        """Allocate one routee at a time onto the currently LEAST-LOADED
        eligible node (ties broken by address for determinism) until total
        capacity or every node's per-node limit is reached — the reference's
        ClusterRouterPoolActor.selectDeploymentTarget order, which spreads
        routees one-per-node instead of packing the lexicographically
        smallest addresses first."""
        if members is None:
            members = self.cluster.state.members
        eligible = [m for m in members if self._eligible(m)]
        while self._capacity_left() > 0 and eligible:
            target = min(eligible, key=lambda m: (
                len(self.node_routees.get(self._member_addr(m), ())),
                self._member_addr(m)))
            if not self._add_one(target):
                eligible.remove(target)  # node at per-node limit

    # -- receive -------------------------------------------------------------
    def receive(self, message: Any):
        if isinstance(message, _ClusterEvent):
            message = message.event
        if isinstance(message, CurrentClusterState):
            self._fill(message.members)
            return None
        if isinstance(message, (MemberUp, MemberWeaklyUp)):
            self._add_member(message.member)
            return None
        if isinstance(message, MemberRemoved):
            self._remove_node(self._member_addr(message.member))
            return None
        if isinstance(message, UnreachableMember):
            self._remove_node(self._member_addr(message.member))
            return None
        if isinstance(message, ReachableMember):
            self._add_member(message.member)
            return None
        if isinstance(message, MemberEvent):
            # other transitions (Left/Exited/Downed): drop the node early
            if message.member.status not in (MemberStatus.UP,
                                             MemberStatus.WEAKLY_UP):
                self._remove_node(self._member_addr(message.member))
            return None
        from ..actor.messages import Terminated
        if isinstance(message, Terminated):
            changed = False
            for addr, routees in list(self.node_routees.items()):
                kept = [r for r in routees
                        if getattr(r, "ref", None) != message.actor]
                if len(kept) != len(routees):
                    changed = True
                    if kept:
                        self.node_routees[addr] = kept
                    else:
                        self.node_routees.pop(addr, None)
            result = super().receive(message)
            if changed and not self._rcell.is_terminating:
                self._fill()  # keep the pool fully filled (reference parity)
            return result
        return super().receive(message)


ClusterRouterConfig.router_actor_class = ClusterRouterActor
