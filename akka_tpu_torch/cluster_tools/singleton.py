"""Cluster singleton: exactly-one actor cluster-wide, hosted on the oldest node.

A copy of `akka_tpu/cluster_tools/singleton.py` at commit c056b95 (host
code, no jax; the port keeps its own copy of every module it needs).

Reference parity: akka-cluster-tools/src/main/scala/akka/cluster/singleton/
ClusterSingletonManager.scala (:176-225 — oldest-node FSM with hand-over
protocol HandOverToMe/HandOverInProgress/HandOverDone/TakeOverFromMe) and
ClusterSingletonProxy.scala (tracks the oldest member, buffers while the
singleton location is unknown, identifies via periodic probes).

The FSM here keeps the reference's state names and hand-over protocol but runs
on the host control plane (singleton moves are rare; fidelity > speed).
States: Start → Younger | Oldest; Younger → BecomingOldest → Oldest;
Oldest → WasOldest (hand-over on leave) → End.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Optional

from ..actor.actor import Actor
from ..actor.props import Props
from ..cluster.cluster import Cluster
from ..cluster.events import (MemberEvent, MemberExited, MemberLeft,
                              MemberRemoved, MemberUp)
from ..cluster.member import Member, MemberStatus, UniqueAddress


# -- hand-over protocol (reference: ClusterSingletonManager.Internal) --------

@dataclass(frozen=True)
class HandOverToMe:
    pass


@dataclass(frozen=True)
class HandOverInProgress:
    pass


@dataclass(frozen=True)
class HandOverDone:
    pass


@dataclass(frozen=True)
class TakeOverFromMe:
    pass


@dataclass(frozen=True)
class _Cleanup:
    pass


@dataclass(frozen=True)
class ClusterSingletonSettings:
    """(reference: ClusterSingletonManagerSettings) — singleton name, role
    filter, hand-over retry cadence; `use_lease` guards instantiation with
    a coordination lease (ClusterSingletonManagerSettings.LeaseSettings —
    the singleton only starts while its node HOLDS the lease, so even a
    split brain cannot run two instances)."""
    singleton_name: str = "singleton"
    role: Optional[str] = None
    hand_over_retry_interval: float = 0.25
    # proxy settings
    buffer_size: int = 1000
    singleton_identification_interval: float = 0.25
    # lease guard (reference: singleton lease-implementation config)
    use_lease: bool = False
    lease_name: Optional[str] = None


class ClusterSingletonManager(Actor):
    """Runs on every node (with the configured role); hosts the singleton
    child while this node is the oldest. Spawn one per singleton name:

        system.actor_of(Props.create(ClusterSingletonManager, props, settings),
                        name="my-singleton-manager")
    """

    def __init__(self, singleton_props: Props,
                 settings: Optional[ClusterSingletonSettings] = None,
                 termination_message: Any = None):
        super().__init__()
        self.settings = settings or ClusterSingletonSettings()
        self.singleton_props = singleton_props
        self.termination_message = termination_message
        self.cluster = Cluster.get(self.context.system)
        self.state = "Start"
        self.singleton: Optional[Any] = None  # ActorRef of the child
        self._members_by_age: List[Member] = []  # oldest first
        self._hand_over_to: Optional[Any] = None  # ref of previous oldest
        self._retry_task = None

    # -- membership bookkeeping ----------------------------------------------
    def _matches_role(self, m: Member) -> bool:
        return self.settings.role is None or self.settings.role in m.roles

    def _refresh_members(self) -> None:
        ms = [m for m in self.cluster.state.members
              if m.status in (MemberStatus.UP, MemberStatus.LEAVING,
                              MemberStatus.EXITING) and self._matches_role(m)]
        ms.sort(key=lambda m: (m.up_number, m.unique_address))
        self._members_by_age = ms

    def _oldest(self) -> Optional[Member]:
        for m in self._members_by_age:
            if m.status is MemberStatus.UP:
                return m
        return self._members_by_age[0] if self._members_by_age else None

    def _self_node(self) -> Optional[UniqueAddress]:
        sm = self.cluster.self_member
        return sm.unique_address if sm else None

    def _am_oldest(self) -> bool:
        o = self._oldest()
        return o is not None and o.unique_address == self._self_node()

    def _peer_manager(self, node: UniqueAddress):
        rel = self.context.self_ref.path.to_string_without_address()
        return self.context.system.provider.resolve_actor_ref(
            f"{node.address_str}{rel}")

    # -- lifecycle -----------------------------------------------------------
    def pre_start(self) -> None:
        self.cluster.subscribe(self._on_cluster_event, MemberEvent,
                               initial_state=False)
        self._retry_task = self.context.system.scheduler.schedule_tell_with_fixed_delay(
            self.settings.hand_over_retry_interval,
            self.settings.hand_over_retry_interval,
            self.self_ref, _Cleanup())
        self.cluster.register_on_member_up(
            lambda: self.self_ref.tell(_Cleanup()))

    def post_stop(self) -> None:
        self.cluster.unsubscribe(self._on_cluster_event)
        if self._retry_task:
            self._retry_task.cancel()
        self._release_lease()

    def _on_cluster_event(self, event: Any) -> None:
        # runs on the cluster event thread; re-enter via our mailbox
        self.self_ref.tell(event)

    # -- FSM -----------------------------------------------------------------
    def receive(self, message: Any) -> Any:
        if isinstance(message, (MemberEvent, _Cleanup)):
            self._refresh_members()
            self._evaluate(message)
        elif isinstance(message, HandOverToMe):
            self._on_hand_over_to_me()
        elif isinstance(message, HandOverInProgress):
            pass  # previous oldest acknowledged; keep waiting for HandOverDone
        elif isinstance(message, HandOverDone):
            if self.state == "BecomingOldest":
                self._become_oldest()
        elif isinstance(message, TakeOverFromMe):
            # previous oldest offers hand-over proactively
            if self.state in ("Younger", "BecomingOldest") and self._am_oldest():
                self.state = "BecomingOldest"
                self.sender.tell(HandOverToMe(), self.self_ref)
        else:
            return NotImplemented

    def _evaluate(self, event: Any) -> None:
        self_node = self._self_node()
        if self_node is None:
            return
        sm = self.cluster.self_member
        leaving = sm is not None and sm.status in (
            MemberStatus.LEAVING, MemberStatus.EXITING)

        if self.state == "Start":
            if sm is None or sm.status is not MemberStatus.UP:
                return
            if self._am_oldest():
                self._become_oldest()
            else:
                self.state = "Younger"
        elif self.state == "Younger":
            if self._am_oldest() and not leaving:
                # previous oldest gone or leaving: hand-over or direct takeover
                prev = self._previous_oldest_gone(event)
                if prev is None:
                    self._become_oldest()  # previous oldest fully removed
                else:
                    self.state = "BecomingOldest"
                    self._peer_manager(prev).tell(HandOverToMe(), self.self_ref)
        elif self.state == "BecomingOldest":
            prev = self._previous_oldest_gone(event)
            if prev is None:
                self._become_oldest()
            elif isinstance(event, _Cleanup):
                self._peer_manager(prev).tell(HandOverToMe(), self.self_ref)
        elif self.state == "Oldest":
            if self.settings.use_lease and isinstance(event, _Cleanup) \
                    and getattr(self, "_lease", None) is not None \
                    and not self._lease.check_lease():
                # lease LOST while running (TTL expired during a stall —
                # another node may already be instantiating): stop our
                # instance immediately and re-race for the lease
                if self.singleton is not None:
                    self.context.stop(self.singleton)
                    self.singleton = None
                self.state = "BecomingOldest"
                return
            if leaving or not self._am_oldest():
                self.state = "WasOldest"
                new = self._oldest()
                if new is not None and new.unique_address != self_node:
                    self._peer_manager(new.unique_address).tell(
                        TakeOverFromMe(), self.self_ref)
        elif self.state == "WasOldest":
            new = self._oldest()
            if isinstance(event, _Cleanup) and new is not None \
                    and new.unique_address != self_node:
                self._peer_manager(new.unique_address).tell(
                    TakeOverFromMe(), self.self_ref)

    def _previous_oldest_gone(self, event: Any) -> Optional[UniqueAddress]:
        """The node we must hand over from: the oldest *other* known member
        that is Leaving/Exiting, or None if no such node remains."""
        self_node = self._self_node()
        for m in self._members_by_age:
            if m.unique_address != self_node and m.status in (
                    MemberStatus.LEAVING, MemberStatus.EXITING):
                return m.unique_address
        return None

    def _acquire_lease(self) -> bool:
        """Take (or confirm) the singleton lease; False defers instantiation
        to the next retry tick (the reference's AcquiringLease state)."""
        if not self.settings.use_lease:
            return True
        if getattr(self, "_lease", None) is None:
            from .lease import LeaseProvider
            name = self.settings.lease_name or (
                f"{self.context.system.name}-singleton-"
                f"{self.settings.singleton_name}")
            self._lease = LeaseProvider.get(self.context.system).get_lease(
                name, "akka.cluster.singleton.lease",
                str(self._self_node()))
        return self._lease.acquire()

    def _release_lease(self) -> None:
        lease = getattr(self, "_lease", None)
        if lease is not None:
            lease.release()

    def _become_oldest(self) -> None:
        if not self._acquire_lease():
            # stay in BecomingOldest: the _Cleanup retry tick re-evaluates
            # and re-attempts the acquire until the holder releases/expires
            self.state = "BecomingOldest"
            return
        self.state = "Oldest"
        if self.singleton is None:
            self.singleton = self.context.actor_of(
                self.singleton_props, self.settings.singleton_name)

    def _on_hand_over_to_me(self) -> None:
        """New oldest asks us to stop the singleton and confirm."""
        requester = self.sender
        if self.state == "HandingOver":
            # retried request while the old instance is still stopping: must
            # NOT ack done yet (two live singletons otherwise); re-confirm
            # in-progress and ack the latest requester on termination
            self._pending_handover_ack = requester
            requester.tell(HandOverInProgress(), self.self_ref)
            return
        if self.state in ("Oldest", "WasOldest") and self.singleton is not None:
            self.state = "HandingOver"
            requester.tell(HandOverInProgress(), self.self_ref)
            singleton, self.singleton = self.singleton, None
            self.context.watch(singleton)
            self._pending_handover_ack = requester
            if self.termination_message is not None:
                singleton.tell(self.termination_message, self.self_ref)
            else:
                self.context.stop(singleton)
        elif self.singleton is None:
            # nothing to hand over (already stopped or never had it)
            requester.tell(HandOverDone(), self.self_ref)
            if self.state in ("Oldest", "WasOldest", "HandingOver"):
                self.state = "End"

    def around_receive(self, receive, msg) -> None:
        from ..actor.messages import Terminated
        if isinstance(msg, Terminated):
            ack = getattr(self, "_pending_handover_ack", None)
            if self.state == "HandingOver" and ack is not None:
                ack.tell(HandOverDone(), self.self_ref)
                self._pending_handover_ack = None
                self.state = "End"
                # the instance is gone: free the lease so the new oldest's
                # acquire succeeds immediately
                self._release_lease()
            return
        super().around_receive(receive, msg)


@dataclass(frozen=True)
class _TryToIdentify:
    pass


class ClusterSingletonProxy(Actor):
    """Location-transparent ref to the singleton: tracks the oldest member,
    buffers messages until the singleton is CONFIRMED alive via Identify
    probing — blind sends during a hand-over would land in dead letters
    (reference: ClusterSingletonProxy.scala identifyInterval + buffer)."""

    def __init__(self, manager_path: str,
                 settings: Optional[ClusterSingletonSettings] = None):
        super().__init__()
        self.settings = settings or ClusterSingletonSettings()
        # path of the manager actor relative to root, e.g. "/user/my-manager"
        self.manager_path = manager_path if manager_path.startswith("/") \
            else "/" + manager_path
        self.cluster = Cluster.get(self.context.system)
        self.buffer: List[tuple] = []
        self.singleton = None       # confirmed-live ref
        self._identify_id = 0
        self._task = None

    def pre_start(self) -> None:
        self.cluster.subscribe(self._on_cluster_event, MemberEvent,
                               initial_state=False)
        self._task = self.context.system.scheduler.schedule_tell_with_fixed_delay(
            0.0, self.settings.singleton_identification_interval,
            self.self_ref, _TryToIdentify())

    def post_stop(self) -> None:
        self.cluster.unsubscribe(self._on_cluster_event)
        if self._task:
            self._task.cancel()

    def _on_cluster_event(self, event: Any) -> None:
        self.self_ref.tell(event)

    def _matches_role(self, m: Member) -> bool:
        return self.settings.role is None or self.settings.role in m.roles

    def _singleton_path(self) -> Optional[str]:
        ms = [m for m in self.cluster.state.members
              if m.status is MemberStatus.UP and self._matches_role(m)]
        if not ms:
            return None
        oldest = min(ms, key=lambda m: (m.up_number, m.unique_address))
        return (f"{oldest.unique_address.address_str}{self.manager_path}/"
                f"{self.settings.singleton_name}")

    def _identify(self) -> None:
        from ..actor.messages import Identify
        path = self._singleton_path()
        if path is None:
            return
        self._identify_id += 1
        ref = self.context.system.provider.resolve_actor_ref(path)
        ref.tell(Identify((self._identify_id, path)), self.self_ref)

    def receive(self, message: Any) -> Any:
        from ..actor.messages import ActorIdentity, Terminated
        if isinstance(message, MemberEvent):
            # topology changed: the singleton may have moved — re-confirm
            self.singleton = None
            self._identify()
        elif isinstance(message, _TryToIdentify):
            if self.singleton is None:
                self._identify()
        elif isinstance(message, ActorIdentity):
            if message.ref is not None and message.correlation_id[0] == self._identify_id:
                self.singleton = message.ref
                self.context.watch(self.singleton)
                self._flush()
        elif isinstance(message, Terminated):
            if self.singleton is not None and message.actor == self.singleton:
                self.singleton = None
                self._identify()
        else:
            if self.singleton is not None:
                self.singleton.tell(message, self.sender)
            else:
                if len(self.buffer) >= self.settings.buffer_size:
                    self.buffer.pop(0)  # drop oldest (reference logs + drops)
                self.buffer.append((message, self.sender))
                self._identify()

    def _flush(self) -> None:
        buffered, self.buffer = self.buffer, []
        for msg, snd in buffered:
            self.singleton.tell(msg, snd)
