"""ClusterCoreDaemon: the membership state machine actor.

A copy of `akka_tpu/cluster/daemon.py` at commit 56e9e23 (host code, no jax;
the port keeps its own copy of every module it needs).

Reference parity: akka-cluster/src/main/scala/akka/cluster/ClusterDaemon.scala
(:312) — `joining` (:735), `leaving` (:834), `receiveGossip` (:994),
`gossipTick` (:1116), `leaderActions` (:1166), `leaderActionsOnConvergence`
(:1245), `reapUnreachableMembers` (:1413); heartbeating per
cluster/ClusterHeartbeat.scala (ring neighbors feeding phi-accrual).

The control plane runs on the host (it's low-rate); the data plane stays on
device (batched/). One daemon actor per node at /system/cluster.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, replace
from typing import Any, Dict, FrozenSet, Optional

from ..actor.actor import Actor
from ..actor.path import Address
from ..remote.failure_detector import FailureDetectorRegistry
from .events import (CurrentClusterState, LeaderChanged, MemberDowned,
                     MemberEvent, MemberExited, MemberJoined, MemberLeft,
                     MemberRemoved, MemberUp, MemberWeaklyUp, ReachableMember,
                     UnreachableMember)
from .gossip import Gossip
from .member import Member, MemberStatus, UniqueAddress


# -- inter-node protocol (picklable; reference: ClusterMessage hierarchy) ----

@dataclass(frozen=True)
class Join:
    node: UniqueAddress
    roles: FrozenSet[str] = frozenset()
    # digest of the joiner's cluster-critical config; the first contact
    # node refuses mismatches (reference: JoinConfigCompatChecker.scala:18)
    config_digest: str = ""


@dataclass(frozen=True)
class JoinRefused:
    """Join denied — incompatible configuration (the reference replies
    IncompatibleConfig and the joiner logs + gives up)."""
    from_node: UniqueAddress
    reason: str


@dataclass(frozen=True)
class Welcome:
    from_node: UniqueAddress
    gossip: Gossip


@dataclass(frozen=True)
class GossipEnvelope:
    from_node: UniqueAddress
    gossip: Gossip


@dataclass(frozen=True)
class ClusterHeartbeat:
    from_node: UniqueAddress


@dataclass(frozen=True)
class ClusterHeartbeatRsp:
    from_node: UniqueAddress


@dataclass(frozen=True)
class LeaveCmd:
    address_str: str


@dataclass(frozen=True)
class DownCmd:
    address_str: str


@dataclass(frozen=True)
class JoinTo:
    """Local command: send Join to this address (seed or explicit join)."""
    address_str: str


@dataclass(frozen=True)
class JoinSeedNodes:
    """Local command: join the first reachable seed, retrying and rotating
    through the list (reference: cluster/SeedNodeProcess.scala)."""
    seeds: tuple


class _JoinRetryTick:
    pass


class _GossipTick:
    pass


class _LeaderActionsTick:
    pass


class _ReapTick:
    pass


class _HeartbeatTick:
    pass


class ClusterCoreDaemon(Actor):
    def __init__(self, cluster):
        super().__init__()
        self.cluster = cluster
        self.self_node: UniqueAddress = cluster.self_unique_address
        self.roles: FrozenSet[str] = cluster.self_roles
        # multi-DC: leader actions / heartbeat ring / reaping are PER-DC
        # (CrossDcClusterHeartbeat.scala:39; one DC per TPU slice/pod)
        self.dc: str = getattr(cluster, "self_data_center", "default")
        self._cross_dc = getattr(cluster, "cross_dc_settings",
                                 {"monitoring_members": 2,
                                  "interval_factor": 3})
        self._hb_tick_count = 0
        self.gossip = Gossip()
        self.fd = FailureDetectorRegistry(cluster.fd_factory)
        self._tasks = []
        self._published: Dict[UniqueAddress, MemberStatus] = {}
        self._published_unreachable: FrozenSet[UniqueAddress] = frozenset()
        self._published_leader: Optional[UniqueAddress] = None
        self._removed = False

    # -- lifecycle ------------------------------------------------------------
    def pre_start(self) -> None:
        s = self.context.system.scheduler
        cfg = self.cluster.settings
        self._tasks = [
            s.schedule_tell_with_fixed_delay(cfg["gossip_interval"],
                                             cfg["gossip_interval"],
                                             self.self_ref, _GossipTick()),
            s.schedule_tell_with_fixed_delay(cfg["leader_actions_interval"],
                                             cfg["leader_actions_interval"],
                                             self.self_ref, _LeaderActionsTick()),
            s.schedule_tell_with_fixed_delay(cfg["reaper_interval"],
                                             cfg["reaper_interval"],
                                             self.self_ref, _ReapTick()),
            s.schedule_tell_with_fixed_delay(cfg["heartbeat_interval"],
                                             cfg["heartbeat_interval"],
                                             self.self_ref, _HeartbeatTick()),
        ]

    def post_stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        self._stop_join_retry()

    # -- receive --------------------------------------------------------------
    def receive(self, message: Any):
        if isinstance(message, _GossipTick):
            self._gossip_tick()
        elif isinstance(message, _LeaderActionsTick):
            self._leader_actions()
        elif isinstance(message, _ReapTick):
            self._reap_unreachable()
        elif isinstance(message, _HeartbeatTick):
            self._heartbeat_tick()
        elif isinstance(message, Join):
            self._joining(message.node, message.roles,
                          getattr(message, "config_digest", ""))
        elif isinstance(message, JoinRefused):
            self._join_refused(message)
        elif isinstance(message, Welcome):
            self._welcome(message)
        elif isinstance(message, GossipEnvelope):
            self._receive_gossip(message)
        elif isinstance(message, ClusterHeartbeat):
            self._send_to(message.from_node, ClusterHeartbeatRsp(self.self_node))
        elif isinstance(message, ClusterHeartbeatRsp):
            self.fd.heartbeat(message.from_node.address_str)
        elif isinstance(message, JoinTo):
            self._start_join((message.address_str,))
        elif isinstance(message, JoinSeedNodes):
            self._start_join(tuple(message.seeds))
        elif isinstance(message, _JoinRetryTick):
            self._join_retry()
        elif isinstance(message, LeaveCmd):
            self._leaving(message.address_str)
        elif isinstance(message, DownCmd):
            self._downing(message.address_str)
        elif message == "get-state":
            self.sender.tell(self._current_state(), self.self_ref)
        else:
            return NotImplemented
        return None

    # -- join (reference: ClusterDaemon.joining :735; retry semantics per
    # SeedNodeProcess — a single Join may be dropped or arrive before the
    # target has self-joined, so resend until welcomed) -----------------------
    def _start_join(self, seeds: tuple) -> None:
        self._join_seeds = seeds
        self._join_idx = 0
        if getattr(self, "_join_retry_task", None) is None:
            interval = self.cluster.settings.get(
                "retry_unsuccessful_join_after", 0.25)
            self._join_retry_task = \
                self.context.system.scheduler.schedule_tell_with_fixed_delay(
                    interval, interval, self.self_ref, _JoinRetryTick())
        self._join_to(seeds[0])

    def _join_retry(self) -> None:
        if self.gossip.has_member(self.self_node):
            self._stop_join_retry()
            return
        seeds = getattr(self, "_join_seeds", ())
        if not seeds:
            self._stop_join_retry()
            return
        self._join_idx = (self._join_idx + 1) % len(seeds)
        self._join_to(seeds[self._join_idx])

    def _stop_join_retry(self) -> None:
        task = getattr(self, "_join_retry_task", None)
        if task is not None:
            task.cancel()
        self._join_retry_task = None
        self._join_seeds = ()

    def _join_to(self, address_str: str) -> None:
        if address_str == self.self_node.address_str:
            # join self: become the first member of a new cluster
            if not self.gossip.has_member(self.self_node):
                m = Member(self.self_node, MemberStatus.JOINING, self.roles)
                self.gossip = (self.gossip.with_member(m)
                               .bump(self.self_node)
                               .seen_by(self.self_node))
                self._publish_changes()
            self._stop_join_retry()
        else:
            self._send_to_addr(address_str,
                               Join(self.self_node, self.roles,
                                    self.cluster.config_digest))

    def _joining(self, node: UniqueAddress, roles: FrozenSet[str],
                 config_digest: str = "") -> None:
        if not self.gossip.has_member(self.self_node):
            return  # not yet a member ourselves; joiner will retry
        # configuration compatibility check at first contact (reference:
        # JoinConfigCompatChecker.scala:18 + ClusterDaemon joining's
        # validateJoin): a node with incompatible cluster-critical config
        # is refused with a logged reason, never admitted
        if (self.cluster.enforce_config_compat and config_digest
                and config_digest != self.cluster.config_digest):
            reason = (f"incompatible cluster configuration from {node}: "
                      f"digest {config_digest[:12]} != "
                      f"{self.cluster.config_digest[:12]} over "
                      f"{self.cluster.config_compat_paths}")
            self._log_warning(reason)
            self._send_to(node, JoinRefused(self.self_node, reason))
            return
        existing = self.gossip.member(node)
        if existing is not None and existing.status is not MemberStatus.REMOVED:
            self._send_to(node, Welcome(self.self_node, self.gossip))
            return
        # restarted incarnation of same address: remove the old member first
        for m in list(self.gossip.members):
            if m.address_str == node.address_str and m.unique_address != node:
                self.gossip = self.gossip.without_member(m)
        m = Member(node, MemberStatus.JOINING, roles)
        self.gossip = (self.gossip.with_member(m)
                       .bump(self.self_node)
                       .only_seen_by(self.self_node))
        self._publish_changes()
        self._send_to(node, Welcome(self.self_node, self.gossip))

    def _join_refused(self, msg: JoinRefused) -> None:
        """The contact node rejected our config: log loudly and STOP
        retrying (an operator must fix the config; hammering the seed with
        doomed joins helps nobody)."""
        self._log_warning(
            f"join refused by {msg.from_node}: {msg.reason}")
        self._stop_join_retry()
        self.cluster.join_refused_reason = msg.reason

    def _log_warning(self, text: str) -> None:
        from ..event.logging import Warning as _Warning
        self.context.system.event_stream.publish(
            _Warning(str(self.self_ref.path), "ClusterCoreDaemon", text))

    def _welcome(self, w: Welcome) -> None:
        if not w.gossip.has_member(self.self_node):
            return
        self.gossip = w.gossip.seen_by(self.self_node)
        self._publish_changes()
        self._gossip_to(w.from_node)

    # -- gossip (reference: receiveGossip :994, gossipTick :1116) --------------
    def _gossip_tick(self) -> None:
        peers = [m.unique_address for m in self.gossip.members
                 if m.unique_address != self.self_node
                 and m.status not in (MemberStatus.REMOVED,)
                 and self.gossip.reachability.is_reachable(m.unique_address)]
        if not peers:
            return
        # prefer peers that haven't seen our version (faster convergence;
        # reference: gossip target selection probabilities)
        unseen = [p for p in peers if p not in self.gossip.seen]
        target = random.choice(unseen if unseen else peers)
        self._gossip_to(target)

    def _gossip_to(self, node: UniqueAddress) -> None:
        self.gossip = self.gossip.seen_by(self.self_node)
        self._send_to(node, GossipEnvelope(self.self_node, self.gossip))

    def _receive_gossip(self, env: GossipEnvelope) -> None:
        if self._removed:
            return
        remote = env.gossip
        if env.from_node in self.gossip.tombstones:
            return  # stale gossip from a removed incarnation
        if self.self_node in remote.tombstones:
            self._self_removed()
            return
        if not remote.has_member(self.self_node):
            # we were removed from the cluster's view
            me = self.gossip.member(self.self_node)
            if me is not None and me.status in (MemberStatus.EXITING,
                                                MemberStatus.DOWN,
                                                MemberStatus.LEAVING):
                self._self_removed()
            return
        cmp = self.gossip.version.compare(remote.version)
        if cmp.value == "Same":
            self.gossip = replace(
                self.gossip,
                seen=self.gossip.seen | remote.seen | {self.self_node})
        elif cmp.value == "Before":
            self.gossip = remote.seen_by(self.self_node)
        elif cmp.value == "After":
            self._gossip_to(env.from_node)  # we know more; push back
            return
        else:  # concurrent
            self.gossip = self.gossip.merge(remote).seen_by(self.self_node)
        self._publish_changes()
        # reply if sender hasn't seen what we now have
        if env.from_node not in self.gossip.seen:
            self._gossip_to(env.from_node)
        me = self.gossip.member(self.self_node)
        if me is not None and me.status is MemberStatus.REMOVED:
            self._self_removed()

    # -- leader actions (reference: leaderActions :1166, :1245) ----------------
    def _leader_actions(self) -> None:
        if self._removed or not self.gossip.members:
            return
        # per-DC leadership: each data center's (lowest-address) leader
        # promotes/removes ITS OWN members only (MembershipState.leaderOf)
        leader = self.gossip.leader(self.self_node, dc=self.dc)
        if leader != self.self_node:
            return
        changed = False
        removed_nodes = []
        if self.gossip.convergence(self.self_node, dc=self.dc):
            up_number = self.gossip.youngest_up_number
            for m in list(self.gossip.members):
                if m.data_center != self.dc:
                    continue
                if m.status in (MemberStatus.JOINING, MemberStatus.WEAKLY_UP):
                    up_number += 1
                    self.gossip = self.gossip.with_member(
                        m.copy_with(MemberStatus.UP, up_number=up_number))
                    changed = True
                elif m.status is MemberStatus.LEAVING:
                    self.gossip = self.gossip.with_member(
                        m.copy_with(MemberStatus.EXITING))
                    changed = True
                elif m.status in (MemberStatus.EXITING, MemberStatus.DOWN):
                    self.gossip = self.gossip.without_member(m)
                    self._publish_removed(m)
                    removed_nodes.append(m.unique_address)
                    changed = True
        elif self.cluster.settings["allow_weakly_up"]:
            # no convergence (unreachable nodes): still let joiners in weakly
            unreachable = self.gossip.reachability.all_unreachable
            for m in list(self.gossip.members):
                if (m.data_center == self.dc
                        and m.status is MemberStatus.JOINING
                        and m.unique_address not in unreachable):
                    self.gossip = self.gossip.with_member(
                        m.copy_with(MemberStatus.WEAKLY_UP))
                    changed = True
            # leader can always remove Down members it observes as unreachable?
            # reference requires convergence-among-reachable; approximate:
            reachable_seen = {n for n in self.gossip.seen if n not in unreachable}
            reachable_members = {m.unique_address for m in self.gossip.members
                                 if m.unique_address not in unreachable
                                 and m.data_center == self.dc
                                 and m.status in (MemberStatus.UP, MemberStatus.LEAVING)}
            if reachable_members <= reachable_seen:
                for m in list(self.gossip.members):
                    if m.status is MemberStatus.DOWN \
                            and m.data_center == self.dc:
                        self.gossip = self.gossip.without_member(m)
                        self._publish_removed(m)
                        removed_nodes.append(m.unique_address)
                        changed = True
        if changed:
            self.gossip = (self.gossip.bump(self.self_node)
                           .only_seen_by(self.self_node))
            self._publish_changes()
            # final notice so removed nodes learn their fate (reference:
            # ExitingCompleted hand-off; they are no longer gossip targets)
            for node in removed_nodes:
                if node != self.self_node:
                    self._send_to(node, GossipEnvelope(self.self_node, self.gossip))

    # -- heartbeats + reaping (reference: ClusterHeartbeat.scala — ring is
    # PER-DC; CrossDcClusterHeartbeat.scala:39 — the oldest members of each
    # DC also monitor the oldest members of the other DCs at a lower rate) --
    def _alive_members(self) -> list:
        return [m for m in self.gossip.members
                if m.status in (MemberStatus.JOINING, MemberStatus.WEAKLY_UP,
                                MemberStatus.UP, MemberStatus.LEAVING)]

    def _neighbors(self) -> list:
        alive = [m.unique_address for m in self._alive_members()
                 if m.unique_address != self.self_node
                 and m.data_center == self.dc]
        if not alive:
            return []
        from ..utils.hashing import stable_hash
        ring = sorted(alive + [self.self_node],
                      key=lambda n: stable_hash((n.address_str, n.uid)))
        i = ring.index(self.self_node)
        k = self.cluster.settings["monitored_by_nr_of_members"]
        out = []
        for step in range(1, len(ring)):
            if len(out) >= k:
                break
            out.append(ring[(i + step) % len(ring)])
        return out

    def _cross_dc_targets(self) -> list:
        """Other-DC nodes THIS node monitors: only when self is among the
        `cross-dc-connections` OLDEST members of its DC, and then the same
        number of oldest members of every other DC
        (CrossDcHeartbeatSender.activeReceivers semantics)."""
        k = self._cross_dc["monitoring_members"]
        by_dc: Dict[str, list] = {}
        for m in self._alive_members():
            by_dc.setdefault(m.data_center, []).append(m)
        mine = sorted(by_dc.get(self.dc, ()),
                      key=lambda m: (m.up_number, m.unique_address))
        if self.self_node not in [m.unique_address for m in mine[:k]]:
            return []
        out = []
        for dc, members in by_dc.items():
            if dc == self.dc:
                continue
            oldest = sorted(members,
                            key=lambda m: (m.up_number, m.unique_address))[:k]
            out.extend(m.unique_address for m in oldest)
        return out

    def _heartbeat_tick(self) -> None:
        self._hb_tick_count += 1
        targets = list(self._neighbors())
        if self._hb_tick_count % self._cross_dc["interval_factor"] == 0:
            # cross-DC heartbeats ride DCN at a lower rate than the
            # intra-DC (ICI-local) ring
            targets += self._cross_dc_targets()
        for n in targets:
            self._send_to(n, ClusterHeartbeat(self.self_node))
            if not self.fd.is_monitoring(n.address_str):
                # arm the detector at first send: a neighbor that NEVER
                # responds must still become unreachable (the phi estimator
                # bootstraps from first-heartbeat-estimate)
                self.fd.heartbeat(n.address_str)

    def _reap_unreachable(self) -> None:
        if self._removed:
            return
        changed = False
        monitored = set(self._neighbors()) | set(self._cross_dc_targets())
        currently_unreachable = self.gossip.reachability.all_unreachable_from(
            self.self_node)
        for n in monitored:
            addr = n.address_str
            if not self.fd.is_monitoring(addr):
                continue
            if not self.fd.is_available(addr) and n not in currently_unreachable:
                self.gossip = replace(
                    self.gossip, seen=frozenset({self.self_node}),
                    reachability=self.gossip.reachability.unreachable(
                        self.self_node, n)).bump(self.self_node)
                changed = True
        for n in currently_unreachable:
            addr = n.address_str
            if self.fd.is_monitoring(addr) and self.fd.is_available(addr):
                self.gossip = replace(
                    self.gossip, seen=frozenset({self.self_node}),
                    reachability=self.gossip.reachability.reachable(
                        self.self_node, n)).bump(self.self_node)
                changed = True
        if changed:
            self._publish_changes()

    # -- leave / down (reference: leaving :834, downing) -----------------------
    def _leaving(self, address_str: str) -> None:
        for m in self.gossip.members:
            if m.address_str == address_str and m.status in (
                    MemberStatus.JOINING, MemberStatus.WEAKLY_UP, MemberStatus.UP):
                self.gossip = (self.gossip.with_member(m.copy_with(MemberStatus.LEAVING))
                               .bump(self.self_node)
                               .only_seen_by(self.self_node))
                self._publish_changes()
                return

    def _downing(self, address_str: str) -> None:
        for m in self.gossip.members:
            if m.address_str == address_str and m.status not in (
                    MemberStatus.DOWN, MemberStatus.REMOVED):
                self.gossip = (self.gossip.with_member(m.copy_with(MemberStatus.DOWN))
                               .bump(self.self_node)
                               .only_seen_by(self.self_node))
                self._publish_changes()  # publishes the MemberDowned event
                if m.unique_address == self.self_node:
                    self._self_removed()
                return

    def _self_removed(self) -> None:
        if self._removed:
            return
        self._removed = True
        me = self.gossip.member(self.self_node)
        prev = me.status if me is not None else MemberStatus.REMOVED
        self.context.system.event_stream.publish(MemberRemoved(
            Member(self.self_node, MemberStatus.REMOVED, self.roles), prev))
        self.cluster._on_self_removed()

    # -- event publication -----------------------------------------------------
    def _current_state(self) -> CurrentClusterState:
        unreachable = frozenset(
            m for m in self.gossip.members
            if m.unique_address in self.gossip.reachability.all_unreachable)
        return CurrentClusterState(
            members=self.gossip.members, unreachable=unreachable,
            leader=self.gossip.leader(self.self_node, dc=self.dc),
            seen_by=self.gossip.seen)

    def _publish_removed(self, m: Member) -> None:
        self.context.system.event_stream.publish(
            MemberRemoved(Member(m.unique_address, MemberStatus.REMOVED, m.roles),
                          m.status))
        self._published.pop(m.unique_address, None)

    def _publish_changes(self) -> None:
        es = self.context.system.event_stream
        self.cluster._latest_state = self._current_state()
        for m in self.gossip.members:
            prev = self._published.get(m.unique_address)
            if prev == m.status:
                continue
            self._published[m.unique_address] = m.status
            if m.status is MemberStatus.JOINING:
                es.publish(MemberJoined(m))
            elif m.status is MemberStatus.WEAKLY_UP:
                es.publish(MemberWeaklyUp(m))
            elif m.status is MemberStatus.UP:
                es.publish(MemberUp(m))
            elif m.status is MemberStatus.LEAVING:
                es.publish(MemberLeft(m))
            elif m.status is MemberStatus.EXITING:
                es.publish(MemberExited(m))
            elif m.status is MemberStatus.DOWN:
                es.publish(MemberDowned(m))
        # removed members no longer in gossip
        current = {m.unique_address for m in self.gossip.members}
        for node in list(self._published):
            if node not in current:
                status = self._published.pop(node)
                es.publish(MemberRemoved(
                    Member(node, MemberStatus.REMOVED), status))
        # reachability diffs
        unreachable = frozenset(n for n in self.gossip.reachability.all_unreachable
                                if self.gossip.has_member(n))
        for n in unreachable - self._published_unreachable:
            m = self.gossip.member(n)
            if m is not None:
                es.publish(UnreachableMember(m))
        for n in self._published_unreachable - unreachable:
            m = self.gossip.member(n)
            if m is not None:
                es.publish(ReachableMember(m))
        self._published_unreachable = unreachable
        # leader
        leader = self.gossip.leader(self.self_node, dc=self.dc)
        if leader != self._published_leader:
            self._published_leader = leader
            es.publish(LeaderChanged(leader))

    # -- wire helpers ----------------------------------------------------------
    def _send_to(self, node: UniqueAddress, message: Any) -> None:
        self._send_to_addr(node.address_str, message)

    def _send_to_addr(self, address_str: str, message: Any) -> None:
        provider = self.context.system.provider
        ref = provider.resolve_actor_ref(f"{address_str}/system/cluster")
        ref.tell(message, self.self_ref)
