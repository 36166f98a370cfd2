"""Cluster extension: the per-system membership façade.

A copy of `akka_tpu/cluster/cluster.py` at commit 56e9e23 (host code, no jax;
the port keeps its own copy of every module it needs). One change:
`Cluster.get` forgets a system's instance when the system terminates.

Reference parity: akka-cluster/src/main/scala/akka/cluster/Cluster.scala —
`Cluster(system)` extension exposing join/joinSeedNodes/leave/down, subscribe
with initial-state snapshot, selfMember/state, registerOnMemberUp; the daemon
hierarchy at /system/cluster (ClusterDaemon.scala:312); seed-node process
(SeedNodeProcess.scala, simplified: join the first seed, self-join if we ARE
the first seed); SBR wired per sbr/SplitBrainResolver.scala.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional

from ..actor.path import Address
from ..actor.props import Props
from ..actor.system import ActorSystem, CoordinatedShutdown, ExtensionId
from ..pattern.ask import ask_sync
from ..remote.failure_detector import PhiAccrualFailureDetector
from .daemon import ClusterCoreDaemon, DownCmd, JoinTo, LeaveCmd
from .events import CurrentClusterState, MemberRemoved, MemberUp
from .member import Member, MemberStatus, UniqueAddress
from .sbr import SplitBrainResolver, strategy_from_config


class Cluster:
    """Obtain via Cluster.get(system)."""

    _instances: dict = {}
    _lock = threading.Lock()

    @staticmethod
    def get(system: ActorSystem) -> "Cluster":
        with Cluster._lock:
            inst = Cluster._instances.get(system)
            if inst is None:
                inst = Cluster._instances[system] = Cluster(system)
                # the port drops a terminated system's instance (the
                # reference keeps every system, and what it holds, alive)
                system.register_on_termination(
                    lambda: Cluster._instances.pop(system, None))
            return inst

    def __init__(self, system: ActorSystem):
        provider = system.provider
        if not hasattr(provider, "local_address") or provider.local_address is None:
            raise RuntimeError(
                "Cluster requires akka.actor.provider = remote|cluster")
        self.system = system
        cfg = system.settings.config.get_config("akka.cluster")
        fd_cfg = cfg.get_config("failure-detector")
        self.self_unique_address = UniqueAddress(
            str(provider.local_address), provider.uid)
        # the data center rides the roles set as `dc-<name>` (reference:
        # ClusterSettings.DcRolePrefix; multi-DC membership per
        # CrossDcClusterHeartbeat.scala / MembershipState per-DC logic).
        # Natural TPU mapping: one DC per slice/pod, DCN between DCs.
        self.self_data_center = cfg.get_string(
            "multi-data-center.self-data-center", "default")
        user_roles = frozenset(cfg.get("roles", []) or [])
        reserved = [r for r in user_roles if r.startswith("dc-")]
        if reserved:
            # the dc- prefix is RESERVED for the data-center encoding
            # (reference: ClusterSettings requires roles not start with
            # the DcRolePrefix); a second dc- role would make
            # Member.data_center ambiguous
            raise ValueError(
                f"cluster roles must not use the reserved 'dc-' prefix "
                f"(got {reserved}); set "
                f"akka.cluster.multi-data-center.self-data-center instead")
        self.self_roles = user_roles | \
            frozenset({f"dc-{self.self_data_center}"})
        mdc = cfg.get_config("multi-data-center")
        self.cross_dc_settings = {
            "monitoring_members": mdc.get_int(
                "cross-dc-connections", 2),
            "interval_factor": max(1, mdc.get_int(
                "cross-dc-heartbeat-interval-factor", 3)),
        }
        self.fd_factory = lambda: PhiAccrualFailureDetector(
            threshold=fd_cfg.get_float("threshold", 8.0),
            max_sample_size=fd_cfg.get_int("max-sample-size", 1000),
            min_std_deviation=fd_cfg.get_duration("min-std-deviation", "100ms"),
            acceptable_heartbeat_pause=fd_cfg.get_duration(
                "acceptable-heartbeat-pause", "3s"),
            first_heartbeat_estimate=fd_cfg.get_duration(
                "expected-first-heartbeat-estimate", "1s"))
        self.settings = {
            "gossip_interval": cfg.get_duration("gossip-interval", "1s"),
            "leader_actions_interval": cfg.get_duration("leader-actions-interval", "1s"),
            "reaper_interval": cfg.get_duration("unreachable-nodes-reaper-interval", "1s"),
            "heartbeat_interval": fd_cfg.get_duration("heartbeat-interval", "1s"),
            "monitored_by_nr_of_members": fd_cfg.get_int("monitored-by-nr-of-members", 5),
            "allow_weakly_up": cfg.get_bool("allow-weakly-up-members", True),
        }
        self._latest_state = CurrentClusterState()
        self._on_member_up: List[Callable[[], None]] = []
        self._member_up_fired = False
        self._removed_event = threading.Event()

        # join-time configuration compatibility (reference:
        # JoinConfigCompatChecker.scala:18 — a configurable set of
        # cluster-critical paths is digested; the contact node compares)
        compat = cfg.get_config("configuration-compatibility-check")
        self.enforce_config_compat = compat.get_bool("enforce-on-join", True)
        self.config_compat_paths = tuple(
            compat.get("sensitive-config-paths", None) or (
                "downing-provider-class",
                "split-brain-resolver.active-strategy",
                "allow-weakly-up-members",
            ))
        import hashlib as _hashlib
        import json as _json
        snapshot = {p: cfg.get(p, None) for p in self.config_compat_paths}
        self.config_digest = _hashlib.sha256(
            _json.dumps(snapshot, sort_keys=True, default=str)
            .encode()).hexdigest()
        self.join_refused_reason: Optional[str] = None

        self.daemon = system.system_actor_of(
            Props.create(ClusterCoreDaemon, self), "cluster")

        # downing is OPT-IN (the reference defaults to no downing provider):
        # enable SBR only when explicitly selected, either via
        # downing-provider-class = "sbr" or a configured active-strategy
        sbr_cfg = cfg.get_config("split-brain-resolver")
        provider = cfg.get_string("downing-provider-class", "")
        active = sbr_cfg.get_string("active-strategy", "")
        if provider == "sbr" or active not in ("", "off"):
            self.sbr = system.system_actor_of(
                Props.create(SplitBrainResolver, self,
                             strategy_from_config(
                                 sbr_cfg, system=system,
                                 self_owner=str(self.self_unique_address)),
                             sbr_cfg.get_duration("stable-after", "20s")),
                "split-brain-resolver")
        else:
            self.sbr = None

        self._es_sub = self._on_event
        system.event_stream.subscribe(self._es_sub, MemberUp)
        system.event_stream.subscribe(self._es_sub, MemberRemoved)
        system.coordinated_shutdown.add_task(
            CoordinatedShutdown.PHASE_CLUSTER_LEAVE, "leave-cluster",
            self._leave_on_shutdown)

        seeds = cfg.get("seed-nodes", []) or []
        if seeds:
            self.join_seed_nodes(seeds)

    # -- event plumbing -------------------------------------------------------
    def _on_event(self, event: Any) -> None:
        if isinstance(event, MemberUp):
            if (event.member.unique_address == self.self_unique_address
                    and not self._member_up_fired):
                self._member_up_fired = True
                for cb in self._on_member_up:
                    try:
                        cb()
                    except Exception:  # noqa: BLE001
                        pass
        elif isinstance(event, MemberRemoved):
            if event.member.unique_address == self.self_unique_address:
                self._removed_event.set()

    def _on_self_removed(self) -> None:
        self._removed_event.set()

    # -- API (reference: Cluster.scala join/leave/down/subscribe) -------------
    def join(self, address: "str | Address") -> None:
        self.daemon.tell(JoinTo(_addr_str(address)))

    def join_seed_nodes(self, seeds: List[str]) -> None:
        seeds = [_addr_str(s) for s in seeds]
        if not seeds:
            return
        from .daemon import JoinSeedNodes
        if seeds[0] == self.self_unique_address.address_str:
            self.join(seeds[0])  # we are the first seed: self-join
        else:
            # rotate through seeds until one welcomes us
            self.daemon.tell(JoinSeedNodes(tuple(seeds)))

    def leave(self, address: "str | Address | None" = None) -> None:
        target = _addr_str(address) if address is not None else \
            self.self_unique_address.address_str
        # leaving must spread: tell ourselves AND every known node's daemon
        self.daemon.tell(LeaveCmd(target))

    def down(self, address: "str | Address") -> None:
        self.daemon.tell(DownCmd(_addr_str(address)))

    def subscribe(self, subscriber: Callable[[Any], None],
                  *event_classes: type, initial_state: bool = True) -> None:
        if initial_state:
            subscriber(self.state)
        for cls in event_classes:
            self.system.event_stream.subscribe(subscriber, cls)

    def unsubscribe(self, subscriber: Callable[[Any], None]) -> None:
        self.system.event_stream.unsubscribe(subscriber)

    @property
    def state(self) -> CurrentClusterState:
        return self._latest_state

    @property
    def self_member(self) -> Optional[Member]:
        for m in self._latest_state.members:
            if m.unique_address == self.self_unique_address:
                return m
        return None

    def register_on_member_up(self, cb: Callable[[], None]) -> None:
        if self._member_up_fired:
            cb()
        else:
            self._on_member_up.append(cb)

    @property
    def is_removed(self) -> bool:
        return self._removed_event.is_set()

    def await_removed(self, timeout: Optional[float] = None) -> bool:
        return self._removed_event.wait(timeout)

    def _leave_on_shutdown(self) -> None:
        if self.self_member is not None and not self.is_removed:
            self.leave()
            self._removed_event.wait(5.0)


class ClusterExtension(ExtensionId):
    def create_extension(self, system: ActorSystem) -> Cluster:
        return Cluster.get(system)


def _addr_str(address: "str | Address") -> str:
    return str(address) if isinstance(address, Address) else str(address)
