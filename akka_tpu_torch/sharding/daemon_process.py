"""ShardedDaemonProcess: N always-alive, sharding-pinned workers.

A copy of `akka_tpu/sharding/daemon_process.py` at commit 5834bbc (host
code, no jax; the port keeps its own copy of every module it needs).

Reference parity: akka-cluster-sharding-typed/src/main/scala/akka/cluster/
sharding/typed/scaladsl/ShardedDaemonProcess.scala:20-39 and impl/
ShardedDaemonProcessImpl.scala — the "keep N consumers of a sharded event
stream running" pattern. Each instance index becomes a sharded entity whose
id IS its shard id (one shard per instance, so the allocation strategy
spreads the N workers across the cluster and rebalances them with it), and
a keep-alive pinger periodically sends StartEntity for every index so
workers start immediately, restart after crashes, and re-spawn on their new
home after a rebalance or node loss (KeepAlivePinger in the reference impl).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

from ..actor.actor import Actor
from ..actor.props import Props
from ..actor.ref import ActorRef
from .messages import StartEntity
from .region import ClusterShardingSettings
from .typed import ClusterShardingTyped, Entity, EntityTypeKey


@dataclass(frozen=True)
class ShardedDaemonProcessSettings:
    """(reference: ShardedDaemonProcessSettings.scala)"""
    keep_alive_interval: float = 10.0   # reference default: 10s
    role: Optional[str] = None
    sharding_settings: Optional[ClusterShardingSettings] = None


class _KeepAlivePinger(Actor):
    """(reference: ShardedDaemonProcessImpl.KeepAlivePinger) — periodically
    StartEntity-pings every instance id; runs on every node hosting the
    type so at least one live node keeps the workers alive through
    departures. StartEntityAck replies are absorbed here."""

    class _Tick:
        pass

    def __init__(self, region: ActorRef, ids: tuple, interval: float):
        super().__init__()
        self._region = region
        self._ids = ids
        self._interval = interval
        self._task = None

    def pre_start(self) -> None:
        self._ping()
        self._task = self.context.system.scheduler \
            .schedule_tell_with_fixed_delay(
                self._interval, self._interval, self.self_ref, self._Tick())

    def post_stop(self) -> None:
        if self._task is not None:
            self._task.cancel()

    def _ping(self) -> None:
        for eid in self._ids:
            self._region.tell(StartEntity(eid), self.self_ref)

    def receive(self, message: Any) -> Any:
        if isinstance(message, self._Tick):
            self._ping()
        # StartEntityAck and anything else: absorbed


class ShardedDaemonProcess:
    """`ShardedDaemonProcess.get(system).init(name, n, factory)`
    (reference: scaladsl/ShardedDaemonProcess.scala:20)"""

    def __init__(self, system):
        self.system = system

    @staticmethod
    def get(system) -> "ShardedDaemonProcess":
        return ShardedDaemonProcess(system)

    def init(self, name: str, number_of_instances: int,
             behavior_factory: Callable[[int], Any],
             stop_message: Any = None,
             settings: Optional[ShardedDaemonProcessSettings] = None
             ) -> ActorRef:
        """Start (this node's share of) N always-alive workers; returns the
        backing shard region. `behavior_factory(i)` builds worker i's typed
        behavior; workers are addressed internally as entities "0".."N-1"
        of type `sharded-daemon-process-{name}`."""
        settings = settings or ShardedDaemonProcessSettings()
        ids = tuple(str(i) for i in range(number_of_instances))
        key = EntityTypeKey(f"sharded-daemon-process-{name}")

        import dataclasses
        base = settings.sharding_settings or \
            ClusterShardingSettings(role=settings.role)
        # one shard per instance: the id IS the shard (reference impl's
        # shardId = entityId message extractor), so LeastShardAllocation
        # spreads and rebalances the workers like any other shards;
        # daemons never passivate
        sharding_settings = dataclasses.replace(
            base, number_of_shards=number_of_instances,
            passivate_idle_after=None)

        def extract_shard_id(message: Any) -> Optional[str]:
            from .messages import ShardingEnvelope
            if isinstance(message, StartEntity):
                return message.entity_id
            if isinstance(message, ShardingEnvelope):
                return message.entity_id
            return None

        region = ClusterShardingTyped.get(self.system).init(Entity(
            type_key=key,
            create_behavior=lambda ctx: behavior_factory(int(ctx.entity_id)),
            settings=sharding_settings,
            stop_message=stop_message,
            extract_shard_id=extract_shard_id))
        self.system.actor_of(
            Props.create(_KeepAlivePinger, region, ids,
                         settings.keep_alive_interval),
            f"sharded-daemon-pinger-{name}")
        return region
