"""ShardCoordinator: singleton allocator of shards to regions + rebalance.

A copy of `akka_tpu/sharding/coordinator.py` at commit 5834bbc (host
code, no jax; the port keeps its own copy of every module it needs).

Reference parity: akka-cluster-sharding/src/main/scala/akka/cluster/sharding/
ShardCoordinator.scala — allocation-strategy interface (:90-160),
LeastShardAllocationStrategy (:201 — allocate to the region with fewest
shards; rebalance from most- to least-loaded until within threshold), and the
coordinator protocol (Register/GetShardHome/ShardHome/BeginHandOff/HandOff).

Runs as the child of a ClusterSingletonManager (one live coordinator
cluster-wide, on the oldest node). Region refs are carried as path strings so
the protocol serializes across nodes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Set

from ..actor.actor import Actor
from ..actor.messages import Terminated
from .messages import (BeginHandOff, BeginHandOffAck, GetShardHome,
                       GracefulShutdownReq, HandOff, HostShard, Register,
                       RegisterAck, RegisterProxy, ShardHome, ShardStopped)


class ShardAllocationStrategy:
    """(reference: ShardCoordinator.scala:90-160)"""

    def allocate_shard(self, requester: str, shard_id: str,
                       current: Dict[str, List[str]]) -> str:
        """Pick the region (path) to host shard_id. `current` maps
        region-path -> shard ids it hosts."""
        raise NotImplementedError

    def rebalance(self, current: Dict[str, List[str]],
                  in_progress: Set[str]) -> Set[str]:
        """Return shard ids to hand off this round."""
        raise NotImplementedError


class LeastShardAllocationStrategy(ShardAllocationStrategy):
    """(reference: ShardCoordinator.scala:201) — allocate to the least-loaded
    region; rebalance when max-min exceeds `rebalance_threshold`, at most
    `max_simultaneous_rebalance` in flight."""

    def __init__(self, rebalance_threshold: int = 1,
                 max_simultaneous_rebalance: int = 3):
        self.rebalance_threshold = rebalance_threshold
        self.max_simultaneous_rebalance = max_simultaneous_rebalance

    def allocate_shard(self, requester, shard_id, current):
        return min(current.items(), key=lambda kv: (len(kv[1]), kv[0]))[0]

    def rebalance(self, current, in_progress):
        if len(in_progress) >= self.max_simultaneous_rebalance or not current:
            return set()
        # consider only shards not already moving
        loads = {r: [s for s in shards if s not in in_progress]
                 for r, shards in current.items()}
        out: Set[str] = set()
        budget = self.max_simultaneous_rebalance - len(in_progress)
        while budget > 0:
            most = max(loads.items(), key=lambda kv: (len(kv[1]), kv[0]))
            least = min(loads.items(), key=lambda kv: (len(kv[1]), kv[0]))
            if len(most[1]) - len(least[1]) <= self.rebalance_threshold:
                break
            shard = sorted(most[1])[0]
            out.add(shard)
            most[1].remove(shard)
            budget -= 1
        return out


@dataclass(frozen=True)
class _RebalanceTick:
    pass


class ShardCoordinator(Actor):
    """State: regions (path -> hosted shards), shards (id -> region path),
    unallocated GetShardHome requests wait until a region registers."""

    def __init__(self, type_name: str,
                 allocation_strategy: Optional[ShardAllocationStrategy] = None,
                 rebalance_interval: float = 1.0):
        super().__init__()
        self.type_name = type_name
        self.strategy = allocation_strategy or LeastShardAllocationStrategy()
        self.rebalance_interval = rebalance_interval
        self.regions: Dict[str, List[str]] = {}   # region path -> shard ids
        self.proxies: Set[str] = set()
        self.shards: Dict[str, str] = {}          # shard id -> region path
        # rebalance bookkeeping: shard -> waiting-for BeginHandOffAck sources
        self.rebalance_ack_wait: Dict[str, Set[str]] = {}
        self.rebalance_in_progress: Set[str] = set()
        self.graceful_shutdown: Set[str] = set()
        self._pending_get_home: List[tuple] = []  # (shard_id, reply_to_path)
        self._watched: Dict[Any, str] = {}        # region ref -> path
        self._task = None

    def pre_start(self) -> None:
        self._task = self.context.system.scheduler.schedule_tell_with_fixed_delay(
            self.rebalance_interval, self.rebalance_interval, self.self_ref,
            _RebalanceTick())

    def post_stop(self) -> None:
        if self._task:
            self._task.cancel()

    # -- helpers -------------------------------------------------------------
    def _ref(self, path: str):
        return self.context.system.provider.resolve_actor_ref(path)

    def _self_path(self) -> str:
        ref = self.self_ref
        addr = self.context.system.provider.default_address
        return f"{addr}{ref.path.to_string_without_address()}"

    def _active_regions(self) -> Dict[str, List[str]]:
        return {r: s for r, s in self.regions.items()
                if r not in self.graceful_shutdown}

    def _allocate(self, shard_id: str, requester_path: str) -> None:
        active = self._active_regions()
        if not active:
            self._pending_get_home.append((shard_id, requester_path))
            return
        region = self.strategy.allocate_shard(requester_path, shard_id, active)
        self.shards[shard_id] = region
        self.regions[region].append(shard_id)
        self._ref(region).tell(HostShard(shard_id), self.self_ref)
        home = ShardHome(shard_id, region)
        for r in set(self.regions) | self.proxies:
            self._ref(r).tell(home, self.self_ref)

    # -- receive -------------------------------------------------------------
    def receive(self, message: Any) -> Any:  # noqa: C901
        if isinstance(message, Register):
            region_ref = self._ref(message.region_path)
            if message.region_path not in self.regions:
                self.context.watch(region_ref)
                self._watched[region_ref] = message.region_path
            self.regions.setdefault(message.region_path, [])
            self.graceful_shutdown.discard(message.region_path)
            region_ref.tell(RegisterAck(self._self_path()), self.self_ref)
            # region can now host: drain deferred allocations
            pending, self._pending_get_home = self._pending_get_home, []
            for shard_id, requester in pending:
                if shard_id not in self.shards:
                    self._allocate(shard_id, requester)
                else:
                    self._ref(requester).tell(
                        ShardHome(shard_id, self.shards[shard_id]), self.self_ref)
        elif isinstance(message, RegisterProxy):
            proxy_ref = self._ref(message.region_path)
            if message.region_path not in self.proxies:
                self.context.watch(proxy_ref)
                self._watched[proxy_ref] = message.region_path
            self.proxies.add(message.region_path)
            proxy_ref.tell(RegisterAck(self._self_path()), self.self_ref)
        elif isinstance(message, GetShardHome):
            shard_id = message.shard_id
            requester = self._sender_path()
            if shard_id in self.rebalance_in_progress:
                pass  # home is in flux; region retries
            elif shard_id in self.shards:
                self.sender.tell(ShardHome(shard_id, self.shards[shard_id]),
                                 self.self_ref)
            else:
                self._allocate(shard_id, requester)
        elif isinstance(message, BeginHandOffAck):
            self._on_begin_handoff_ack(message.shard_id)
        elif isinstance(message, ShardStopped):
            shard_id = message.shard_id
            if shard_id in self.rebalance_in_progress:
                self.rebalance_in_progress.discard(shard_id)
                region = self.shards.pop(shard_id, None)
                if region and shard_id in self.regions.get(region, []):
                    self.regions[region].remove(shard_id)
        elif isinstance(message, GracefulShutdownReq):
            region = message.region_path
            if region in self.regions:
                self.graceful_shutdown.add(region)
                for shard_id in list(self.regions[region]):
                    self._start_rebalance(shard_id)
        elif isinstance(message, _RebalanceTick):
            for shard_id in self.strategy.rebalance(self._active_regions(),
                                                    self.rebalance_in_progress):
                self._start_rebalance(shard_id)
        elif isinstance(message, Terminated):
            self._region_terminated(message.actor)
        else:
            return NotImplemented

    def _region_terminated(self, ref: Any) -> None:
        """Free a dead region's shards so they reallocate on next demand, and
        unwedge any rebalance waiting on its acks (reference:
        ShardCoordinator regionTerminated)."""
        path = self._watched.pop(ref, None)
        if path is None:
            return
        self.proxies.discard(path)
        self.graceful_shutdown.discard(path)
        for shard_id in self.regions.pop(path, []):
            self.shards.pop(shard_id, None)
            self.rebalance_in_progress.discard(shard_id)
            self.rebalance_ack_wait.pop(shard_id, None)
        for shard_id in list(self.rebalance_ack_wait):
            waiting = self.rebalance_ack_wait[shard_id]
            waiting.discard(path)
            if not waiting:
                del self.rebalance_ack_wait[shard_id]
                region = self.shards.get(shard_id)
                if region is not None:
                    self._ref(region).tell(HandOff(shard_id), self.self_ref)
                else:
                    self.rebalance_in_progress.discard(shard_id)

    def _sender_path(self) -> str:
        s = self.sender
        path = s.path
        addr = path.address
        if not addr.has_global_scope:
            addr = self.context.system.provider.default_address
        return f"{addr}{path.to_string_without_address()}"

    # -- rebalance (reference: RebalanceWorker in ShardCoordinator.scala) ----
    def _start_rebalance(self, shard_id: str) -> None:
        if shard_id in self.rebalance_in_progress or shard_id not in self.shards:
            return
        self.rebalance_in_progress.add(shard_id)
        targets = set(self.regions) | self.proxies
        self.rebalance_ack_wait[shard_id] = set(targets)
        msg = BeginHandOff(shard_id)
        for r in targets:
            self._ref(r).tell(msg, self.self_ref)

    def _on_begin_handoff_ack(self, shard_id: str) -> None:
        waiting = self.rebalance_ack_wait.get(shard_id)
        if waiting is None:
            return
        waiting.discard(self._sender_path())
        if not waiting:
            del self.rebalance_ack_wait[shard_id]
            region = self.shards.get(shard_id)
            if region is not None:
                self._ref(region).tell(HandOff(shard_id), self.self_ref)
            else:
                self.rebalance_in_progress.discard(shard_id)
