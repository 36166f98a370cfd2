"""Sharding protocol messages.

A copy of `akka_tpu/sharding/messages.py` at commit 5834bbc (host
code, no jax; the port keeps its own copy of every module it needs).

Reference parity: akka-cluster-sharding/src/main/scala/akka/cluster/sharding/
ShardRegion.scala (StartEntity :440-446, Passivate, extractEntityId/
extractShardId :42-43) and ShardCoordinator.scala Internal protocol
(Register/RegisterAck/GetShardHome/ShardHome/BeginHandOff/HandOff/
ShardStopped/RebalanceTick).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple


# -- user-facing -------------------------------------------------------------

@dataclass(frozen=True)
class ShardingEnvelope:
    """(reference: sharding-typed ClusterSharding.scala:362) — explicit
    (entity_id, message) addressing; the default extractor understands it."""
    entity_id: str
    message: Any


@dataclass(frozen=True)
class StartEntity:
    """Start an entity without sending it a message (remember-entities uses
    this internally; reference ShardRegion.scala:440)."""
    entity_id: str


@dataclass(frozen=True)
class StartEntityAck:
    entity_id: str
    shard_id: str


@dataclass(frozen=True)
class Passivate:
    """Entity → its Shard parent: stop me gracefully; buffered messages will
    restart me (reference: ShardRegion.Passivate)."""
    stop_message: Any = "poison-pill"


# -- region <-> coordinator ---------------------------------------------------

@dataclass(frozen=True)
class Register:
    """Region registers itself (path string resolves cross-node)."""
    region_path: str


@dataclass(frozen=True)
class RegisterProxy:
    region_path: str


@dataclass(frozen=True)
class RegisterAck:
    coordinator_path: str


@dataclass(frozen=True)
class GetShardHome:
    shard_id: str


@dataclass(frozen=True)
class ShardHome:
    shard_id: str
    region_path: str


@dataclass(frozen=True)
class HostShard:
    """Coordinator → owning region: you now host this shard."""
    shard_id: str


@dataclass(frozen=True)
class ShardStarted:
    shard_id: str


@dataclass(frozen=True)
class BeginHandOff:
    """Coordinator → all regions: forget this shard's home (rebalance step 1)."""
    shard_id: str


@dataclass(frozen=True)
class BeginHandOffAck:
    shard_id: str


@dataclass(frozen=True)
class HandOff:
    """Coordinator → owning region: stop the shard's entities, then ack."""
    shard_id: str


@dataclass(frozen=True)
class ShardStopped:
    shard_id: str


@dataclass(frozen=True)
class GracefulShutdownReq:
    region_path: str


# -- introspection ------------------------------------------------------------

@dataclass(frozen=True)
class GetShardRegionState:
    pass


@dataclass(frozen=True)
class ShardState:
    shard_id: str
    entity_ids: Tuple[str, ...]


@dataclass(frozen=True)
class CurrentShardRegionState:
    shards: Tuple[ShardState, ...]


@dataclass(frozen=True)
class GetClusterShardingStats:
    timeout: float = 3.0


@dataclass(frozen=True)
class ClusterShardingStats:
    regions: Any  # Dict[address_str, Dict[shard_id, entity_count]]
