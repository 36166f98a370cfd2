"""Replicated state (CRDTs): akka-distributed-data equivalent.

A copy of `akka_tpu/ddata/__init__.py` at commit c056b95 (host code, no
jax; the port keeps its own copy of every module it needs).

Host control plane: Replicator actor with Get/Update/Subscribe/Delete and
tunable consistency, gossip + delta propagation, durable keys. Device data
plane: tensor CRDT banks whose merge is one elementwise op and whose
convergence over a mesh is one collective (akka_tpu_torch/ddata/tensor.py).
"""

from .version_vector import Ordering, VersionVector  # noqa: F401
from .crdt import (DeltaReplicatedData, Flag, GCounter, GSet,  # noqa: F401
                   LWWMap, LWWRegister, ORMap, ORMultiMap, ORSet, PNCounter,
                   PNCounterMap, RemovedNodePruning, ReplicatedData)
from .durable import DurableStore  # noqa: F401
from .replicator import (Changed, DataDeleted, Delete, Deleted,  # noqa: F401
                         DeleteSuccess, DistributedData, Get, GetDataDeleted,
                         GetFailure, GetKeyIds, GetKeyIdsResult,
                         GetReplicaCount, GetSuccess, Key, ModifyFailure,
                         NotFound, ReadAll, ReadFrom, ReadLocal, ReadMajority,
                         ReplicaCount, ReplicationDeleteFailure, Replicator,
                         ReplicatorSettings, Subscribe, Unsubscribe, Update,
                         UpdateDataDeleted, UpdateSuccess, UpdateTimeout,
                         WriteAll, WriteLocal, WriteMajority, WriteTo)
from . import tensor  # noqa: F401

__all__ = [
    "VersionVector", "Ordering",
    "ReplicatedData", "DeltaReplicatedData", "RemovedNodePruning",
    "GCounter", "PNCounter", "GSet", "ORSet", "ORMap", "ORMultiMap",
    "PNCounterMap", "LWWMap", "LWWRegister", "Flag",
    "Replicator", "ReplicatorSettings", "DistributedData", "Key",
    "Get", "GetSuccess", "NotFound", "GetFailure", "GetDataDeleted",
    "Update", "UpdateSuccess", "UpdateTimeout", "ModifyFailure",
    "UpdateDataDeleted", "Delete", "DeleteSuccess", "DataDeleted",
    "ReplicationDeleteFailure", "Subscribe", "Unsubscribe", "Changed",
    "Deleted", "GetKeyIds", "GetKeyIdsResult", "GetReplicaCount",
    "ReplicaCount",
    "ReadLocal", "ReadFrom", "ReadMajority", "ReadAll",
    "WriteLocal", "WriteTo", "WriteMajority", "WriteAll",
    "DurableStore", "tensor",
]
