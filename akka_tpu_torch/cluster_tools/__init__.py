"""Cluster services: singleton, distributed pub-sub, lease, discovery, metrics.

A copy of `akka_tpu/cluster_tools/__init__.py` at commit c056b95 (host
code, no jax; the port keeps its own copy of every module it needs).

Reference parity: akka-cluster-tools (singleton/ClusterSingletonManager.scala,
pubsub/DistributedPubSubMediator.scala), akka-coordination
(lease/scaladsl/LeaseProvider.scala), akka-discovery
(discovery/ServiceDiscovery.scala), akka-cluster-metrics (EWMA.scala,
ClusterMetricsRouting.scala). SURVEY.md §2.6.
"""

from .singleton import (ClusterSingletonManager, ClusterSingletonProxy,
                        ClusterSingletonSettings)
from .pubsub import (DistributedPubSub, DistributedPubSubMediator, Publish,
                     Put, Remove, Send, SendToAll, Subscribe, SubscribeAck,
                     Unsubscribe, UnsubscribeAck, GetTopics, CurrentTopics)
from .lease import Lease, LeaseProvider, LeaseSettings, InProcLease, TimeoutSettings
from .discovery import (AggregateServiceDiscovery, ConfigServiceDiscovery,
                        DnsServiceDiscovery,
                        Discovery, Lookup, Resolved, ResolvedTarget,
                        ServiceDiscovery)
from .metrics import (EWMA, AdaptiveLoadBalancingRoutingLogic,
                      ClusterMetricsExtension, NodeMetrics,
                      CapacityMetricsSelector, CpuMetricsSelector,
                      MemoryMetricsSelector, MixMetricsSelector)

__all__ = [
    "ClusterSingletonManager", "ClusterSingletonProxy", "ClusterSingletonSettings",
    "DistributedPubSub", "DistributedPubSubMediator", "Publish", "Put", "Remove",
    "Send", "SendToAll", "Subscribe", "SubscribeAck", "Unsubscribe",
    "UnsubscribeAck", "GetTopics", "CurrentTopics",
    "Lease", "LeaseProvider", "LeaseSettings", "InProcLease", "TimeoutSettings",
    "AggregateServiceDiscovery", "ConfigServiceDiscovery", "DnsServiceDiscovery",
    "Discovery", "Lookup",
    "Resolved", "ResolvedTarget", "ServiceDiscovery",
    "EWMA", "AdaptiveLoadBalancingRoutingLogic", "ClusterMetricsExtension",
    "NodeMetrics", "CapacityMetricsSelector", "CpuMetricsSelector",
    "MemoryMetricsSelector", "MixMetricsSelector",
    "ClusterClient", "ClusterClientReceptionist", "ClusterClientSettings",
]
from .client import (ClusterClient, ClusterClientReceptionist,  # noqa: F401
                     ClusterClientSettings)
