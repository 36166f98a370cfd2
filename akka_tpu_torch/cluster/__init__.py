"""Cluster membership: gossip + vector clocks + leader actions + SBR
(reference: akka-cluster — SURVEY.md §2.4, §3.6).

A copy of `akka_tpu/cluster/__init__.py` at commit 56e9e23 (host code, no jax;
the port keeps its own copy of every module it needs).
"""

from .cluster import Cluster, ClusterExtension  # noqa: F401
from .member import Member, MemberStatus, UniqueAddress  # noqa: F401
from .vector_clock import VectorClock, Ordering  # noqa: F401
from .reachability import Reachability, ReachabilityStatus  # noqa: F401
from .gossip import Gossip  # noqa: F401
from .events import (ClusterDomainEvent, CurrentClusterState,  # noqa: F401
                     LeaderChanged, MemberDowned, MemberEvent, MemberExited,
                     MemberJoined, MemberLeft, MemberRemoved, MemberUp,
                     MemberWeaklyUp, ReachabilityEvent, ReachableMember,
                     UnreachableMember)
from .sbr import (DownAll, DowningStrategy, KeepMajority,  # noqa: F401
                  KeepOldest, SplitBrainResolver, StaticQuorum)
from .routing import (ClusterRouterGroup, ClusterRouterGroupSettings,  # noqa: F401
                      ClusterRouterPool, ClusterRouterPoolSettings)
