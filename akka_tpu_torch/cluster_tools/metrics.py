"""Cluster metrics: node load sampling, EWMA smoothing, adaptive routing.

A copy of `akka_tpu/cluster_tools/metrics.py` at commit c056b95 (host
code, no jax; the port keeps its own copy of every module it needs). One
change: the device probe (`akka.cluster.metrics.probe-device`,
`probe_device`) reads the card through `torch.cuda` (`device_memory`:
allocated bytes from `torch.cuda.memory_stats`, the limit from the card's
total memory) and raises RuntimeError without a card; the reference reads
`jax.devices()[0].memory_stats()` and swallows any error.

Reference parity: akka-cluster-metrics/src/main/scala/akka/cluster/metrics/
EWMA.scala (exponentially weighted moving average with half-life alpha),
MetricsCollector.scala (:45-78 — sigar JNI with JMX fallback; here: /proc +
os.getloadavg, with an optional device-memory probe as the
accelerator-native analogue), ClusterMetricsCollector gossip, and
ClusterMetricsRouting.scala (CapacityMetricsSelector → weighted routee
selection).
"""

from __future__ import annotations

import math
import os
import random
import threading
import time
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..actor.actor import Actor
from ..actor.props import Props
from ..actor.system import ActorSystem, ExtensionId
from ..cluster.cluster import Cluster
from ..cluster.member import MemberStatus
from ..routing.router import Routee, RoutingLogic


@dataclass(frozen=True)
class EWMA:
    """(reference: metrics/EWMA.scala) value smoothed with decay alpha, where
    alpha is derived from a half-life and the sample interval."""
    value: float
    alpha: float

    def __add__(self, x: float) -> "EWMA":
        return EWMA(self.alpha * x + (1 - self.alpha) * self.value, self.alpha)

    @staticmethod
    def alpha_for(half_life: float, collect_interval: float) -> float:
        # reference: EWMA.alpha — 1 - exp(ln(0.5) / halfLife * interval)
        return 1.0 - math.exp(math.log(0.5) / half_life * collect_interval)


@dataclass(frozen=True)
class Metric:
    name: str
    value: float
    average: Optional[EWMA] = None

    def updated(self, sample: float) -> "Metric":
        avg = (self.average + sample) if self.average else None
        return Metric(self.name, sample if avg is None else avg.value, avg)

    @property
    def smooth(self) -> float:
        return self.average.value if self.average else self.value


# standard metric names (reference: StandardMetrics)
CPU_COMBINED = "cpu-combined"            # 0..1 load fraction
SYSTEM_LOAD_AVERAGE = "system-load-average"
HEAP_MEMORY_USED = "heap-memory-used"    # here: process RSS bytes
HEAP_MEMORY_MAX = "heap-memory-max"      # here: total system memory bytes
DEVICE_MEMORY_USED = "device-memory-used"  # card memory allocated (bytes)
DEVICE_MEMORY_MAX = "device-memory-max"


@dataclass(frozen=True)
class NodeMetrics:
    address: str
    timestamp: float
    metrics: Dict[str, Metric] = field(default_factory=dict)

    def metric(self, name: str) -> Optional[Metric]:
        return self.metrics.get(name)

    def merged(self, other: "NodeMetrics") -> "NodeMetrics":
        return other if other.timestamp >= self.timestamp else self

    def updated(self, samples: Dict[str, float], ts: float,
                alpha: float) -> "NodeMetrics":
        out = dict(self.metrics)
        for name, v in samples.items():
            cur = out.get(name)
            if cur is None:
                out[name] = Metric(name, v, EWMA(v, alpha))
            else:
                out[name] = cur.updated(v)
        return NodeMetrics(self.address, ts, out)


class MetricsCollector:
    """Host+device sampler (reference: MetricsCollector.scala:45-78; sigar →
    /proc, JMX heap → RSS, plus the card's memory through torch.cuda when
    `probe_device`)."""

    def __init__(self, probe_device: bool = False):
        self.probe_device = probe_device
        self._n_cpus = os.cpu_count() or 1
        if probe_device:
            device_memory()  # refuse at once without a card

    def sample(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        try:
            load1, _, _ = os.getloadavg()
            out[SYSTEM_LOAD_AVERAGE] = load1
            out[CPU_COMBINED] = min(load1 / self._n_cpus, 1.0)
        except OSError:
            pass
        try:
            with open("/proc/meminfo") as f:
                info = {}
                for line in f:
                    parts = line.split()
                    if len(parts) >= 2:
                        info[parts[0].rstrip(":")] = int(parts[1]) * 1024
            total = info.get("MemTotal")
            avail = info.get("MemAvailable")
            if total is not None and avail is not None:
                out[HEAP_MEMORY_MAX] = float(total)
                out[HEAP_MEMORY_USED] = float(total - avail)
        except OSError:
            pass
        if self.probe_device:
            out.update(device_memory())
        return out


def device_memory() -> Dict[str, float]:
    """The card's memory: bytes allocated by this process's caching
    allocator and the card's total memory. Raises RuntimeError without a
    card (the reference's jax probe swallows every error)."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError(
            "akka.cluster.metrics.probe-device = on needs a CUDA card")
    dev = torch.cuda.current_device()
    stats = torch.cuda.memory_stats(dev)
    return {DEVICE_MEMORY_USED: float(stats.get("allocated_bytes.all.current",
                                                0)),
            DEVICE_MEMORY_MAX: float(
                torch.cuda.get_device_properties(dev).total_memory)}


# -- gossip ------------------------------------------------------------------

@dataclass(frozen=True)
class MetricsGossip:
    nodes: Dict[str, NodeMetrics]


@dataclass(frozen=True)
class _SampleTick:
    pass


@dataclass(frozen=True)
class _GossipTick:
    pass


class ClusterMetricsCollector(Actor):
    """Per-node actor: samples local metrics, gossips the merged map
    (reference: ClusterMetricsCollector in ClusterMetricsExtension.scala)."""

    def __init__(self, collect_interval: float = 0.5,
                 gossip_interval: float = 0.5, half_life: float = 6.0,
                 probe_device: bool = False):
        super().__init__()
        self.collector = MetricsCollector(probe_device)
        self.alpha = EWMA.alpha_for(half_life, collect_interval)
        self.collect_interval = collect_interval
        self.gossip_interval = gossip_interval
        self.cluster = Cluster.get(self.context.system)
        self.self_addr = str(self.context.system.provider.default_address)
        self.nodes: Dict[str, NodeMetrics] = {}
        self._tasks = []

    def pre_start(self) -> None:
        s = self.context.system.scheduler
        self._tasks = [
            s.schedule_tell_with_fixed_delay(0.0, self.collect_interval,
                                             self.self_ref, _SampleTick()),
            s.schedule_tell_with_fixed_delay(self.gossip_interval,
                                             self.gossip_interval,
                                             self.self_ref, _GossipTick()),
        ]

    def post_stop(self) -> None:
        for t in self._tasks:
            t.cancel()

    def receive(self, message: Any) -> Any:
        if isinstance(message, _SampleTick):
            now = time.time()
            cur = self.nodes.get(
                self.self_addr, NodeMetrics(self.self_addr, now))
            self.nodes[self.self_addr] = cur.updated(
                self.collector.sample(), now, self.alpha)
            ext = ClusterMetricsExtension.get(self.context.system)
            ext._publish(dict(self.nodes))
        elif isinstance(message, _GossipTick):
            peers = [str(m.address) for m in self.cluster.state.members
                     if m.status is MemberStatus.UP
                     and str(m.address) != self.self_addr]
            if peers:
                target = random.choice(peers)
                rel = self.context.self_ref.path.to_string_without_address()
                ref = self.context.system.provider.resolve_actor_ref(
                    f"{target}{rel}")
                ref.tell(MetricsGossip(dict(self.nodes)), self.self_ref)
        elif isinstance(message, MetricsGossip):
            for addr, nm in message.nodes.items():
                cur = self.nodes.get(addr)
                self.nodes[addr] = nm if cur is None else cur.merged(nm)
        else:
            return NotImplemented


class ClusterMetricsExtension(ExtensionId):
    """Extension entry: starts the collector, exposes the latest metrics map
    and change subscriptions."""

    def create_extension(self, system: ActorSystem) -> "_MetricsExt":
        return _MetricsExt(system)

    @staticmethod
    def get(system: ActorSystem) -> "_MetricsExt":
        return system.register_extension(ClusterMetricsExtension())


class _MetricsExt:
    def __init__(self, system: ActorSystem):
        self.system = system
        self._lock = threading.Lock()
        self._latest: Dict[str, NodeMetrics] = {}
        self._subscribers: List[Any] = []
        cfg = system.settings.config
        if cfg.get_bool("akka.cluster.metrics.probe-device", False):
            device_memory()  # refuse at once without a card
        self.supervisor = system.system_actor_of(
            Props.create(
                ClusterMetricsCollector,
                collect_interval=cfg.get_duration(
                    "akka.cluster.metrics.collect-interval", 0.5),
                gossip_interval=cfg.get_duration(
                    "akka.cluster.metrics.gossip-interval", 0.5),
                probe_device=cfg.get_bool(
                    "akka.cluster.metrics.probe-device", False)),
            "clusterMetrics")

    def _publish(self, nodes: Dict[str, NodeMetrics]) -> None:
        with self._lock:
            self._latest = nodes
            subs = list(self._subscribers)
        for cb in subs:
            try:
                cb(nodes)
            except Exception:
                pass

    @property
    def node_metrics(self) -> Dict[str, NodeMetrics]:
        with self._lock:
            return dict(self._latest)

    def subscribe(self, callback) -> None:
        with self._lock:
            self._subscribers.append(callback)


# -- adaptive load-balancing routing (reference: ClusterMetricsRouting.scala) -

class CapacityMetricsSelector:
    """capacity(node) in [0,1]: higher = more headroom."""

    def capacity(self, nodes: Dict[str, NodeMetrics]) -> Dict[str, float]:
        raise NotImplementedError

    def weights(self, nodes: Dict[str, NodeMetrics]) -> Dict[str, int]:
        cap = self.capacity(nodes)
        if not cap:
            return {}
        lo = min(cap.values())
        divisor = max(lo, 0.01)
        return {a: max(int(round(c / divisor)), 1) for a, c in cap.items()}


class CpuMetricsSelector(CapacityMetricsSelector):
    def capacity(self, nodes):
        out = {}
        for addr, nm in nodes.items():
            m = nm.metric(CPU_COMBINED)
            if m is not None:
                out[addr] = max(0.0, 1.0 - m.smooth)
        return out


class MemoryMetricsSelector(CapacityMetricsSelector):
    """Host memory headroom; prefers device (HBM) headroom when sampled —
    the device-native capacity signal."""

    def capacity(self, nodes):
        out = {}
        for addr, nm in nodes.items():
            used, cap = nm.metric(DEVICE_MEMORY_USED), nm.metric(DEVICE_MEMORY_MAX)
            if not (used and cap and cap.smooth > 0):
                used, cap = nm.metric(HEAP_MEMORY_USED), nm.metric(HEAP_MEMORY_MAX)
            if used and cap and cap.smooth > 0:
                out[addr] = max(0.0, (cap.smooth - used.smooth) / cap.smooth)
        return out


class MixMetricsSelector(CapacityMetricsSelector):
    def __init__(self, selectors: Optional[Sequence[CapacityMetricsSelector]] = None):
        self.selectors = list(selectors) if selectors else [
            CpuMetricsSelector(), MemoryMetricsSelector()]

    def capacity(self, nodes):
        acc: Dict[str, List[float]] = {}
        for sel in self.selectors:
            for addr, c in sel.capacity(nodes).items():
                acc.setdefault(addr, []).append(c)
        return {a: sum(cs) / len(cs) for a, cs in acc.items()}


class AdaptiveLoadBalancingRoutingLogic(RoutingLogic):
    """Weighted-random routee selection by node capacity (reference:
    AdaptiveLoadBalancingRoutingLogic). Routee→node mapping uses the routee
    ref's address; local refs map to the system's own address."""

    def __init__(self, system: ActorSystem,
                 selector: Optional[CapacityMetricsSelector] = None):
        self.system = system
        self.selector = selector or MixMetricsSelector()
        self.self_addr = str(system.provider.default_address)

    def _node_of(self, routee: Routee) -> str:
        ref = getattr(routee, "ref", None)
        if ref is None:
            return self.self_addr
        addr = ref.path.address
        return str(addr) if addr.has_global_scope else self.self_addr

    def select(self, message: Any, routees: Sequence[Routee]) -> Routee:
        if not routees:
            raise ValueError("no routees")
        nodes = ClusterMetricsExtension.get(self.system).node_metrics
        weights = self.selector.weights(nodes)
        if not weights:
            return random.choice(list(routees))
        ws = [max(weights.get(self._node_of(r), 1), 1) for r in routees]
        return random.choices(list(routees), weights=ws, k=1)[0]
