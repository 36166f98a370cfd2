"""Service discovery: resolve service names to addresses.

A copy of `akka_tpu/cluster_tools/discovery.py` at commit c056b95 (host
code, no jax; the port keeps its own copy of every module it needs). One
change: a DNS lookup that answers within its timeout joins its resolver
thread; one that times out leaves it to the OS resolver's own limit, as
the reference does.

Reference parity: akka-discovery/src/main/scala/akka/discovery/
ServiceDiscovery.scala (Lookup/Resolved/ResolvedTarget), impls
config/ConfigServiceDiscovery.scala (:51), aggregate/AggregateServiceDiscovery
(:49 — try methods in order until one returns targets), and a DNS method
(dns/DnsServiceDiscovery.scala:69) via the system resolver; the in-proc
registry stands in for DNS in zero-egress multi-'node' tests.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ..actor.system import ActorSystem, ExtensionId


@dataclass(frozen=True)
class Lookup:
    """(reference: discovery/Lookup.scala) service name + optional port/protocol"""
    service_name: str
    port_name: Optional[str] = None
    protocol: Optional[str] = None


@dataclass(frozen=True)
class ResolvedTarget:
    host: str
    port: Optional[int] = None


@dataclass(frozen=True)
class Resolved:
    service_name: str
    addresses: Tuple[ResolvedTarget, ...] = ()


class ServiceDiscovery:
    def lookup(self, lookup: Lookup, resolve_timeout: float = 3.0) -> Resolved:
        raise NotImplementedError


class ConfigServiceDiscovery(ServiceDiscovery):
    """Services from config:
    akka.discovery.config.services.<name>.endpoints = ["host:port", ...]
    (reference: config/ConfigServiceDiscovery.scala:51)"""

    def __init__(self, system: ActorSystem):
        self._services: Dict[str, List[ResolvedTarget]] = {}
        services = system.settings.config.get(
            "akka.discovery.config.services", {}) or {}
        for name, spec in services.items():
            endpoints = spec.get("endpoints", []) if isinstance(spec, dict) else []
            targets = []
            for ep in endpoints:
                host, _, port = str(ep).rpartition(":")
                if host:
                    targets.append(ResolvedTarget(host, int(port)))
                else:
                    targets.append(ResolvedTarget(str(ep)))
            self._services[name] = targets

    def lookup(self, lookup: Lookup, resolve_timeout: float = 3.0) -> Resolved:
        return Resolved(lookup.service_name,
                        tuple(self._services.get(lookup.service_name, ())))


class InProcServiceDiscovery(ServiceDiscovery):
    """Process-global registry for multi-'node' tests (DNS stand-in)."""

    _registry: Dict[str, List[ResolvedTarget]] = {}
    _lock = threading.Lock()

    def __init__(self, system: Optional[ActorSystem] = None):
        pass

    @classmethod
    def register(cls, service_name: str, host: str, port: Optional[int] = None) -> None:
        with cls._lock:
            cls._registry.setdefault(service_name, []).append(
                ResolvedTarget(host, port))

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            cls._registry.clear()

    def lookup(self, lookup: Lookup, resolve_timeout: float = 3.0) -> Resolved:
        with InProcServiceDiscovery._lock:
            return Resolved(lookup.service_name, tuple(
                InProcServiceDiscovery._registry.get(lookup.service_name, ())))


class DnsServiceDiscovery(ServiceDiscovery):
    """Resolve service names through DNS (reference:
    discovery/dns/DnsServiceDiscovery.scala:69 — the reference speaks
    SRV + A records through the async resolver; here A/AAAA via the
    system resolver, with the Lookup's port_name carried onto every
    target when it parses as a port number, matching how the A-record
    mode of the reference leaves ports to configuration)."""

    def __init__(self, system: Optional[ActorSystem] = None):
        pass

    def lookup(self, lookup: Lookup, resolve_timeout: float = 3.0) -> Resolved:
        import socket

        port: Optional[int] = None
        if lookup.port_name and lookup.port_name.isdigit():
            port = int(lookup.port_name)
        # getaddrinfo has no timeout of its own (OS resolver retries can
        # block 5-30s) — honor the advertised resolve_timeout by resolving
        # on a PER-CALL daemon thread and abandoning the wait. A fixed pool
        # would let a few black-holed resolutions starve every later lookup
        # (a running getaddrinfo cannot be cancelled); an abandoned thread
        # costs one stack until the OS resolver gives up, bounded by its
        # own retry window.
        result: Dict[str, object] = {}
        done = threading.Event()

        def work():
            try:
                result["v"] = socket.getaddrinfo(
                    lookup.service_name, port, type=socket.SOCK_STREAM)
            except OSError:
                pass
            done.set()

        t = threading.Thread(target=work, daemon=True, name="akka-tpu-dns")
        t.start()
        if not done.wait(resolve_timeout):
            return Resolved(lookup.service_name)
        t.join()
        if "v" not in result:
            return Resolved(lookup.service_name)
        infos = result["v"]
        seen = []
        for _family, _t, _p, _canon, sockaddr in infos:
            target = ResolvedTarget(sockaddr[0], port)
            if target not in seen:
                seen.append(target)
        return Resolved(lookup.service_name, tuple(seen))


class AggregateServiceDiscovery(ServiceDiscovery):
    """Try each method in order; first non-empty wins
    (reference: aggregate/AggregateServiceDiscovery.scala:49)."""

    def __init__(self, methods: List[ServiceDiscovery]):
        self.methods = methods

    def lookup(self, lookup: Lookup, resolve_timeout: float = 3.0) -> Resolved:
        last = Resolved(lookup.service_name)
        for m in self.methods:
            last = m.lookup(lookup, resolve_timeout)
            if last.addresses:
                return last
        return last


_METHODS: Dict[str, Callable[[ActorSystem], ServiceDiscovery]] = {
    "config": ConfigServiceDiscovery,
    "in-proc": InProcServiceDiscovery,
    "dns": DnsServiceDiscovery,
}


def register_discovery_method(name: str,
                              factory: Callable[[ActorSystem], ServiceDiscovery]) -> None:
    _METHODS[name] = factory


class Discovery(ExtensionId):
    """Extension: `Discovery.get(system).discovery` is the method selected by
    `akka.discovery.method`; `load_method(name)` for explicit selection."""

    def create_extension(self, system: ActorSystem) -> "_DiscoveryExt":
        return _DiscoveryExt(system)

    @staticmethod
    def get(system: ActorSystem) -> "_DiscoveryExt":
        return system.register_extension(Discovery())


class _DiscoveryExt:
    def __init__(self, system: ActorSystem):
        self.system = system
        self._cache: Dict[str, ServiceDiscovery] = {}
        method = system.settings.config.get_string("akka.discovery.method",
                                                   "config")
        if "," in method:
            self.discovery: ServiceDiscovery = AggregateServiceDiscovery(
                [self.load_method(m.strip()) for m in method.split(",")])
        else:
            self.discovery = self.load_method(method)

    def load_method(self, name: str) -> ServiceDiscovery:
        if name not in self._cache:
            self._cache[name] = _METHODS[name](self.system)
        return self._cache[name]
