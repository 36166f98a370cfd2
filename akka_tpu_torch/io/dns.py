"""Async DNS (reference: akka-actor/src/main/scala/akka/io/Dns.scala and
io/dns/ — async resolver with positive/negative caching). Resolution runs
on a small thread pool via socket.getaddrinfo; results are cached with a
TTL and delivered as Resolved messages.

A copy of `akka_tpu/io/dns.py` at commit 43876c4 (host code, no
jax; the port keeps its own copy of every module it needs). The resolver
pool belongs to the `Dns` extension, which shuts it down and joins its
threads at the system's termination; the reference's actor shuts it down
without waiting for them."""

from __future__ import annotations

import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from ..actor.actor import Actor
from ..actor.props import Props
from ..actor.ref import ActorRef
from ..actor.system import ActorSystem


@dataclass(frozen=True)
class Resolve:
    name: str


@dataclass(frozen=True)
class Resolved:
    name: str
    addresses: Tuple[str, ...]


@dataclass(frozen=True)
class ResolveFailed:
    name: str
    cause: str


@dataclass(frozen=True)
class _ResolutionDone:
    name: str
    addresses: Optional[Tuple[str, ...]]
    error: str
    requesters: Tuple[ActorRef, ...]


class DnsManagerActor(Actor):
    def __init__(self, pool: ThreadPoolExecutor, positive_ttl: float = 30.0,
                 negative_ttl: float = 5.0):
        super().__init__()
        self.positive_ttl = positive_ttl
        self.negative_ttl = negative_ttl
        self.cache: Dict[str, Tuple[float, Any]] = {}  # name -> (expiry, msg)
        self.in_flight: Dict[str, List[ActorRef]] = {}
        self.pool = pool  # joined by the Dns extension at termination

    def post_stop(self) -> None:
        self.pool.shutdown(wait=False)

    def receive(self, message: Any) -> Any:
        if isinstance(message, Resolve):
            name, requester = message.name, self.sender
            cached = self.cache.get(name)
            if cached is not None and cached[0] > time.monotonic():
                requester.tell(cached[1], self.self_ref)
                return
            if name in self.in_flight:
                self.in_flight[name].append(requester)
                return
            self.in_flight[name] = [requester]
            self_ref = self.self_ref

            def resolve():
                try:
                    infos = socket.getaddrinfo(name, None)
                    addrs = tuple(dict.fromkeys(i[4][0] for i in infos))
                    self_ref.tell(_ResolutionDone(
                        name, addrs, "", ()), None)
                except OSError as e:
                    self_ref.tell(_ResolutionDone(name, None, str(e), ()),
                                  None)
            self.pool.submit(resolve)
        elif isinstance(message, _ResolutionDone):
            requesters = self.in_flight.pop(message.name, [])
            if message.addresses is not None:
                reply: Any = Resolved(message.name, message.addresses)
                ttl = self.positive_ttl
            else:
                reply = ResolveFailed(message.name, message.error)
                ttl = self.negative_ttl
            self.cache[message.name] = (time.monotonic() + ttl, reply)
            for r in requesters:
                r.tell(reply, self.self_ref)
        else:
            return NotImplemented


class Dns:
    """Dns.get(system).manager; tell it Resolve(name)."""

    _instances: Dict[ActorSystem, "Dns"] = {}
    _lock = threading.Lock()

    @staticmethod
    def get(system: ActorSystem) -> "Dns":
        with Dns._lock:
            inst = Dns._instances.get(system)
            if inst is None:
                inst = Dns._instances[system] = Dns(system)
                system.register_on_termination(inst._shutdown)
            return inst

    def __init__(self, system: ActorSystem):
        self.system = system
        self.pool = ThreadPoolExecutor(4, thread_name_prefix="akka-tpu-dns")
        self.manager = system.system_actor_of(
            Props.create(DnsManagerActor, self.pool), "IO-DNS")

    def _shutdown(self) -> None:
        self.pool.shutdown(wait=True, cancel_futures=True)
        Dns._instances.pop(self.system, None)
