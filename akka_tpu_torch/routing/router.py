"""Routing: fan-out without the router's mailbox on the hot path.

A copy of `akka_tpu/routing/router.py` at commit 5d9b7cd (host code, no jax;
the port keeps its own copy of every module it needs).

Reference parity: akka-actor/src/main/scala/akka/routing/ —
`RoutedActorCell.sendMessage` routes directly (routing/RoutedActorCell.scala:137-141),
`Router.route` (routing/Router.scala:116), logics RoundRobin/Random/Broadcast/
SmallestMailbox/ConsistentHashing (murmur hash, routing/MurmurHash.scala)/
ScatterGatherFirstCompleted/TailChopping, Pool vs Group, Resizer, and the
management messages (GetRoutees/AddRoutee/RemoveRoutee/AdjustPoolSize).

The batched analogue — routing logics as index-permutation tensors — lives in
akka_tpu/routing/batched.py (SURVEY.md §2.11).
"""

from __future__ import annotations

import hashlib
import itertools
import random as _random
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Sequence

from ..actor.messages import PoisonPill
from ..actor.props import Props
from ..actor.ref import ActorRef, Nobody
from ..dispatch.mailbox import Envelope


# -- routees ----------------------------------------------------------------

class Routee:
    def send(self, message: Any, sender: Optional[ActorRef]) -> None:
        raise NotImplementedError


@dataclass(frozen=True)
class ActorRefRoutee(Routee):
    ref: ActorRef

    def send(self, message, sender) -> None:
        self.ref.tell(message, sender)


@dataclass(frozen=True)
class ActorSelectionRoutee(Routee):
    path: str
    system: Any = None

    def send(self, message, sender) -> None:
        self.system.actor_selection(self.path).tell(message, sender)


class NoRoutee(Routee):
    def send(self, message, sender) -> None:
        pass


@dataclass(frozen=True)
class SeveralRoutees(Routee):
    routees: tuple

    def send(self, message, sender) -> None:
        for r in self.routees:
            r.send(message, sender)


# -- management messages (reference: routing/RouterManagementMesssage.scala) --

class RouterManagementMessage:
    __slots__ = ()


class GetRoutees(RouterManagementMessage):
    pass


@dataclass(frozen=True)
class Routees:
    routees: tuple


@dataclass(frozen=True)
class AddRoutee(RouterManagementMessage):
    routee: Routee


@dataclass(frozen=True)
class RemoveRoutee(RouterManagementMessage):
    routee: Routee


@dataclass(frozen=True)
class AdjustPoolSize(RouterManagementMessage):
    change: int


@dataclass(frozen=True)
class Broadcast:
    """Envelope: send the inner message to ALL routees (reference: routing/Broadcast)."""
    message: Any


# -- routing logics ----------------------------------------------------------

class RoutingLogic:
    def select(self, message: Any, routees: Sequence[Routee]) -> Routee:
        raise NotImplementedError


class RoundRobinRoutingLogic(RoutingLogic):
    def __init__(self):
        self._next = itertools.count()

    def select(self, message, routees):
        if not routees:
            return NoRoutee()
        return routees[next(self._next) % len(routees)]


class RandomRoutingLogic(RoutingLogic):
    def select(self, message, routees):
        if not routees:
            return NoRoutee()
        return routees[_random.randrange(len(routees))]


class BroadcastRoutingLogic(RoutingLogic):
    def select(self, message, routees):
        return SeveralRoutees(tuple(routees))


class SmallestMailboxRoutingLogic(RoutingLogic):
    """(reference: routing/SmallestMailbox.scala — prefers idle/empty mailboxes)"""

    def select(self, message, routees):
        if not routees:
            return NoRoutee()
        best, best_size = None, None
        for r in routees:
            size = 0
            ref = getattr(r, "ref", None)
            cell = getattr(ref, "cell", None)
            if cell is not None and cell.mailbox is not None:
                size = cell.mailbox.number_of_messages
            if best is None or size < best_size:
                best, best_size = r, size
        return best


def _hash_key(key: Any) -> int:
    h = hashlib.md5(repr(key).encode()).digest()
    return int.from_bytes(h[:8], "little")


class ConsistentHashingRoutingLogic(RoutingLogic):
    """Consistent-hash ring with virtual nodes (reference:
    routing/ConsistentHashingRouter.scala + ConsistentHash.scala)."""

    def __init__(self, hash_mapping: Optional[Callable[[Any], Any]] = None,
                 virtual_nodes_factor: int = 17):
        self.hash_mapping = hash_mapping
        self.vnodes = virtual_nodes_factor
        self._ring_cache: tuple = ()

    def _ring(self, routees):
        key = tuple(id(r) for r in routees)
        if self._ring_cache and self._ring_cache[0] == key:
            return self._ring_cache[1]
        ring = sorted((_hash_key((i, v)), r)
                      for i, r in enumerate(routees) for v in range(self.vnodes))
        self._ring_cache = (key, ring)
        return ring

    def select(self, message, routees):
        if not routees:
            return NoRoutee()
        key = message
        if self.hash_mapping is not None:
            key = self.hash_mapping(message)
        elif isinstance(message, ConsistentHashableEnvelope):
            key = message.hash_key
            message = message.message
        h = _hash_key(key)
        ring = self._ring(routees)
        # first node clockwise from h
        lo, hi = 0, len(ring)
        while lo < hi:
            mid = (lo + hi) // 2
            if ring[mid][0] < h:
                lo = mid + 1
            else:
                hi = mid
        return ring[lo % len(ring)][1]


@dataclass(frozen=True)
class ConsistentHashableEnvelope:
    message: Any
    hash_key: Any


class ScatterGatherFirstCompletedRoutingLogic(RoutingLogic):
    """Send to all; first reply wins (reference: routing/ScatterGatherFirstCompleted...)"""

    def __init__(self, within: float = 5.0):
        self.within = within

    def select(self, message, routees):
        return SeveralRoutees(tuple(routees))


class TailChoppingRoutingLogic(RoutingLogic):
    """Send to one random routee, then another after `interval` until a reply
    (reference: routing/TailChopping.scala). Approximated: scatter to a random
    ordering with host-side delay handled by the router actor."""

    def __init__(self, scheduler=None, within: float = 5.0, interval: float = 0.5):
        self.scheduler = scheduler
        self.within = within
        self.interval = interval

    def select(self, message, routees):
        if not routees:
            return NoRoutee()
        shuffled = list(routees)
        _random.shuffle(shuffled)
        if self.scheduler is None or len(shuffled) == 1:
            return shuffled[0]
        first, rest = shuffled[0], shuffled[1:]

        class _Chopper(Routee):
            def send(_self, message, sender):
                first.send(message, sender)
                for i, r in enumerate(rest):
                    self.scheduler.schedule_once(
                        self.interval * (i + 1), lambda r=r: r.send(message, sender))
        return _Chopper()


class Router:
    """(reference: routing/Router.scala:116)"""

    def __init__(self, logic: RoutingLogic, routees: Sequence[Routee] = ()):
        self.logic = logic
        self.routees: List[Routee] = list(routees)

    def route(self, message: Any, sender: Optional[ActorRef]) -> None:
        if isinstance(message, Broadcast):
            SeveralRoutees(tuple(self.routees)).send(message.message, sender)
        else:
            self.logic.select(message, self.routees).send(message, sender)

    def with_routees(self, routees: Sequence[Routee]) -> "Router":
        return Router(self.logic, list(routees))

    def add_routee(self, routee: Routee) -> None:
        self.routees.append(routee)

    def remove_routee(self, routee: Routee) -> None:
        try:
            self.routees.remove(routee)
        except ValueError:
            pass


# -- resizer (reference: routing/Resizer.scala DefaultResizer) ---------------

@dataclass
class DefaultResizer:
    lower_bound: int = 1
    upper_bound: int = 10
    pressure_threshold: int = 1
    rampup_rate: float = 0.2
    backoff_threshold: float = 0.3
    backoff_rate: float = 0.1
    messages_per_resize: int = 10

    def is_time_for_resize(self, message_counter: int) -> bool:
        return message_counter % self.messages_per_resize == 0

    def resize(self, routees: Sequence[Routee]) -> int:
        """Returns the change in capacity (+/-)."""
        pressure = 0
        for r in routees:
            cell = getattr(getattr(r, "ref", None), "cell", None)
            if cell is not None and cell.mailbox is not None:
                if cell.mailbox.number_of_messages >= self.pressure_threshold:
                    pressure += 1
        cap = len(routees)
        if pressure >= cap:
            change = max(1, int(cap * self.rampup_rate))
        elif cap > 0 and pressure / cap < self.backoff_threshold:
            change = -max(1, int(cap * self.backoff_rate))
        else:
            change = 0
        new_cap = min(max(cap + change, self.lower_bound), self.upper_bound)
        return new_cap - cap


@dataclass
class OptimalSizeExploringResizer:
    """Explore-and-exploit pool sizing (reference:
    routing/OptimalSizeExploringResizer.scala): most resize checks EXPLOIT
    the best-throughput size seen so far; with `explore_step_size`
    probability-driven jitter the pool EXPLORES nearby sizes, recording
    messages-processed-per-size so the optimum tracks changing workloads.
    Same `resize(routees) -> delta` seam as DefaultResizer."""

    lower_bound: int = 1
    upper_bound: int = 10
    chance_of_exploration: float = 0.4
    explore_step_size: float = 0.1
    messages_per_resize: int = 10
    # decayed throughput record: size -> (ewma msgs processed per check)
    _perf: dict = field(default_factory=dict)
    _last_queued: int = 0

    def is_time_for_resize(self, message_counter: int) -> bool:
        return message_counter % self.messages_per_resize == 0

    def _record(self, routees: Sequence[Routee]) -> int:
        """Messages PROCESSED since the last check: exactly
        messages_per_resize were routed between checks, so processed =
        routed - backlog growth. Backlog is tracked as a delta (not an
        absolute clamp) so sizes stay distinguishable under sustained
        saturation — a size that drains faster records more throughput
        even while a queue persists."""
        queued = 0
        for r in routees:
            cell = getattr(getattr(r, "ref", None), "cell", None)
            if cell is not None and cell.mailbox is not None:
                queued += cell.mailbox.number_of_messages
        processed = max(
            0, self.messages_per_resize - (queued - self._last_queued))
        self._last_queued = queued
        size = len(routees)
        prev = self._perf.get(size)
        self._perf[size] = (processed if prev is None
                            else 0.5 * prev + 0.5 * processed)
        return queued

    def resize(self, routees: Sequence[Routee]) -> int:
        size = len(routees)
        queued = self._record(routees)
        if _random.random() < self.chance_of_exploration:
            # explore: jitter around the current size
            step = max(1, int(size * self.explore_step_size))
            target = size + _random.choice((-step, step))
        else:
            # exploit: the best recorded size; bias upward under pressure
            if self._perf:
                target = max(self._perf.items(), key=lambda kv: kv[1])[0]
            else:
                target = size
            if queued > size:
                target = max(target, size + 1)
        target = min(max(target, self.lower_bound), self.upper_bound)
        return target - size


# -- router configs ----------------------------------------------------------

@dataclass(frozen=True)
class RouterConfig:
    nr_of_instances: int = 0
    logic_factory: Callable[[], RoutingLogic] = RoundRobinRoutingLogic
    paths: tuple = ()
    resizer: Optional[DefaultResizer] = None
    supervisor_strategy: Any = None

    def create_router(self, system) -> Router:
        return Router(self.logic_factory())

    @property
    def is_group(self) -> bool:
        return bool(self.paths)


def RoundRobinPool(n: int, resizer: Optional[DefaultResizer] = None,
                   supervisor_strategy=None) -> RouterConfig:
    return RouterConfig(nr_of_instances=n, logic_factory=RoundRobinRoutingLogic,
                        resizer=resizer, supervisor_strategy=supervisor_strategy)


def RandomPool(n: int, **kw) -> RouterConfig:
    return RouterConfig(nr_of_instances=n, logic_factory=RandomRoutingLogic, **kw)


def BroadcastPool(n: int, **kw) -> RouterConfig:
    return RouterConfig(nr_of_instances=n, logic_factory=BroadcastRoutingLogic, **kw)


def SmallestMailboxPool(n: int, **kw) -> RouterConfig:
    return RouterConfig(nr_of_instances=n, logic_factory=SmallestMailboxRoutingLogic, **kw)


def ConsistentHashingPool(n: int, hash_mapping=None, virtual_nodes_factor: int = 17,
                          **kw) -> RouterConfig:
    return RouterConfig(
        nr_of_instances=n,
        logic_factory=lambda: ConsistentHashingRoutingLogic(hash_mapping, virtual_nodes_factor),
        **kw)


def ScatterGatherFirstCompletedPool(n: int, within: float = 5.0, **kw) -> RouterConfig:
    return RouterConfig(nr_of_instances=n,
                        logic_factory=lambda: ScatterGatherFirstCompletedRoutingLogic(within),
                        **kw)


def TailChoppingPool(n: int, within: float = 5.0, interval: float = 0.5, **kw) -> RouterConfig:
    return RouterConfig(nr_of_instances=n,
                        logic_factory=lambda: TailChoppingRoutingLogic(None, within, interval),
                        **kw)


def RoundRobinGroup(paths: Sequence[str]) -> RouterConfig:
    return RouterConfig(logic_factory=RoundRobinRoutingLogic, paths=tuple(paths))


def RandomGroup(paths: Sequence[str]) -> RouterConfig:
    return RouterConfig(logic_factory=RandomRoutingLogic, paths=tuple(paths))


def BroadcastGroup(paths: Sequence[str]) -> RouterConfig:
    return RouterConfig(logic_factory=BroadcastRoutingLogic, paths=tuple(paths))


def ConsistentHashingGroup(paths: Sequence[str], hash_mapping=None) -> RouterConfig:
    return RouterConfig(logic_factory=lambda: ConsistentHashingRoutingLogic(hash_mapping),
                        paths=tuple(paths))
