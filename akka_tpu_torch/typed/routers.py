"""Typed routers: pool and group (reference parity:
akka-actor-typed/src/main/scala/akka/actor/typed/scaladsl/Routers.scala:24,36
— PoolRouter spawns N children of one behavior and routes over them;
GroupRouter routes over receptionist Listings for a ServiceKey; impl in
typed/internal/routing/).

A copy of `akka_tpu/typed/routers.py` at commit 1001e26 (host code, no jax;
the port keeps its own copy of every module it needs).

Both are plain Behaviors: spawn them like any other —
    system.spawn(Routers.pool(4, worker_behavior), "workers")
    system.spawn(Routers.group(key), "proxy")
"""

from __future__ import annotations

import itertools
import random as _random
from typing import Any, Callable, List, Optional

from .behavior import Behavior
from .behaviors import Behaviors
from .receptionist import Listing, Receptionist, ServiceKey, Subscribe


_LOGICS = ("round-robin", "random")
_GROUP_BUFFER = 1024  # messages held while awaiting the first Listing


def _check_logic(logic: str) -> None:
    if logic not in _LOGICS:
        raise ValueError(f"unknown routing logic {logic!r}; one of {_LOGICS}")


class Routers:
    @staticmethod
    def pool(pool_size: int, behavior: Behavior | Callable[[], Behavior],
             logic: str = "round-robin") -> Behavior:
        """A pool router: spawns `pool_size` children running `behavior`
        and routes incoming messages over them (PoolRouter). Children are
        watched; a crashed-and-stopped child leaves the pool (the typed
        reference restarts by wrapping `behavior` in supervision — pass a
        supervised behavior for that)."""
        if pool_size <= 0:
            raise ValueError("pool_size must be > 0")
        _check_logic(logic)

        def factory():
            # Behavior instances (incl. DeferredBehavior, which defines
            # __call__(ctx)) are used as-is; only plain zero-arg factories
            # are invoked — `callable()` alone would mis-call Deferred
            return behavior if isinstance(behavior, Behavior) else behavior()

        def setup(ctx):
            routees: List[Any] = [
                ctx.spawn(factory(), f"pool-{i}") for i in range(pool_size)]
            for r in routees:
                ctx.watch(r)
            rr = itertools.count()

            def on_message(ctx_, msg):
                if not routees:
                    # every child terminated: the loss must be VISIBLE
                    from ..actor.messages import DeadLetter
                    ctx.system.dead_letters.tell(
                        DeadLetter(msg, None, ctx.self), None)
                    return Behaviors.same
                if logic == "random":
                    target = _random.choice(routees)
                else:  # round-robin
                    target = routees[next(rr) % len(routees)]
                target.tell(msg)
                return Behaviors.same

            def on_signal(ctx_, sig):
                from ..actor.messages import Terminated as _T
                if isinstance(sig, _T):
                    actor = getattr(sig, "actor", None) or \
                        getattr(sig, "ref", None)
                    if actor is not None:
                        routees[:] = [r for r in routees if r != actor]
                return Behaviors.same

            return Behaviors.receive(on_message, on_signal)

        return Behaviors.setup(setup)

    @staticmethod
    def group(key: ServiceKey, logic: str = "round-robin") -> Behavior:
        """A group router: routes over the receptionist's current Listing
        for `key` (GroupRouter). Messages arriving before the first listing
        are buffered (BOUNDED — overflow goes to dead letters, so a never-
        registered key cannot grow memory without bound)."""
        _check_logic(logic)

        def setup(ctx):
            routees: List[Any] = []
            pending: List[Any] = []
            rr = itertools.count()
            Receptionist.get(ctx.system).subscribe(key, ctx.self)

            def route(msg):
                if logic == "random":
                    _random.choice(routees).tell(msg)
                else:
                    routees[next(rr) % len(routees)].tell(msg)

            def on_message(ctx_, msg):
                if isinstance(msg, Listing):
                    # deterministic round-robin order over the frozenset
                    routees[:] = sorted(msg.service_instances,
                                        key=lambda r: str(r.path))
                    if routees and pending:
                        for m in pending:
                            route(m)
                        pending.clear()
                    return Behaviors.same
                if not routees:
                    if len(pending) < _GROUP_BUFFER:
                        pending.append(msg)
                    else:
                        from ..actor.messages import DeadLetter
                        ctx.system.dead_letters.tell(
                            DeadLetter(msg, None, ctx.self), None)
                    return Behaviors.same
                route(msg)
                return Behaviors.same

            return Behaviors.receive_message(
                lambda msg: on_message(ctx, msg))

        return Behaviors.setup(setup)
