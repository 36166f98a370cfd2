"""Deploy: where/how an actor is instantiated — dispatcher, mailbox, router,

A copy of `akka_tpu/actor/deploy.py` at commit 5d9b7cd (host code, no jax;
the port keeps its own copy of every module it needs).
and (with the remote provider) the node it lives on.

Reference parity: akka-actor/src/main/scala/akka/actor/Deployer.scala —
config-driven per-path deployment (`akka.actor.deployment` section, wildcard
path patterns, router/dispatcher/mailbox selection) — and the Scope model
(LocalScope / RemoteScope, the latter from akka-remote/src/main/scala/akka/
remote/RemoteDeployer.scala). Props.deploy and the deployer's config entry are
merged at spawn time with the config entry winning (Deployer.scala lookup +
ActorRefProvider.actorOf deployment resolution).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple


class Scope:
    """Where the actor is created (reference: actor/Deploy.scala Scope)."""
    __slots__ = ()

    def with_fallback(self, other: "Scope") -> "Scope":
        return self


class LocalScope(Scope):
    __slots__ = ()

    def __repr__(self) -> str:  # pragma: no cover - repr only
        return "LocalScope"


class NoScopeGiven(Scope):
    __slots__ = ()

    def with_fallback(self, other: Scope) -> Scope:
        return other

    def __repr__(self) -> str:  # pragma: no cover - repr only
        return "NoScopeGiven"


@dataclass(frozen=True)
class RemoteScope(Scope):
    """Deploy onto the node at `address` ("akka://sys@host:port").
    Reference: remote/RemoteDeployer.scala RemoteScope."""
    address: str


NO_SCOPE = NoScopeGiven()
LOCAL_SCOPE = LocalScope()


@dataclass(frozen=True)
class Deploy:
    """(reference: actor/Deploy.scala — path/config/routerConfig/scope/
    dispatcher/mailbox with with_fallback merge)"""
    path: str = ""
    scope: Scope = NO_SCOPE
    dispatcher: Optional[str] = None
    mailbox: Optional[Any] = None
    router_config: Optional[Any] = None
    tags: Tuple[str, ...] = ()

    def with_fallback(self, other: "Deploy") -> "Deploy":
        return Deploy(
            path=self.path or other.path,
            scope=self.scope.with_fallback(other.scope),
            dispatcher=self.dispatcher if self.dispatcher is not None else other.dispatcher,
            mailbox=self.mailbox if self.mailbox is not None else other.mailbox,
            router_config=(self.router_config if self.router_config is not None
                           else other.router_config),
            tags=self.tags or other.tags)


def _router_from_config(kind: str, entry) -> Any:
    """Build a RouterConfig from a deployment entry's `router = <kind>`
    (reference: Deployer.scala createRouterConfig's type registry)."""
    from ..routing import router as r
    n = entry.get_int("nr-of-instances", 1)
    paths = tuple(entry.get("routees", {}).get("paths", ()) or ())
    table = {
        "round-robin-pool": lambda: r.RoundRobinPool(n),
        "random-pool": lambda: r.RandomPool(n),
        "broadcast-pool": lambda: r.BroadcastPool(n),
        "smallest-mailbox-pool": lambda: r.SmallestMailboxPool(n),
        "consistent-hashing-pool": lambda: r.ConsistentHashingPool(n),
        "scatter-gather-pool": lambda: r.ScatterGatherFirstCompletedPool(n),
        "tail-chopping-pool": lambda: r.TailChoppingPool(n),
        "round-robin-group": lambda: r.RoundRobinGroup(paths),
        "random-group": lambda: r.RandomGroup(paths),
        "broadcast-group": lambda: r.BroadcastGroup(paths),
        "consistent-hashing-group": lambda: r.ConsistentHashingGroup(paths),
    }
    factory = table.get(kind)
    if factory is None:
        raise ValueError(f"unknown router type in deployment config: {kind!r}")
    return factory()


class Deployer:
    """Parses `akka.actor.deployment` into Deploy entries and answers
    lookups by /user-relative path, most-specific match first, with `*`
    wildcard elements (reference: actor/Deployer.scala:156-178 lookup on a
    WildcardTree)."""

    def __init__(self, settings):
        self._entries: List[Tuple[Tuple[str, ...], Deploy]] = []
        section = settings.config.get("akka.actor.deployment", {}) or {}
        cfg = settings.config.get_config("akka.actor.deployment")
        for raw_path in section:
            if raw_path == "default":
                continue
            entry = cfg.get_config(raw_path)
            elements = tuple(e for e in raw_path.split("/") if e)
            router_kind = entry.get_string("router", "")
            deploy = Deploy(
                path=raw_path,
                scope=(RemoteScope(entry.get_string("remote"))
                       if entry.get_string("remote", "") else NO_SCOPE),
                dispatcher=entry.get_string("dispatcher", "") or None,
                mailbox=entry.get_string("mailbox", "") or None,
                router_config=(_router_from_config(router_kind, entry)
                               if router_kind and router_kind != "from-code"
                               else None))
            self._entries.append((elements, deploy))
        # longest (most specific) patterns first; literals beat wildcards
        self._entries.sort(key=lambda kv: (-len(kv[0]), kv[0].count("*")))

    @staticmethod
    def _matches(pattern: Tuple[str, ...], elements: Sequence[str]) -> bool:
        if pattern and pattern[-1] == "**":
            # trailing "**" matches ANY suffix, including a single element
            # (Deployer wildcard-tree parity)
            head = pattern[:-1]
            return (len(elements) >= len(head)
                    and all(p == "*" or p == e
                            for p, e in zip(head, elements)))
        if len(pattern) != len(elements):
            return False
        return all(p == "*" or p == e for p, e in zip(pattern, elements))

    def lookup(self, elements: Sequence[str]) -> Optional[Deploy]:
        """`elements` is the /user-relative path (e.g. ["service", "worker"])."""
        elements = list(elements)
        for pattern, deploy in self._entries:
            if self._matches(pattern, elements):
                return deploy
        return None
