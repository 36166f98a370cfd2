"""Actor addresses and hierarchical paths.

A copy of `akka_tpu/actor/path.py` at commit 5d9b7cd (host code, no jax; the
port keeps its own copy of every module it needs).

Reference parity: akka-actor/src/main/scala/akka/actor/Address.scala and
ActorPath.scala — location-transparent names `akka://system@host:port/user/a/b`
with a per-incarnation uid appended as `#uid` (uid-in-path evidence:
actor/ActorCell.scala:382-388).
"""

from __future__ import annotations

import itertools
import re
from dataclasses import dataclass
from typing import Iterable, Optional, Tuple

_VALID_ELEMENT = re.compile(r"^[-\w:@&=+,.!~*'_;()]+$")

undefined_uid = 0
_uid_counter = itertools.count(1)


def new_uid() -> int:
    return next(_uid_counter)


@dataclass(frozen=True)
class Address:
    """Network location of an actor system. `host`/`port` are None for a
    purely local address (reference: actor/Address.scala:24-53)."""

    protocol: str
    system: str
    host: Optional[str] = None
    port: Optional[int] = None

    @property
    def has_local_scope(self) -> bool:
        return self.host is None

    @property
    def has_global_scope(self) -> bool:
        return self.host is not None

    def __str__(self) -> str:
        if self.host is None:
            return f"{self.protocol}://{self.system}"
        return f"{self.protocol}://{self.system}@{self.host}:{self.port}"

    @property
    def host_port(self) -> str:
        return str(self).split("://", 1)[1]

    @staticmethod
    def parse(s: str) -> "Address":
        m = re.match(r"^(\w[\w+.-]*)://([^@/]+)(?:@([^:/]+):(\d+))?$", s)
        if not m:
            raise ValueError(f"malformed address: {s!r}")
        proto, system, host, port = m.groups()
        return Address(proto, system, host, int(port) if port else None)


class ActorPath:
    """Immutable hierarchical path. Child construction via `path / name`."""

    __slots__ = ("address", "elements", "uid", "_str")

    def __init__(self, address: Address, elements: Tuple[str, ...] = (), uid: int = undefined_uid):
        self.address = address
        self.elements = elements
        self.uid = uid
        self._str: Optional[str] = None

    # -- construction ------------------------------------------------------
    def __truediv__(self, child: str) -> "ActorPath":
        return self.child(child)

    def child(self, name: str) -> "ActorPath":
        if not name or ("/" in name and not name.startswith("$")):
            raise ValueError(f"illegal actor name: {name!r}")
        return ActorPath(self.address, self.elements + (name,))

    def descendant(self, names: Iterable[str]) -> "ActorPath":
        p = self
        for n in names:
            p = p.child(n)
        return p

    def with_uid(self, uid: int) -> "ActorPath":
        return ActorPath(self.address, self.elements, uid)

    def with_address(self, address: Address) -> "ActorPath":
        return ActorPath(address, self.elements, self.uid)

    # -- views -------------------------------------------------------------
    @property
    def name(self) -> str:
        return self.elements[-1] if self.elements else "/"

    @property
    def parent(self) -> "ActorPath":
        if not self.elements:
            return self
        return ActorPath(self.address, self.elements[:-1])

    @property
    def root(self) -> "ActorPath":
        return ActorPath(self.address)

    def is_ancestor_of(self, other: "ActorPath") -> bool:
        return (other.address == self.address
                and len(other.elements) >= len(self.elements)
                and other.elements[: len(self.elements)] == self.elements)

    def to_string_without_address(self) -> str:
        return "/" + "/".join(self.elements)

    def to_serialization_format(self) -> str:
        s = f"{self.address}{self.to_string_without_address()}"
        return f"{s}#{self.uid}" if self.uid != undefined_uid else s

    def __str__(self) -> str:
        if self._str is None:
            self._str = f"{self.address}{self.to_string_without_address()}"
        return self._str

    def __repr__(self) -> str:
        return str(self)

    def __hash__(self) -> int:
        # uid excluded to match __eq__ (uid is ActorRef identity, not path identity)
        return hash((self.address, self.elements))

    def __eq__(self, other: object) -> bool:
        return (isinstance(other, ActorPath)
                and self.address == other.address
                and self.elements == other.elements)

    def __lt__(self, other: "ActorPath") -> bool:
        return str(self) < str(other)


def validate_path_element(name: str) -> str:
    if not _VALID_ELEMENT.match(name):
        raise ValueError(
            f"invalid actor name [{name}]: must match {_VALID_ELEMENT.pattern}")
    return name


def parse_actor_path(s: str) -> ActorPath:
    """Parse `proto://system@host:port/a/b#uid` back into an ActorPath
    (reference: RootActorPath/ActorPath.fromString)."""
    uid = undefined_uid
    if "#" in s:
        s, uid_s = s.rsplit("#", 1)
        uid = int(uid_s)
    if "://" not in s:
        raise ValueError(f"malformed actor path: {s!r}")
    addr_part, _, path_part = s.partition("://")
    rest = path_part.split("/")
    addr = Address.parse(f"{addr_part}://{rest[0]}")
    elements = tuple(e for e in rest[1:] if e)
    return ActorPath(addr, elements, uid)
