"""System messages — the out-of-band control plane with guaranteed delivery.

A copy of `akka_tpu/dispatch/sysmsg.py` at commit 5d9b7cd (host code, no
jax; the port keeps its own copy of every module it needs).

Reference parity: akka-actor/src/main/scala/akka/dispatch/sysmsg/SystemMessage.scala:220-273
(Create/Recreate/Suspend/Resume/Terminate/Supervise/Watch/Unwatch/Failed/
DeathWatchNotification/NoMessage). System messages bypass the user mailbox and
are processed before user messages on every mailbox run
(dispatch/Mailbox.scala:227-237).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional


class SystemMessage:
    """Base class. Instances are single-use and owned by exactly one queue —
    the reference's 'NEVER SEND THE SAME SYSTEM MESSAGE OBJECT TO TWO ACTORS'
    invariant (actor/dungeon/Dispatch.scala:92-97)."""

    __slots__ = ()


@dataclass
class Create(SystemMessage):
    failure: Optional[BaseException] = None


@dataclass
class Recreate(SystemMessage):
    cause: Optional[BaseException] = None


@dataclass
class Suspend(SystemMessage):
    pass


@dataclass
class Resume(SystemMessage):
    caused_by_failure: Optional[BaseException] = None


@dataclass
class Terminate(SystemMessage):
    pass


@dataclass
class Supervise(SystemMessage):
    child: Any = None  # ActorRef
    asynchronous: bool = True


@dataclass
class Watch(SystemMessage):
    watchee: Any = None  # InternalActorRef
    watcher: Any = None


@dataclass
class Unwatch(SystemMessage):
    watchee: Any = None
    watcher: Any = None


@dataclass
class Failed(SystemMessage):
    child: Any = None
    cause: Optional[BaseException] = None
    uid: int = 0


@dataclass
class DeathWatchNotification(SystemMessage):
    actor: Any = None
    existence_confirmed: bool = True
    address_terminated: bool = False
    cause: Optional[BaseException] = None  # set when death was a failure


@dataclass
class NoMessage(SystemMessage):
    pass
