"""Built-in user-level message types auto-handled by the actor cell.

A copy of `akka_tpu/actor/messages.py` at commit 5d9b7cd (host code, no jax;
the port keeps its own copy of every module it needs).

Reference parity: akka-actor/src/main/scala/akka/actor/Actor.scala
(PoisonPill, Kill, ReceiveTimeout, Terminated, Identify/ActorIdentity,
Status) and event/DeadLetter types (event/EventStream-published).
AutoReceive handling lives in ActorCell.invoke (actor/ActorCell.scala:557-568).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional


class AutoReceivedMessage:
    """Marker: handled by the cell itself, not the user receive."""
    __slots__ = ()


class PossiblyHarmful:
    __slots__ = ()


class _PoisonPill(AutoReceivedMessage, PossiblyHarmful):
    _instance: "Optional[_PoisonPill]" = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:
        return "PoisonPill"


class _Kill(AutoReceivedMessage, PossiblyHarmful):
    _instance: "Optional[_Kill]" = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:
        return "Kill"


class _ReceiveTimeout(PossiblyHarmful):
    _instance: "Optional[_ReceiveTimeout]" = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:
        return "ReceiveTimeout"


PoisonPill = _PoisonPill()
Kill = _Kill()
ReceiveTimeout = _ReceiveTimeout()


class ActorKilledException(Exception):
    pass


class ActorInitializationException(Exception):
    def __init__(self, actor: Any, message: str, cause: Optional[BaseException] = None):
        super().__init__(message)
        self.actor = actor
        self.cause = cause


class PreRestartException(ActorInitializationException):
    pass


class PostRestartException(ActorInitializationException):
    pass


class DeathPactException(Exception):
    """Terminated received but not handled (reference: actor/Actor.scala DeathPactException)."""

    def __init__(self, dead: Any):
        super().__init__(f"monitored actor {dead} terminated")
        self.dead = dead


class IllegalActorStateException(Exception):
    pass


class InvalidActorNameException(Exception):
    pass


class InvalidMessageException(Exception):
    pass


@dataclass(frozen=True)
class Terminated(AutoReceivedMessage):
    """DeathWatch notification delivered to watchers
    (reference: actor/dungeon/DeathWatch.scala:81). `cause` is non-None when
    the watched actor died from a failure (feeds typed ChildFailed)."""
    actor: Any
    existence_confirmed: bool = True
    address_terminated: bool = False
    cause: Optional[BaseException] = None


@dataclass(frozen=True)
class Identify(AutoReceivedMessage):
    message_id: Any = None


@dataclass(frozen=True)
class ActorIdentity:
    correlation_id: Any
    ref: Any  # Optional[ActorRef]


@dataclass(frozen=True)
class DeadLetter:
    """Published to the EventStream for messages to dead/nonexistent actors
    (reference: actor/DeadLetter in actor/Actor.scala; event/DeadLetterListener.scala)."""
    message: Any
    sender: Any
    recipient: Any


@dataclass(frozen=True)
class SuppressedDeadLetter:
    message: Any
    sender: Any
    recipient: Any


@dataclass(frozen=True)
class Dropped:
    """Envelope dropped due to overflow/invalid state (reference: actor/Dropped)."""
    message: Any
    reason: str
    sender: Any
    recipient: Any


@dataclass(frozen=True)
class UnhandledMessage:
    message: Any
    sender: Any
    recipient: Any


class Status:
    @dataclass(frozen=True)
    class Success:
        status: Any = None

    @dataclass(frozen=True)
    class Failure:
        cause: BaseException = None  # type: ignore[assignment]
