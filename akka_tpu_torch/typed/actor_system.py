"""Typed ActorSystem facade: the system IS an ActorRef to the guardian.

A copy of `akka_tpu/typed/actor_system.py` at commit 1001e26 (host code, no
jax; the port keeps its own copy of every module it needs).

Reference parity: akka-actor-typed/src/main/scala/akka/actor/typed/ActorSystem.scala
+ internal/adapter/ActorSystemAdapter.scala — `ActorSystem(guardianBehavior, name)`
spawns the user guardian from a Behavior; tell on the system reaches the guardian.
"""

from __future__ import annotations

from typing import Any, Optional

from ..actor.system import ActorSystem as ClassicActorSystem
from ..config import Config
from .adapter import props_from_behavior
from .behavior import Behavior


class ActorSystem:
    def __init__(self, guardian_behavior: Behavior, name: str = "default",
                 config: Optional[Config | dict] = None):
        self.classic = ClassicActorSystem(name, config)
        self.guardian = self.classic.actor_of(props_from_behavior(guardian_behavior), "guardian")
        self.name = name

    @staticmethod
    def create(guardian_behavior: Behavior, name: str = "default",
               config: Optional[Config | dict] = None) -> "ActorSystem":
        return ActorSystem(guardian_behavior, name, config)

    # the system acts as the guardian's ref (reference: ActorSystem extends ActorRef)
    def tell(self, message: Any, sender=None) -> None:
        self.guardian.tell(message, sender)

    @property
    def path(self):
        return self.guardian.path

    @property
    def scheduler(self):
        return self.classic.scheduler

    @property
    def event_stream(self):
        return self.classic.event_stream

    @property
    def settings(self):
        return self.classic.settings

    @property
    def log(self):
        return self.classic.log

    def spawn(self, behavior: Behavior, name: Optional[str] = None):
        """Spawn a top-level actor next to the guardian (SpawnProtocol-ish)."""
        return self.classic.actor_of(props_from_behavior(behavior), name)

    def terminate(self) -> None:
        self.classic.terminate()

    def await_termination(self, timeout: Optional[float] = None) -> bool:
        return self.classic.await_termination(timeout)

    @property
    def when_terminated(self):
        return self.classic.when_terminated

    def __repr__(self) -> str:
        return f"typed.ActorSystem({self.name})"
