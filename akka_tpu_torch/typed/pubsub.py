"""Typed local pub-sub Topic.

A copy of `akka_tpu/typed/pubsub.py` at commit 1001e26 (host code, no jax;
the port keeps its own copy of every module it needs).

Reference parity: akka-actor-typed/src/main/scala/akka/actor/typed/pubsub/
Topic.scala — a Topic actor per topic name; Subscribe/Unsubscribe local
refs; Publish fans out; when clustered, topics find each other through the
Receptionist (the reference uses the receptionist for topic discovery too),
so a publish on one node reaches subscribers everywhere.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Set

from ..actor.actor import Actor
from ..actor.messages import Terminated
from ..actor.props import Props
from ..actor.ref import ActorRef
from .receptionist import Listing, Receptionist, ServiceKey


@dataclass(frozen=True)
class TopicSubscribe:
    subscriber: ActorRef


@dataclass(frozen=True)
class TopicUnsubscribe:
    subscriber: ActorRef


@dataclass(frozen=True)
class Publish:
    message: Any


@dataclass(frozen=True)
class _TopicMessage:
    message: Any


class TopicActor(Actor):
    def __init__(self, topic_name: str):
        super().__init__()
        self.topic_name = topic_name
        self.key = ServiceKey(f"topic-{topic_name}")
        self.subscribers: Set[ActorRef] = set()
        self.peers: Set[ActorRef] = set()

    def pre_start(self) -> None:
        rec = Receptionist.get(self.context.system)
        rec.register(self.key, self.self_ref)
        rec.subscribe(self.key, self.self_ref)

    def receive(self, message: Any) -> Any:
        if isinstance(message, TopicSubscribe):
            self.subscribers.add(message.subscriber)
            self.context.watch(message.subscriber)
        elif isinstance(message, TopicUnsubscribe):
            self.subscribers.discard(message.subscriber)
            self.context.unwatch(message.subscriber)
        elif isinstance(message, Terminated):
            self.subscribers.discard(message.actor)
        elif isinstance(message, Publish):
            for peer in self.peers:
                peer.tell(_TopicMessage(message.message), self.self_ref)
            if not self.peers:  # not yet discovered (at least ourselves)
                self._deliver(message.message)
        elif isinstance(message, _TopicMessage):
            self._deliver(message.message)
        elif isinstance(message, Listing):
            self.peers = set(message.service_instances)
        else:
            return NotImplemented

    def _deliver(self, msg: Any) -> None:
        for sub in list(self.subscribers):
            sub.tell(msg, self.self_ref)


class Topic:
    """Topic.create(system, name) -> ref accepting Subscribe/Publish."""

    @staticmethod
    def create(system, topic_name: str, actor_name: str = None) -> ActorRef:
        classic = getattr(system, "classic", system)
        return classic.actor_of(Props.create(TopicActor, topic_name),
                                actor_name)
