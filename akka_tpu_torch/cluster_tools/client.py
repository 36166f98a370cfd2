"""ClusterClient: an actor system OUTSIDE the cluster talking to services
inside it through a receptionist.

A copy of `akka_tpu/cluster_tools/client.py` at commit c056b95 (host code,
no jax; the port keeps its own copy of every module it needs).

Reference parity: akka-cluster-tools/src/main/scala/akka/cluster/client/
ClusterClient.scala:287 (the client FSM: establish contact from
initial-contacts, buffer while connecting, forward Send/SendToAll/Publish)
and ClusterReceptionist (the cluster-side endpoint delegating into the
DistributedPubSub mediator; services are exposed with
ClusterClientReceptionist.registerService).

The client's system uses `provider = remote` — it is NOT a cluster member;
only the receptionist endpoints need to be reachable.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

from ..actor.actor import Actor
from ..actor.props import Props
from ..actor.system import ActorSystem, ExtensionId
from . import pubsub as _ps


# -- protocol (reference: ClusterClientMessages) ------------------------------

@dataclass(frozen=True)
class Send:
    """Deliver to ONE actor registered at `path` (mediator Send routing)."""
    path: str
    msg: Any
    local_affinity: bool = False


@dataclass(frozen=True)
class SendToAll:
    path: str
    msg: Any


@dataclass(frozen=True)
class Publish:
    topic: str
    msg: Any


@dataclass(frozen=True)
class GetContacts:
    pass


@dataclass(frozen=True)
class Contacts:
    """Receptionist addresses the client may (re)connect to."""
    contact_points: Tuple[str, ...]


RECEPTIONIST_NAME = "cluster-client-receptionist"


class ClusterReceptionistActor(Actor):
    """Cluster-side endpoint (reference: client/ClusterReceptionist): hands
    out contact points and forwards client traffic into the pub-sub
    mediator, preserving the ORIGINAL client as sender so replies flow
    straight back over remoting."""

    def __init__(self):
        super().__init__()
        self._mediator = None

    def pre_start(self) -> None:
        self._mediator = _ps.DistributedPubSub.get(
            self.context.system).mediator

    def receive(self, message: Any):
        if isinstance(message, GetContacts):
            from ..cluster import Cluster
            from ..cluster.member import MemberStatus
            cluster = Cluster.get(self.context.system)
            state = cluster.state
            # advertise only LIVE endpoints: Up/WeaklyUp and reachable —
            # handing out a Down node's path would make the client burn
            # its re-establish ticks on a dead receptionist
            points = tuple(
                f"{m.address_str}/system/{RECEPTIONIST_NAME}"
                for m in state.members
                if m.status in (MemberStatus.UP, MemberStatus.WEAKLY_UP)
                and m not in state.unreachable)
            self.sender.tell(Contacts(points or (
                f"{cluster.self_unique_address.address_str}"
                f"/system/{RECEPTIONIST_NAME}",)), self.self_ref)
        elif isinstance(message, Send):
            self._mediator.tell(
                _ps.Send(message.path, message.msg,
                         local_affinity=message.local_affinity), self.sender)
        elif isinstance(message, SendToAll):
            self._mediator.tell(_ps.SendToAll(message.path, message.msg),
                                self.sender)
        elif isinstance(message, Publish):
            self._mediator.tell(_ps.Publish(message.topic, message.msg),
                                self.sender)
        else:
            return NotImplemented
        return None


class ClusterClientReceptionist(ExtensionId):
    """Cluster-side extension: starts the receptionist endpoint and exposes
    registerService (reference: ClusterClientReceptionist.registerService —
    a Put into the mediator so Send-by-path resolves)."""

    def create_extension(self, system: ActorSystem):
        return _ReceptionistExt(system)

    @staticmethod
    def get(system: ActorSystem) -> "_ReceptionistExt":
        return system.register_extension(ClusterClientReceptionist())


class _ReceptionistExt:
    def __init__(self, system: ActorSystem):
        self.system = system
        self.underlying = system.system_actor_of(
            Props.create(ClusterReceptionistActor), RECEPTIONIST_NAME)

    def register_service(self, service) -> None:
        _ps.DistributedPubSub.get(self.system).mediator.tell(
            _ps.Put(service), None)

    def register_subscriber(self, topic: str, subscriber) -> None:
        _ps.DistributedPubSub.get(self.system).mediator.tell(
            _ps.Subscribe(topic, subscriber), subscriber)


@dataclass
class ClusterClientSettings:
    """(reference: ClusterClientSettings) — initial receptionist addresses
    as `akka://sys@host:port` strings."""
    initial_contacts: Tuple[str, ...]
    establishing_get_contacts_interval: float = 0.5
    buffer_size: int = 1024


class ClusterClient(Actor):
    """The client actor (reference: ClusterClient.scala:287): send it
    Send/SendToAll/Publish; it buffers until a receptionist is established
    and re-establishes (round-robining contacts) when the connection's
    node dies."""

    class _Reconnect:
        pass

    def __init__(self, settings: ClusterClientSettings):
        super().__init__()
        if not settings.initial_contacts:
            raise ValueError("initial_contacts must not be empty")
        self.settings = settings
        self._receptionist = None          # established endpoint ref
        self._buffer: List[Tuple[Any, Any]] = []
        self._task = None
        self._contacts: Tuple[str, ...] = tuple(settings.initial_contacts)

    def _contact_refs(self):
        out = []
        for addr in self._contacts:
            path = addr if "/system/" in addr else \
                f"{addr}/system/{RECEPTIONIST_NAME}"
            out.append(self.context.system.provider.resolve_actor_ref(path))
        return out

    def pre_start(self) -> None:
        self._task = self.context.system.scheduler.schedule_tell_with_fixed_delay(
            0.0, self.settings.establishing_get_contacts_interval,
            self.self_ref, self._Reconnect())

    def post_stop(self) -> None:
        if self._task is not None:
            self._task.cancel()

    def receive(self, message: Any):
        from ..actor.messages import Terminated

        if isinstance(message, self._Reconnect):
            if self._receptionist is None:
                for ref in self._contact_refs():
                    ref.tell(GetContacts(), self.self_ref)
            else:
                # refresh contacts while ESTABLISHED too: the cluster may
                # roll its membership completely — a client frozen on its
                # first Contacts reply could be left with an all-dead list
                # and never re-establish (reference: periodic
                # HeartbeatTick/contacts refresh)
                self._receptionist.tell(GetContacts(), self.self_ref)
        elif isinstance(message, Contacts):
            if message.contact_points:
                self._contacts = message.contact_points
            if self._receptionist is None:
                self._receptionist = self.sender
                self.context.watch(self._receptionist)
                for msg, snd in self._buffer:
                    self._receptionist.tell(msg, snd)
                self._buffer.clear()
        elif isinstance(message, Terminated):
            if self._receptionist is not None and \
                    message.actor.path == self._receptionist.path:
                self._receptionist = None  # re-establish on next tick
        elif isinstance(message, (Send, SendToAll, Publish)):
            if self._receptionist is not None:
                self._receptionist.tell(message, self.sender)
            else:
                self._buffer.append((message, self.sender))
                if len(self._buffer) > self.settings.buffer_size:
                    # full: evict the OLDEST (the reference drops the first
                    # buffered message, keeping the freshest traffic) and
                    # make the loss VISIBLE via dead letters
                    from ..actor.messages import DeadLetter
                    old_msg, old_snd = self._buffer.pop(0)
                    self.context.system.dead_letters.tell(
                        DeadLetter(old_msg, old_snd, self.self_ref), old_snd)
        else:
            return NotImplemented
        return None
