"""Actor references: location-transparent handles with `tell`.

A copy of `akka_tpu/actor/ref.py` at commit 5d9b7cd (host code, no jax; the
port keeps its own copy of every module it needs).

Reference parity: akka-actor/src/main/scala/akka/actor/ActorRef.scala —
`ActorRef.!` (:185), `LocalActorRef` delegating to its ActorCell (:412-413),
MinimalActorRef for synthetic refs, Nobody, DeadLetterActorRef
(akka/actor/ActorRefProvider.scala dead-letters), and FunctionRef
(actor/dungeon/Children FunctionRef) used for probes/adapters.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Optional

from .path import ActorPath, Address, undefined_uid
from .messages import DeadLetter, Terminated
from ..dispatch.mailbox import Envelope
from ..dispatch import sysmsg


class ActorRef:
    """The public handle. Ordered and hashed by path."""

    path: ActorPath

    def tell(self, message: Any, sender: "Optional[ActorRef]" = None) -> None:
        raise NotImplementedError

    # `ref << msg` sugar for tell with no sender
    def __lshift__(self, message: Any) -> None:
        self.tell(message, None)

    def forward(self, message: Any, context) -> None:
        self.tell(message, context.sender)

    @property
    def uid(self) -> int:
        return self.path.uid

    def __eq__(self, other: object) -> bool:
        return (isinstance(other, ActorRef) and self.path == other.path
                and self.path.uid == other.path.uid)

    def __hash__(self) -> int:
        return hash((self.path, self.path.uid))

    def __lt__(self, other: "ActorRef") -> bool:
        return (str(self.path), self.path.uid) < (str(other.path), other.path.uid)

    def __repr__(self) -> str:
        return f"Actor[{self.path.to_serialization_format()}]"

    def __reduce__(self):
        # refs in message payloads cross the wire as full-address path strings
        # resolved against the receiving system's provider (reference:
        # Serialization.currentTransportInformation, Serialization.scala:93-136)
        from ..serialization.serialization import resolve_ref, serialized_ref_path
        return (resolve_ref, (serialized_ref_path(self),))


class InternalActorRef(ActorRef):
    """SPI shared by local/remote refs (reference: InternalActorRef in ActorRef.scala)."""

    def start(self) -> None: ...
    def suspend(self) -> None: ...
    def resume(self, caused_by_failure: Optional[BaseException] = None) -> None: ...
    def restart(self, cause: Optional[BaseException] = None) -> None: ...
    def stop(self) -> None: ...

    def send_system_message(self, message: sysmsg.SystemMessage) -> None: ...

    @property
    def is_local(self) -> bool:
        return True

    @property
    def is_terminated(self) -> bool:
        return False

    def get_child(self, names: list) -> "InternalActorRef":
        return Nobody


class LocalActorRef(InternalActorRef):
    """Delegates everything to its ActorCell (reference: ActorRef.scala:305-430)."""

    __slots__ = ("path", "cell", "_system")

    def __init__(self, system, props, dispatcher_id, parent, path: ActorPath):
        from .cell import ActorCell
        self.path = path
        self._system = system
        self.cell = ActorCell(system, self, props, dispatcher_id, parent)

    def initialize(self, send_supervise: bool, mailbox_type) -> "LocalActorRef":
        self.cell.init(send_supervise, mailbox_type)
        return self

    def tell(self, message: Any, sender: Optional[ActorRef] = None) -> None:
        if message is None:
            from .messages import InvalidMessageException
            raise InvalidMessageException("message must not be None")
        self.cell.send_message(Envelope(message, sender))

    def send_system_message(self, message: sysmsg.SystemMessage) -> None:
        self.cell.send_system_message(message)

    def start(self) -> None:
        self.cell.start()

    def suspend(self) -> None:
        self.cell.suspend()

    def resume(self, caused_by_failure: Optional[BaseException] = None) -> None:
        self.cell.resume(caused_by_failure)

    def restart(self, cause: Optional[BaseException] = None) -> None:
        self.cell.restart(cause)

    def stop(self) -> None:
        self.cell.stop()

    @property
    def is_terminated(self) -> bool:
        return self.cell.is_terminated

    @property
    def underlying(self):
        return self.cell

    def get_child(self, names: list) -> InternalActorRef:
        ref: InternalActorRef = self
        for name in names:
            if name in ("", "."):
                continue
            if name == "..":
                ref = ref.cell.parent if isinstance(ref, LocalActorRef) else Nobody
            elif isinstance(ref, LocalActorRef):
                child = ref.cell.get_single_child(name)
                if child is None:
                    return Nobody
                ref = child
            else:
                return Nobody
        return ref


class MinimalActorRef(InternalActorRef):
    """No cell, no mailbox — synthetic refs (reference: MinimalActorRef)."""

    def __init__(self, path: ActorPath, provider=None):
        self.path = path
        self.provider = provider

    def tell(self, message: Any, sender: Optional[ActorRef] = None) -> None:
        pass

    def send_system_message(self, message: sysmsg.SystemMessage) -> None:
        if isinstance(message, sysmsg.Watch):
            if message.watchee == self and message.watcher != self:
                message.watcher.send_system_message(
                    sysmsg.DeathWatchNotification(self, existence_confirmed=False))

    @property
    def is_terminated(self) -> bool:
        return True


class _Nobody(MinimalActorRef):
    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __init__(self):
        super().__init__(ActorPath(Address("akka", "all-systems"), ("Nobody",)))

    def __repr__(self):
        return "Nobody"


Nobody = _Nobody()


class DeadLetterActorRef(MinimalActorRef):
    """Publishes DeadLetter to the event stream
    (reference: DeadLetterActorRef in ActorRefProvider.scala)."""

    def __init__(self, path: ActorPath, event_stream):
        super().__init__(path)
        self.event_stream = event_stream

    def tell(self, message: Any, sender: Optional[ActorRef] = None) -> None:
        if isinstance(message, DeadLetter):
            self.event_stream.publish(message)
        else:
            self.event_stream.publish(DeadLetter(message, sender if sender is not None else Nobody, self))


class FunctionRef(MinimalActorRef):
    """A ref backed by a plain function; supports being watched
    (reference: akka.actor.FunctionRef in actor/ActorCell.scala companion area)."""

    def __init__(self, path: ActorPath, provider, handler: Callable[[Any, Optional[ActorRef]], None]):
        super().__init__(path, provider)
        self.handler = handler
        self._watched_by: set = set()
        self._stopped = False
        self._lock = threading.Lock()

    def tell(self, message: Any, sender: Optional[ActorRef] = None) -> None:
        if not self._stopped:
            self.handler(message, sender)

    def send_system_message(self, message: sysmsg.SystemMessage) -> None:
        if isinstance(message, sysmsg.Watch):
            with self._lock:
                if self._stopped:
                    message.watcher.send_system_message(
                        sysmsg.DeathWatchNotification(self, existence_confirmed=True))
                else:
                    self._watched_by.add(message.watcher)
        elif isinstance(message, sysmsg.Unwatch):
            with self._lock:
                self._watched_by.discard(message.watcher)
        elif isinstance(message, sysmsg.DeathWatchNotification):
            self.tell(Terminated(message.actor, message.existence_confirmed,
                                 message.address_terminated), message.actor)

    @property
    def is_terminated(self) -> bool:
        return self._stopped

    def stop(self) -> None:
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            watchers = list(self._watched_by)
            self._watched_by.clear()
        for w in watchers:
            w.send_system_message(sysmsg.DeathWatchNotification(self, existence_confirmed=True))

    def watch(self, other: InternalActorRef) -> None:
        other.send_system_message(sysmsg.Watch(watchee=other, watcher=self))

    def unwatch(self, other: InternalActorRef) -> None:
        other.send_system_message(sysmsg.Unwatch(watchee=other, watcher=self))
