"""Mailboxes: per-actor message queue + scheduling status machine.

A copy of `akka_tpu/dispatch/mailbox.py` at commit 5d9b7cd (host code, no
jax; the port keeps its own copy of every module it needs).

Reference parity: akka-actor/src/main/scala/akka/dispatch/Mailbox.scala —
status bitfield constants (:37-45), `run` (:227-237), the throughput-bounded
`processMailbox` loop (:260-277), `processAllSystemMessages` (:286-330), and
the pluggable mailbox types (:638-1036). The reference's Unsafe CAS on the
status word (dispatch/Mailbox.scala:115-138 via AbstractMailbox field offsets)
becomes an `AtomicInt` here; the optional C++ substrate (native/, the
`native-unbounded` mailbox type) provides a lock-free MPSC queue for the
user-message queue.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from collections import deque
from typing import Any, Callable, NamedTuple, Optional, TYPE_CHECKING

from . import sysmsg
from ..actor.messages import DeadLetter, Dropped

if TYPE_CHECKING:  # pragma: no cover
    from .dispatcher import MessageDispatcher


class Envelope(NamedTuple):
    """A user message + its sender (reference: dispatch/AbstractDispatcher.scala:26-38)."""
    message: Any
    sender: Any


class AtomicInt:
    """CAS-able int. Stands in for sun.misc.Unsafe volatile/CAS field ops
    (reference: akka-actor/src/main/scala/akka/util/Unsafe.java:17-35)."""

    __slots__ = ("_value", "_lock")

    def __init__(self, value: int = 0):
        self._value = value
        self._lock = threading.Lock()

    def get(self) -> int:
        return self._value

    def set(self, value: int) -> None:
        with self._lock:
            self._value = value

    def compare_and_set(self, expect: int, update: int) -> bool:
        with self._lock:
            if self._value == expect:
                self._value = update
                return True
            return False

    def get_and_add(self, delta: int) -> int:
        with self._lock:
            v = self._value
            self._value = v + delta
            return v


# -- message queues --------------------------------------------------------

class MessageQueue:
    def enqueue(self, receiver: Any, handle: Envelope) -> None:
        raise NotImplementedError

    def dequeue(self) -> Optional[Envelope]:
        raise NotImplementedError

    @property
    def number_of_messages(self) -> int:
        raise NotImplementedError

    @property
    def has_messages(self) -> bool:
        return self.number_of_messages > 0

    def clean_up(self, owner: Any, dead_letters: "MessageQueue") -> None:
        while True:
            env = self.dequeue()
            if env is None:
                break
            dead_letters.enqueue(owner, env)


class UnboundedMessageQueue(MessageQueue):
    """MPSC unbounded FIFO (reference: UnboundedMailbox, dispatch/Mailbox.scala:647,
    backed by AbstractNodeQueue.java). collections.deque.append/popleft are
    atomic under the GIL, matching the lock-free reference queue's contract."""

    __slots__ = ("_q",)

    def __init__(self) -> None:
        self._q: deque = deque()

    def enqueue(self, receiver: Any, handle: Envelope) -> None:
        self._q.append(handle)

    def dequeue(self) -> Optional[Envelope]:
        try:
            return self._q.popleft()
        except IndexError:
            return None

    @property
    def number_of_messages(self) -> int:
        return len(self._q)


class BoundedMessageQueue(MessageQueue):
    """Blocking bounded queue; on push-timeout the envelope goes to dead
    letters (reference: BoundedMailbox, dispatch/Mailbox.scala:699-726)."""

    __slots__ = ("_q", "capacity", "push_timeout", "_not_full", "_owner_system")

    def __init__(self, capacity: int, push_timeout: float) -> None:
        self._q: deque = deque()
        self.capacity = capacity
        self.push_timeout = push_timeout
        self._not_full = threading.Condition()

    def enqueue(self, receiver: Any, handle: Envelope) -> None:
        with self._not_full:
            if len(self._q) >= self.capacity:
                ok = self._not_full.wait_for(
                    lambda: len(self._q) < self.capacity,
                    timeout=self.push_timeout if self.push_timeout != float("inf") else None)
                if not ok:
                    system = getattr(receiver, "_system", None) or getattr(getattr(receiver, "provider", None), "system", None)
                    if system is not None:
                        system.dead_letters.tell(
                            DeadLetter(handle.message, handle.sender, receiver), handle.sender)
                    return
            self._q.append(handle)

    def dequeue(self) -> Optional[Envelope]:
        with self._not_full:
            if not self._q:
                return None
            env = self._q.popleft()
            self._not_full.notify()
            return env

    @property
    def number_of_messages(self) -> int:
        return len(self._q)


class NonBlockingBoundedMessageQueue(MessageQueue):
    """Drops to dead letters when full, never blocks the sender
    (reference: NonBlockingBoundedMailbox, dispatch/Mailbox.scala:684-697)."""

    __slots__ = ("_q", "capacity")

    def __init__(self, capacity: int) -> None:
        self._q: deque = deque()
        self.capacity = capacity

    def enqueue(self, receiver: Any, handle: Envelope) -> None:
        if len(self._q) >= self.capacity:
            system = getattr(receiver, "_system", None)
            if system is not None:
                system.dead_letters.tell(
                    DeadLetter(handle.message, handle.sender, receiver), handle.sender)
            return
        self._q.append(handle)

    def dequeue(self) -> Optional[Envelope]:
        try:
            return self._q.popleft()
        except IndexError:
            return None

    @property
    def number_of_messages(self) -> int:
        return len(self._q)


class PriorityMessageQueue(MessageQueue):
    """Unbounded priority queue; `stable` keeps FIFO order among equal
    priorities (reference: UnboundedPriorityMailbox :764 /
    UnboundedStablePriorityMailbox :795)."""

    __slots__ = ("_heap", "_counter", "_prio", "_lock")

    def __init__(self, priority: Callable[[Any], int], stable: bool = True) -> None:
        self._heap: list = []
        self._counter = itertools.count()
        self._prio = priority
        self._lock = threading.Lock()

    def enqueue(self, receiver: Any, handle: Envelope) -> None:
        with self._lock:
            heapq.heappush(self._heap, (self._prio(handle.message), next(self._counter), handle))

    def dequeue(self) -> Optional[Envelope]:
        with self._lock:
            if not self._heap:
                return None
            return heapq.heappop(self._heap)[2]

    @property
    def number_of_messages(self) -> int:
        return len(self._heap)


class ControlMessage:
    """Marker: jumps the queue in a ControlAwareMessageQueue
    (reference: ControlAwareMessageQueueSemantics, dispatch/Mailbox.scala:881-920)."""
    __slots__ = ()


class ControlAwareMessageQueue(MessageQueue):
    __slots__ = ("_control", "_ordinary")

    def __init__(self) -> None:
        self._control: deque = deque()
        self._ordinary: deque = deque()

    def enqueue(self, receiver: Any, handle: Envelope) -> None:
        if isinstance(handle.message, ControlMessage):
            self._control.append(handle)
        else:
            self._ordinary.append(handle)

    def dequeue(self) -> Optional[Envelope]:
        try:
            return self._control.popleft()
        except IndexError:
            try:
                return self._ordinary.popleft()
            except IndexError:
                return None

    @property
    def number_of_messages(self) -> int:
        return len(self._control) + len(self._ordinary)


class DequeBasedMessageQueue(UnboundedMessageQueue):
    """Supports enqueue_first for Stash unstashing
    (reference: UnboundedDequeBasedMailbox, dispatch/Mailbox.scala:838)."""

    def enqueue_first(self, receiver: Any, handle: Envelope) -> None:
        self._q.appendleft(handle)


# -- requirement markers (reference: RequiresMessageQueue, Mailbox.scala:1036) --

class RequiresMessageQueue:
    """Actor classes may set `mailbox_requirement` to a MessageQueue marker
    class; Mailboxes.lookup honors it."""
    mailbox_requirement: Optional[type] = None


# -- the mailbox itself ----------------------------------------------------

# Status bitfield (reference: dispatch/Mailbox.scala:37-45)
OPEN = 0
CLOSED = 1
SCHEDULED = 2
SHOULD_SCHEDULE_MASK = 3
SHOULD_NOT_PROCESS_MASK = ~2 & 0xFFFFFFFF
SUSPEND_MASK = ~3 & 0xFFFFFFFF
SUSPEND_UNIT = 4


class Mailbox:
    """Binds an actor cell to a message queue, runs as a task on the
    dispatcher's executor. One `run` processes all system messages then up to
    `throughput` user messages (reference: dispatch/Mailbox.scala:227-277)."""

    __slots__ = ("message_queue", "actor", "dispatcher", "_status", "_sysq", "_sysq_lock")

    def __init__(self, message_queue: MessageQueue):
        self.message_queue = message_queue
        self.actor = None          # ActorCell, set by Dispatch.init
        self.dispatcher: Optional["MessageDispatcher"] = None
        self._status = AtomicInt(OPEN)
        self._sysq: deque = deque()
        self._sysq_lock = threading.Lock()

    # -- status machine (reference: Mailbox.scala:96-225) -------------------
    @property
    def status(self) -> int:
        return self._status.get()

    def should_process_message(self) -> bool:
        return (self.status & SHOULD_NOT_PROCESS_MASK) == 0

    def suspend_count(self) -> int:
        return self.status // SUSPEND_UNIT

    def is_suspended(self) -> bool:
        return (self.status & SUSPEND_MASK) != 0

    def is_closed(self) -> bool:
        return self.status == CLOSED

    def is_scheduled(self) -> bool:
        return (self.status & SCHEDULED) != 0

    def suspend(self) -> bool:
        """Increment suspend count; True if transitioned from not-suspended."""
        while True:
            s = self.status
            if s == CLOSED:
                return False
            if self._status.compare_and_set(s, s + SUSPEND_UNIT):
                return s < SUSPEND_UNIT

    def resume(self) -> bool:
        """Decrement suspend count; True if now fully resumed."""
        while True:
            s = self.status
            if s == CLOSED:
                return False
            next_s = s if s < SUSPEND_UNIT else s - SUSPEND_UNIT
            if self._status.compare_and_set(s, next_s):
                return next_s < SUSPEND_UNIT

    def become_closed(self) -> bool:
        while True:
            s = self.status
            if s == CLOSED:
                return False
            if self._status.compare_and_set(s, CLOSED):
                return True

    def set_as_scheduled(self) -> bool:
        while True:
            s = self.status
            if (s & SHOULD_SCHEDULE_MASK) != OPEN:
                return False
            if self._status.compare_and_set(s, s | SCHEDULED):
                return True

    def set_as_idle(self) -> bool:
        while True:
            s = self.status
            if self._status.compare_and_set(s, s & ~SCHEDULED if s != CLOSED else CLOSED):
                return True

    def can_be_scheduled_for_execution(self, has_message_hint: bool, has_system_message_hint: bool) -> bool:
        s = self.status
        if s in (OPEN, SCHEDULED):
            return has_message_hint or has_system_message_hint or self.has_system_messages or self.has_messages
        if s == CLOSED:
            return False
        return has_system_message_hint or self.has_system_messages

    # -- queues ------------------------------------------------------------
    def enqueue(self, receiver: Any, envelope: Envelope) -> None:
        self.message_queue.enqueue(receiver, envelope)

    def dequeue(self) -> Optional[Envelope]:
        return self.message_queue.dequeue()

    @property
    def has_messages(self) -> bool:
        return self.message_queue.has_messages

    @property
    def number_of_messages(self) -> int:
        return self.message_queue.number_of_messages

    def system_enqueue(self, receiver: Any, message: sysmsg.SystemMessage) -> None:
        """MPSC system queue (reference: Mailbox.scala:467-497)."""
        with self._sysq_lock:
            if self.is_closed():
                closed = True
            else:
                self._sysq.append(message)
                closed = False
        if closed:
            system = getattr(receiver, "_system", None)
            if system is not None:
                system.dead_letters.tell(DeadLetter(message, receiver, receiver), receiver)

    def system_drain(self) -> list:
        with self._sysq_lock:
            msgs = list(self._sysq)
            self._sysq.clear()
            return msgs

    @property
    def has_system_messages(self) -> bool:
        return len(self._sysq) > 0

    # -- execution (reference: Mailbox.scala:227-330) -----------------------
    def run(self) -> None:
        try:
            if not self.is_closed():
                self.process_all_system_messages()
                self.process_mailbox()
        finally:
            self.set_as_idle()
            if self.dispatcher is not None:
                self.dispatcher.register_for_execution(self, False, False)

    def process_all_system_messages(self) -> None:
        while self.has_system_messages and not self.is_closed():
            for msg in self.system_drain():
                self.actor.system_invoke(msg)

    def process_mailbox(self) -> None:
        left = self.dispatcher.throughput if self.dispatcher else 1
        deadline = (time.monotonic() + self.dispatcher.throughput_deadline
                    if self.dispatcher and self.dispatcher.throughput_deadline > 0 else 0.0)
        while left > 0 and self.should_process_message():
            env = self.dequeue()
            if env is None:
                return
            self.actor.invoke(env)
            if self.has_system_messages:
                self.process_all_system_messages()
            left -= 1
            if deadline and time.monotonic() >= deadline:
                return

    def clean_up(self) -> None:
        """Move remaining messages to dead letters after close, then let the
        queue release its backing resources via the MessageQueue.clean_up SPI
        (reference: Mailbox.scala:332-360 delegating to
        messageQueue.cleanUp(actor.self, deadLetterMailbox.messageQueue))."""
        if self.actor is None:
            return
        system = self.actor.system
        dl = system.dead_letters
        for msg in self.system_drain():
            dl.tell(msg, self.actor.self_ref)
        self.message_queue.clean_up(
            self.actor.self_ref, _DeadLetterSink(dl, self.actor.self_ref))


class _DeadLetterSink(MessageQueue):
    """Adapter presenting the dead-letters ActorRef as the MessageQueue that
    MessageQueue.clean_up drains into (the deadLetterMailbox.messageQueue
    role in the reference)."""

    __slots__ = ("_dl", "_owner")

    def __init__(self, dead_letters_ref: Any, owner_ref: Any) -> None:
        self._dl = dead_letters_ref
        self._owner = owner_ref

    def enqueue(self, receiver: Any, handle: Envelope) -> None:
        self._dl.tell(DeadLetter(handle.message, handle.sender, self._owner),
                      handle.sender)

    def dequeue(self) -> Optional[Envelope]:
        return None

    @property
    def number_of_messages(self) -> int:
        return 0


# -- mailbox type registry (reference: dispatch/Mailboxes.scala:91) ---------

class MailboxType:
    """Factory for message queues."""

    def create(self, owner: Any, system: Any) -> MessageQueue:
        raise NotImplementedError


class UnboundedMailbox(MailboxType):
    def create(self, owner, system) -> MessageQueue:
        return UnboundedMessageQueue()


class BoundedMailbox(MailboxType):
    def __init__(self, capacity: int, push_timeout: float = 10.0):
        self.capacity = capacity
        self.push_timeout = push_timeout

    def create(self, owner, system) -> MessageQueue:
        return BoundedMessageQueue(self.capacity, self.push_timeout)


class NonBlockingBoundedMailbox(MailboxType):
    def __init__(self, capacity: int):
        self.capacity = capacity

    def create(self, owner, system) -> MessageQueue:
        return NonBlockingBoundedMessageQueue(self.capacity)


class UnboundedPriorityMailbox(MailboxType):
    def __init__(self, priority: Callable[[Any], int], stable: bool = True):
        self.priority = priority
        self.stable = stable

    def create(self, owner, system) -> MessageQueue:
        return PriorityMessageQueue(self.priority, self.stable)


class UnboundedControlAwareMailbox(MailboxType):
    def create(self, owner, system) -> MessageQueue:
        return ControlAwareMessageQueue()


class UnboundedDequeBasedMailbox(MailboxType):
    def create(self, owner, system) -> MessageQueue:
        return DequeBasedMessageQueue()


class Mailboxes:
    """Mailbox-type lookup from config path or requirement
    (reference: dispatch/Mailboxes.scala)."""

    def __init__(self, settings, event_stream):
        self.settings = settings
        self.event_stream = event_stream
        self._types: dict[str, MailboxType] = {
            "unbounded": UnboundedMailbox(),
            "unbounded-deque-based": UnboundedDequeBasedMailbox(),
            "unbounded-control-aware": UnboundedControlAwareMailbox(),
        }

    def register(self, name: str, mailbox_type: MailboxType) -> None:
        self._types[name] = mailbox_type

    def lookup(self, name: str) -> MailboxType:
        if name in self._types:
            return self._types[name]
        cfg = self.settings.config.get_config(name) if self.settings.config.has_path(name) else None
        if cfg is not None and cfg.has_path("mailbox-type"):
            return self.from_config(cfg)
        raise KeyError(f"unknown mailbox type: {name}")

    def from_config(self, cfg) -> MailboxType:
        mt = cfg.get_string("mailbox-type", "unbounded")
        if mt in self._types:
            return self._types[mt]
        if mt == "bounded":
            return BoundedMailbox(cfg.get_int("mailbox-capacity", 1000),
                                  cfg.get_duration("mailbox-push-timeout-time", "10s"))
        raise KeyError(f"unknown mailbox-type: {mt}")

    def default_mailbox(self) -> MailboxType:
        return self._types["unbounded"]

    def for_props(self, props) -> MailboxType:
        if props.mailbox is not None:
            if isinstance(props.mailbox, MailboxType):
                return props.mailbox
            return self.lookup(props.mailbox)
        req = getattr(props.actor_class(), "mailbox_requirement", None) if props.actor_class() else None
        if req is DequeBasedMessageQueue:
            return self._types["unbounded-deque-based"]
        if req is ControlAwareMessageQueue:
            return self._types["unbounded-control-aware"]
        return self.default_mailbox()
