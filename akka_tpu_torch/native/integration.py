"""Hook the native substrate into the runtime seams.

A copy of `akka_tpu/native/integration.py` (commit 001ef4f). Where the
reference falls back to the Python queues when the library does not
build, the port raises: `register_native_mailbox` and `NativeScheduler`
raise RuntimeError (naming g++ when it is missing).

- NativeUnboundedMailbox: a MailboxType over the lock-free C++ MPSC queue,
  registered as "native-unbounded" in the Mailboxes registry (the
  dispatch/Mailboxes.scala:91 extension seam).
- NativeScheduler: the Scheduler interface backed by the C++ hashed-wheel
  timer (actor/LightArrayRevolverScheduler.scala parity), selected via
  `akka.scheduler.implementation = native`.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from ..actor.scheduler import Cancellable
from ..dispatch.mailbox import Envelope, MailboxType, MessageQueue
from . import lib as _libmod
from .queues import NativeMpscQueue, NativeWheelTimer


class NativeMessageQueue(MessageQueue):
    __slots__ = ("_q", "_dead_letters")

    def __init__(self):
        self._q = NativeMpscQueue()
        self._dead_letters: Optional[MessageQueue] = None

    def enqueue(self, receiver: Any, handle: Envelope) -> None:
        if not self._q.enqueue(handle):
            # closed (actor stopped): redirect to dead letters, mirroring
            # the reference's becomeClosed mailbox swap — late sends are
            # visible on the EventStream, never silently lost
            dl = self._dead_letters
            if dl is not None:
                dl.enqueue(receiver, handle)

    def dequeue(self) -> Optional[Envelope]:
        return self._q.dequeue()

    @property
    def number_of_messages(self) -> int:
        return len(self._q)

    def clean_up(self, owner: Any, dead_letters: MessageQueue) -> None:
        """On actor stop: install the dead-letter sink for late tells, shut
        the producer side, drain what's left to dead letters, then sweep
        messages orphaned by racing producers — every message is either
        delivered or dead-lettered, exactly once. Memory is reclaimed by
        NativeMpscQueue.__del__ once no producer can hold the handle."""
        self._dead_letters = dead_letters
        self._q.close_producers()
        super().clean_up(owner, dead_letters)  # drains visible nodes
        for obj in self._q.drain_registry():
            dead_letters.enqueue(owner, obj)
        self._q.close()


class NativeUnboundedMailbox(MailboxType):
    def create(self, owner, system) -> MessageQueue:
        return NativeMessageQueue()


def register_native_mailbox(mailboxes) -> bool:
    """Idempotently add the native mailbox type. Raises RuntimeError when
    the library cannot be built."""
    _libmod.get()
    mailboxes.register("native-unbounded", NativeUnboundedMailbox())
    return True


class _NativeCancellable(Cancellable):
    __slots__ = ("_timer", "_tid")

    def __init__(self, timer: NativeWheelTimer, tid: int):
        super().__init__()
        self._timer = timer
        self._tid = tid

    def cancel(self) -> bool:
        out = super().cancel()
        if out:
            self._timer.cancel(self._tid)
        return out


class NativeScheduler:
    """Drop-in for actor.scheduler.Scheduler backed by the C++ wheel. Same
    public surface; shutdown stops the native tick thread."""

    def __init__(self, tick_duration: float = 0.001, ticks_per_wheel: int = 512,
                 name: str = "akka-tpu-torch-native-scheduler"):
        self.tick_duration = tick_duration
        self._timer = NativeWheelTimer(tick_duration, ticks_per_wheel)

    # -- public API (mirrors Scheduler) --------------------------------------
    def schedule_once(self, delay: float, fn: Callable[[], None]) -> Cancellable:
        holder = {}

        def run():
            # the timer may fire before holder is populated; cancel() cannot
            # have been called by then, so a missing entry means "run"
            c = holder.get("c")
            if c is None or not c.is_cancelled:
                fn()
        holder["c"] = _NativeCancellable(
            self._timer, self._timer.schedule_once(delay, run))
        return holder["c"]

    def schedule_with_fixed_delay(self, initial_delay: float, delay: float,
                                  fn: Callable[[], None]) -> Cancellable:
        holder = {}

        def run():
            c = holder.get("c")
            if c is None or not c.is_cancelled:
                fn()
        holder["c"] = _NativeCancellable(
            self._timer, self._timer.schedule_periodically(initial_delay,
                                                           delay, run))
        return holder["c"]

    # the native wheel reschedules at fixed intervals; fixed-rate and
    # fixed-delay coincide for short callbacks
    schedule_at_fixed_rate = schedule_with_fixed_delay

    def schedule_tell_once(self, delay: float, receiver, message: Any,
                           sender=None) -> Cancellable:
        return self.schedule_once(delay,
                                  lambda: receiver.tell(message, sender))

    def schedule_tell_with_fixed_delay(self, initial_delay: float,
                                       delay: float, receiver, message: Any,
                                       sender=None) -> Cancellable:
        return self.schedule_with_fixed_delay(
            initial_delay, delay, lambda: receiver.tell(message, sender))

    def shutdown(self) -> None:
        self._timer.shutdown()
