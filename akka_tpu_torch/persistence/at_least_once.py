"""AtLeastOnceDelivery: resend-until-confirm with persisted delivery state.

A copy of `akka_tpu/persistence/at_least_once.py` at commit 1001e26 (host
code, no jax; the port keeps its own copy of every module it needs).

Reference parity: akka-persistence/src/main/scala/akka/persistence/
AtLeastOnceDelivery.scala — deliver() allocates a delivery id and tracks the
unconfirmed message, a redeliver tick resends overdue ones (redeliver-interval,
redelivery-burst-limit), confirmDelivery() clears, UnconfirmedWarning after
warn-after-number-of-unconfirmed-attempts, getDeliverySnapshot/
setDeliverySnapshot persist the delivery state across restarts.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Tuple

from .eventsourced import PersistentActor


@dataclass(frozen=True)
class UnconfirmedDelivery:
    delivery_id: int
    destination: Any  # ActorRef
    message: Any


@dataclass(frozen=True)
class UnconfirmedWarning:
    unconfirmed_deliveries: Tuple[UnconfirmedDelivery, ...]


@dataclass(frozen=True)
class AtLeastOnceDeliverySnapshot:
    current_delivery_id: int
    unconfirmed_deliveries: Tuple[UnconfirmedDelivery, ...]


@dataclass(frozen=True)
class _RedeliveryTick:
    pass


class _Delivery:
    __slots__ = ("destination", "message", "timestamp", "attempt")

    def __init__(self, destination, message, timestamp, attempt):
        self.destination = destination
        self.message = message
        self.timestamp = timestamp
        self.attempt = attempt


class AtLeastOnceDelivery(PersistentActor):
    """Mix-in flavor of PersistentActor (reference trait AtLeastOnceDelivery)."""

    redeliver_interval = 5.0
    redelivery_burst_limit = 10_000
    warn_after_number_of_unconfirmed_attempts = 5
    max_unconfirmed_messages = 100_000

    def __init__(self) -> None:
        super().__init__()
        self._delivery_sequence_nr = 0
        self._unconfirmed: Dict[int, _Delivery] = {}
        self._redeliver_task = None

    # -- lifecycle ------------------------------------------------------------
    def pre_start(self) -> None:
        self._redeliver_task = \
            self.context.system.scheduler.schedule_tell_with_fixed_delay(
                self.redeliver_interval / 2, self.redeliver_interval / 2,
                self.self_ref, _RedeliveryTick())
        super().pre_start()

    def post_stop(self) -> None:
        if self._redeliver_task:
            self._redeliver_task.cancel()
        super().post_stop()

    # -- user API -------------------------------------------------------------
    def deliver(self, destination, delivery_id_to_message: Callable[[int], Any]
                ) -> None:
        """(reference: AtLeastOnceDelivery.deliver)"""
        if len(self._unconfirmed) >= self.max_unconfirmed_messages:
            raise MaxUnconfirmedMessagesExceededException(
                f"too many unconfirmed messages "
                f"({self.max_unconfirmed_messages})")
        self._delivery_sequence_nr += 1
        did = self._delivery_sequence_nr
        msg = delivery_id_to_message(did)
        now = time.time()
        if self.recovery_running:
            # replayed deliver: don't send now, the redeliver tick will —
            # unless it gets confirmed later in the replay
            self._unconfirmed[did] = _Delivery(destination, msg, now, 0)
        else:
            self._unconfirmed[did] = _Delivery(destination, msg, now, 1)
            destination.tell(msg, self.self_ref)

    def confirm_delivery(self, delivery_id: int) -> bool:
        return self._unconfirmed.pop(delivery_id, None) is not None

    @property
    def number_of_unconfirmed(self) -> int:
        return len(self._unconfirmed)

    def get_delivery_snapshot(self) -> AtLeastOnceDeliverySnapshot:
        return AtLeastOnceDeliverySnapshot(
            self._delivery_sequence_nr,
            tuple(UnconfirmedDelivery(did, d.destination, d.message)
                  for did, d in sorted(self._unconfirmed.items())))

    def set_delivery_snapshot(self, snap: AtLeastOnceDeliverySnapshot) -> None:
        self._delivery_sequence_nr = snap.current_delivery_id
        now = time.time()
        self._unconfirmed = {
            u.delivery_id: _Delivery(u.destination, u.message, now, 0)
            for u in snap.unconfirmed_deliveries}

    # -- redelivery -----------------------------------------------------------
    def around_receive(self, receive: Callable[[Any], Any], msg: Any) -> None:
        if isinstance(msg, _RedeliveryTick):
            self._redeliver_overdue()
            return
        super().around_receive(receive, msg)

    def _redeliver_overdue(self) -> None:
        if self.recovery_running:
            return
        now = time.time()
        deadline = now - self.redeliver_interval
        warnings: List[UnconfirmedDelivery] = []
        sent = 0
        for did, d in sorted(self._unconfirmed.items()):
            if sent >= self.redelivery_burst_limit:
                break
            if d.timestamp <= deadline or d.attempt == 0:
                d.timestamp = now
                d.attempt += 1
                d.destination.tell(d.message, self.self_ref)
                sent += 1
                if d.attempt == self.warn_after_number_of_unconfirmed_attempts:
                    warnings.append(UnconfirmedDelivery(did, d.destination,
                                                        d.message))
        if warnings:
            self.self_ref.tell(UnconfirmedWarning(tuple(warnings)),
                               self.self_ref)


class MaxUnconfirmedMessagesExceededException(RuntimeError):
    pass
