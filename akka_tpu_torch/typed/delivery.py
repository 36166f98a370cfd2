"""Reliable delivery: sequenced producer/consumer controllers with resend,
flow control, work pulling, and an optional durable queue.

A copy of `akka_tpu/typed/delivery.py` at commit 1001e26 (host code, no jax;
the port keeps its own copy of every module it needs).

Reference parity: akka-actor-typed/src/main/scala/akka/actor/typed/delivery/
— ProducerController.scala / ConsumerController.scala (demand: Request
(confirmedSeqNr, requestUpToSeqNr), SequencedMessage(producerId, seqNr,
first, ack), gap detection + Resend(fromSeqNr), Ack on confirm),
WorkPullingProducerController.scala (workers discovered via a Receptionist
ServiceKey, each with its own demand), DurableProducerQueue.scala +
EventSourcedProducerQueue (unconfirmed messages replayed after producer
restart), impl in delivery/internal/ProducerControllerImpl.scala:334.

Implemented as classic actors (our typed behaviors run on the same cells;
refs interoperate) with the reference's message protocol.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..actor.actor import Actor
from ..actor.messages import Terminated
from ..actor.props import Props
from ..actor.ref import ActorRef


# -- producer-facing API (reference: ProducerController object) --------------

@dataclass(frozen=True)
class Start:
    """Producer (or consumer) registers itself."""
    ref: ActorRef


@dataclass(frozen=True)
class RequestNext:
    """Demand: send ONE message to `send_next_to` (reference:
    ProducerController.RequestNext)."""
    producer_id: str
    current_seq_nr: int
    send_next_to: ActorRef


@dataclass(frozen=True)
class MessageWithConfirmation:
    """Send + ask for an ack when the consumer confirms."""
    message: Any
    reply_to: ActorRef


@dataclass(frozen=True)
class RegisterConsumer:
    consumer_controller: ActorRef


# -- consumer-facing API (reference: ConsumerController object) --------------

@dataclass(frozen=True)
class Delivery:
    producer_id: str
    seq_nr: int
    message: Any
    confirm_to: ActorRef


@dataclass(frozen=True)
class Confirmed:
    pass


@dataclass(frozen=True)
class RegisterToProducerController:
    producer_controller: ActorRef


# -- wire protocol (reference: ConsumerController.SequencedMessage etc.) -----

@dataclass(frozen=True)
class SequencedMessage:
    producer_id: str
    seq_nr: int
    message: Any
    first: bool
    ack: bool
    producer_controller: ActorRef


@dataclass(frozen=True)
class Request:
    confirmed_seq_nr: int
    request_up_to_seq_nr: int
    support_resend: bool = True


@dataclass(frozen=True)
class Resend:
    from_seq_nr: int


@dataclass(frozen=True)
class Ack:
    confirmed_seq_nr: int


# -- durable queue protocol (reference: DurableProducerQueue.scala) ----------

@dataclass(frozen=True)
class StoreMessageSent:
    seq_nr: int
    message: Any
    reply_to: ActorRef


@dataclass(frozen=True)
class StoreMessageSentAck:
    stored_seq_nr: int


@dataclass(frozen=True)
class StoreMessageConfirmed:
    seq_nr: int


@dataclass(frozen=True)
class LoadState:
    reply_to: ActorRef


@dataclass(frozen=True)
class DurableState:
    current_seq_nr: int       # next unallocated seq nr
    highest_confirmed_seq_nr: int
    unconfirmed: Tuple[Tuple[int, Any], ...]


def _make_durable_queue_props(persistence_id: str) -> Props:
    """Durable queue backed by the persistence journal (reference:
    EventSourcedProducerQueue.scala). Events: ("sent", seq, msg) and
    ("confirmed", seq)."""
    from ..persistence.eventsourced import PersistentActor
    from ..persistence.messages import RecoveryCompleted, SnapshotOffer

    class _ESQueue(PersistentActor):
        def __init__(self):
            super().__init__()
            self.seq_nr = 1
            self.confirmed = 0
            self.unconfirmed: Dict[int, Any] = {}

        @property
        def persistence_id(self) -> str:
            return f"durable-queue|{persistence_id}"

        def receive_recover(self, message):
            if isinstance(message, SnapshotOffer):
                self.seq_nr, self.confirmed, unconf = message.snapshot
                self.unconfirmed = dict(unconf)
            elif isinstance(message, tuple):
                self._apply(message)
            elif isinstance(message, RecoveryCompleted):
                pass
            else:
                return NotImplemented

        def _apply(self, ev):
            if ev[0] == "sent":
                self.unconfirmed[ev[1]] = ev[2]
                self.seq_nr = max(self.seq_nr, ev[1] + 1)
            else:  # confirmed
                self.confirmed = max(self.confirmed, ev[1])
                for s in [s for s in self.unconfirmed if s <= ev[1]]:
                    del self.unconfirmed[s]

        def receive_command(self, message):
            if isinstance(message, StoreMessageSent):
                def done(ev):
                    self._apply(ev)
                    message.reply_to.tell(StoreMessageSentAck(ev[1]),
                                          self.self_ref)
                self.persist(("sent", message.seq_nr, message.message), done)
            elif isinstance(message, StoreMessageConfirmed):
                self.persist(("confirmed", message.seq_nr), self._apply)
            elif isinstance(message, LoadState):
                message.reply_to.tell(DurableState(
                    self.seq_nr, self.confirmed,
                    tuple(sorted(self.unconfirmed.items()))), self.self_ref)
            else:
                return NotImplemented
    return Props.create(_ESQueue)


class ProducerController(Actor):
    """(reference: ProducerControllerImpl.scala) One per producer; connects
    to exactly one ConsumerController."""

    def __init__(self, producer_id: str,
                 durable_queue_props: Optional[Props] = None):
        super().__init__()
        self.producer_id = producer_id
        self.producer: Optional[ActorRef] = None
        self.consumer_controller: Optional[ActorRef] = None
        self.current_seq = 1           # next seq nr to assign
        self.confirmed_seq = 0
        self.requested_up_to = 0
        self.unconfirmed: Dict[int, Any] = {}
        self.first_sent = False
        self.pending_replies: Dict[int, ActorRef] = {}  # seq -> ask reply_to
        self.durable: Optional[ActorRef] = None
        self._durable_props = durable_queue_props
        self._demand_outstanding = False
        self._replay: List[Tuple[int, Any]] = []

    def pre_start(self) -> None:
        if self._durable_props is not None:
            self.durable = self.context.actor_of(self._durable_props,
                                                 "durable")
            self.durable.tell(LoadState(self.self_ref), self.self_ref)

    # -- helpers -------------------------------------------------------------
    def _maybe_request_next(self) -> None:
        if (self.producer is not None and not self._demand_outstanding
                and self.consumer_controller is not None
                and self.current_seq <= self.requested_up_to):
            self._demand_outstanding = True
            self.producer.tell(RequestNext(self.producer_id,
                                           self.current_seq, self.self_ref),
                               self.self_ref)

    def _send(self, seq: int, msg: Any) -> None:
        # `first` marks the first message of the SESSION with this consumer
        # controller (reset on RegisterConsumer) so a fresh consumer can
        # adopt the sequence base instead of demanding a resend from 1
        self.consumer_controller.tell(
            SequencedMessage(self.producer_id, seq, msg,
                             first=not self.first_sent,
                             ack=seq in self.pending_replies,
                             producer_controller=self.self_ref),
            self.self_ref)
        self.first_sent = True

    def _on_new_message(self, msg: Any, reply_to: Optional[ActorRef]) -> None:
        seq = self.current_seq
        self.current_seq += 1
        self._demand_outstanding = False
        if reply_to is not None:
            self.pending_replies[seq] = reply_to
        if self.durable is not None:
            self.durable.tell(StoreMessageSent(seq, msg, self.self_ref),
                              self.self_ref)
            # optimistic send; redelivery covers a crash before the ack
        self.unconfirmed[seq] = msg
        if self.consumer_controller is not None:
            self._send(seq, msg)
        self._maybe_request_next()

    # -- receive -------------------------------------------------------------
    def receive(self, message: Any) -> Any:  # noqa: C901
        if isinstance(message, Start):
            self.producer = message.ref
            self._maybe_request_next()
        elif isinstance(message, RegisterConsumer):
            self.consumer_controller = message.consumer_controller
            self.first_sent = False  # new session: next send carries first=True
            # resend everything outstanding to the (new) consumer controller
            for seq in sorted(self.unconfirmed):
                self._send(seq, self.unconfirmed[seq])
        elif isinstance(message, MessageWithConfirmation):
            self._on_new_message(message.message, message.reply_to)
        elif isinstance(message, Request):
            self.requested_up_to = max(self.requested_up_to,
                                       message.request_up_to_seq_nr)
            self._confirm_through(message.confirmed_seq_nr)
            self._maybe_request_next()
        elif isinstance(message, Resend):
            for seq in sorted(self.unconfirmed):
                if seq >= message.from_seq_nr:
                    self._send(seq, self.unconfirmed[seq])
        elif isinstance(message, Ack):
            self._confirm_through(message.confirmed_seq_nr)
        elif isinstance(message, DurableState):
            self.current_seq = max(self.current_seq, message.current_seq_nr)
            self.confirmed_seq = max(self.confirmed_seq,
                                     message.highest_confirmed_seq_nr)
            for seq, msg in message.unconfirmed:
                self.unconfirmed.setdefault(seq, msg)
                if self.consumer_controller is not None:
                    self._send(seq, msg)
            self._maybe_request_next()
        elif isinstance(message, StoreMessageSentAck):
            pass
        else:
            # a plain message from the producer answering RequestNext
            self._on_new_message(message, None)

    def _confirm_through(self, seq: int) -> None:
        if seq <= self.confirmed_seq:
            return
        self.confirmed_seq = seq
        for s in [s for s in self.unconfirmed if s <= seq]:
            del self.unconfirmed[s]
        for s in [s for s in self.pending_replies if s <= seq]:
            self.pending_replies.pop(s).tell(s, self.self_ref)
        if self.durable is not None:
            self.durable.tell(StoreMessageConfirmed(seq), self.self_ref)


class ConsumerController(Actor):
    """(reference: ConsumerControllerImpl.scala) Delivers in order, detects
    gaps, confirms, and keeps `flow_control_window` demand open."""

    def __init__(self, flow_control_window: int = 20,
                 resend_interval: float = 1.0):
        super().__init__()
        self.window = flow_control_window
        self.resend_interval = resend_interval
        self.consumer: Optional[ActorRef] = None
        self.producer_controller: Optional[ActorRef] = None
        self.producer_id = ""
        self.received_seq = 0         # highest in-order received
        self.confirmed_seq = 0
        self.requested_up_to = 0
        self.delivering = False       # waiting for Confirmed from consumer
        self.stash: List[SequencedMessage] = []
        self._task = None

    def pre_start(self) -> None:
        self._task = self.context.system.scheduler.schedule_tell_with_fixed_delay(
            self.resend_interval, self.resend_interval, self.self_ref,
            _RetryTick())

    def post_stop(self) -> None:
        if self._task:
            self._task.cancel()

    def _request_more(self) -> None:
        if self.producer_controller is None:
            return
        new_up_to = self.confirmed_seq + self.window
        if new_up_to > self.requested_up_to:
            self.requested_up_to = new_up_to
            self.producer_controller.tell(
                Request(self.confirmed_seq, new_up_to), self.self_ref)

    def _deliver_next(self) -> None:
        if self.delivering or self.consumer is None:
            return
        while self.stash and self.stash[0].seq_nr <= self.received_seq:
            self.stash.pop(0)  # duplicates
        if self.stash and self.stash[0].seq_nr == self.received_seq + 1:
            sm = self.stash.pop(0)
            self.received_seq = sm.seq_nr
            self.delivering = True
            self.consumer.tell(Delivery(sm.producer_id, sm.seq_nr, sm.message,
                                        self.self_ref), self.self_ref)

    def receive(self, message: Any) -> Any:  # noqa: C901
        if isinstance(message, Start):
            self.consumer = message.ref
            self._deliver_next()
        elif isinstance(message, RegisterToProducerController):
            self.producer_controller = message.producer_controller
            message.producer_controller.tell(RegisterConsumer(self.self_ref),
                                             self.self_ref)
            self._request_more()
        elif isinstance(message, SequencedMessage):
            if self.producer_controller is None:
                self.producer_controller = message.producer_controller
                self._request_more()
            self.producer_id = message.producer_id
            if message.first and message.seq_nr > self.received_seq + 1:
                # adopt the producer's base: a session's first message may
                # start past 1 (restart with confirmed history) — reference
                # ConsumerControllerImpl sets receivedSeqNr = seqNr - 1
                self.received_seq = message.seq_nr - 1
            if message.seq_nr <= self.received_seq:
                pass  # duplicate
            elif message.seq_nr == self.received_seq + 1:
                self.stash.append(message)
                self.stash.sort(key=lambda m: m.seq_nr)
                self._deliver_next()
            else:
                # gap: buffer out-of-order, ask for resend
                self.stash.append(message)
                self.stash.sort(key=lambda m: m.seq_nr)
                message.producer_controller.tell(
                    Resend(self.received_seq + 1), self.self_ref)
        elif isinstance(message, Confirmed):
            self.confirmed_seq = self.received_seq
            self.delivering = False
            if self.producer_controller is not None:
                self.producer_controller.tell(Ack(self.confirmed_seq),
                                              self.self_ref)
            self._request_more()
            self._deliver_next()
        elif isinstance(message, _RetryTick):
            if self.producer_controller is not None and \
                    self.stash and not self.delivering and \
                    self.stash[0].seq_nr > self.received_seq + 1:
                self.producer_controller.tell(Resend(self.received_seq + 1),
                                              self.self_ref)
        else:
            return NotImplemented


@dataclass(frozen=True)
class _RetryTick:
    pass


# -- work pulling ------------------------------------------------------------

@dataclass(frozen=True)
class WorkPullingRequestNext:
    """Demand from the pool: send ONE job to `send_next_to`."""
    send_next_to: ActorRef


class WorkPullingProducerController(Actor):
    """Distributes messages to whichever registered worker has demand
    (reference: WorkPullingProducerController.scala — workers register via
    a Receptionist ServiceKey; each worker pair gets its own session)."""

    def __init__(self, producer_id: str, worker_service_key):
        super().__init__()
        from .receptionist import Receptionist
        self.producer_id = producer_id
        self.key = worker_service_key
        self.producer: Optional[ActorRef] = None
        # worker consumer-controller ref -> session state
        self.sessions: Dict[ActorRef, Dict[str, Any]] = {}
        self.queue: List[Any] = []   # unsent jobs
        self.seq = 1
        self._demand_outstanding = False
        Receptionist.get(self.context.system).subscribe(self.key,
                                                        self.self_ref)

    def _maybe_request_next(self) -> None:
        if self.producer is None or self._demand_outstanding:
            return
        if any(s["demand"] > 0 for s in self.sessions.values()) or \
                len(self.queue) < 100:
            self._demand_outstanding = True
            self.producer.tell(WorkPullingRequestNext(self.self_ref),
                               self.self_ref)

    @staticmethod
    def _new_session() -> Dict[str, Any]:
        return {"demand": 0, "next_seq": 1, "confirmed": 0,
                "unconfirmed": {}, "active": True, "bootstrapped": False}

    def _dispatch(self) -> None:
        while self.queue:
            target = None
            for cc, s in self.sessions.items():
                if s["active"] and s["demand"] > 0:
                    target = cc
                    break
            if target is None:
                # no open demand: bootstrap a session with ONE first=True
                # message — the consumer controller learns the producer from
                # it and answers with Request (reference: first=true send)
                for cc, s in self.sessions.items():
                    if s["active"] and not s["bootstrapped"] \
                            and not s["unconfirmed"]:
                        target = cc
                        s["demand"] = 1
                        s["bootstrapped"] = True
                        break
            if target is None:
                return
            job = self.queue.pop(0)
            s = self.sessions[target]
            seq = s["next_seq"]
            s["next_seq"] += 1
            s["demand"] -= 1
            s["unconfirmed"][seq] = job
            target.tell(SequencedMessage(self.producer_id, seq, job,
                                         first=(seq == 1), ack=False,
                                         producer_controller=self.self_ref),
                        self.self_ref)

    def receive(self, message: Any) -> Any:  # noqa: C901
        from .receptionist import Listing
        if isinstance(message, Start):
            self.producer = message.ref
            self._maybe_request_next()
        elif isinstance(message, Listing):
            current = set(message.service_instances)
            for cc in list(self.sessions):
                if cc not in current and self.sessions[cc]["active"]:
                    # worker gone: requeue its unconfirmed jobs in order.
                    # Keep the session (with its seq counter) — a transient
                    # listing flap must NOT reset next_seq to 1, or the
                    # worker's consumer controller would discard the
                    # redelivered jobs as duplicates
                    s = self.sessions[cc]
                    s["active"] = False
                    jobs = [s["unconfirmed"][seq]
                            for seq in sorted(s["unconfirmed"])]
                    s["unconfirmed"].clear()
                    s["demand"] = 0
                    self.queue[:0] = jobs
            for cc in current:
                if cc not in self.sessions:
                    self.sessions[cc] = self._new_session()
                else:
                    self.sessions[cc]["active"] = True
            self._dispatch()
            self._maybe_request_next()
        elif isinstance(message, Request):
            s = self.sessions.get(self.sender)
            if s is not None:
                s["demand"] = max(
                    s["demand"],
                    message.request_up_to_seq_nr - s["next_seq"] + 1)
                self._confirm(self.sender, message.confirmed_seq_nr)
            self._dispatch()
            self._maybe_request_next()
        elif isinstance(message, Ack):
            self._confirm(self.sender, message.confirmed_seq_nr)
        elif isinstance(message, Resend):
            s = self.sessions.get(self.sender)
            if s is not None:
                for seq in sorted(s["unconfirmed"]):
                    if seq >= message.from_seq_nr:
                        self.sender.tell(
                            SequencedMessage(self.producer_id, seq,
                                             s["unconfirmed"][seq],
                                             first=(seq == 1), ack=False,
                                             producer_controller=self.self_ref),
                            self.self_ref)
        elif isinstance(message, RegisterConsumer):
            if message.consumer_controller not in self.sessions:
                self.sessions[message.consumer_controller] = \
                    self._new_session()
        else:
            # job from the producer answering WorkPullingRequestNext
            self._demand_outstanding = False
            self.queue.append(message)
            self._dispatch()
            self._maybe_request_next()

    def _confirm(self, cc: ActorRef, seq: int) -> None:
        s = self.sessions.get(cc)
        if s is None:
            return
        s["confirmed"] = max(s["confirmed"], seq)
        for k in [k for k in s["unconfirmed"] if k <= seq]:
            del s["unconfirmed"][k]


def producer_controller_props(producer_id: str,
                              durable_queue_name: Optional[str] = None
                              ) -> Props:
    dq = _make_durable_queue_props(durable_queue_name) \
        if durable_queue_name else None
    return Props.create(ProducerController, producer_id, dq)


def consumer_controller_props(flow_control_window: int = 20,
                              resend_interval: float = 1.0) -> Props:
    return Props.create(ConsumerController, flow_control_window,
                        resend_interval)


def work_pulling_producer_props(producer_id: str, worker_service_key) -> Props:
    return Props.create(WorkPullingProducerController, producer_id,
                        worker_service_key)
