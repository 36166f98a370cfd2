"""PersistentActor: event sourcing with persist/persistAsync + recovery.

A copy of `akka_tpu/persistence/eventsourced.py` at commit 1001e26 (host
code, no jax; the port keeps its own copy of every module it needs).

Reference parity: akka-persistence/src/main/scala/akka/persistence/
Eventsourced.scala — persist appends to a batch and registers a stashing
handler invocation (:399), the batch is flushed to the journal AFTER the
current receive returns (:354-362), commands arriving while a `persist` is
in flight go to an internal stash (:218-233, single-writer per
persistenceId), recovery = permit → snapshot load → event replay →
RecoveryCompleted (RecoveryPermitter.scala, journal/AsyncRecovery.scala),
persistAsync skips the stashing, deferAsync sequences a handler after
in-flight persists. Journal write failure stops the actor; rejection keeps
it running (onPersistFailure/onPersistRejected semantics).
"""

from __future__ import annotations

import time
import uuid
from typing import Any, Callable, List, Optional, Sequence

from ..actor.actor import Actor
from ..dispatch.mailbox import DequeBasedMessageQueue, Envelope
from .messages import (AtomicWrite, DeleteMessagesFailure,
                       DeleteMessagesSuccess, DeleteMessagesTo, LoadSnapshot,
                       LoadSnapshotFailed, LoadSnapshotResult, PersistentRepr,
                       Recovery, RecoveryCompleted, RecoverySuccess,
                       ReplayedMessage, ReplayMessages, ReplayMessagesFailure,
                       SaveSnapshot, SaveSnapshotFailure, SaveSnapshotSuccess,
                       SnapshotMetadata, SnapshotOffer, WriteMessageFailure,
                       WriteMessageRejected, WriteMessages,
                       WriteMessagesFailed, WriteMessagesSuccessful,
                       WriteMessageSuccess, DeleteSnapshot, DeleteSnapshots,
                       DeleteSnapshotSuccess, DeleteSnapshotsSuccess,
                       DeleteSnapshotFailure, DeleteSnapshotsFailure,
                       SnapshotSelectionCriteria)
from .persistence import (Persistence, RecoveryPermitGranted,
                          RequestRecoveryPermit, ReturnRecoveryPermit)


class _Invocation:
    """One queued handler: a persist/persistAsync awaiting its write
    confirmation, or a deferAsync awaiting all prior persists. Carries the
    envelope of the command that initiated it so `self.sender` inside the
    handler is the ORIGINAL sender, not the journal (reference: Eventsourced
    keeps the current envelope across the journal round trip)."""

    __slots__ = ("handler", "stashing", "kind", "event", "envelope")

    def __init__(self, handler: Callable[[Any], None], stashing: bool,
                 kind: str = "persist", event: Any = None, envelope=None):
        self.handler = handler
        self.stashing = stashing
        self.kind = kind
        self.event = event
        self.envelope = envelope


class PersistentActor(Actor):
    """Subclass; implement persistence_id, receive_command, receive_recover.

    States (reference Eventsourced: waitingRecoveryPermit →
    recoveryStarted → recovering → processingCommands ⇄ persistingEvents).
    """

    mailbox_requirement = DequeBasedMessageQueue

    journal_plugin_id = ""          # "" -> akka.persistence.journal.plugin
    snapshot_plugin_id = ""

    def __init__(self) -> None:
        super().__init__()
        self._extension = Persistence.get(self.context.system)
        self._journal = self._extension.journal_for(self.journal_plugin_id)
        self._snapshot_store = self._extension.snapshot_store_for(
            self.snapshot_plugin_id)
        self._instance_id = self._extension.next_instance_id()
        self._writer_uuid = uuid.uuid4().hex
        self._last_sequence_nr = 0
        self._snapshot_sequence_nr = 0
        self._state = "waiting-permit"
        self._event_batch: List[AtomicWrite] = []   # built during one receive
        self._journal_batch: List[AtomicWrite] = []
        self._pending: List[_Invocation] = []       # in-flight handler queue
        self._pending_stash_count = 0               # stashing invocations only
        self._internal_stash: List[Envelope] = []
        self._recovery_highest = 0

    # -- user API -------------------------------------------------------------
    @property
    def persistence_id(self) -> str:
        raise NotImplementedError

    def receive_command(self, message: Any) -> Any:
        raise NotImplementedError

    def receive_recover(self, message: Any) -> Any:
        raise NotImplementedError

    @property
    def last_sequence_nr(self) -> int:
        return self._last_sequence_nr

    @property
    def snapshot_sequence_nr(self) -> int:
        return self._snapshot_sequence_nr

    @property
    def recovery_running(self) -> bool:
        return self._state in ("waiting-permit", "recovering-snapshot",
                               "recovering-events")

    def recovery(self) -> Recovery:
        """Override to customize (reference: PersistentActor.recovery)."""
        return Recovery()

    def persist(self, event: Any, handler: Callable[[Any], None]) -> None:
        """Store `event`; run `handler(event)` after the write is confirmed.
        Commands arriving in between are stashed (reference :399)."""
        self._pending.append(_Invocation(handler, stashing=True,
                                         envelope=self.context.current_message))
        self._pending_stash_count += 1
        self._event_batch.append(self._atomic([event]))

    def persist_all(self, events: Sequence[Any],
                    handler: Callable[[Any], None]) -> None:
        if not events:
            return
        for _ in events:
            self._pending.append(_Invocation(
                handler, stashing=True,
                envelope=self.context.current_message))
            self._pending_stash_count += 1
        self._event_batch.append(self._atomic(list(events)))

    def persist_async(self, event: Any, handler: Callable[[Any], None]) -> None:
        """Like persist but does NOT stash commands (reference :437)."""
        self._pending.append(_Invocation(handler, stashing=False,
                                         envelope=self.context.current_message))
        self._event_batch.append(self._atomic([event]))

    def defer_async(self, event: Any, handler: Callable[[Any], None]) -> None:
        """Run handler after all in-flight persists complete; nothing stored."""
        if not any(i.kind == "persist" for i in self._pending) \
                and not self._event_batch:
            handler(event)
        else:
            self._pending.append(_Invocation(
                handler, stashing=False, kind="defer", event=event,
                envelope=self.context.current_message))

    def delete_messages(self, to_sequence_nr: int) -> None:
        self._journal.tell(DeleteMessagesTo(self.persistence_id,
                                            to_sequence_nr, self.self_ref),
                           self.self_ref)

    def save_snapshot(self, snapshot: Any) -> None:
        md = SnapshotMetadata(self.persistence_id, self._last_sequence_nr,
                              time.time())
        self._snapshot_store.tell(SaveSnapshot(md, snapshot), self.self_ref)

    def delete_snapshot(self, sequence_nr: int) -> None:
        self._snapshot_store.tell(DeleteSnapshot(
            SnapshotMetadata(self.persistence_id, sequence_nr)), self.self_ref)

    def delete_snapshots(self, criteria: SnapshotSelectionCriteria) -> None:
        self._snapshot_store.tell(DeleteSnapshots(self.persistence_id,
                                                  criteria), self.self_ref)

    # -- failure hooks (reference: onPersistFailure/onPersistRejected/
    #    onRecoveryFailure — default logs; failure also stops the actor) -----
    def on_persist_failure(self, cause: str, event: Any, seq_nr: int) -> None:
        self.context.system.log.error(
            f"persist failure for {self.persistence_id} seq {seq_nr}: {cause}")

    def on_persist_rejected(self, cause: str, event: Any, seq_nr: int) -> None:
        self.context.system.log.error(
            f"persist rejected for {self.persistence_id} seq {seq_nr}: {cause}")

    def on_recovery_failure(self, cause: str, event: Optional[Any]) -> None:
        self.context.system.log.error(
            f"recovery failure for {self.persistence_id}: {cause}")

    # -- lifecycle ------------------------------------------------------------
    def pre_start(self) -> None:
        self._extension.recovery_permitter.tell(RequestRecoveryPermit(),
                                                self.self_ref)

    def post_stop(self) -> None:
        if self.recovery_running:
            self._extension.recovery_permitter.tell(ReturnRecoveryPermit(),
                                                    self.self_ref)

    # -- dispatch -------------------------------------------------------------
    def around_receive(self, receive: Callable[[Any], Any], msg: Any) -> None:
        if self._state == "waiting-permit":
            self._waiting_permit(msg)
        elif self._state == "recovering-snapshot":
            self._recovering_snapshot(msg)
        elif self._state == "recovering-events":
            self._recovering_events(msg)
        else:
            self._processing(msg)

    def receive(self, message: Any) -> Any:  # unused; around_receive routes
        return NotImplemented

    # -- state: waiting for recovery permit -----------------------------------
    def _waiting_permit(self, msg: Any) -> None:
        if isinstance(msg, RecoveryPermitGranted):
            rec = self.recovery()
            if rec.to_sequence_nr == 0 and rec.replay_max == 0 and \
                    rec.from_snapshot == SnapshotSelectionCriteria.none():
                # Recovery.none
                self._recovery_highest = 0
                self._finish_recovery()
                return
            self._state = "recovering-snapshot"
            self._snapshot_store.tell(
                LoadSnapshot(self.persistence_id, rec.from_snapshot,
                             rec.to_sequence_nr), self.self_ref)
        else:
            self._internal_stash.append(self._current_envelope())

    # -- state: loading snapshot ----------------------------------------------
    def _recovering_snapshot(self, msg: Any) -> None:
        rec = self.recovery()
        if isinstance(msg, LoadSnapshotResult):
            if msg.snapshot is not None:
                md = msg.snapshot.metadata
                self._last_sequence_nr = md.sequence_nr
                self._snapshot_sequence_nr = md.sequence_nr
                self._call_recover(SnapshotOffer(md, msg.snapshot.snapshot))
            self._state = "recovering-events"
            self._journal.tell(
                ReplayMessages(self._last_sequence_nr + 1, rec.to_sequence_nr,
                               rec.replay_max, self.persistence_id,
                               self.self_ref), self.self_ref)
        elif isinstance(msg, LoadSnapshotFailed):
            self.on_recovery_failure(msg.cause, None)
            self.context.stop(self.self_ref)
        else:
            self._internal_stash.append(self._current_envelope())

    # -- state: replaying events ----------------------------------------------
    def _recovering_events(self, msg: Any) -> None:
        if isinstance(msg, ReplayedMessage):
            r = msg.persistent
            self._last_sequence_nr = r.sequence_nr
            try:
                self._call_recover(r.payload)
            except Exception as e:  # noqa: BLE001
                self.on_recovery_failure(str(e), r.payload)
                raise
        elif isinstance(msg, RecoverySuccess):
            self._recovery_highest = msg.highest_sequence_nr
            self._last_sequence_nr = max(self._last_sequence_nr,
                                         msg.highest_sequence_nr)
            self._finish_recovery()
        elif isinstance(msg, ReplayMessagesFailure):
            self.on_recovery_failure(msg.cause, None)
            self.context.stop(self.self_ref)
        else:
            self._internal_stash.append(self._current_envelope())

    def _finish_recovery(self) -> None:
        self._state = "processing"
        self._extension.recovery_permitter.tell(ReturnRecoveryPermit(),
                                                self.self_ref)
        self._call_recover(RecoveryCompleted())
        self._flush_batch()  # RecoveryCompleted handler may have persisted
        self._unstash_internal()

    def _call_recover(self, msg: Any) -> None:
        handled = self.receive_recover(msg)
        if handled is NotImplemented and not isinstance(msg, RecoveryCompleted):
            self.unhandled(msg)

    # -- state: processing commands / persisting ------------------------------
    def _processing(self, msg: Any) -> None:
        if isinstance(msg, WriteMessageSuccess):
            if msg.actor_instance_id != self._instance_id:
                return
            self._last_sequence_nr = max(self._last_sequence_nr,
                                         msg.persistent.sequence_nr)
            self._pop_invocation(msg.persistent.payload)
        elif isinstance(msg, WriteMessageRejected):
            if msg.actor_instance_id != self._instance_id:
                return
            self.on_persist_rejected(msg.cause, msg.persistent.payload,
                                     msg.persistent.sequence_nr)
            self._pop_invocation(msg.persistent.payload, run_handler=False)
        elif isinstance(msg, WriteMessageFailure):
            if msg.actor_instance_id != self._instance_id:
                return
            self.on_persist_failure(msg.cause, msg.persistent.payload,
                                    msg.persistent.sequence_nr)
            self.context.stop(self.self_ref)
        elif isinstance(msg, (WriteMessagesSuccessful, WriteMessagesFailed)):
            pass  # per-message replies drive the state machine
        elif isinstance(msg, (SaveSnapshotSuccess, SaveSnapshotFailure,
                              DeleteMessagesSuccess, DeleteMessagesFailure,
                              DeleteSnapshotSuccess, DeleteSnapshotsSuccess,
                              DeleteSnapshotFailure, DeleteSnapshotsFailure)):
            if isinstance(msg, SaveSnapshotSuccess):
                self._snapshot_sequence_nr = msg.metadata.sequence_nr
            self._forward_to_command(msg)
        elif self._pending_stash_count > 0:
            # a stashing persist is in flight: defer user commands
            self._internal_stash.append(self._current_envelope())
        else:
            self._forward_to_command(msg)
            self._flush_batch()

    def _forward_to_command(self, msg: Any) -> None:
        handled = self.receive_command(msg)
        if handled is NotImplemented:
            self.unhandled(msg)

    def _flush_batch(self) -> None:
        """Send events persisted during this receive to the journal
        (reference: flushBatch / sendBatchedEventsToJournal :354-362)."""
        if not self._event_batch:
            return
        writes, self._event_batch = self._event_batch, []
        self._journal.tell(
            WriteMessages(tuple(writes), self.self_ref, self._instance_id),
            self.self_ref)

    def _atomic(self, events: List[Any]) -> AtomicWrite:
        reprs = []
        for ev in events:
            seq = self._alloc_seq_nr()
            reprs.append(PersistentRepr(ev, seq, self.persistence_id,
                                        writer_uuid=self._writer_uuid))
        return AtomicWrite(tuple(reprs))

    def _alloc_seq_nr(self) -> int:
        nxt = max(self._last_sequence_nr,
                  getattr(self, "_allocated_seq", 0)) + 1
        self._allocated_seq = nxt
        return nxt

    def _pop_invocation(self, payload: Any, run_handler: bool = True) -> None:
        if not self._pending:
            return
        inv = self._pending.pop(0)  # the persist this confirmation is for
        if inv.stashing:
            self._pending_stash_count -= 1
        if run_handler:
            self._run_with_envelope(inv, lambda: inv.handler(payload))
        # defers queued right after it only waited on that persist
        while self._pending and self._pending[0].kind == "defer":
            d = self._pending.pop(0)
            self._run_with_envelope(d, lambda: d.handler(d.event))
        self._flush_batch()  # handlers may have called persist again
        if self._pending_stash_count == 0:
            self._unstash_internal()

    def _run_with_envelope(self, inv: _Invocation, fn: Callable[[], None]
                           ) -> None:
        """Run a handler with self.sender restored to the initiating
        command's sender (the cell's current message is the journal reply)."""
        cell = self.context
        saved_env, saved_sender = cell.current_message, cell.sender
        if inv.envelope is not None:
            cell.current_message = inv.envelope
            cell.sender = (inv.envelope.sender
                           if inv.envelope.sender is not None
                           else cell.system.dead_letters)
        try:
            fn()
        finally:
            cell.current_message, cell.sender = saved_env, saved_sender

    # -- internal stash mechanics ---------------------------------------------
    def _current_envelope(self) -> Envelope:
        env = self.context.current_message
        if env is None:
            raise RuntimeError("no current message")
        return env

    def _unstash_internal(self) -> None:
        if not self._internal_stash:
            return
        mq = self.context.mailbox.message_queue
        if not isinstance(mq, DequeBasedMessageQueue):
            raise RuntimeError("PersistentActor requires a deque mailbox")
        for env in reversed(self._internal_stash):
            mq.enqueue_first(self.context.self_ref, env)
        self._internal_stash = []
