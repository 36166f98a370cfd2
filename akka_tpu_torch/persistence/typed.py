"""Typed event sourcing: EventSourcedBehavior + Effect API.

A copy of `akka_tpu/persistence/typed.py` at commit 1001e26 (host code, no
jax; the port keeps its own copy of every module it needs).

Reference parity: akka-persistence-typed/src/main/scala/akka/persistence/
typed/internal/ — the phase chain RequestingRecoveryPermit.scala →
ReplayingSnapshot.scala → ReplayingEvents.scala → Running.scala;
EventSourcedBehaviorImpl.scala (persistenceId/emptyState/commandHandler/
eventHandler + snapshotWhen/retention/tagger); EffectImpl.scala (Persist/
PersistAll/None/Unhandled/Stop + side effects ThenRun/ThenReply/ThenStop);
RetentionCriteriaImpl.scala (snapshotEvery N keep K, optional delete-events).

Commands arriving during recovery or while a persist is being confirmed are
stashed and replayed in order (Running.scala persistingEvents stash).
"""

from __future__ import annotations

import time
import uuid
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple

from ..typed.behavior import Behavior, ExtensibleBehavior, Signal, UNHANDLED
from ..typed.behaviors import Behaviors
from .messages import (AtomicWrite, LoadSnapshot, LoadSnapshotFailed,
                       LoadSnapshotResult, PersistentRepr, RecoveryCompleted,
                       RecoverySuccess, ReplayedMessage, ReplayMessages,
                       ReplayMessagesFailure, SaveSnapshot,
                       SaveSnapshotFailure, SaveSnapshotSuccess,
                       SnapshotMetadata, SnapshotSelectionCriteria, Tagged,
                       DeleteMessagesTo, DeleteSnapshots,
                       WriteMessageFailure, WriteMessageRejected,
                       WriteMessages, WriteMessagesFailed,
                       WriteMessagesSuccessful, WriteMessageSuccess)
from .persistence import (Persistence, RecoveryPermitGranted,
                          RequestRecoveryPermit, ReturnRecoveryPermit)


@dataclass(frozen=True)
class PersistenceId:
    """(reference: typed/PersistenceId.scala — "EntityType|entityId")"""
    id: str

    @staticmethod
    def of(entity_type: str, entity_id: str, separator: str = "|"
           ) -> "PersistenceId":
        return PersistenceId(f"{entity_type}{separator}{entity_id}")

    @staticmethod
    def of_unique_id(id_: str) -> "PersistenceId":
        return PersistenceId(id_)


# -- Effect API (reference: EffectImpl.scala / Effect.scala) -----------------

class Effect:
    """Returned by the command handler."""

    __slots__ = ("events", "kind", "side_effects")

    def __init__(self, kind: str, events: Tuple[Any, ...] = (),
                 side_effects: Tuple = ()):
        self.kind = kind            # persist | none | unhandled | stop | stash
        self.events = events
        self.side_effects = side_effects

    # -- constructors --------------------------------------------------------
    @staticmethod
    def persist(*events: Any) -> "Effect":
        """Effect.persist(ev) or Effect.persist(ev1, ev2) or
        Effect.persist([ev1, ev2]). A tuple is ONE event (events are often
        tuples); only a list is treated as a collection."""
        if len(events) == 1 and isinstance(events[0], list):
            events = tuple(events[0])
        return Effect("persist", tuple(events))

    @staticmethod
    def none() -> "Effect":
        return Effect("none")

    @staticmethod
    def unhandled() -> "Effect":
        return Effect("unhandled")

    @staticmethod
    def stop() -> "Effect":
        return Effect("stop")

    @staticmethod
    def stash() -> "Effect":
        return Effect("stash")

    @staticmethod
    def reply(reply_to, message: Any) -> "Effect":
        return Effect("none").then_reply(reply_to, lambda _s: message)

    # -- chained side effects (run AFTER events are persisted) ---------------
    def then_run(self, fn: Callable[[Any], None]) -> "Effect":
        return Effect(self.kind, self.events,
                      self.side_effects + (("run", fn),))

    def then_reply(self, reply_to, message_fn: Callable[[Any], Any]) -> "Effect":
        return Effect(self.kind, self.events,
                      self.side_effects + (("reply", reply_to, message_fn),))

    def then_stop(self) -> "Effect":
        return Effect(self.kind, self.events,
                      self.side_effects + (("stop",),))

    def then_no_reply(self) -> "Effect":
        return self


@dataclass(frozen=True)
class RetentionCriteria:
    """(reference: RetentionCriteriaImpl.scala)"""
    snapshot_every: int = 0
    keep_n_snapshots: int = 2
    delete_events_on_snapshot: bool = False

    @staticmethod
    def snapshot_every_n(n: int, keep: int = 2,
                         delete_events: bool = False) -> "RetentionCriteria":
        return RetentionCriteria(n, keep, delete_events)


class EventSourcedBehavior(ExtensibleBehavior):
    """Typed ES behavior: command_handler(state, cmd) -> Effect,
    event_handler(state, event) -> state.

    Spawn like any Behavior; internally drives the journal protocol through
    the reference's phase chain.
    """

    def __init__(self, persistence_id: PersistenceId, empty_state: Any,
                 command_handler: Callable[[Any, Any], Effect],
                 event_handler: Callable[[Any, Any], Any],
                 retention: Optional[RetentionCriteria] = None,
                 snapshot_when: Optional[Callable[[Any, Any, int], bool]] = None,
                 tagger: Optional[Callable[[Any], frozenset]] = None,
                 on_signal: Optional[Callable[[Any, Signal], None]] = None,
                 recovery_completed: Optional[Callable[[Any, Any], None]] = None,
                 journal_plugin_id: str = "", snapshot_plugin_id: str = "",
                 snapshot_adapter=None, event_adapter=None):
        self.persistence_id = persistence_id
        self.empty_state = empty_state
        self.command_handler = command_handler
        self.event_handler = event_handler
        self.retention = retention or RetentionCriteria()
        self.snapshot_when = snapshot_when
        self.tagger = tagger
        self.on_signal_cb = on_signal
        self.recovery_completed = recovery_completed
        self.journal_plugin_id = journal_plugin_id
        self.snapshot_plugin_id = snapshot_plugin_id
        # state <-> stored-snapshot mapping incl. old-snapshot upcasts
        # (reference: typed/SnapshotAdapter.scala:14, wired per behavior)
        self.snapshot_adapter = snapshot_adapter
        # per-behavior domain<->journal event mapping with 1->N read
        # upcasting (reference: typed/EventAdapter.scala, applied before
        # the journal — composes with the journal-level EventAdapters
        # registry, which sees this adapter's OUTPUT)
        self.event_adapter = event_adapter
        # per-spawned-actor runtime, keyed by the actor's ref (the same
        # EventSourcedBehavior object may be spawned more than once)
        self._runtimes: dict = {}

    # ExtensibleBehavior protocol: the adapter calls receive for messages.
    # On first activation we build the runtime via Behaviors.setup.
    def receive(self, ctx, msg) -> Behavior:
        rt = self._ensure_runtime(ctx)
        return rt.on_message(ctx, msg)

    def receive_signal(self, ctx, signal: Signal) -> Behavior:
        from ..typed.behavior import PostStop, PreRestart
        if signal is PostStop or signal is PreRestart:
            # drop the runtime: a supervised restart must re-run recovery
            # from the journal, and stopped refs must not leak runtimes
            rt = self._runtimes.pop(ctx.self, None)
            if rt is not None and self.on_signal_cb is not None:
                self.on_signal_cb(rt.state, signal)
            return self
        rt = self._ensure_runtime(ctx)
        return rt.on_signal(ctx, signal)

    def _ensure_runtime(self, ctx) -> "_ESRuntime":
        rt = self._runtimes.get(ctx.self)
        if rt is None:
            rt = self._runtimes[ctx.self] = _ESRuntime(self, ctx)
        return rt


class _ESRuntime:
    """Per-actor mutable machinery (phases mirror akka-persistence-typed
    internal/: RequestingRecoveryPermit → ReplayingSnapshot →
    ReplayingEvents → Running)."""

    def __init__(self, beh: EventSourcedBehavior, ctx):
        self.b = beh
        self.ctx_ref = ctx.self
        system = ctx.system
        self.ext = Persistence.get(system)
        self.journal = self.ext.journal_for(beh.journal_plugin_id)
        self.snapshot_store = self.ext.snapshot_store_for(beh.snapshot_plugin_id)
        self.instance_id = self.ext.next_instance_id()
        self.writer_uuid = uuid.uuid4().hex
        self.state = beh.empty_state
        self.seq_nr = 0
        self.phase = "requesting-permit"
        self.stash: List[Any] = []
        self.pending_effects: List[Effect] = []  # effects awaiting write ack
        self.pending_events = 0
        self.effect_rejected = False
        self.ext.recovery_permitter.tell(RequestRecoveryPermit(), ctx.self)

    # -- message pump ---------------------------------------------------------
    def on_message(self, ctx, msg) -> Behavior:
        if self.phase == "requesting-permit":
            return self._requesting_permit(ctx, msg)
        if self.phase == "replaying-snapshot":
            return self._replaying_snapshot(ctx, msg)
        if self.phase == "replaying-events":
            return self._replaying_events(ctx, msg)
        return self._running(ctx, msg)

    def on_signal(self, ctx, signal) -> Behavior:
        if self.b.on_signal_cb is not None:
            self.b.on_signal_cb(self.state, signal)
            return self.b
        return UNHANDLED

    # -- phases ---------------------------------------------------------------
    def _requesting_permit(self, ctx, msg) -> Behavior:
        if isinstance(msg, RecoveryPermitGranted):
            self.phase = "replaying-snapshot"
            self.snapshot_store.tell(
                LoadSnapshot(self.b.persistence_id.id,
                             SnapshotSelectionCriteria.latest(), 2**63 - 1),
                ctx.self)
        else:
            self.stash.append(msg)
        return self.b

    def _replaying_snapshot(self, ctx, msg) -> Behavior:
        if isinstance(msg, LoadSnapshotResult):
            if msg.snapshot is not None:
                stored = msg.snapshot.snapshot
                self.state = stored if self.b.snapshot_adapter is None \
                    else self.b.snapshot_adapter.from_journal(stored)
                self.seq_nr = msg.snapshot.metadata.sequence_nr
            self.phase = "replaying-events"
            self.journal.tell(
                ReplayMessages(self.seq_nr + 1, 2**63 - 1, 2**63 - 1,
                               self.b.persistence_id.id, ctx.self), ctx.self)
        elif isinstance(msg, LoadSnapshotFailed):
            ctx.system.log.error(
                f"snapshot recovery failed for {self.b.persistence_id.id}: "
                f"{msg.cause}")
            return Behaviors.stopped()
        else:
            self.stash.append(msg)
        return self.b

    def _replaying_events(self, ctx, msg) -> Behavior:
        if isinstance(msg, ReplayedMessage):
            self.seq_nr = msg.persistent.sequence_nr
            payload = msg.persistent.payload
            if self.b.event_adapter is not None:
                for domain in self.b.event_adapter.from_journal(
                        payload, msg.persistent.manifest).events:
                    self.state = self.b.event_handler(self.state, domain)
            else:
                self.state = self.b.event_handler(self.state, payload)
        elif isinstance(msg, RecoverySuccess):
            self.seq_nr = max(self.seq_nr, msg.highest_sequence_nr)
            self.phase = "running"
            self.ext.recovery_permitter.tell(ReturnRecoveryPermit(), ctx.self)
            if self.b.recovery_completed is not None:
                self.b.recovery_completed(self.state, ctx)
            return self._unstash(ctx)
        elif isinstance(msg, ReplayMessagesFailure):
            ctx.system.log.error(
                f"replay failed for {self.b.persistence_id.id}: {msg.cause}")
            return Behaviors.stopped()
        else:
            self.stash.append(msg)
        return self.b

    # -- running --------------------------------------------------------------
    def _running(self, ctx, msg) -> Behavior:
        if isinstance(msg, WriteMessageSuccess):
            if msg.actor_instance_id != self.instance_id:
                return self.b
            return self._on_event_persisted(ctx, msg.persistent)
        if isinstance(msg, WriteMessageRejected):
            if msg.actor_instance_id != self.instance_id:
                return self.b
            ctx.system.log.error(
                f"persist rejected for {self.b.persistence_id.id}: {msg.cause}")
            self.pending_events -= 1
            self.effect_rejected = True  # suppress then_reply/then_run: the
            # event was NOT stored, a success-style reply would lie
            if self.pending_events == 0:
                self._finish_effect(ctx)
                return self._unstash(ctx)
            return self.b
        if isinstance(msg, WriteMessageFailure):
            if msg.actor_instance_id != self.instance_id:
                return self.b
            ctx.system.log.error(
                f"persist failed for {self.b.persistence_id.id}: {msg.cause}")
            return Behaviors.stopped()
        if isinstance(msg, (WriteMessagesSuccessful, WriteMessagesFailed,
                            SaveSnapshotSuccess, SaveSnapshotFailure)):
            return self.b
        if self.pending_events > 0:
            self.stash.append(msg)  # single-writer: wait for confirmations
            return self.b
        return self._handle_command(ctx, msg)

    def _handle_command(self, ctx, cmd) -> Behavior:
        effect = self.b.command_handler(self.state, cmd)
        if effect is None:
            effect = Effect.none()
        if effect.kind == "unhandled":
            self._apply_side_effects(ctx, effect)
            return UNHANDLED
        if effect.kind == "stash":
            self.stash.append(cmd)
            return self.b
        if effect.kind == "persist" and effect.events:
            reprs = []
            for ev in effect.events:
                self.seq_nr += 1
                payload, manifest = ev, ""
                ea = self.b.event_adapter
                if ea is not None:
                    payload = ea.to_journal(ev)
                    manifest = ea.manifest(ev)
                if self.b.tagger is not None:
                    # the tagger sees the DOMAIN event (it is part of the
                    # behavior's vocabulary, not the journal model's)
                    tags = self.b.tagger(ev)
                    if tags:
                        payload = Tagged(payload, frozenset(tags))
                reprs.append(PersistentRepr(payload, self.seq_nr,
                                            self.b.persistence_id.id,
                                            manifest=manifest,
                                            writer_uuid=self.writer_uuid))
            self.pending_events = len(reprs)
            self.pending_effects.append(effect)
            self.journal.tell(
                WriteMessages((AtomicWrite(tuple(reprs)),), ctx.self,
                              self.instance_id), ctx.self)
            return self.b
        # none / stop without events
        self._apply_side_effects(ctx, effect)
        if effect.kind == "stop" or ("stop",) in effect.side_effects:
            return Behaviors.stopped()
        return self.b

    def _on_event_persisted(self, ctx, persistent: PersistentRepr) -> Behavior:
        ev = persistent.payload
        if isinstance(ev, Tagged):
            ev = ev.payload
        # the journal echoes the JOURNAL model; the event handler's (and
        # snapshot_when's) vocabulary is the domain model — the adapter's
        # read side is authoritative for the mapping (1->N folds in order)
        events = [ev] if self.b.event_adapter is None else \
            self.b.event_adapter.from_journal(ev, persistent.manifest).events
        for domain in events:
            self.state = self.b.event_handler(self.state, domain)
        self.pending_events -= 1
        if events:
            self._maybe_snapshot(ctx, events[-1], persistent.sequence_nr)
        if self.pending_events == 0:
            stop = self._finish_effect(ctx)
            if stop:
                return Behaviors.stopped()
            return self._unstash(ctx)
        return self.b

    def _finish_effect(self, ctx) -> bool:
        if not self.pending_effects:
            return False
        effect = self.pending_effects.pop(0)
        rejected = getattr(self, "effect_rejected", False)
        self.effect_rejected = False
        if not rejected:
            self._apply_side_effects(ctx, effect)
        return (not rejected) and (
            effect.kind == "stop" or ("stop",) in effect.side_effects)

    def _apply_side_effects(self, ctx, effect: Effect) -> None:
        for se in effect.side_effects:
            if se[0] == "run":
                se[1](self.state)
            elif se[0] == "reply":
                se[1].tell(se[2](self.state), ctx.self)
            elif se[0] == "stop":
                pass  # handled by callers

    def _maybe_snapshot(self, ctx, event: Any, seq_nr: int) -> None:
        ret = self.b.retention
        should = False
        if ret.snapshot_every > 0 and seq_nr % ret.snapshot_every == 0:
            should = True
        if self.b.snapshot_when is not None and \
                self.b.snapshot_when(self.state, event, seq_nr):
            should = True
        if not should:
            return
        md = SnapshotMetadata(self.b.persistence_id.id, seq_nr, time.time())
        stored = self.state if self.b.snapshot_adapter is None \
            else self.b.snapshot_adapter.to_journal(self.state)
        self.snapshot_store.tell(SaveSnapshot(md, stored), ctx.self)
        if ret.snapshot_every > 0:
            keep_from = seq_nr - ret.snapshot_every * ret.keep_n_snapshots
            if keep_from > 0:
                self.snapshot_store.tell(
                    DeleteSnapshots(self.b.persistence_id.id,
                                    SnapshotSelectionCriteria(
                                        max_sequence_nr=keep_from)), ctx.self)
                if ret.delete_events_on_snapshot:
                    self.journal.tell(
                        DeleteMessagesTo(self.b.persistence_id.id, keep_from,
                                         ctx.self), ctx.self)

    def _unstash(self, ctx) -> Behavior:
        """Replay stashed messages. Iterates over a snapshot so a handler
        returning Effect.stash() re-stashes without looping forever, and
        propagates a stop result instead of discarding it."""
        from ..typed.behavior import is_alive
        while self.stash and self.pending_events == 0:
            msgs, self.stash = self.stash, []
            for i, msg in enumerate(msgs):
                result = self.on_message(ctx, msg)
                if not is_alive(result):
                    # requeue the rest as dead letters' would-be input: they
                    # follow the actor into termination (reference drops them)
                    return result
                if self.pending_events > 0:
                    # a persist is in flight again: keep the rest stashed,
                    # in order, ahead of anything stashed meanwhile
                    self.stash = msgs[i + 1:] + self.stash
                    return self.b
            if self.stash == msgs:
                break  # everything re-stashed itself: avoid a busy loop
        return self.b
