"""Persistence protocol messages.

A copy of `akka_tpu/persistence/messages.py` at commit 1001e26 (host code,
no jax; the port keeps its own copy of every module it needs).

Reference parity: akka-persistence/src/main/scala/akka/persistence/
JournalProtocol.scala (WriteMessages / ReplayMessages and their replies),
SnapshotProtocol.scala (LoadSnapshot / SaveSnapshot), Persistent.scala
(PersistentRepr), Persistence.scala (Recovery), Snapshot.scala
(SnapshotMetadata / SnapshotOffer / SelectedSnapshot).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, FrozenSet, List, Optional, Tuple


@dataclass(frozen=True)
class PersistentRepr:
    """One persisted event record (reference: Persistent.scala PersistentRepr)."""
    payload: Any
    sequence_nr: int
    persistence_id: str
    manifest: str = ""
    writer_uuid: str = ""
    deleted: bool = False
    timestamp: float = field(default_factory=time.time)

    def with_payload(self, payload: Any) -> "PersistentRepr":
        return PersistentRepr(payload, self.sequence_nr, self.persistence_id,
                              self.manifest, self.writer_uuid, self.deleted,
                              self.timestamp)


@dataclass(frozen=True)
class Tagged:
    """Wrap an event to attach query tags (reference: journal/Tagged.scala)."""
    payload: Any
    tags: FrozenSet[str]

    @staticmethod
    def of(payload: Any, *tags: str) -> "Tagged":
        return Tagged(payload, frozenset(tags))


# -- journal protocol (reference: JournalProtocol.scala) ---------------------

@dataclass(frozen=True)
class AtomicWrite:
    """All-or-nothing batch of events from one persistAll call."""
    payload: Tuple[PersistentRepr, ...]

    @property
    def persistence_id(self) -> str:
        return self.payload[0].persistence_id

    @property
    def lowest_sequence_nr(self) -> int:
        return self.payload[0].sequence_nr

    @property
    def highest_sequence_nr(self) -> int:
        return self.payload[-1].sequence_nr


@dataclass(frozen=True)
class WriteMessages:
    messages: Tuple[AtomicWrite, ...]
    persistent_actor: Any  # ActorRef
    actor_instance_id: int


@dataclass(frozen=True)
class WriteMessagesSuccessful:
    actor_instance_id: int


@dataclass(frozen=True)
class WriteMessagesFailed:
    cause: str
    write_count: int
    actor_instance_id: int


@dataclass(frozen=True)
class WriteMessageSuccess:
    persistent: PersistentRepr
    actor_instance_id: int


@dataclass(frozen=True)
class WriteMessageRejected:
    """Serialization-style rejection: the event was NOT stored but the actor
    keeps running (reference: JournalProtocol.WriteMessageRejected)."""
    persistent: PersistentRepr
    cause: str
    actor_instance_id: int


@dataclass(frozen=True)
class WriteMessageFailure:
    """Store failure: the actor is stopped (reference semantics)."""
    persistent: PersistentRepr
    cause: str
    actor_instance_id: int


@dataclass(frozen=True)
class ReplayMessages:
    from_sequence_nr: int
    to_sequence_nr: int
    max: int
    persistence_id: str
    persistent_actor: Any


@dataclass(frozen=True)
class ReplayedMessage:
    persistent: PersistentRepr


@dataclass(frozen=True)
class RecoverySuccess:
    highest_sequence_nr: int


@dataclass(frozen=True)
class ReplayMessagesFailure:
    cause: str


@dataclass(frozen=True)
class DeleteMessagesTo:
    persistence_id: str
    to_sequence_nr: int
    persistent_actor: Any


@dataclass(frozen=True)
class DeleteMessagesSuccess:
    to_sequence_nr: int


@dataclass(frozen=True)
class DeleteMessagesFailure:
    cause: str
    to_sequence_nr: int


# -- snapshot protocol (reference: SnapshotProtocol.scala, Snapshot.scala) ---

@dataclass(frozen=True)
class SnapshotMetadata:
    persistence_id: str
    sequence_nr: int
    timestamp: float = 0.0


@dataclass(frozen=True)
class SnapshotOffer:
    """Delivered to receive_recover before any replayed events."""
    metadata: SnapshotMetadata
    snapshot: Any


@dataclass(frozen=True)
class SelectedSnapshot:
    metadata: SnapshotMetadata
    snapshot: Any


@dataclass(frozen=True)
class SnapshotSelectionCriteria:
    max_sequence_nr: int = 2**63 - 1
    max_timestamp: float = float("inf")
    min_sequence_nr: int = 0
    min_timestamp: float = 0.0

    @staticmethod
    def latest() -> "SnapshotSelectionCriteria":
        return SnapshotSelectionCriteria()

    @staticmethod
    def none() -> "SnapshotSelectionCriteria":
        return SnapshotSelectionCriteria(max_sequence_nr=0, max_timestamp=0.0)

    def matches(self, md: SnapshotMetadata) -> bool:
        return (self.min_sequence_nr <= md.sequence_nr <= self.max_sequence_nr
                and self.min_timestamp <= md.timestamp <= self.max_timestamp)


@dataclass(frozen=True)
class LoadSnapshot:
    persistence_id: str
    criteria: SnapshotSelectionCriteria
    to_sequence_nr: int


@dataclass(frozen=True)
class LoadSnapshotResult:
    snapshot: Optional[SelectedSnapshot]
    to_sequence_nr: int


@dataclass(frozen=True)
class LoadSnapshotFailed:
    cause: str


@dataclass(frozen=True)
class SaveSnapshot:
    metadata: SnapshotMetadata
    snapshot: Any


@dataclass(frozen=True)
class SaveSnapshotSuccess:
    metadata: SnapshotMetadata


@dataclass(frozen=True)
class SaveSnapshotFailure:
    metadata: SnapshotMetadata
    cause: str


@dataclass(frozen=True)
class DeleteSnapshot:
    metadata: SnapshotMetadata


@dataclass(frozen=True)
class DeleteSnapshotSuccess:
    metadata: SnapshotMetadata


@dataclass(frozen=True)
class DeleteSnapshotFailure:
    metadata: SnapshotMetadata
    cause: str


@dataclass(frozen=True)
class DeleteSnapshots:
    persistence_id: str
    criteria: SnapshotSelectionCriteria


@dataclass(frozen=True)
class DeleteSnapshotsSuccess:
    criteria: SnapshotSelectionCriteria


@dataclass(frozen=True)
class DeleteSnapshotsFailure:
    criteria: SnapshotSelectionCriteria
    cause: str


# -- recovery config (reference: Persistence.scala Recovery) -----------------

@dataclass(frozen=True)
class Recovery:
    from_snapshot: SnapshotSelectionCriteria = SnapshotSelectionCriteria()
    to_sequence_nr: int = 2**63 - 1
    replay_max: int = 2**63 - 1

    @staticmethod
    def default() -> "Recovery":
        return Recovery()

    @staticmethod
    def none() -> "Recovery":
        return Recovery(from_snapshot=SnapshotSelectionCriteria.none(),
                        to_sequence_nr=0, replay_max=0)


@dataclass(frozen=True)
class RecoveryCompleted:
    pass


RECOVERY_COMPLETED = RecoveryCompleted()
