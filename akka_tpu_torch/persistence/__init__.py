"""Persistence (event sourcing) of the port: a copy of
`akka_tpu/persistence` at commit 1001e26 (host code, no jax).

Classic PersistentActor with persist/persistAsync + recovery, typed
EventSourcedBehavior with the Effect API, journal/snapshot plugin SPI with
in-mem and append-only-file implementations, AtLeastOnceDelivery,
persistence-query, a programmable-failure testkit journal, TCK compliance
suites; and the durability of the batched runtime: the record log, the
write-ahead tell journal, the per-entity event journal and the `.npz` slab
snapshot. Every file format is the reference's, so either package reads
the other's files; every pickle the port reads goes through
`serialization.records.load_record` (re-exported by `journal`), which
maps the JAX package's class paths onto the port's.
"""

from .messages import (AtomicWrite, DeleteMessagesFailure,  # noqa: F401
                       DeleteMessagesSuccess, DeleteSnapshotsSuccess,
                       DeleteSnapshotSuccess, LoadSnapshot, LoadSnapshotResult,
                       PersistentRepr, Recovery, RecoveryCompleted,
                       RecoverySuccess, ReplayedMessage, ReplayMessages,
                       SaveSnapshot, SaveSnapshotFailure, SaveSnapshotSuccess,
                       SelectedSnapshot, SnapshotMetadata, SnapshotOffer,
                       SnapshotSelectionCriteria, Tagged, WriteMessages)
from .journal import (FileJournal, InMemJournal, JournalActor,  # noqa: F401
                      JournalPlugin, SharedInMemStore, UnresolvedRecordClass,
                      load_record, repair_record_log, scan_record_log)
from .snapshot import (InMemSnapshotStore, LocalSnapshotStore,  # noqa: F401
                       SnapshotPlugin, SnapshotStoreActor)
from .persistence import (JOURNAL_FILE, JOURNAL_INMEM,  # noqa: F401
                          Persistence, RecoveryPermitter, SNAPSHOT_INMEM,
                          SNAPSHOT_LOCAL)
from .eventsourced import PersistentActor  # noqa: F401
from .adapter import (EventAdapter, EventAdapters, EventSeq,  # noqa: F401
                      IdentityEventAdapter, SnapshotAdapter)
from .at_least_once import (AtLeastOnceDelivery,  # noqa: F401
                            AtLeastOnceDeliverySnapshot,
                            MaxUnconfirmedMessagesExceededException,
                            UnconfirmedDelivery, UnconfirmedWarning)
from .typed import (Effect, EventSourcedBehavior,  # noqa: F401
                    PersistenceId, RetentionCriteria)
from .query import (EventEnvelope, EventStream, NoOffset,  # noqa: F401
                    PersistenceQuery, ReadJournal, Sequence)
from .entity_journal import EntityJournal, OP_ADD  # noqa: F401
from .testkit import (FailIf, FailNextN, PassAll,  # noqa: F401
                      PersistenceTestKitJournal, ProcessingPolicy,
                      RejectNextN, journal_tck, snapshot_store_tck)
from .slab_snapshot import (SCHEMA_VERSION, gc_slabs,  # noqa: F401
                            latest_slab_path, load_slab_tree,
                            restore_slab_pytree, restore_slabs,
                            save_slab_tree, save_slabs, slab_pytree)
from .tell_journal import TellJournal, replay_journal  # noqa: F401
from . import slab_snapshot  # noqa: F401

__all__ = [
    "PersistentRepr", "AtomicWrite", "Tagged", "Recovery",
    "RecoveryCompleted", "SnapshotOffer", "SnapshotMetadata",
    "SnapshotSelectionCriteria", "SelectedSnapshot",
    "SaveSnapshotSuccess", "SaveSnapshotFailure", "DeleteMessagesSuccess",
    "JournalPlugin", "InMemJournal", "FileJournal", "JournalActor",
    "SharedInMemStore",
    "SnapshotPlugin", "InMemSnapshotStore", "LocalSnapshotStore",
    "SnapshotStoreActor",
    "Persistence", "RecoveryPermitter",
    "JOURNAL_INMEM", "JOURNAL_FILE", "SNAPSHOT_INMEM", "SNAPSHOT_LOCAL",
    "PersistentActor",
    "EventAdapter", "EventAdapters", "EventSeq", "IdentityEventAdapter",
    "SnapshotAdapter",
    "AtLeastOnceDelivery", "AtLeastOnceDeliverySnapshot",
    "UnconfirmedDelivery", "UnconfirmedWarning",
    "MaxUnconfirmedMessagesExceededException",
    "EventSourcedBehavior", "Effect", "PersistenceId", "RetentionCriteria",
    "PersistenceQuery", "ReadJournal", "EventEnvelope", "EventStream",
    "Sequence", "NoOffset",
    "EntityJournal", "OP_ADD",
    "PersistenceTestKitJournal", "ProcessingPolicy", "PassAll", "FailNextN",
    "RejectNextN", "FailIf", "journal_tck", "snapshot_store_tck",
    "slab_snapshot",
    # the port's record log and batched-runtime durability
    "UnresolvedRecordClass", "load_record", "repair_record_log",
    "scan_record_log", "SCHEMA_VERSION", "TellJournal", "gc_slabs",
    "latest_slab_path", "load_slab_tree", "replay_journal",
    "restore_slab_pytree", "restore_slabs", "save_slab_tree", "save_slabs",
    "slab_pytree",
]
