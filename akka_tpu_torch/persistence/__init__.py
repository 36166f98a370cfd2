"""Durability of the batched runtime (port of the device half of
`akka_tpu/persistence`): the record log, the write-ahead tell journal, the
per-entity event journal and the `.npz` slab snapshot. Every file format
is the reference's, so either package reads the other's files. The
actor-level persistence of the reference (the journal plugins, event-
sourced actors, snapshots, queries) stands on the host actor runtime,
which the port has; it is not ported yet (ROADMAP A12.1)."""

from .entity_journal import OP_ADD, EntityJournal
from .journal import repair_record_log, scan_record_log
from .slab_snapshot import (SCHEMA_VERSION, gc_slabs, latest_slab_path,
                            load_slab_tree, restore_slab_pytree,
                            restore_slabs, save_slab_tree, save_slabs,
                            slab_pytree)
from .tell_journal import TellJournal, replay_journal
from . import slab_snapshot  # noqa: F401

__all__ = ["EntityJournal", "OP_ADD", "SCHEMA_VERSION", "TellJournal",
           "gc_slabs", "latest_slab_path", "load_slab_tree",
           "repair_record_log", "replay_journal", "restore_slab_pytree",
           "restore_slabs", "save_slab_tree", "save_slabs", "scan_record_log",
           "slab_pytree", "slab_snapshot"]
