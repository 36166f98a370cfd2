"""Snapshot store plugins + actor.

A copy of `akka_tpu/persistence/snapshot.py` at commit 1001e26 (host code,
no jax; the port keeps its own copy of every module it needs).

Reference parity: akka-persistence/src/main/scala/akka/persistence/snapshot/
SnapshotStore.scala (LoadSnapshot/SaveSnapshot actor protocol),
snapshot/local/LocalSnapshotStore.scala:31 (one file per snapshot named
snapshot-<pid>-<seqNr>-<ts>, newest-first selection, keep a few fallbacks).
"""

from __future__ import annotations

import hashlib
import os
import pickle
import threading
from typing import Any, Dict, List, Optional, Tuple

from ..actor.actor import Actor
from ..serialization.records import load_record
from .messages import (DeleteSnapshot, DeleteSnapshotFailure, DeleteSnapshots,
                       DeleteSnapshotsFailure, DeleteSnapshotsSuccess,
                       DeleteSnapshotSuccess, LoadSnapshot, LoadSnapshotFailed,
                       LoadSnapshotResult, SaveSnapshot, SaveSnapshotFailure,
                       SaveSnapshotSuccess, SelectedSnapshot, SnapshotMetadata,
                       SnapshotSelectionCriteria)


class SnapshotPlugin:
    def load(self, persistence_id: str, criteria: SnapshotSelectionCriteria
             ) -> Optional[SelectedSnapshot]:
        raise NotImplementedError

    def save(self, metadata: SnapshotMetadata, snapshot: Any) -> None:
        raise NotImplementedError

    def delete(self, metadata: SnapshotMetadata) -> None:
        raise NotImplementedError

    def delete_matching(self, persistence_id: str,
                        criteria: SnapshotSelectionCriteria) -> None:
        raise NotImplementedError


class InMemSnapshotStore(SnapshotPlugin):
    def __init__(self):
        self.lock = threading.RLock()
        self.snapshots: Dict[str, List[Tuple[SnapshotMetadata, Any]]] = {}

    def load(self, persistence_id, criteria):
        with self.lock:
            candidates = [(md, s) for md, s in
                          self.snapshots.get(persistence_id, [])
                          if criteria.matches(md)]
        if not candidates:
            return None
        md, snap = max(candidates, key=lambda p: (p[0].sequence_nr,
                                                  p[0].timestamp))
        return SelectedSnapshot(md, snap)

    def save(self, metadata, snapshot):
        with self.lock:
            lst = self.snapshots.setdefault(metadata.persistence_id, [])
            lst[:] = [(md, s) for md, s in lst
                      if not (md.sequence_nr == metadata.sequence_nr
                              and md.timestamp == metadata.timestamp)]
            lst.append((metadata, snapshot))

    def delete(self, metadata):
        with self.lock:
            lst = self.snapshots.get(metadata.persistence_id, [])
            lst[:] = [(md, s) for md, s in lst
                      if md.sequence_nr != metadata.sequence_nr]

    def delete_matching(self, persistence_id, criteria):
        with self.lock:
            lst = self.snapshots.get(persistence_id, [])
            lst[:] = [(md, s) for md, s in lst if not criteria.matches(md)]


class LocalSnapshotStore(SnapshotPlugin):
    """One pickle file per snapshot: snapshot-<pidhash>-<seqnr>-<ts_us>
    (reference: snapshot/local/LocalSnapshotStore.scala:31). Files load
    through serialization.records.load_record: a snapshot that names a
    class the port cannot resolve raises instead of falling back to an
    older one."""

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.lock = threading.RLock()

    @staticmethod
    def _safe(pid: str) -> str:
        return hashlib.sha1(pid.encode()).hexdigest()[:16]

    def _files_for(self, pid: str) -> List[Tuple[SnapshotMetadata, str]]:
        prefix = f"snapshot-{self._safe(pid)}-"
        out = []
        for name in os.listdir(self.dir):
            if not name.startswith(prefix):
                continue
            try:
                _, _, seq, ts = name.rsplit("-", 3)
                out.append((SnapshotMetadata(pid, int(seq), int(ts) / 1e6),
                            os.path.join(self.dir, name)))
            except ValueError:
                continue
        return out

    def load(self, persistence_id, criteria):
        with self.lock:
            candidates = [(md, p) for md, p in self._files_for(persistence_id)
                          if criteria.matches(md)]
            # newest first; fall back on unreadable files (reference keeps 3)
            for md, path in sorted(candidates,
                                   key=lambda x: (x[0].sequence_nr,
                                                  x[0].timestamp),
                                   reverse=True):
                try:
                    with open(path, "rb") as f:
                        return SelectedSnapshot(md, load_record(f.read()))
                except (OSError, pickle.PickleError, EOFError):
                    continue
        return None

    def save(self, metadata, snapshot):
        with self.lock:
            name = (f"snapshot-{self._safe(metadata.persistence_id)}-"
                    f"{metadata.sequence_nr}-{int(metadata.timestamp * 1e6)}")
            tmp = os.path.join(self.dir, name + ".tmp")
            with open(tmp, "wb") as f:
                pickle.dump(snapshot, f, protocol=4)
            os.replace(tmp, os.path.join(self.dir, name))

    def delete(self, metadata):
        with self.lock:
            for md, path in self._files_for(metadata.persistence_id):
                if md.sequence_nr == metadata.sequence_nr:
                    try:
                        os.unlink(path)
                    except OSError:
                        pass

    def delete_matching(self, persistence_id, criteria):
        with self.lock:
            for md, path in self._files_for(persistence_id):
                if criteria.matches(md):
                    try:
                        os.unlink(path)
                    except OSError:
                        pass


class SnapshotStoreActor(Actor):
    """(reference: snapshot/SnapshotStore.scala receive)"""

    def __init__(self, plugin: SnapshotPlugin):
        super().__init__()
        self.plugin = plugin

    def receive(self, message: Any) -> Any:
        if isinstance(message, LoadSnapshot):
            try:
                crit = message.criteria
                if message.to_sequence_nr < crit.max_sequence_nr:
                    crit = SnapshotSelectionCriteria(
                        max_sequence_nr=message.to_sequence_nr,
                        max_timestamp=crit.max_timestamp,
                        min_sequence_nr=crit.min_sequence_nr,
                        min_timestamp=crit.min_timestamp)
                selected = self.plugin.load(message.persistence_id, crit)
                self.sender.tell(
                    LoadSnapshotResult(selected, message.to_sequence_nr),
                    self.self_ref)
            except Exception as e:  # noqa: BLE001
                self.sender.tell(LoadSnapshotFailed(str(e)), self.self_ref)
        elif isinstance(message, SaveSnapshot):
            try:
                self.plugin.save(message.metadata, message.snapshot)
                self.sender.tell(SaveSnapshotSuccess(message.metadata),
                                 self.self_ref)
            except Exception as e:  # noqa: BLE001
                self.sender.tell(SaveSnapshotFailure(message.metadata, str(e)),
                                 self.self_ref)
        elif isinstance(message, DeleteSnapshot):
            try:
                self.plugin.delete(message.metadata)
                self.sender.tell(DeleteSnapshotSuccess(message.metadata),
                                 self.self_ref)
            except Exception as e:  # noqa: BLE001
                self.sender.tell(DeleteSnapshotFailure(message.metadata,
                                                       str(e)), self.self_ref)
        elif isinstance(message, DeleteSnapshots):
            try:
                self.plugin.delete_matching(message.persistence_id,
                                            message.criteria)
                self.sender.tell(DeleteSnapshotsSuccess(message.criteria),
                                 self.self_ref)
            except Exception as e:  # noqa: BLE001
                self.sender.tell(DeleteSnapshotsFailure(message.criteria,
                                                        str(e)), self.self_ref)
        else:
            return NotImplemented
