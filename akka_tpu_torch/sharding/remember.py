"""Remember-entities stores for the device region.

A copy of the store classes of `akka_tpu/sharding/region.py` (the module
itself imports the host actor runtime, so only these classes are copied):
the `RememberEntitiesStore` interface, the process-global
`InProcRememberEntitiesStore` and the durable record-log
`JournalRememberEntitiesStore`, whose file format is the reference's, so
either package reads the other's store. The replicated store
(`DDataRememberEntitiesStore`) needs the ddata replicator, ROADMAP A12.

A region with `DeviceEntity.remember_store` adds every entity id on its
first allocation, and `restore()` respawns every remembered id before the
journals replay.
"""

from __future__ import annotations

import os
import pickle
import threading
from typing import Any, Dict, Set, Tuple

from ..persistence.journal import repair_record_log, scan_record_log

__all__ = ["RememberEntitiesStore", "InProcRememberEntitiesStore",
           "JournalRememberEntitiesStore", "DDataRememberEntitiesStore"]


class RememberEntitiesStore:
    def remembered(self, type_name: str, shard_id: str) -> Set[str]:
        raise NotImplementedError

    def add(self, type_name: str, shard_id: str, entity_id: str) -> None:
        raise NotImplementedError

    def remove(self, type_name: str, shard_id: str, entity_id: str) -> None:
        raise NotImplementedError


class InProcRememberEntitiesStore(RememberEntitiesStore):
    """Process-global store: survives regions rebuilt in one process (the
    test analogue of a replicated store)."""

    _data: Dict[Tuple[str, str], Set[str]] = {}
    _lock = threading.Lock()

    def remembered(self, type_name, shard_id):
        with self._lock:
            return set(self._data.get((type_name, shard_id), set()))

    def add(self, type_name, shard_id, entity_id):
        with self._lock:
            self._data.setdefault((type_name, shard_id), set()).add(entity_id)

    def remove(self, type_name, shard_id, entity_id):
        with self._lock:
            self._data.get((type_name, shard_id), set()).discard(entity_id)

    @classmethod
    def reset(cls):
        with cls._lock:
            cls._data.clear()


class JournalRememberEntitiesStore(RememberEntitiesStore):
    """Durable file-backed store: add/remove ops append to a
    length-prefixed record log (torn tails truncated on open), folded into
    memory at open so remembered() never touches the disk. A restarted
    region reads back exactly the ids whose add() was flushed.

    Appends are skipped for an id already present, flushed per record
    (kill -9 safe) and fsync'd every `fsync_every_n` appends; `compact()`
    rewrites the log as one snapshot record of every non-empty
    (type, shard)."""

    def __init__(self, path: str, flight_recorder: Any = None,
                 fsync_every_n: int = 1):
        self.path = path
        self.fsync_every_n = max(1, int(fsync_every_n))
        self._since_fsync = 0
        self._lock = threading.Lock()
        self._data: Dict[Tuple[str, str], Set[str]] = {}
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self.truncated_bytes = repair_record_log(path, flight_recorder)
        for _end, rec in scan_record_log(path):
            self._apply(rec)
        self._fh = open(path, "ab")

    def _apply(self, rec: Dict[str, Any]) -> None:
        op = rec.get("op")
        if op == "snap":
            for type_name, shard_id, ids in rec.get("data", ()):
                self._data[(type_name, shard_id)] = set(ids)
            return
        key = (rec["type"], rec["shard"])
        if op == "add":
            self._data.setdefault(key, set()).add(rec["eid"])
        elif op == "remove":
            self._data.get(key, set()).discard(rec["eid"])

    def _append_locked(self, rec: Dict[str, Any]) -> None:
        if self._fh is None:
            raise ValueError("JournalRememberEntitiesStore is closed")
        blob = pickle.dumps(rec, protocol=4)
        self._fh.write(len(blob).to_bytes(8, "little"))
        self._fh.write(blob)
        self._fh.flush()
        self._since_fsync += 1
        if self._since_fsync >= self.fsync_every_n:
            os.fsync(self._fh.fileno())
            self._since_fsync = 0

    def remembered(self, type_name, shard_id):
        with self._lock:
            return set(self._data.get((type_name, shard_id), set()))

    def add(self, type_name, shard_id, entity_id):
        with self._lock:
            ids = self._data.setdefault((type_name, shard_id), set())
            if entity_id in ids:
                return
            ids.add(entity_id)
            self._append_locked({"op": "add", "type": type_name,
                                 "shard": shard_id, "eid": entity_id})

    def remove(self, type_name, shard_id, entity_id):
        with self._lock:
            ids = self._data.get((type_name, shard_id), set())
            if entity_id not in ids:
                return
            ids.discard(entity_id)
            self._append_locked({"op": "remove", "type": type_name,
                                 "shard": shard_id, "eid": entity_id})

    def compact(self) -> int:
        """Atomic log rewrite: one snapshot record of the live fold.
        Returns the number of remembered ids kept."""
        with self._lock:
            if self._fh is None:
                raise ValueError("JournalRememberEntitiesStore is closed")
            data = [(t, s, sorted(ids))
                    for (t, s), ids in self._data.items() if ids]
            blob = pickle.dumps({"op": "snap", "data": data}, protocol=4)
            tmp = self.path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(len(blob).to_bytes(8, "little"))
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            self._fh.close()
            os.replace(tmp, self.path)
            self._fh = open(self.path, "ab")
            self._since_fsync = 0
            return sum(len(ids) for _t, _s, ids in data)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                if self._since_fsync:
                    self._fh.flush()
                    os.fsync(self._fh.fileno())
                    self._since_fsync = 0
                self._fh.close()
                self._fh = None


class DDataRememberEntitiesStore(RememberEntitiesStore):
    """The replicated store of the reference (one ORSet of entity ids per
    (type, shard) in the ddata replicator). Not ported: the replicator is
    ROADMAP A12."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "DDataRememberEntitiesStore is not ported yet (ROADMAP A12: "
            "the ddata replicator)")
