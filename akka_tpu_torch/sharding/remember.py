"""Remember-entities stores for the device region.

A copy of the store classes of `akka_tpu/sharding/region.py` (the module
itself imports the host actor runtime, so only these classes are copied):
the `RememberEntitiesStore` interface, the process-global
`InProcRememberEntitiesStore` and the durable record-log
`JournalRememberEntitiesStore`, whose file format is the reference's, so
either package reads the other's store, and the replicated
`DDataRememberEntitiesStore` (one ORSet of ids per shard in the ddata
replicator). The port adds to `DDataRememberEntitiesStore` a grow-only
set of (id, row index) per shard beside each ORSet: `add_many` records a
batch of a region's new ids with their rows (every touched shard's two
updates in flight at once), and `remembered_rows` reads them back, with
which a region re-hosts ids at the rows they had, whichever nodes wrote
them.

A region with `DeviceEntity.remember_store` adds every entity id on its
first allocation, and `restore()` respawns every remembered id before the
journals replay. The host `Shard` (`region.py`) takes its store from
`make_remember_entities_store`, a copy of the reference's
(`akka_tpu/sharding/region.py:285-312`), and reads and writes through
`remembered_async`, `add_async` and `remove_async`: its ids carry no
row.
"""

from __future__ import annotations

import os
import pickle
import threading
from concurrent.futures import Future
from typing import Any, Dict, Iterable, Optional, Set, Tuple

from ..persistence.journal import repair_record_log, scan_record_log

__all__ = ["RememberEntitiesStore", "InProcRememberEntitiesStore",
           "JournalRememberEntitiesStore", "DDataRememberEntitiesStore",
           "make_remember_entities_store"]


class RememberEntitiesStore:
    """The host `Shard` reads and writes through the `_async` methods (a
    port addition), so a store that waits on another actor (ddata) parks
    no dispatcher thread. Their defaults call the synchronous method and
    return a Future that is already done, holding its result or error."""

    def remembered(self, type_name: str, shard_id: str) -> Set[str]:
        raise NotImplementedError

    def add(self, type_name: str, shard_id: str, entity_id: str) -> None:
        raise NotImplementedError

    def remove(self, type_name: str, shard_id: str, entity_id: str) -> None:
        raise NotImplementedError

    def remembered_async(self, type_name: str, shard_id: str) -> Future:
        return _done(self.remembered, type_name, shard_id)

    def add_async(self, type_name: str, shard_id: str,
                  entity_id: str) -> Future:
        return _done(self.add, type_name, shard_id, entity_id)

    def remove_async(self, type_name: str, shard_id: str,
                     entity_id: str) -> Future:
        return _done(self.remove, type_name, shard_id, entity_id)


def _done(fn, *args) -> Future:
    """A Future already holding fn(*args), or the error it raised."""
    out: Future = Future()
    try:
        out.set_result(fn(*args))
    except Exception as e:  # noqa: BLE001 — handed to the caller
        out.set_exception(e)
    return out


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
    """Replicated store: one ORSet of entity ids per (type, shard) key in
    the ddata Replicator — adds/removes travel as the op-based deltas of
    ddata/crdt.py (an add to a 10k-id set gossips O(1 id), not the set), and a
    region restarted on ANY node of the cluster reads back the ids with
    one local Get (reference: DDataRememberEntitiesShardStore.scala).

    Local-first semantics: updates are WriteLocal (the shard's add must
    never block on a quorum — the reference uses majority writes but
    batches behind the shard's message stash; here gossip + delta ticks
    converge the set) and reads are ReadLocal."""

    def __init__(self, system, key_prefix: str = "sharding-remember",
                 timeout: float = 5.0):
        from ..ddata import DistributedData
        dd = DistributedData.get(system)
        self.system = system
        self.replicator = dd.replicator
        self.node = dd.self_unique_address
        self.key_prefix = key_prefix
        self.timeout = float(timeout)

    def _key(self, type_name: str, shard_id: str):
        from ..ddata import Key
        return Key(f"{self.key_prefix}-{type_name}-{shard_id}")

    # the synchronous calls (the device region's) wait as the reference's
    # ask_sync does: the ask's own timeout, then one second more
    def remembered(self, type_name, shard_id):
        return self.remembered_async(type_name, shard_id).result(
            self.timeout + 1.0)

    def remembered_async(self, type_name, shard_id) -> Future:
        from ..ddata import Get, GetSuccess, ReadLocal
        from ..pattern.ask import ask
        got = ask(self.replicator,
                  Get(self._key(type_name, shard_id), ReadLocal()),
                  timeout=self.timeout, system=self.system)
        # NotFound: nothing remembered yet
        return _then(got, lambda rep: set(rep.data.elements)
                     if isinstance(rep, GetSuccess) else set())

    def _rows_key(self, type_name: str, shard_id: str):
        from ..ddata import Key
        return Key(f"{self.key_prefix}-{type_name}-{shard_id}-rows")

    def remembered_rows(self, type_name, shard_id) -> Dict[str, Optional[int]]:
        """Every remembered id with the row index its region gave it
        (`add_many`), or None where no row was recorded (an id of `add`). A
        port addition: a region that lost its allocation log re-hosts the
        ids at these rows (`_respawn_remembered`), whichever nodes wrote
        them. Raises ValueError where two rows were recorded for one id
        (two regions allocated the shard at once)."""
        from ..ddata import Get, GetSuccess, ReadLocal
        from ..pattern.ask import ask
        got = [ask(self.replicator, Get(k, ReadLocal()), timeout=self.timeout,
                   system=self.system)
               for k in (self._key(type_name, shard_id),
                         self._rows_key(type_name, shard_id))]
        ids, rows = (f.result(self.timeout) for f in got)
        if not isinstance(ids, GetSuccess):
            return {}
        out: Dict[str, Optional[int]] = dict.fromkeys(ids.data.elements)
        for eid, index in (rows.data.elements
                           if isinstance(rows, GetSuccess) else ()):
            if eid not in out:
                continue  # removed since
            if out[eid] is not None and out[eid] != index:
                raise ValueError(
                    f"remember-entities: {eid!r} of shard {shard_id} has "
                    f"two recorded rows ({out[eid]}, {index})")
            out[eid] = index
        return out

    def add_many(self, type_name: str,
                 entries: Iterable[Tuple[str, str, int]]) -> None:
        """Remember a batch of (shard_id, entity_id, row index): per touched
        shard one update of its rows set, then one of its ORSet, all in
        flight at once (a port addition: a region's wave of new ids costs
        one round trip, not one per id). The rows go first, so a peer that
        sees an id through the deltas sees its row too."""
        from ..ddata import GSet, ORSet, Update, UpdateSuccess, WriteLocal
        from ..pattern.ask import ask
        by_shard: Dict[str, list] = {}
        for shard_id, eid, index in entries:
            by_shard.setdefault(shard_id, []).append((eid, int(index)))

        def add_rows(s, items):
            for item in items:
                s = s.add(item)
            return s

        def add_ids(s, items):
            for eid, _ in items:
                s = s.add(self.node, eid)
            return s
        pending = []
        for shard_id, items in by_shard.items():
            for key, empty, modify in (
                    (self._rows_key(type_name, shard_id), GSet.empty(),
                     add_rows),
                    (self._key(type_name, shard_id), ORSet.empty(),
                     add_ids)):
                pending.append(ask(
                    self.replicator,
                    Update(key, empty, WriteLocal(),
                           modify=lambda s, m=modify, i=items: m(s, i)),
                    timeout=self.timeout, system=self.system))
        for f in pending:
            rep = f.result(self.timeout)
            if not isinstance(rep, UpdateSuccess):
                raise RuntimeError(
                    f"remember-entities ddata update failed: {rep!r}")

    def _update_async(self, type_name, shard_id, modify) -> Future:
        from ..ddata import ORSet, Update, UpdateSuccess, WriteLocal
        from ..pattern.ask import ask
        got = ask(self.replicator,
                  Update(self._key(type_name, shard_id), ORSet.empty(),
                         WriteLocal(), modify=modify),
                  timeout=self.timeout, system=self.system)

        def ok(rep):
            if not isinstance(rep, UpdateSuccess):
                raise RuntimeError(
                    f"remember-entities ddata update failed: {rep!r}")
            return rep
        return _then(got, ok)

    def add_async(self, type_name, shard_id, entity_id) -> Future:
        return self._update_async(type_name, shard_id,
                                  lambda s: s.add(self.node, entity_id))

    def remove_async(self, type_name, shard_id, entity_id) -> Future:
        return self._update_async(type_name, shard_id,
                                  lambda s: s.remove(self.node, entity_id))

    def add(self, type_name, shard_id, entity_id):
        self.add_async(type_name, shard_id, entity_id).result(
            self.timeout + 1.0)

    def remove(self, type_name, shard_id, entity_id):
        self.remove_async(type_name, shard_id, entity_id).result(
            self.timeout + 1.0)


def _then(fut: Future, fn) -> Future:
    """A Future of fn(fut's result); fut's failure, or fn's, passes
    through."""
    out: Future = Future()

    def done(f):
        try:
            out.set_result(fn(f.result()))
        except BaseException as e:  # noqa: BLE001 — handed to the caller
            out.set_exception(e)
    fut.add_done_callback(done)
    return out


def make_remember_entities_store(
        settings: Any, system=None,
        flight_recorder: Any = None) -> Optional[RememberEntitiesStore]:
    """Resolve `settings.remember_entities_store` (a
    `ClusterShardingSettings`) to an impl (None when remember_entities is
    off). "journal" needs remember_entities_dir; "ddata" needs the
    ActorSystem hosting the replicator."""
    if not settings.remember_entities:
        return None
    kind = settings.remember_entities_store or "inproc"
    if kind == "inproc":
        return InProcRememberEntitiesStore()
    if kind == "journal":
        if not settings.remember_entities_dir:
            raise ValueError(
                "remember_entities_store='journal' needs "
                "remember_entities_dir")
        return JournalRememberEntitiesStore(
            os.path.join(settings.remember_entities_dir,
                         "remember_entities.journal"),
            flight_recorder=flight_recorder)
    if kind == "ddata":
        if system is None:
            raise ValueError(
                "remember_entities_store='ddata' needs the ActorSystem")
        return DDataRememberEntitiesStore(system)
    raise ValueError(f"unknown remember_entities_store {kind!r}")
