"""Journal plugins, the journal actor, and the record log every journal
of the port shares.

A copy of `akka_tpu/persistence/journal.py` at commit 1001e26 (host code,
no jax; the port keeps its own copy of every module it needs), with one
change: every pickle the port reads goes through `load_record`.

Reference parity: akka-persistence/src/main/scala/akka/persistence/journal/
AsyncWriteJournal.scala (the WriteMessages/ReplayMessages actor protocol,
per-message Success/Rejected/Failure fan-out), journal/inmem/InmemJournal.scala,
journal/leveldb/LeveldbStore.scala (replaced by an append-only pickle record
log — there is no LevelDB; the access pattern, per-id replay cursors +
tag index, is preserved), journal/leveldb/SharedLeveldbStore.scala (shared
store for multi-node tests → SharedInMemStore).

The record log's format is the reference's, byte for byte: each record is
an 8-byte little-endian length followed by a pickle blob, so either package
reads the other's logs. `load_record` (serialization/records.py,
re-exported here) unpickles a blob with the class paths of the JAX
package (`akka_tpu.…`) mapped onto the port's (`akka_tpu_torch.…`), so
reading a file the JAX package wrote never imports it. A class that does
not resolve in the port (a module the port lacks, or jax) raises
`UnresolvedRecordClass`, an ImportError: such a record is intact, so the
scan does not read it as a torn tail and the repair leaves the file alone
(the reference's scan reads any unpickling error as a torn tail). The
port writes its own class paths.

The batched runtime's slab snapshots live in slab_snapshot.py; the flight
recorder (`journal_truncated(path, dropped)`, event/flight_recorder.py) is
optional and may be None.
"""

from __future__ import annotations

import os
import pickle
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..actor.actor import Actor
from ..serialization.records import (UnresolvedRecordClass,  # noqa: F401
                                     _PortUnpickler, load_record)
from .adapter import EventAdapters
from .adapter import _IDENTITY as _IDENTITY_ADAPTER
from .messages import (AtomicWrite, DeleteMessagesFailure,
                       DeleteMessagesSuccess, DeleteMessagesTo,
                       PersistentRepr, RecoverySuccess, ReplayedMessage,
                       ReplayMessages, ReplayMessagesFailure, Tagged,
                       WriteMessageFailure, WriteMessageRejected,
                       WriteMessages, WriteMessagesFailed,
                       WriteMessagesSuccessful, WriteMessageSuccess)


class JournalPlugin:
    """Synchronous storage SPI; the JournalActor provides the async actor
    protocol on top (reference: AsyncWriteJournal + AsyncRecovery SPI).

    write_atomic returns None on success or an error string to REJECT the
    write (event not stored, actor keeps running); raising an exception is a
    write FAILURE (actor stops) — mirroring the reference's Try[Unit] vs
    failed future distinction (AsyncWriteJournal.scala asyncWriteMessages doc).
    """

    def write_atomic(self, write: AtomicWrite) -> Optional[str]:
        raise NotImplementedError

    def replay(self, persistence_id: str, from_nr: int, to_nr: int, max_n: int,
               callback: Callable[[PersistentRepr], None]) -> None:
        raise NotImplementedError

    def highest_sequence_nr(self, persistence_id: str, from_nr: int) -> int:
        raise NotImplementedError

    def delete_to(self, persistence_id: str, to_nr: int) -> None:
        raise NotImplementedError

    # -- query-side hooks (persistence-query reads through the plugin) -------
    def persistence_ids(self) -> List[str]:
        return []

    def events_by_tag(self, tag: str, from_offset: int
                      ) -> List[Tuple[int, PersistentRepr]]:
        """[(offset, repr)] for tagged events; offset is a global counter."""
        return []

    def add_listener(self, listener: Callable[[PersistentRepr], None]) -> None:
        """Live-query hook: called for every stored repr."""

    def remove_listener(self, listener: Callable[[PersistentRepr], None]) -> None:
        pass


class _MemStore:
    """Shared guts of the in-memory journal (separable so multiple systems
    can point at ONE store, the SharedLeveldbStore pattern for multi-node
    persistence tests)."""

    def __init__(self):
        self.lock = threading.RLock()
        self.messages: Dict[str, List[PersistentRepr]] = {}
        self.deleted_to: Dict[str, int] = {}
        self.highest: Dict[str, int] = {}
        self.by_tag: Dict[str, List[Tuple[int, PersistentRepr]]] = {}
        self.offset = 0
        self.listeners: List[Callable[[PersistentRepr], None]] = []


class InMemJournal(JournalPlugin):
    """(reference: journal/inmem/InmemJournal.scala)"""

    def __init__(self, store: Optional[_MemStore] = None):
        self.store = store or _MemStore()

    def write_atomic(self, write: AtomicWrite) -> Optional[str]:
        st = self.store
        with st.lock:
            pid = write.persistence_id
            lst = st.messages.setdefault(pid, [])
            for repr_ in write.payload:
                repr_, tags = _untag(repr_)
                lst.append(repr_)
                st.highest[pid] = max(st.highest.get(pid, 0), repr_.sequence_nr)
                st.offset += 1
                for t in tags:
                    st.by_tag.setdefault(t, []).append((st.offset, repr_))
            listeners = list(st.listeners)
            stored = [_untag(r)[0] for r in write.payload]
        for cb in listeners:
            for r in stored:
                cb(r)
        return None

    def replay(self, persistence_id, from_nr, to_nr, max_n, callback):
        with self.store.lock:
            deleted_to = self.store.deleted_to.get(persistence_id, 0)
            msgs = [r for r in self.store.messages.get(persistence_id, [])
                    if from_nr <= r.sequence_nr <= to_nr
                    and r.sequence_nr > deleted_to][:max_n]
        for r in msgs:
            callback(r)

    def highest_sequence_nr(self, persistence_id, from_nr):
        with self.store.lock:
            return self.store.highest.get(persistence_id, 0)

    def delete_to(self, persistence_id, to_nr):
        with self.store.lock:
            cur = self.store.deleted_to.get(persistence_id, 0)
            self.store.deleted_to[persistence_id] = max(cur, to_nr)

    def persistence_ids(self):
        with self.store.lock:
            return sorted(self.store.messages.keys())

    def events_by_tag(self, tag, from_offset):
        with self.store.lock:
            return [(o, r) for o, r in self.store.by_tag.get(tag, [])
                    if o > from_offset]

    def add_listener(self, listener):
        with self.store.lock:
            self.store.listeners.append(listener)

    def remove_listener(self, listener):
        with self.store.lock:
            if listener in self.store.listeners:
                self.store.listeners.remove(listener)


class SharedInMemStore:
    """Process-global named stores for multi-node tests (reference:
    SharedLeveldbStore)."""

    _stores: Dict[str, _MemStore] = {}
    _lock = threading.Lock()

    @staticmethod
    def get(name: str = "default") -> _MemStore:
        with SharedInMemStore._lock:
            st = SharedInMemStore._stores.get(name)
            if st is None:
                st = SharedInMemStore._stores[name] = _MemStore()
            return st

    @staticmethod
    def reset(name: Optional[str] = None) -> None:
        with SharedInMemStore._lock:
            if name is None:
                SharedInMemStore._stores.clear()
            else:
                SharedInMemStore._stores.pop(name, None)


def _untag(repr_: PersistentRepr) -> Tuple[PersistentRepr, frozenset]:
    if isinstance(repr_.payload, Tagged):
        return repr_.with_payload(repr_.payload.payload), repr_.payload.tags
    return repr_, frozenset()


class _SerializedPayload:
    """Envelope stored in place of the raw event payload when the journal
    serializes through the Serialization registry: (serializer id,
    manifest, bytes) — the manifest carries the schema VERSION, so
    replays after a rolling upgrade run the registered migrations
    (akka-serialization-jackson JacksonMigration parity)."""

    __slots__ = ("serializer_id", "manifest", "data")

    def __init__(self, serializer_id: int, manifest: str, data: bytes):
        self.serializer_id = serializer_id
        self.manifest = manifest
        self.data = data

    def __getstate__(self):
        return (self.serializer_id, self.manifest, self.data)

    def __setstate__(self, s):
        self.serializer_id, self.manifest, self.data = s


def scan_record_log(path: str):
    """Yield (end_offset, record) for every INTACT record in a
    length-prefixed record log, stopping at the first torn or corrupt tail
    (short header, short blob, or a blob the unpickler rejects). The
    end_offset of the last yielded record is the byte length of the valid
    prefix — what repair_record_log truncates to. A record whose class
    does not resolve raises UnresolvedRecordClass."""
    if not os.path.exists(path):
        return
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        offset = 0
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                return
            n = int.from_bytes(hdr, "little")
            if offset + 8 + n > size:
                # truncated tail, or garbage read as an absurd length
                # prefix: bound by the file size before allocating, so a
                # torn tail can never MemoryError the repair
                return
            blob = f.read(n)
            if len(blob) < n:
                return  # truncated tail (crash mid-append)
            try:
                obj = load_record(blob)
            except UnresolvedRecordClass:
                raise
            except Exception:  # noqa: BLE001 — torn/garbled tail record
                return
            offset += 8 + n
            yield offset, obj


def repair_record_log(path: str, flight_recorder=None) -> int:
    """Crash-safe open: truncate a torn tail record (a host killed
    mid-append leaves a partial length-prefix+blob) back to the last intact
    record, warning via the flight recorder (if any) instead of letting
    readers hit UnpicklingError. Returns the number of bytes dropped
    (0 = intact). Raises UnresolvedRecordClass, with the file untouched,
    for a record whose class the port cannot resolve."""
    if not os.path.exists(path):
        return 0
    good = 0
    for end, _obj in scan_record_log(path):
        good = end
    size = os.path.getsize(path)
    if size <= good:
        return 0
    with open(path, "r+b") as f:
        f.truncate(good)
        f.flush()
        os.fsync(f.fileno())
    dropped = size - good
    if flight_recorder is not None and getattr(
            flight_recorder, "enabled", False):
        flight_recorder.journal_truncated(path, dropped)
    return dropped


class FileJournal(JournalPlugin):
    """Append-only record log: one file per persistence id, length-prefixed
    pickled PersistentReprs, plus a tag-index file. Replaces the reference's
    LevelDB store (journal/leveldb/LeveldbStore.scala) with the same
    capabilities: per-id replay, highest-seq-nr, logical delete-to, tags.

    Appends are atomic-at-the-record (length-prefix + fsync); on open every
    log in the directory is repaired via repair_record_log, so a kill -9
    mid-append costs at most the record being written, never the log.

    With `serialization` set (a serialization.Serialization), event
    PAYLOADS are stored as (serializer id, manifest, bytes) envelopes via
    the registry instead of raw pickle — the versioned-manifest seam that
    makes journals survive schema evolution (VersionedJsonSerializer +
    SchemaMigration, the Jackson-journal analogue)."""

    def __init__(self, directory: str, serialization=None,
                 flight_recorder=None):
        self.serialization = serialization
        self.flight_recorder = flight_recorder
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.lock = threading.RLock()
        self.listeners: List[Callable[[PersistentRepr], None]] = []
        self._meta_path = os.path.join(directory, "_meta.pickle")
        self._tags_path = os.path.join(directory, "_tags.log")
        # {pid: {"deleted_to": n, "highest": n}}, global tag offset counter
        self._meta: Dict[str, Dict[str, int]] = {}
        self._offset = 0
        for name in sorted(os.listdir(directory)):
            if name.endswith(".log"):
                repair_record_log(os.path.join(directory, name),
                                  flight_recorder)
        self._load_meta()

    # -- file helpers ---------------------------------------------------------
    def _pid_path(self, pid: str) -> str:
        import hashlib
        safe = hashlib.sha1(pid.encode()).hexdigest()[:16]
        return os.path.join(self.dir, f"j-{safe}.log")

    @staticmethod
    def _append_record(path: str, obj: Any) -> None:
        blob = pickle.dumps(obj, protocol=4)
        with open(path, "ab") as f:
            f.write(len(blob).to_bytes(8, "little"))
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())

    @staticmethod
    def _read_records(path: str):
        # torn/corrupt tails stop the scan rather than raising; the repair
        # pass in __init__ already truncated them with a warning
        for _end, obj in scan_record_log(path):
            yield obj

    def _load_meta(self) -> None:
        if os.path.exists(self._meta_path):
            try:
                with open(self._meta_path, "rb") as f:
                    saved = load_record(f.read())
                self._meta = saved.get("meta", {})
                self._offset = saved.get("offset", 0)
            except (OSError, pickle.PickleError, EOFError):
                self._meta = {}
        # recover pid registry from directory on cold start
        for rec in self._read_records(os.path.join(self.dir, "_pids.log")):
            self._meta.setdefault(rec, {})

    def _save_meta(self) -> None:
        tmp = self._meta_path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump({"meta": self._meta, "offset": self._offset}, f, 4)
        os.replace(tmp, self._meta_path)

    # -- SPI -------------------------------------------------------------------
    def write_atomic(self, write: AtomicWrite) -> Optional[str]:
        with self.lock:
            pid = write.persistence_id
            path = self._pid_path(pid)
            # serialize EVERYTHING first so an unpicklable event rejects the
            # whole batch with zero bytes written (AtomicWrite is
            # all-or-nothing; events reported rejected must not replay later)
            untagged = []
            try:
                from ..serialization.serialization import SerializationError
                blobs = []
                for repr_ in write.payload:
                    r, tags = _untag(repr_)
                    if self.serialization is not None:
                        sid, man, blob = self.serialization.serialize(
                            r.payload)
                        r = r.with_payload(
                            _SerializedPayload(sid, man, blob))
                    untagged.append((r, tags))
                    blobs.append(pickle.dumps(r, protocol=4))
                    for t in tags:
                        pickle.dumps((t, 0, r), protocol=4)
            except (pickle.PickleError, TypeError, AttributeError,
                    SerializationError) as e:
                return f"unserializable event: {e}"  # reject, not fail
            known = pid in self._meta
            m = self._meta.setdefault(pid, {})
            stored = []
            for r, tags in untagged:
                self._append_record(path, r)
                m["highest"] = max(m.get("highest", 0), r.sequence_nr)
                stored.append(r)
                for t in tags:
                    self._offset += 1
                    self._append_record(self._tags_path,
                                        (t, self._offset, r))
            if not known:
                self._append_record(os.path.join(self.dir, "_pids.log"), pid)
            self._save_meta()
            listeners = list(self.listeners)
        if listeners:
            unwrapped = [self._unwrap(r) for r in stored]  # once, not per cb
            for cb in listeners:
                for r in unwrapped:
                    cb(r)
        return None

    def _unwrap(self, r):
        """Deserialize a _SerializedPayload envelope back into the event
        object — where versioned manifests run their migrations."""
        if self.serialization is not None and \
                isinstance(r.payload, _SerializedPayload):
            p = r.payload
            return r.with_payload(self.serialization.deserialize(
                p.serializer_id, p.manifest, p.data))
        return r

    def replay(self, persistence_id, from_nr, to_nr, max_n, callback):
        if max_n <= 0:
            return
        with self.lock:
            deleted_to = self._meta.get(persistence_id, {}).get("deleted_to", 0)
            out = []
            for r in self._read_records(self._pid_path(persistence_id)):
                if (from_nr <= r.sequence_nr <= to_nr
                        and r.sequence_nr > deleted_to):
                    out.append(r)
                    if len(out) >= max_n:
                        break
        for r in out:
            callback(self._unwrap(r))

    def highest_sequence_nr(self, persistence_id, from_nr):
        with self.lock:
            return self._meta.get(persistence_id, {}).get("highest", 0)

    def delete_to(self, persistence_id, to_nr):
        with self.lock:
            m = self._meta.setdefault(persistence_id, {})
            m["deleted_to"] = max(m.get("deleted_to", 0), to_nr)
            self._save_meta()

    def persistence_ids(self):
        with self.lock:
            return sorted(self._meta.keys())

    def events_by_tag(self, tag, from_offset):
        with self.lock:
            out = []
            for t, off, r in self._read_records(self._tags_path):
                if t == tag and off > from_offset:
                    out.append((off, r))
        # deserialization (and user migration code) runs OUTSIDE the lock,
        # like replay(): a slow migration must not stall concurrent writes
        return [(off, self._unwrap(r)) for off, r in out]

    def add_listener(self, listener):
        with self.lock:
            self.listeners.append(listener)

    def remove_listener(self, listener):
        with self.lock:
            if listener in self.listeners:
                self.listeners.remove(listener)


class JournalActor(Actor):
    """Async actor protocol over a sync plugin (reference:
    AsyncWriteJournal.scala receiveWriteMessages / ReplayMessages handling).
    Runs on its own dispatcher in the reference; here the actor's mailbox
    already serializes plugin access per journal.

    `adapters` (EventAdapters) is the per-journal domain<->journal-model
    seam (reference: WriteJournalBase.preparePersistentBatch applying
    toJournal on the write side, AsyncWriteJournal.adaptFromJournal fanning
    each stored record out to 0..N ReplayedMessages on the read side)."""

    def __init__(self, plugin: JournalPlugin, adapters=None):
        super().__init__()
        self.plugin = plugin
        self.adapters = adapters if adapters is not None else EventAdapters()

    def _adapt_to_journal(self, repr_: PersistentRepr) -> PersistentRepr:
        """Apply the write-side adapter to the DOMAIN payload; a typed
        tagger's Tagged wrapper is transparent (adapt inside, keep tags) —
        and an adapter may itself RETURN Tagged to attach tags."""
        payload, tags = repr_.payload, None
        if isinstance(payload, Tagged):
            payload, tags = payload.payload, payload.tags
        adapter = self.adapters.get(type(payload))
        if adapter is _IDENTITY_ADAPTER and tags is None:
            return repr_
        adapted = adapter.to_journal(payload)
        manifest = adapter.manifest(payload) or repr_.manifest
        if tags is not None:
            # tagger tags and adapter-attached tags UNION (dropping either
            # silently breaks events_by_tag for that source)
            if isinstance(adapted, Tagged):
                adapted = Tagged(adapted.payload, adapted.tags | tags)
            else:
                adapted = Tagged(adapted, tags)
        out = repr_.with_payload(adapted)
        return PersistentRepr(out.payload, out.sequence_nr,
                              out.persistence_id, manifest, out.writer_uuid,
                              out.deleted, out.timestamp)

    def _adapt_from_journal(self, repr_: PersistentRepr) -> List[PersistentRepr]:
        """Read-side: one stored record -> 0..N domain events, all sharing
        the stored sequence_nr (reference: adaptFromJournal)."""
        adapter = self.adapters.get(type(repr_.payload))
        seq = adapter.from_journal(repr_.payload, repr_.manifest)
        return [repr_.with_payload(ev) for ev in seq.events]

    def receive(self, message: Any) -> Any:
        if isinstance(message, WriteMessages):
            self._write(message)
        elif isinstance(message, ReplayMessages):
            self._replay(message)
        elif isinstance(message, DeleteMessagesTo):
            try:
                self.plugin.delete_to(message.persistence_id,
                                      message.to_sequence_nr)
                message.persistent_actor.tell(
                    DeleteMessagesSuccess(message.to_sequence_nr), self.self_ref)
            except Exception as e:  # noqa: BLE001
                message.persistent_actor.tell(
                    DeleteMessagesFailure(str(e), message.to_sequence_nr),
                    self.self_ref)
        else:
            return NotImplemented

    def _write(self, msg: WriteMessages) -> None:
        actor, iid = msg.persistent_actor, msg.actor_instance_id
        results: List[Tuple[AtomicWrite, Optional[str]]] = []
        failure: Optional[str] = None
        n_written = 0
        for aw in msg.messages:
            if failure is not None:
                break
            try:
                to_store = aw if self.adapters.is_empty else AtomicWrite(
                    tuple(self._adapt_to_journal(r) for r in aw.payload))
                rejection = self.plugin.write_atomic(to_store)
                results.append((aw, rejection))
                if rejection is None:
                    n_written += 1
            except Exception as e:  # noqa: BLE001 — store failure
                failure = str(e)
        if failure is not None:
            actor.tell(WriteMessagesFailed(failure, len(msg.messages), iid),
                       self.self_ref)
            for aw in msg.messages:
                for repr_ in aw.payload:
                    actor.tell(WriteMessageFailure(repr_, failure, iid),
                               self.self_ref)
            return
        actor.tell(WriteMessagesSuccessful(iid), self.self_ref)
        for aw, rejection in results:
            for repr_ in aw.payload:
                r, _ = _untag(repr_)
                if rejection is None:
                    actor.tell(WriteMessageSuccess(r, iid), self.self_ref)
                else:
                    actor.tell(WriteMessageRejected(r, rejection, iid),
                               self.self_ref)

    def _replay(self, msg: ReplayMessages) -> None:
        actor = msg.persistent_actor

        def emit(r: PersistentRepr) -> None:
            if self.adapters.is_empty:
                actor.tell(ReplayedMessage(r), self.self_ref)
                return
            for adapted in self._adapt_from_journal(r):
                actor.tell(ReplayedMessage(adapted), self.self_ref)
        try:
            self.plugin.replay(
                msg.persistence_id, msg.from_sequence_nr, msg.to_sequence_nr,
                msg.max, emit)
            highest = self.plugin.highest_sequence_nr(
                msg.persistence_id, msg.from_sequence_nr)
            actor.tell(RecoverySuccess(highest), self.self_ref)
        except Exception as e:  # noqa: BLE001
            actor.tell(ReplayMessagesFailure(str(e)), self.self_ref)
