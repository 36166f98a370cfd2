"""Persistence query: streams of persisted events.

A copy of `akka_tpu/persistence/query.py` at commit 1001e26 (host code, no
jax; the port keeps its own copy of every module it needs).

Reference parity: akka-persistence-query/src/main/scala/akka/persistence/
query/scaladsl/ — CurrentEventsByPersistenceIdQuery.scala:14,
EventsByPersistenceIdQuery, EventsByTagQuery.scala:14, PersistenceIdsQuery;
query/EventEnvelope.scala; Offset (Sequence). The leveldb ReadJournal impl
(persistence-query/.../journal/leveldb/) reads through the journal store and
subscribes for live updates — here the ReadJournal reads through the
JournalPlugin and registers a listener for the live variants.

`current_*` queries return plain lists (the finite snapshot); `events_by_*`
live queries return an EventStream handle: iterate, poll, or attach a
callback; close() detaches. The reference has no EventStream.to_source
yet; neither package bridges an EventStream into the stream DSL.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable, List, Optional

from ..actor.system import ActorSystem
from .journal import JournalPlugin
from .messages import PersistentRepr, Tagged
from .persistence import Persistence


@dataclass(frozen=True)
class Sequence:
    """Offset (reference: query/Offset.scala)."""
    value: int


NoOffset = Sequence(0)


@dataclass(frozen=True)
class EventEnvelope:
    """(reference: query/EventEnvelope.scala)"""
    offset: Sequence
    persistence_id: str
    sequence_nr: int
    event: Any
    timestamp: float = 0.0


class EventStream:
    """Live query handle: buffered push stream with callback or poll access."""

    def __init__(self, detach: Callable[[], None]):
        self._detach = detach
        self._lock = threading.Lock()
        self._buf: List[EventEnvelope] = []
        self._cv = threading.Condition(self._lock)
        self._callback: Optional[Callable[[EventEnvelope], None]] = None
        self._closed = False

    def _push(self, env: EventEnvelope) -> None:
        cb = None
        with self._cv:
            if self._closed:
                return
            if self._callback is not None:
                cb = self._callback
            else:
                self._buf.append(env)
                self._cv.notify_all()
        if cb is not None:
            cb(env)

    def on_event(self, cb: Callable[[EventEnvelope], None]) -> "EventStream":
        with self._cv:
            self._callback = cb
            pending, self._buf = self._buf, []
        for env in pending:
            cb(env)
        return self

    def poll(self, timeout: Optional[float] = None) -> Optional[EventEnvelope]:
        with self._cv:
            if not self._buf:
                self._cv.wait(timeout)
            if self._buf:
                return self._buf.pop(0)
            return None

    def drain(self) -> List[EventEnvelope]:
        with self._cv:
            out, self._buf = self._buf, []
            return out

    def close(self) -> None:
        with self._cv:
            self._closed = True
        self._detach()


class ReadJournal:
    """Obtain via PersistenceQuery.get(system).read_journal_for(plugin_id)."""

    def __init__(self, system: ActorSystem, plugin: JournalPlugin):
        self.system = system
        self.plugin = plugin

    # -- current (finite) queries --------------------------------------------
    def current_persistence_ids(self) -> List[str]:
        return self.plugin.persistence_ids()

    def current_events_by_persistence_id(
            self, persistence_id: str, from_sequence_nr: int = 0,
            to_sequence_nr: int = 2**63 - 1) -> List[EventEnvelope]:
        out: List[EventEnvelope] = []

        def cb(r: PersistentRepr) -> None:
            out.append(self._envelope(r))

        self.plugin.replay(persistence_id, max(1, from_sequence_nr),
                           to_sequence_nr, 2**63 - 1, cb)
        return out

    def current_events_by_tag(self, tag: str,
                              offset: Sequence = NoOffset
                              ) -> List[EventEnvelope]:
        return [EventEnvelope(Sequence(off), r.persistence_id, r.sequence_nr,
                              r.payload, r.timestamp)
                for off, r in self.plugin.events_by_tag(tag, offset.value)]

    # -- live queries ---------------------------------------------------------
    def events_by_persistence_id(self, persistence_id: str,
                                 from_sequence_nr: int = 0) -> EventStream:
        """Current events then live updates, gap-free: the listener is
        registered BEFORE the current read, events arriving in between are
        buffered and flushed after it, deduped by sequence nr."""
        lock = threading.Lock()
        emitted: set = set()
        buffered: List[PersistentRepr] = []
        live = [False]
        min_nr = max(1, from_sequence_nr)

        def listener(r: PersistentRepr) -> None:
            if r.persistence_id != persistence_id or r.sequence_nr < min_nr:
                return
            with lock:
                if r.sequence_nr in emitted:
                    return
                if not live[0]:
                    buffered.append(r)
                    return
                emitted.add(r.sequence_nr)
            stream._push(self._envelope(r))

        stream = EventStream(lambda: self.plugin.remove_listener(listener))
        self.plugin.add_listener(listener)
        current = self.current_events_by_persistence_id(persistence_id,
                                                        from_sequence_nr)
        with lock:
            for env in current:
                emitted.add(env.sequence_nr)
        for env in current:
            stream._push(env)
        # flush whatever arrived during the current read, in order, until a
        # pass finds nothing new — ONLY then go live, so a concurrent write
        # can never be pushed ahead of earlier events
        while True:
            with lock:
                pending = sorted((r for r in buffered
                                  if r.sequence_nr not in emitted),
                                 key=lambda r: r.sequence_nr)
                for r in pending:
                    emitted.add(r.sequence_nr)
                if not pending:
                    live[0] = True
                    buffered.clear()
                    break
            for r in pending:
                stream._push(self._envelope(r))
        return stream

    def events_by_tag(self, tag: str, offset: Sequence = NoOffset
                      ) -> EventStream:
        """Gap-free live tag query; tracks the highest emitted offset so each
        notification only reads NEW tag-index entries (not the whole index)."""
        lock = threading.Lock()
        last = [offset.value]
        live = [False]

        def new_envelopes() -> List[EventEnvelope]:
            # call under lock; tag index rows hold untagged payloads
            out = []
            for off, r in self.plugin.events_by_tag(tag, last[0]):
                last[0] = max(last[0], off)
                out.append(EventEnvelope(Sequence(off), r.persistence_id,
                                         r.sequence_nr, r.payload,
                                         r.timestamp))
            return out

        def listener(_r: PersistentRepr) -> None:
            with lock:
                if not live[0]:
                    return  # the initial read covers it (offset-tracked)
                out = new_envelopes()
            for env in out:
                stream._push(env)

        stream = EventStream(lambda: self.plugin.remove_listener(listener))
        self.plugin.add_listener(listener)
        # loop until a read finds nothing new, then flip live under the same
        # lock the listener takes — no window for out-of-order emission
        while True:
            with lock:
                batch = new_envelopes()
                if not batch:
                    live[0] = True
                    break
            for env in batch:
                stream._push(env)
        return stream

    @staticmethod
    def _envelope(r: PersistentRepr) -> EventEnvelope:
        payload = r.payload.payload if isinstance(r.payload, Tagged) else r.payload
        return EventEnvelope(Sequence(r.sequence_nr), r.persistence_id,
                             r.sequence_nr, payload, r.timestamp)


class PersistenceQuery:
    """(reference: PersistenceQuery.scala extension)"""

    _instances = {}
    _lock = threading.Lock()

    @staticmethod
    def get(system: ActorSystem) -> "PersistenceQuery":
        with PersistenceQuery._lock:
            inst = PersistenceQuery._instances.get(system)
            if inst is None:
                inst = PersistenceQuery._instances[system] = \
                    PersistenceQuery(system)
                system.register_on_termination(
                    lambda: PersistenceQuery._instances.pop(system, None))
            return inst

    def __init__(self, system: ActorSystem):
        self.system = system

    def read_journal_for(self, plugin_id: str = "") -> ReadJournal:
        plugin = Persistence.get(self.system).journal_plugin_for(plugin_id)
        return ReadJournal(self.system, plugin)
