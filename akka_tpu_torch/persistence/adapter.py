"""Event/snapshot adapter seams: domain model <-> journal model.

A copy of `akka_tpu/persistence/adapter.py` at commit 1001e26 (host code, no
jax; the port keeps its own copy of every module it needs).

Reference parity: akka-persistence/src/main/scala/akka/persistence/journal/
EventAdapter.scala:21 (manifest/toJournal/fromJournal with EventSeq —
0..N domain events per stored record, the read-side upcasting hook),
EventAdapters.scala:25 (the per-journal registry binding event classes to
adapters, most-specific class wins), and akka-persistence-typed/src/main/
scala/akka/persistence/typed/SnapshotAdapter.scala:14 (state <-> stored
snapshot mapping, wired into EventSourcedBehavior).

The adapter layer COMPOSES with the versioned serializer
(serialization/versioned.py): adapters map between in-memory models before
anything is serialized; schema migrations rewrite serialized payloads. A
tagging adapter returns `Tagged(journal_event, tags)` and the journal's
untag path (journal.py _untag) handles it like the typed tagger's output.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Type


class EventSeq:
    """What fromJournal returns: zero, one or many domain events for one
    stored record (reference: EventAdapter.scala EventSeq)."""

    __slots__ = ("events",)

    def __init__(self, events: Iterable[Any]):
        self.events: List[Any] = list(events)

    @staticmethod
    def empty() -> "EventSeq":
        return EventSeq(())

    @staticmethod
    def single(event: Any) -> "EventSeq":
        return EventSeq((event,))

    @staticmethod
    def many(events: Iterable[Any]) -> "EventSeq":
        return EventSeq(events)


class EventAdapter:
    """domain event <-> journal model (reference: EventAdapter.scala:21).

    Override any subset: `to_journal` for the write side (wrap, detach the
    domain model, attach tags), `from_journal` for the read side (unwrap,
    upcast 1->N), `manifest` to stamp a type hint stored alongside."""

    def manifest(self, event: Any) -> str:
        return ""

    def to_journal(self, event: Any) -> Any:
        return event

    def from_journal(self, event: Any, manifest: str) -> EventSeq:
        return EventSeq.single(event)


class IdentityEventAdapter(EventAdapter):
    """(reference: IdentityEventAdapter)"""


_IDENTITY = IdentityEventAdapter()


class EventAdapters:
    """Per-journal adapter registry (reference: EventAdapters.scala:25).

    bindings: {event_class: adapter}. Lookup walks the class MRO so the
    most specific binding wins; unbound classes get the identity adapter.
    Write-side lookup uses the DOMAIN event's class; read-side lookup uses
    the stored JOURNAL model's class."""

    def __init__(self, bindings: Optional[Dict[Type, EventAdapter]] = None):
        self._bindings: Dict[Type, EventAdapter] = dict(bindings or {})
        self._cache: Dict[Type, EventAdapter] = {}

    def register(self, event_class: Type, adapter: EventAdapter) -> None:
        self._bindings[event_class] = adapter
        self._cache.clear()

    def get(self, event_class: Type) -> EventAdapter:
        hit = self._cache.get(event_class)
        if hit is not None:
            return hit
        for cls in event_class.__mro__:
            adapter = self._bindings.get(cls)
            if adapter is not None:
                self._cache[event_class] = adapter
                return adapter
        self._cache[event_class] = _IDENTITY
        return _IDENTITY

    @property
    def is_empty(self) -> bool:
        return not self._bindings


class SnapshotAdapter:
    """state <-> stored snapshot (reference: typed/SnapshotAdapter.scala:14).
    Override `to_journal` to detach/compress the stored form and
    `from_journal` to upcast old snapshots into the current state type."""

    def to_journal(self, state: Any) -> Any:
        return state

    def from_journal(self, from_journal: Any) -> Any:
        return from_journal
