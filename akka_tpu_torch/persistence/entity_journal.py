"""Per-entity event journal with wave-granular group commit.

A copy of `akka_tpu/persistence/entity_journal.py`, record format
unchanged, so either package reads the other's journal. Each ok ask wave
emits per-entity events (entity_id, op, value) that are appended as ONE
group-committed record at the wave's resolve boundary, before any ack
leaves:

    {"step": S, "events": [(entity_id, op, value), ...],
     "snaps": {entity_id: total},
     "replies": [(tenant, request_id, status, value), ...]}

`replies` is the gateway's dedup frontier: the ok reply of every
idempotent-session request resolved in the wave rides the same record
(and fsync) as the events it acknowledges, so kill -9 + restore replays it
(`replies()`) and a retry after restore gets the cached reply. `snaps` are
per-entity post-wave totals piggybacked into the same write once an
entity has accumulated `snapshot_every` events since its last snapshot
(the reference snaps the total at the crossing event instead, which
loses the entity's later events of the same wave on replay). Replay folds
oldest to newest: a snap resets the entity's total, events add on top
(within a record, events precede snaps, since a snap is the post-wave
total). The fold is kept live in memory (`totals()`), so a restore reads
the acked frontier without touching the device.

Group commit counts waves: every append flush()es (a process kill -9
loses nothing), and fsync lands every `fsync_every_n` waves (1 = one fsync
per ask wave). `per_event_fsync=True` is the A/B leg: one record + fsync
per event. `compact()` rewrites the log as one snap-all record (tmp +
fsync + replace); the region calls it at checkpoint(), and the journal
compacts itself once `compact_every` events have accumulated.

`registry` takes a metrics registry (event/metrics.py
`MetricsRegistry`, or anything with `histogram(name, help)` giving
`observe`/`observe_many` and a `step` attribute) and may be None, as
may the flight recorder (event/flight_recorder.py).
"""

from __future__ import annotations

import os
import pickle
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .journal import repair_record_log, scan_record_log

__all__ = ["EntityJournal", "OP_ADD"]

OP_ADD = 0  # fold: total += value (the counter/additive entity family)


def _fold(total: float, op: int, value: float) -> float:
    # one op family today; the op byte is journaled so richer entity
    # state machines can extend the fold without a format change
    return total + value if op == OP_ADD else total


class EntityJournal:
    """Append-only per-entity event log, one file, group-committed per
    ask wave. Thread-safe; the in-memory fold (`totals`) is the acked
    frontier: an event is appended only after its wave saw the ok reply,
    and fsync'd before the ack leaves the gateway."""

    def __init__(self, path: str, flight_recorder: Optional[Any] = None,
                 fsync_every_n: int = 1, snapshot_every: int = 64,
                 compact_every: int = 8192, registry=None,
                 max_replies: int = 1 << 16, writer: bool = True):
        self.path = path
        # writer=False (a port addition): a follower of another process's
        # or rank's journal (a ranked region's ranks other than 0). It
        # folds the file at open and every appended wave in memory, and
        # never opens, repairs or writes the file
        self.writer = bool(writer)
        self._closed = False
        self.flight_recorder = flight_recorder
        self.fsync_every_n = max(1, int(fsync_every_n))
        self.snapshot_every = max(1, int(snapshot_every))
        self.compact_every = max(self.snapshot_every, int(compact_every))
        self.max_replies = max(1, int(max_replies))
        self._since_fsync = 0
        self._events_since_compact = 0
        self._lock = threading.Lock()
        self._totals: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}  # events since entity's last snap
        # insertion-ordered dedup frontier: (tenant, id) -> (status, value)
        self._replies: Dict[Tuple[str, int], Tuple[int, float]] = {}
        self._last_step = 0
        self._stats = {"waves": 0, "events": 0, "snaps": 0, "fsyncs": 0,
                       "compactions": 0, "replies": 0}
        self._h_batch = self._h_fsync = self._h_replay = None
        self._registry = registry
        if registry is not None:
            self._h_batch = registry.histogram(
                "entity_journal_batch_size",
                "entity events group-committed per ask wave")
            self._h_fsync = registry.histogram(
                "entity_journal_fsync_ms",
                "wall ms of the wave-boundary group-commit fsync")
            self._h_replay = registry.histogram(
                "entity_replay_events",
                "events folded per entity during restore replay")
        self.truncated_bytes = 0
        self._fh = None
        if self.writer:
            parent = os.path.dirname(os.path.abspath(path))
            os.makedirs(parent, exist_ok=True)
            self.truncated_bytes = repair_record_log(path, flight_recorder)
            self._fh = open(path, "ab")
        self._fold_existing()

    # -- open-time fold ------------------------------------------------------
    def _fold_existing(self) -> None:
        """Replay the on-disk log into the live fold (snapshot + event
        tail per entity) at open, so a fresh process's journal answers
        `totals()` before any device work."""
        replayed: Dict[str, int] = {}
        for _end, rec in scan_record_log(self.path):
            self._apply_record(rec, replayed)
        if replayed and self._h_replay is not None:
            step = self._registry.step if self._registry else None
            self._h_replay.observe_many(
                [float(n) for n in replayed.values()], step=step)
        self._replayed_events = replayed

    def _apply_record(self, rec: Dict[str, Any],
                      replayed: Optional[Dict[str, int]] = None) -> None:
        self._last_step = max(self._last_step, int(rec.get("step", 0)))
        for eid, op, value in rec.get("events", ()):
            self._totals[eid] = _fold(self._totals.get(eid, 0.0),
                                      int(op), float(value))
            self._counts[eid] = self._counts.get(eid, 0) + 1
            if replayed is not None:
                replayed[eid] = replayed.get(eid, 0) + 1
        # snaps are post-wave totals: they override the event fold above
        for eid, total in (rec.get("snaps") or {}).items():
            self._totals[eid] = float(total)
            self._counts[eid] = 0
        for tenant, rid, status, value in rec.get("replies", ()):
            self._fold_reply((str(tenant), int(rid)),
                             int(status), float(value))

    def _fold_reply(self, key: Tuple[str, int], status: int,
                    value: float) -> None:
        # re-insert moves the key to the newest end (dict order)
        self._replies.pop(key, None)
        self._replies[key] = (status, value)
        while len(self._replies) > self.max_replies:
            del self._replies[next(iter(self._replies))]

    # -- write side ----------------------------------------------------------
    def append_wave(self, step: int,
                    events: Sequence[Tuple[str, int, float]],
                    per_event_fsync: bool = False,
                    replies: Optional[
                        Sequence[Tuple[str, int, int, float]]] = None
                    ) -> int:
        """Group-commit one ask wave's ok events: fold them into the live
        totals, piggyback a snapshot for every entity that crossed
        `snapshot_every` events, and write it all as ONE record. Returns
        the number of events committed. `replies`: the wave's resolved
        idempotent-session replies `(tenant, request_id, status, value)`,
        in the same record; a wave of pure gets writes a replies-only
        record so the reply cache survives a crash."""
        events = [(str(e), int(op), float(v)) for e, op, v in events]
        replies = [(str(t), int(r), int(st), float(v))
                   for t, r, st, v in (replies or ())]
        if not events and not replies:
            return 0
        with self._lock:
            if self._closed:
                raise ValueError("EntityJournal is closed")
            crossed = set()
            for eid, op, value in events:
                self._totals[eid] = _fold(self._totals.get(eid, 0.0),
                                          op, value)
                n = self._counts.get(eid, 0) + 1
                if n >= self.snapshot_every:
                    crossed.add(eid)
                self._counts[eid] = n
            # a snap is the entity's POST-WAVE total (replay folds the
            # record's events, then lets its snaps override them): an
            # entity that crosses snapshot_every before a later event of
            # the same wave must not snap the total in between
            snaps: Dict[str, float] = {}
            for eid in crossed:
                snaps[eid] = self._totals[eid]
                self._counts[eid] = 0
            for tenant, rid, status, value in replies:
                self._fold_reply((tenant, rid), status, value)
            if per_event_fsync:
                for eid, op, value in events:
                    self._write_record({"step": int(step),
                                        "events": [(eid, op, value)],
                                        "snaps": {}})
                    self._fsync_locked()
                if replies:
                    self._write_record({"step": int(step), "events": [],
                                        "snaps": {}, "replies": replies})
                    self._fsync_locked()
            else:
                rec = {"step": int(step), "events": events, "snaps": snaps}
                if replies:
                    rec["replies"] = replies
                self._write_record(rec)
                self._since_fsync += 1
                if self._since_fsync >= self.fsync_every_n:
                    self._fsync_locked()
            self._stats["waves"] += 1
            self._stats["events"] += len(events)
            self._stats["snaps"] += len(snaps)
            self._stats["replies"] += len(replies)
            self._events_since_compact += len(events)
            need_compact = self._events_since_compact >= self.compact_every
        step_stamp = self._registry.step if self._registry else None
        if self._h_batch is not None:
            self._h_batch.observe(float(len(events)), step=step_stamp)
        if self.flight_recorder is not None and getattr(
                self.flight_recorder, "enabled", False):
            self.flight_recorder.event(
                "entity_events_committed", n=len(events),
                snaps=len(snaps), step=int(step))
        if need_compact:
            self.compact()
        return len(events)

    def _write_record(self, rec: Dict[str, Any]) -> None:
        if not self.writer:
            return
        blob = pickle.dumps(rec, protocol=4)
        self._fh.write(len(blob).to_bytes(8, "little"))
        self._fh.write(blob)
        self._fh.flush()

    def _fsync_locked(self) -> None:
        if not self.writer:
            self._since_fsync = 0
            return
        t0 = time.perf_counter()
        os.fsync(self._fh.fileno())
        self._since_fsync = 0
        self._stats["fsyncs"] += 1
        if self._h_fsync is not None:
            self._h_fsync.observe(
                (time.perf_counter() - t0) * 1e3,
                step=self._registry.step if self._registry else None)

    def sync(self) -> None:
        """Force the deferred group-commit fsync (wave-batch boundary)."""
        with self._lock:
            if self._fh is not None and self._since_fsync:
                self._fh.flush()
                self._fsync_locked()

    # -- read side -----------------------------------------------------------
    def totals(self) -> Dict[str, float]:
        """The durable acked frontier: entity_id -> folded total
        (snapshot + event tail). Restore writes this back into the
        device rows."""
        with self._lock:
            return dict(self._totals)

    def replayed_events(self) -> Dict[str, int]:
        """Per-entity event-tail lengths folded by the open-time replay
        (empty for a journal born in this process)."""
        return dict(self._replayed_events)

    def replies(self) -> List[Tuple[str, int, int, float]]:
        """The durable dedup frontier in arrival order:
        `(tenant, request_id, status, value)` per remembered reply, what
        the gateway feeds `ReplyCacheTable.load` on restore."""
        with self._lock:
            return [(t, r, st, v)
                    for (t, r), (st, v) in self._replies.items()]

    def records(self) -> List[Dict[str, Any]]:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
        return [rec for _end, rec in scan_record_log(self.path)]

    def stats(self) -> Dict[str, float]:
        with self._lock:
            out = {k: float(v) for k, v in self._stats.items()}
            out["entities"] = float(len(self._totals))
            out["cached_replies"] = float(len(self._replies))
            out["bytes"] = float(os.path.getsize(self.path)
                                 if os.path.exists(self.path) else 0)
        return out

    # -- maintenance ---------------------------------------------------------
    def compact(self) -> int:
        """Rewrite the log as ONE snap-all record covering the live fold.
        Atomic: tmp + fsync + replace, then the append handle reopens.
        Returns the compacted file's entity count."""
        with self._lock:
            if self._closed:
                raise ValueError("EntityJournal is closed")
            if not self.writer:
                self._events_since_compact = 0
                self._counts = {eid: 0 for eid in self._totals}
                return len(self._totals)
            rec = {"step": int(self._last_step), "events": [],
                   "snaps": dict(self._totals)}
            if self._replies:
                rec["replies"] = [(t, r, st, v) for (t, r), (st, v)
                                  in self._replies.items()]
            blob = pickle.dumps(rec, protocol=4)
            tmp = self.path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(len(blob).to_bytes(8, "little"))
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            self._fh.close()
            os.replace(tmp, self.path)
            self._fh = open(self.path, "ab")
            self._since_fsync = 0  # the rewrite was fsync'd whole
            self._events_since_compact = 0
            self._counts = {eid: 0 for eid in self._totals}
            self._stats["compactions"] += 1
            return len(self._totals)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            if self._fh is not None:
                if self._since_fsync:
                    self._fh.flush()
                    os.fsync(self._fh.fileno())
                    self._since_fsync = 0
                self._fh.close()
                self._fh = None
