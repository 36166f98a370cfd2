"""Write-ahead tell journal of the batched runtime.

A copy of `akka_tpu/persistence/tell_journal.py`, record format unchanged
(so each package replays the other's WAL). Every host-staged batch
(`tell` / `seed_inbox`) is appended to an fsync'd, length-prefixed record
log BEFORE it is staged toward the device, tagged with the host-side
dispatched-step counter at staging time. Recovery = load the latest slab
snapshot (step S), then replay the records with step >= S: each record is
re-staged once the replaying system has been stepped to the record's
counter, so the batch is flushed into the same step that delivered it
originally. The steps between records are re-run.

Why `step >= S` is exactly right: staging and stepping serialize on the
system lock, and a batch staged while the counter reads c is flushed by
dispatch c+1. A snapshot at quiescent step S therefore holds every batch
with c <= S-1 and none with c >= S; replaying the latter (and only the
latter) rebuilds the host staging list as it was. `seed_inbox` writes
device rows directly, so a seed record at exactly step S may already be in
the snapshot: replaying it writes the same rows with the same values.

Records hold numpy arrays only (host copies, never torch tensors), so the
JAX package can read a WAL the port wrote. Torn tails (kill -9 mid-append)
are truncated on open (journal.repair_record_log).

A journal opened with `writer=False` (a port addition: the ranks other
than 0 of a ranked region, whose rank 0 writes the one WAL) never opens,
repairs or writes the file: appends and compactions are no-ops (a
compaction keeps 0 records), and `records()` reads what the writer
wrote. `replay_journal` reads every
record before it steps, so a writer's appends after the replay began
are not replayed by a rank that is behind.
"""

from __future__ import annotations

import os
import pickle
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np

from .journal import repair_record_log, scan_record_log

KIND_TELL = "tell"
KIND_SEED = "seed"

__all__ = ["TellJournal", "replay_journal", "KIND_TELL", "KIND_SEED"]


def _host(x) -> np.ndarray:
    """A contiguous numpy copy of x (a torch tensor is brought to the host
    first: records must never pickle a tensor)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(x))


class TellJournal:
    """Append-only WAL of staged tell batches, one file.

    Records are dicts {step, kind, dst, mtype, payload} with numpy values.
    Appends are atomic at the record: 8-byte little-endian length prefix +
    pickle + flush, and an fsync every `fsync_every_n` appends.
    """

    def __init__(self, path: str, flight_recorder: Optional[Any] = None,
                 fsync_every_n: int = 1, writer: bool = True):
        self.path = path
        self.writer = bool(writer)
        self.flight_recorder = flight_recorder
        # group commit: fsync once per n appends. Every append still
        # flush()es to the OS page cache, so a process crash (kill -9)
        # loses nothing either way; n only widens the machine-crash
        # exposure to at most n-1 records
        self.fsync_every_n = max(1, int(fsync_every_n))
        self._since_fsync = 0
        self._lock = threading.Lock()
        self.truncated_bytes = 0
        self._fh = None
        if self.writer:
            parent = os.path.dirname(os.path.abspath(path))
            os.makedirs(parent, exist_ok=True)
            self.truncated_bytes = repair_record_log(path, flight_recorder)
            self._fh = open(path, "ab")

    # -- write side ----------------------------------------------------------
    def append(self, step: int, kind: str, dst, payload, mtype) -> None:
        if not self.writer:
            return
        rec: Dict[str, Any] = {
            "step": int(step),
            "kind": kind,
            "dst": _host(dst),
            "mtype": _host(mtype),
            "payload": _host(payload),
        }
        blob = pickle.dumps(rec, protocol=4)
        with self._lock:
            if self._fh is None:
                raise ValueError("TellJournal is closed")
            self._fh.write(len(blob).to_bytes(8, "little"))
            self._fh.write(blob)
            self._fh.flush()
            self._since_fsync += 1
            if self._since_fsync >= self.fsync_every_n:
                os.fsync(self._fh.fileno())
                self._since_fsync = 0

    def sync(self) -> None:
        """Force the deferred group-commit fsync (batch boundary)."""
        with self._lock:
            if self._fh is not None and self._since_fsync:
                self._fh.flush()
                os.fsync(self._fh.fileno())
                self._since_fsync = 0

    # -- read side -----------------------------------------------------------
    def records(self) -> Iterator[Dict[str, Any]]:
        """Iterate intact records oldest-first (reads the file; safe while
        the append handle is open, since appends flush per record)."""
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
        for _end, obj in scan_record_log(self.path):
            yield obj

    # -- maintenance ---------------------------------------------------------
    def compact(self, before_step: int) -> int:
        """Drop records with step < before_step (covered by a snapshot at
        that step). Rewrites atomically: tmp + fsync + replace, then
        reopens the append handle. Returns the records kept. The read and
        the rewrite hold the append lock together, so an append from
        another thread (the sentinel compacts on its snapshot writer
        while tells go on) lands before the read or after the reopen,
        never in between, where the replace would lose it (the
        reference reads before it takes the lock)."""
        if not self.writer:
            return 0  # a follower keeps no records of its own
        tmp = self.path + ".tmp"
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
            kept = [obj for _end, obj in scan_record_log(self.path)
                    if int(obj["step"]) >= int(before_step)]
            with open(tmp, "wb") as f:
                for rec in kept:
                    blob = pickle.dumps(rec, protocol=4)
                    f.write(len(blob).to_bytes(8, "little"))
                    f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            if self._fh is not None:
                self._fh.close()
            os.replace(tmp, self.path)
            self._fh = open(self.path, "ab")
            self._since_fsync = 0  # the rewrite was fsync'd whole
        return len(kept)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                if self._since_fsync:
                    self._fh.flush()
                    os.fsync(self._fh.fileno())
                    self._since_fsync = 0
                self._fh.close()
                self._fh = None


def replay_journal(system, journal: TellJournal) -> int:
    """Replay the journaled batches recorded at or after the system's
    restored step counter, stepping the system forward so each batch is
    staged at the counter it was staged at originally. Re-journaling is
    suspended meanwhile (the records already exist). Returns the final
    host step counter; batches staged but not flushed at the crash are
    left staged, as they were."""
    start = system._host_step
    saved, system.tell_journal = system.tell_journal, None
    try:
        for rec in list(journal.records()):
            step = int(rec["step"])
            if step < start:
                continue
            while system._host_step < step:
                system.step()
            if rec["kind"] == KIND_SEED:
                system.seed_inbox(rec["dst"], rec["payload"], rec["mtype"])
            else:
                system.tell(rec["dst"], rec["payload"], rec["mtype"])
    finally:
        system.tell_journal = saved
    return system._host_step
