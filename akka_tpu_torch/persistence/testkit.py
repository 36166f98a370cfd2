"""Persistence testkit: programmable-failure journal + TCK compliance suites.

A copy of `akka_tpu/persistence/testkit.py` at commit 1001e26 (host code, no
jax; the port keeps its own copy of every module it needs).

Reference parity: akka-persistence-testkit/.../PersistenceTestKitPlugin.scala
+ ProcessingPolicy.scala (accept / reject / fail the nth write, pass-all,
fail-next-n — policies swappable at runtime), and akka-persistence-tck's
reusable plugin compliance specs (persistence-tck/.../journal/JournalSpec.scala,
snapshot/SnapshotStoreSpec.scala): any JournalPlugin / SnapshotPlugin
implementation can be run through journal_tck()/snapshot_store_tck().
"""

from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional

from .journal import InMemJournal, JournalPlugin, _MemStore
from .messages import (AtomicWrite, PersistentRepr, SelectedSnapshot,
                       SnapshotMetadata, SnapshotSelectionCriteria)
from .snapshot import SnapshotPlugin


# -- processing policies (reference: ProcessingPolicy.scala) -----------------

class ProcessingPolicy:
    """Decide the fate of each write: "pass" | ("reject", msg) | ("fail", msg)."""

    def decide(self, persistence_id: str, batch: AtomicWrite):
        return "pass"


class PassAll(ProcessingPolicy):
    pass


class FailNextN(ProcessingPolicy):
    def __init__(self, n: int, cause: str = "injected failure"):
        self.n = n
        self.cause = cause
        self._lock = threading.Lock()

    def decide(self, persistence_id, batch):
        with self._lock:
            if self.n > 0:
                self.n -= 1
                return ("fail", self.cause)
        return "pass"


class RejectNextN(ProcessingPolicy):
    def __init__(self, n: int, cause: str = "injected rejection"):
        self.n = n
        self.cause = cause
        self._lock = threading.Lock()

    def decide(self, persistence_id, batch):
        with self._lock:
            if self.n > 0:
                self.n -= 1
                return ("reject", self.cause)
        return "pass"


class FailIf(ProcessingPolicy):
    def __init__(self, predicate: Callable[[str, AtomicWrite], bool],
                 cause: str = "injected failure"):
        self.predicate = predicate
        self.cause = cause

    def decide(self, persistence_id, batch):
        if self.predicate(persistence_id, batch):
            return ("fail", self.cause)
        return "pass"


class PersistenceTestKitJournal(InMemJournal):
    """In-mem journal with a swappable write policy (reference:
    PersistenceTestKitPlugin)."""

    def __init__(self, store: Optional[_MemStore] = None):
        super().__init__(store)
        self.policy: ProcessingPolicy = PassAll()

    def set_policy(self, policy: ProcessingPolicy) -> None:
        self.policy = policy

    def reset_policy(self) -> None:
        self.policy = PassAll()

    def write_atomic(self, write: AtomicWrite):
        decision = self.policy.decide(write.persistence_id, write)
        if decision == "pass":
            return super().write_atomic(write)
        kind, cause = decision
        if kind == "reject":
            return cause
        raise IOError(cause)


# -- TCK (reference: persistence-tck JournalSpec/SnapshotStoreSpec) ----------

def journal_tck(make_plugin: Callable[[], JournalPlugin]) -> None:
    """Run the journal compliance suite against a fresh plugin instance.
    Raises AssertionError on the first violated contract."""

    def reprs(pid: str, nrs: List[int]) -> AtomicWrite:
        return AtomicWrite(tuple(
            PersistentRepr(f"ev-{n}", n, pid) for n in nrs))

    # 1. write + replay round trip, order preserved
    j = make_plugin()
    assert j.write_atomic(reprs("p1", [1, 2, 3])) is None
    assert j.write_atomic(reprs("p1", [4, 5])) is None
    got: List[PersistentRepr] = []
    j.replay("p1", 1, 2**63 - 1, 2**63 - 1, got.append)
    assert [r.sequence_nr for r in got] == [1, 2, 3, 4, 5], got
    assert [r.payload for r in got] == [f"ev-{n}" for n in range(1, 6)]

    # 2. range + max bounds
    got.clear()
    j.replay("p1", 2, 4, 2**63 - 1, got.append)
    assert [r.sequence_nr for r in got] == [2, 3, 4]
    got.clear()
    j.replay("p1", 1, 2**63 - 1, 2, got.append)
    assert [r.sequence_nr for r in got] == [1, 2]

    # 3. highest sequence nr, also after delete
    assert j.highest_sequence_nr("p1", 0) == 5
    j.delete_to("p1", 3)
    got.clear()
    j.replay("p1", 1, 2**63 - 1, 2**63 - 1, got.append)
    assert [r.sequence_nr for r in got] == [4, 5], \
        "logically deleted events must not replay"
    assert j.highest_sequence_nr("p1", 0) == 5, \
        "delete must NOT lower the highest sequence nr"

    # 4. per-id isolation
    assert j.write_atomic(reprs("p2", [1])) is None
    got.clear()
    j.replay("p2", 1, 2**63 - 1, 2**63 - 1, got.append)
    assert [r.sequence_nr for r in got] == [1]

    # 5. unknown id: empty replay, highest == 0
    got.clear()
    j.replay("nope", 1, 2**63 - 1, 2**63 - 1, got.append)
    assert got == []
    assert j.highest_sequence_nr("nope", 0) == 0


def snapshot_store_tck(make_plugin: Callable[[], SnapshotPlugin]) -> None:
    s = make_plugin()
    md = [SnapshotMetadata("p1", n, float(10 + n)) for n in (1, 5, 9)]
    for m in md:
        s.save(m, {"state": m.sequence_nr})

    # newest matching snapshot wins
    sel = s.load("p1", SnapshotSelectionCriteria.latest())
    assert sel is not None and sel.metadata.sequence_nr == 9

    # criteria bounds
    sel = s.load("p1", SnapshotSelectionCriteria(max_sequence_nr=6))
    assert sel is not None and sel.metadata.sequence_nr == 5
    sel = s.load("p1", SnapshotSelectionCriteria(max_sequence_nr=0))
    assert sel is None

    # overwrite same (seq, ts)
    s.save(md[2], {"state": "new"})
    sel = s.load("p1", SnapshotSelectionCriteria.latest())
    assert sel is not None and sel.snapshot == {"state": "new"}

    # single delete
    s.delete(md[2])
    sel = s.load("p1", SnapshotSelectionCriteria.latest())
    assert sel is not None and sel.metadata.sequence_nr == 5

    # delete matching criteria
    s.delete_matching("p1", SnapshotSelectionCriteria(max_sequence_nr=5))
    assert s.load("p1", SnapshotSelectionCriteria.latest()) is None

    # unknown id
    assert s.load("zzz", SnapshotSelectionCriteria.latest()) is None
