"""The CRDT library: state-based convergent replicated data types.

A copy of `akka_tpu/ddata/crdt.py` at commit c056b95 (host code, no jax;
the port keeps its own copy of every module it needs).

Reference parity (akka-distributed-data/src/main/scala/akka/cluster/ddata/):
GCounter.scala, PNCounter.scala, GSet.scala, ORSet.scala (add-wins via
per-element "dots" = version vectors), ORMap.scala, ORMultiMap.scala,
PNCounterMap.scala, LWWMap.scala, LWWRegister.scala, Flag.scala.

Contracts (reference: ReplicatedData.scala):
- `merge(other)` is commutative, associative, idempotent.
- DeltaReplicatedData additionally accumulates a `delta` between replicator
  ticks (`delta`, `reset_delta`, `merge_delta`) so gossip can ship small
  updates (delta-CRDT, Replicator.scala:98-99, DeltaPropagationSelector.scala).
- RemovedNodePruning lets the leader collapse a removed node's contributions
  into a surviving node (`needs_pruning_from`, `prune`).

Mutators take a `node` (the SelfUniqueAddress string) exactly like the
reference's implicit `SelfUniqueAddress`.

Tensor note: GCounter/PNCounter merge is elementwise max over per-node rows —
the psum-shaped bulk form lives in akka_tpu_torch/ddata/tensor.py; these host types
are the unit of the Replicator control plane.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, FrozenSet, Generic, Optional, Tuple, TypeVar

from .version_vector import Ordering, VersionVector

A = TypeVar("A")


class ReplicatedData:
    """Base marker (reference: ReplicatedData.scala)."""

    def merge(self, other: "ReplicatedData") -> "ReplicatedData":
        raise NotImplementedError


class DeltaReplicatedData(ReplicatedData):
    @property
    def delta(self) -> Optional[ReplicatedData]:
        return None

    def reset_delta(self) -> "DeltaReplicatedData":
        return self

    def merge_delta(self, delta: ReplicatedData) -> "DeltaReplicatedData":
        return self.merge(delta)  # full-state deltas by default


class RemovedNodePruning:
    def modified_by_nodes(self) -> FrozenSet[str]:
        raise NotImplementedError

    def needs_pruning_from(self, removed: str) -> bool:
        return removed in self.modified_by_nodes()

    def prune(self, removed: str, collapse_into: str) -> "ReplicatedData":
        raise NotImplementedError

    def prune_cleanup(self, removed: str) -> "ReplicatedData":
        """Drop any residual entries for `removed` (post-prune gossip races)."""
        return self  # type: ignore[return-value]


# -- counters ---------------------------------------------------------------


class GCounter(DeltaReplicatedData, RemovedNodePruning):
    """Grow-only counter: node -> count, merge = pairwise max, value = sum
    (reference: GCounter.scala)."""

    __slots__ = ("state", "_delta")

    def __init__(self, state: Optional[Dict[str, int]] = None,
                 _delta: Optional["GCounter"] = None):
        self.state = dict(state or {})
        self._delta = _delta

    @staticmethod
    def empty() -> "GCounter":
        return GCounter()

    @property
    def value(self) -> int:
        return sum(self.state.values())

    def increment(self, node: str, n: int = 1) -> "GCounter":
        if n < 0:
            raise ValueError("GCounter can't decrement")
        if n == 0:
            return self
        new = dict(self.state)
        new[node] = new.get(node, 0) + n
        delta_state = {node: new[node]}
        d = GCounter(delta_state) if self._delta is None else \
            GCounter({**self._delta.state, **delta_state})
        return GCounter(new, d)

    def merge(self, other: "GCounter") -> "GCounter":
        new = dict(self.state)
        for k, v in other.state.items():
            if new.get(k, 0) < v:
                new[k] = v
        return GCounter(new, self._delta)

    @property
    def delta(self) -> Optional["GCounter"]:
        return self._delta

    def reset_delta(self) -> "GCounter":
        return GCounter(self.state)

    def merge_delta(self, delta: "GCounter") -> "GCounter":
        return self.merge(delta)

    def modified_by_nodes(self) -> FrozenSet[str]:
        return frozenset(self.state)

    def prune(self, removed: str, collapse_into: str) -> "GCounter":
        c = self.state.get(removed)
        if c is None:
            return self
        new = dict(self.state)
        del new[removed]
        new[collapse_into] = new.get(collapse_into, 0) + c
        return GCounter(new)

    def prune_cleanup(self, removed: str) -> "GCounter":
        if removed not in self.state:
            return self
        new = dict(self.state)
        del new[removed]
        return GCounter(new)

    def __eq__(self, other):
        return isinstance(other, GCounter) and self.state == other.state

    def __hash__(self):
        return hash(tuple(sorted(self.state.items())))

    def __repr__(self):
        return f"GCounter({self.value})"


class PNCounter(DeltaReplicatedData, RemovedNodePruning):
    """Increment+decrement counter = two GCounters (reference: PNCounter.scala)."""

    __slots__ = ("increments", "decrements")

    def __init__(self, increments: Optional[GCounter] = None,
                 decrements: Optional[GCounter] = None):
        self.increments = increments or GCounter()
        self.decrements = decrements or GCounter()

    @staticmethod
    def empty() -> "PNCounter":
        return PNCounter()

    @property
    def value(self) -> int:
        return self.increments.value - self.decrements.value

    def increment(self, node: str, n: int = 1) -> "PNCounter":
        if n < 0:
            return self.decrement(node, -n)
        return PNCounter(self.increments.increment(node, n), self.decrements)

    def decrement(self, node: str, n: int = 1) -> "PNCounter":
        if n < 0:
            return self.increment(node, -n)
        return PNCounter(self.increments, self.decrements.increment(node, n))

    def merge(self, other: "PNCounter") -> "PNCounter":
        return PNCounter(self.increments.merge(other.increments),
                         self.decrements.merge(other.decrements))

    @property
    def delta(self) -> Optional["PNCounter"]:
        di, dd = self.increments.delta, self.decrements.delta
        if di is None and dd is None:
            return None
        return PNCounter(di or GCounter(), dd or GCounter())

    def reset_delta(self) -> "PNCounter":
        return PNCounter(self.increments.reset_delta(),
                         self.decrements.reset_delta())

    def merge_delta(self, delta: "PNCounter") -> "PNCounter":
        return self.merge(delta)

    def modified_by_nodes(self) -> FrozenSet[str]:
        return self.increments.modified_by_nodes() | self.decrements.modified_by_nodes()

    def prune(self, removed: str, collapse_into: str) -> "PNCounter":
        return PNCounter(self.increments.prune(removed, collapse_into),
                         self.decrements.prune(removed, collapse_into))

    def prune_cleanup(self, removed: str) -> "PNCounter":
        return PNCounter(self.increments.prune_cleanup(removed),
                         self.decrements.prune_cleanup(removed))

    def __eq__(self, other):
        return (isinstance(other, PNCounter)
                and self.increments == other.increments
                and self.decrements == other.decrements)

    def __hash__(self):
        return hash((self.increments, self.decrements))

    def __repr__(self):
        return f"PNCounter({self.value})"


# -- sets -------------------------------------------------------------------


class GSet(DeltaReplicatedData, Generic[A]):
    """Grow-only set; merge = union (reference: GSet.scala)."""

    __slots__ = ("elements", "_delta")

    def __init__(self, elements: Optional[FrozenSet[A]] = None,
                 _delta: Optional["GSet[A]"] = None):
        self.elements: FrozenSet[A] = frozenset(elements or ())
        self._delta = _delta

    @staticmethod
    def empty() -> "GSet":
        return GSet()

    def contains(self, e: A) -> bool:
        return e in self.elements

    def __contains__(self, e: A) -> bool:
        return e in self.elements

    def add(self, e: A) -> "GSet[A]":
        d = GSet(frozenset({e}) | (self._delta.elements if self._delta else frozenset()))
        return GSet(self.elements | {e}, d)

    def merge(self, other: "GSet[A]") -> "GSet[A]":
        return GSet(self.elements | other.elements, self._delta)

    @property
    def delta(self) -> Optional["GSet[A]"]:
        return self._delta

    def reset_delta(self) -> "GSet[A]":
        return GSet(self.elements)

    def merge_delta(self, delta: "GSet[A]") -> "GSet[A]":
        return self.merge(delta)

    def __eq__(self, other):
        return isinstance(other, GSet) and self.elements == other.elements

    def __hash__(self):
        return hash(self.elements)

    def __repr__(self):
        return f"GSet({set(self.elements)!r})"


class ORSetDeltaOp:
    """Op-based ORSet delta algebra (reference: ORSet.scala:55-110
    AddDeltaOp/RemoveDeltaOp/FullStateDeltaOp/DeltaGroup): an update ships
    only the touched element + its dot, not the whole set. Ops merge into
    groups between propagation ticks; consecutive same-node adds coalesce."""

    __slots__ = ()

    def zero(self) -> "ORSet":
        """Empty full state to apply a delta against on a replica that has
        never seen the key (reference: ReplicatedDelta.zero)."""
        return ORSet()

    def merge(self, that: "ORSetDeltaOp") -> "ORSetDeltaOp":
        if isinstance(that, ORSetDeltaGroup):
            return ORSetDeltaGroup((self,) + that.ops)
        return ORSetDeltaGroup((self, that))

    def __eq__(self, other):
        return type(self) is type(other) and \
            self.underlying == other.underlying  # type: ignore[attr-defined]

    def __hash__(self):
        return hash((type(self).__name__,
                     self.underlying))  # type: ignore[attr-defined]


class ORSetAddDeltaOp(ORSetDeltaOp):
    """underlying: ONLY the added element(s) with their fresh dots; its
    vvector is just those dots (tiny on the wire)."""

    __slots__ = ("underlying",)

    def __init__(self, underlying: "ORSet"):
        self.underlying = underlying

    def merge(self, that: ORSetDeltaOp) -> ORSetDeltaOp:
        if isinstance(that, ORSetAddDeltaOp):
            # consecutive adds from the SAME node coalesce into one op
            new_map = dict(self.underlying.element_map)
            new_map.update(that.underlying.element_map)
            return ORSetAddDeltaOp(ORSet(
                new_map,
                self.underlying.vvector.merge(that.underlying.vvector)))
        return super().merge(that)


class ORSetRemoveDeltaOp(ORSetDeltaOp):
    """underlying: exactly ONE removed element with the remover's dot; its
    vvector is the remover's FULL causal context (the remove only wins over
    adds it observed)."""

    __slots__ = ("underlying",)

    def __init__(self, underlying: "ORSet"):
        if len(underlying.element_map) != 1:
            raise ValueError(
                f"RemoveDeltaOp must contain one removed element, "
                f"got {len(underlying.element_map)}")
        self.underlying = underlying


class ORSetFullStateDeltaOp(ORSetDeltaOp):
    """Fallback op carrying full state (clear(), and mixed histories)."""

    __slots__ = ("underlying",)

    def __init__(self, underlying: "ORSet"):
        self.underlying = underlying


class ORSetDeltaGroup(ORSetDeltaOp):
    """Ordered batch of atomic ops between propagation ticks."""

    __slots__ = ("ops",)

    def __init__(self, ops):
        self.ops = tuple(ops)

    def merge(self, that: ORSetDeltaOp) -> ORSetDeltaOp:
        if isinstance(that, ORSetAddDeltaOp) and self.ops and \
                isinstance(self.ops[-1], ORSetAddDeltaOp):
            return ORSetDeltaGroup(
                self.ops[:-1] + (self.ops[-1].merge(that),))
        if isinstance(that, ORSetDeltaGroup):
            return ORSetDeltaGroup(self.ops + that.ops)
        return ORSetDeltaGroup(self.ops + (that,))

    def __eq__(self, other):
        return isinstance(other, ORSetDeltaGroup) and self.ops == other.ops

    def __hash__(self):
        return hash(self.ops)


class ORSet(DeltaReplicatedData, RemovedNodePruning, Generic[A]):
    """Observed-remove set, add-wins on concurrent add/remove.

    Reference: ORSet.scala — element -> "dot" (a VersionVector naming the
    add events observed for that element) plus a set-level version vector
    `vvector` that records every event the whole set has seen. Merge keeps
    an element present on one side iff its dot is NOT dominated by the other
    side's vvector (i.e. the other side saw the add and deleted it).
    Deltas are OP-BASED (earlier versions shipped full state): add ships only the
    element + fresh dot, remove ships the element + the remover's causal
    context, clear ships full state — the AddDeltaOp/RemoveDeltaOp/
    FullStateDeltaOp/DeltaGroup algebra of ORSet.scala:55-110,334-410.
    """

    __slots__ = ("element_map", "vvector", "_delta")

    def __init__(self, element_map: Optional[Dict[A, VersionVector]] = None,
                 vvector: Optional[VersionVector] = None,
                 _delta: Optional["ORSet[A]"] = None):
        self.element_map: Dict[A, VersionVector] = dict(element_map or {})
        self.vvector = vvector or VersionVector.empty()
        self._delta = _delta

    @staticmethod
    def empty() -> "ORSet":
        return ORSet()

    @property
    def elements(self) -> FrozenSet[A]:
        return frozenset(self.element_map)

    def contains(self, e: A) -> bool:
        return e in self.element_map

    def __contains__(self, e: A) -> bool:
        return e in self.element_map

    def _push_delta(self, op: ORSetDeltaOp) -> ORSetDeltaOp:
        return op if self._delta is None else self._delta.merge(op)

    def add(self, node: str, e: A) -> "ORSet[A]":
        vv = self.vvector.increment(node)
        dot = VersionVector.one(node, vv.version_at(node))
        new = dict(self.element_map)
        new[e] = dot  # fresh dot replaces observed history for e (ORSet.scala add)
        op = ORSetAddDeltaOp(ORSet({e: dot}, dot))
        return ORSet(new, vv, _delta=self._push_delta(op))

    def remove(self, node: str, e: A) -> "ORSet[A]":
        new = dict(self.element_map)
        new.pop(e, None)
        # the op carries the remover's FULL causal context so the remove
        # wins exactly over the adds it observed (ORSet.scala:382)
        delta_dot = VersionVector.one(node, self.vvector.version_at(node))
        op = ORSetRemoveDeltaOp(ORSet({e: delta_dot}, self.vvector))
        return ORSet(new, self.vvector, _delta=self._push_delta(op))

    def clear(self) -> "ORSet[A]":
        op = ORSetFullStateDeltaOp(ORSet({}, self.vvector))
        return ORSet({}, self.vvector, _delta=self._push_delta(op))

    @staticmethod
    def _merge_dots(d1: VersionVector, d2: VersionVector) -> VersionVector:
        return d1.merge(d2)

    def merge(self, other: "ORSet[A]") -> "ORSet[A]":
        return self._dry_merge(other, add_delta=False)

    def _dry_merge(self, other: "ORSet[A]", add_delta: bool) -> "ORSet[A]":
        """Full merge; with add_delta=True, THIS side's unique elements are
        kept unconditionally — an AddDeltaOp's tiny vvector records only
        the new dots, so checking our elements against it would wrongly
        delete everything it has not seen (ORSet.scala:434-453 dryMerge)."""
        merged: Dict[A, VersionVector] = {}
        for e in set(self.element_map) | set(other.element_map):
            mine, theirs = self.element_map.get(e), other.element_map.get(e)
            if mine is not None and theirs is not None:
                merged[e] = self._merge_dots(mine, theirs)
            elif mine is not None:
                # present only here: keep iff other hasn't observed (and
                # hence removed) every event in the dot
                if add_delta or not self._dominated(mine, other.vvector):
                    merged[e] = mine
            else:
                if not self._dominated(theirs, self.vvector):  # type: ignore[arg-type]
                    merged[e] = theirs  # type: ignore[assignment]
        return ORSet(merged, self.vvector.merge(other.vvector), self._delta)

    @staticmethod
    def _dominated(dot: VersionVector, vv: VersionVector) -> bool:
        return all(vv.version_at(n) >= dot.version_at(n) for n in dot.nodes())

    @property
    def delta(self) -> Optional["ORSet[A]"]:
        return self._delta

    def reset_delta(self) -> "ORSet[A]":
        return ORSet(self.element_map, self.vvector)

    def merge_delta(self, delta) -> "ORSet[A]":
        """Apply an op-based delta (ORSet.scala:455-469 mergeDelta); a
        plain ORSet (an older full-state delta) still full-merges."""
        if isinstance(delta, ORSetAddDeltaOp):
            return self._dry_merge(delta.underlying, add_delta=True)
        if isinstance(delta, ORSetRemoveDeltaOp):
            return self._merge_remove_delta(delta)
        if isinstance(delta, ORSetFullStateDeltaOp):
            return self._dry_merge(delta.underlying, add_delta=False)
        if isinstance(delta, ORSetDeltaGroup):
            acc = self
            for op in delta.ops:
                if isinstance(op, ORSetDeltaGroup):
                    raise ValueError("ORSet DeltaGroup must not be nested")
                acc = acc.merge_delta(op)
            return acc
        return self.merge(delta)

    def _merge_remove_delta(self, delta: ORSetRemoveDeltaOp) -> "ORSet[A]":
        """(reference: ORSet.scala:471-501 mergeRemoveDelta) — drop the
        element iff the remover's causal context covers every add event in
        OUR dot for it; always merge the remover's dot into the vvector so
        the removal event itself is recorded."""
        that = delta.underlying
        (elem, that_dot), = that.element_map.items()
        new = dict(self.element_map)
        mine = new.get(elem)
        # drop iff OUR dot is dominated by the remover's causal context —
        # the canonical domination predicate (a node of ours absent from
        # the context makes it false, i.e. a concurrent unseen add wins)
        if mine is not None and self._dominated(mine, that.vvector):
            del new[elem]
        return ORSet(new, self.vvector.merge(that_dot), self._delta)

    def modified_by_nodes(self) -> FrozenSet[str]:
        return frozenset(self.vvector.nodes())

    def prune(self, removed: str, collapse_into: str) -> "ORSet[A]":
        new: Dict[A, VersionVector] = {}
        for e, dot in self.element_map.items():
            new[e] = dot.prune(removed, collapse_into) if dot.contains(removed) else dot
        return ORSet(new, self.vvector.prune(removed, collapse_into))

    def prune_cleanup(self, removed: str) -> "ORSet[A]":
        """Drop `removed` from the vvector and every dot (stale replicas
        gossiping after the prune). Elements whose only add events came from
        `removed` are dropped too — the pruned copy carries them re-dotted
        under the collapse target, so the merge restores them."""
        if removed not in self.vvector.nodes() and not any(
                dot.contains(removed) for dot in self.element_map.values()):
            return self
        new: Dict[A, VersionVector] = {}
        for e, dot in self.element_map.items():
            if dot.contains(removed):
                cleaned = VersionVector({n: v for n, v in dot.versions.items()
                                         if n != removed})
                if not cleaned.is_empty():
                    new[e] = cleaned
            else:
                new[e] = dot
        vv = VersionVector({n: v for n, v in self.vvector.versions.items()
                            if n != removed})
        return ORSet(new, vv)

    def __eq__(self, other):
        return (isinstance(other, ORSet)
                and self.element_map == other.element_map
                and self.vvector == other.vvector)

    def __hash__(self):
        return hash((frozenset(self.element_map.items()), self.vvector))

    def __repr__(self):
        return f"ORSet({set(self.element_map)!r})"


# -- registers & flag -------------------------------------------------------


class Flag(ReplicatedData):
    """Boolean that can only go False -> True (reference: Flag.scala)."""

    __slots__ = ("enabled",)

    def __init__(self, enabled: bool = False):
        self.enabled = enabled

    @staticmethod
    def empty() -> "Flag":
        return Flag(False)

    def switch_on(self) -> "Flag":
        return Flag(True)

    def merge(self, other: "Flag") -> "Flag":
        return Flag(self.enabled or other.enabled)

    def __eq__(self, other):
        return isinstance(other, Flag) and self.enabled == other.enabled

    def __hash__(self):
        return hash(self.enabled)

    def __repr__(self):
        return f"Flag({self.enabled})"


class LWWRegister(ReplicatedData, Generic[A]):
    """Last-writer-wins register (reference: LWWRegister.scala — timestamp
    with node-id tiebreak; pluggable clock for e.g. monotonically increasing
    version semantics)."""

    __slots__ = ("node", "value", "timestamp")

    DefaultClock: Callable[[int, Any], int] = staticmethod(
        lambda current, _value: max(int(time.time() * 1e6), current + 1))

    def __init__(self, node: str, value: A, timestamp: int):
        self.node = node
        self.value = value
        self.timestamp = timestamp

    @staticmethod
    def create(node: str, value: A,
               clock: Optional[Callable[[int, Any], int]] = None) -> "LWWRegister[A]":
        clock = clock or LWWRegister.DefaultClock
        return LWWRegister(node, value, clock(0, value))

    def with_value(self, node: str, value: A,
                   clock: Optional[Callable[[int, Any], int]] = None) -> "LWWRegister[A]":
        clock = clock or LWWRegister.DefaultClock
        return LWWRegister(node, value, clock(self.timestamp, value))

    def merge(self, other: "LWWRegister[A]") -> "LWWRegister[A]":
        if other.timestamp > self.timestamp:
            return other
        if other.timestamp == self.timestamp and other.node < self.node:
            return other
        return self

    def __eq__(self, other):
        return (isinstance(other, LWWRegister) and self.node == other.node
                and self.value == other.value and self.timestamp == other.timestamp)

    def __hash__(self):
        return hash((self.node, self.timestamp))

    def __repr__(self):
        return f"LWWRegister({self.value!r} @ {self.timestamp} by {self.node})"


# -- maps -------------------------------------------------------------------


class ORMapDeltaOp:
    """Op-based ORMap delta algebra (reference: ORMap.scala:30-110
    PutDeltaOp/UpdateDeltaOp/RemoveDeltaOp/RemoveKeyDeltaOp/DeltaGroup):
    a 1-entry change ships one key op + one entry, not the whole map.

    Every op carries a `zero_tag` — the TOP-LEVEL map class (ORMap or a
    derived wrapper) — so a replica that has never seen the key can
    reconstruct the right type from nothing: `op.zero().merge_delta(op)`
    (reference: ZeroTag.scala, the replicator's first-sight path)."""

    __slots__ = ()

    def zero(self) -> "ReplicatedData":
        return self.zero_tag.empty()  # type: ignore[attr-defined]

    def merge(self, that: "ORMapDeltaOp") -> "ORMapDeltaOp":
        if isinstance(that, ORMapDeltaGroup):
            return ORMapDeltaGroup((self,) + that.ops)
        return ORMapDeltaGroup((self, that))


class ORMapPutDeltaOp(ORMapDeltaOp):
    """Destructive entry write: ships the key's ORSet add op + the FULL
    value (put replaces; only `updated` ships value deltas)."""

    __slots__ = ("key_op", "key", "value", "zero_tag")

    def __init__(self, key_op: ORSetDeltaOp, key, value: ReplicatedData,
                 zero_tag: type):
        self.key_op = key_op
        self.key = key
        self.value = value
        self.zero_tag = zero_tag

    def merge(self, that: ORMapDeltaOp) -> ORMapDeltaOp:
        if isinstance(that, ORMapPutDeltaOp) and that.key == self.key:
            # a later put of the SAME key supersedes within the tick
            return ORMapPutDeltaOp(self.key_op.merge(that.key_op),
                                   self.key, that.value, self.zero_tag)
        return super().merge(that)

    def __eq__(self, other):
        return (isinstance(other, ORMapPutDeltaOp)
                and self.key_op == other.key_op and self.key == other.key
                and self.value == other.value
                and self.zero_tag is other.zero_tag)

    def __hash__(self):
        return hash(("put", self.key_op, self.key))


class ORMapUpdateDeltaOp(ORMapDeltaOp):
    """In-place entry update: ships the key's ORSet add op + the value's
    own DELTA per key (a counter increment rides as {node: count}, an
    ORSet binding as one AddDeltaOp — O(entry), never O(map)). Falls back
    to the full value for non-delta value types; `merge_delta` tells the
    two apart by type. Consecutive updates between propagation ticks
    coalesce: key ops merge, per-key value deltas merge."""

    __slots__ = ("key_op", "values", "zero_tag")

    def __init__(self, key_op: ORSetDeltaOp, values: Dict[Any, Any],
                 zero_tag: type):
        self.key_op = key_op
        self.values = dict(values)
        self.zero_tag = zero_tag

    def merge(self, that: ORMapDeltaOp) -> ORMapDeltaOp:
        if isinstance(that, ORMapUpdateDeltaOp) \
                and that.zero_tag is self.zero_tag:
            vals = dict(self.values)
            for k, d in that.values.items():
                cur = vals.get(k)
                vals[k] = d if cur is None else cur.merge(d)
            return ORMapUpdateDeltaOp(self.key_op.merge(that.key_op),
                                      vals, self.zero_tag)
        return super().merge(that)

    def __eq__(self, other):
        return (isinstance(other, ORMapUpdateDeltaOp)
                and self.key_op == other.key_op
                and self.values == other.values
                and self.zero_tag is other.zero_tag)

    def __hash__(self):
        return hash(("update", self.key_op, frozenset(self.values)))


class ORMapRemoveDeltaOp(ORMapDeltaOp):
    """Key removal dropping the value: ships the key's ORSet remove op
    (one element + the remover's causal context). The entry disappears
    with the key; value types that need their causal context preserved
    across a remove (ORMultiMap) use RemoveKeyDeltaOp instead."""

    __slots__ = ("key_op", "key", "zero_tag")

    def __init__(self, key_op: ORSetDeltaOp, key, zero_tag: type):
        self.key_op = key_op
        self.key = key
        self.zero_tag = zero_tag

    def __eq__(self, other):
        return (isinstance(other, ORMapRemoveDeltaOp)
                and self.key_op == other.key_op and self.key == other.key
                and self.zero_tag is other.zero_tag)

    def __hash__(self):
        return hash(("remove", self.key_op, self.key))


class ORMapRemoveKeyDeltaOp(ORMapDeltaOp):
    """Key removal RETAINING the value as a tombstone (reference:
    ORMap.scala RemoveKeyDeltaOp): the cleared value keeps its causal
    context so a concurrent binding update converges instead of
    resurrecting removed elements — the ORMultiMap remove path clears
    the set (a value delta) then removes the key with this op."""

    __slots__ = ("key_op", "key", "zero_tag")

    def __init__(self, key_op: ORSetDeltaOp, key, zero_tag: type):
        self.key_op = key_op
        self.key = key
        self.zero_tag = zero_tag

    def __eq__(self, other):
        return (isinstance(other, ORMapRemoveKeyDeltaOp)
                and self.key_op == other.key_op and self.key == other.key
                and self.zero_tag is other.zero_tag)

    def __hash__(self):
        return hash(("remove_key", self.key_op, self.key))


class ORMapDeltaGroup(ORMapDeltaOp):
    """Ordered batch of atomic ops between propagation ticks; an incoming
    op first tries to coalesce with the trailing op."""

    __slots__ = ("ops",)

    def __init__(self, ops):
        self.ops = tuple(ops)

    @property
    def zero_tag(self) -> type:
        return self.ops[0].zero_tag  # type: ignore[attr-defined]

    def merge(self, that: ORMapDeltaOp) -> ORMapDeltaOp:
        if isinstance(that, ORMapDeltaGroup):
            return ORMapDeltaGroup(self.ops + that.ops)
        if self.ops:
            tail = self.ops[-1].merge(that)
            if not isinstance(tail, ORMapDeltaGroup):
                return ORMapDeltaGroup(self.ops[:-1] + (tail,))
        return ORMapDeltaGroup(self.ops + (that,))

    def __eq__(self, other):
        return isinstance(other, ORMapDeltaGroup) and self.ops == other.ops

    def __hash__(self):
        return hash(self.ops)


class ORMap(DeltaReplicatedData, RemovedNodePruning, Generic[A]):
    """Observed-remove map: ORSet of keys + per-key ReplicatedData values
    merged recursively (reference: ORMap.scala).

    Deltas are OP-BASED (previously full-state snapshots): put/updated/
    remove emit Put/Update/Remove/RemoveKey ops carrying one key op and
    one entry (or just the entry's own delta), the DeltaGroup algebra of
    ORMap.scala:30-110 with zero-tag reconstruction for replicas that
    have never seen the key and the causal guard on update application
    (a value delta only applies if its key survived the key-set merge).

    Known reference anomaly, kept for parity: a remove() concurrent with
    an updated() of the SAME key can transiently differ between the op
    path (the update's value delta resurrects the entry from zero) and
    the full-merge path; full-state gossip reconciles. Value types whose
    causal context must survive a remove use remove_key() tombstones —
    ORMultiMap does (clear-then-remove_key, merge retaining deleted
    values); PNCounterMap/LWWMap accept the documented anomaly."""

    __slots__ = ("keys", "entries", "_delta")

    def __init__(self, keys: Optional[ORSet] = None,
                 entries: Optional[Dict[Any, ReplicatedData]] = None,
                 _delta: Optional["ORMap"] = None):
        self.keys = keys or ORSet()
        self.entries: Dict[Any, ReplicatedData] = dict(entries or {})
        self._delta = _delta

    @staticmethod
    def empty() -> "ORMap":
        return ORMap()

    def get(self, key) -> Optional[ReplicatedData]:
        return self.entries.get(key)

    def contains(self, key) -> bool:
        return key in self.entries

    def __contains__(self, key) -> bool:
        return key in self.entries

    def _push_delta(self, op: ORMapDeltaOp) -> ORMapDeltaOp:
        return op if self._delta is None else self._delta.merge(op)

    def _key_add_op(self, node: str, key) -> Tuple[ORSet, ORSetDeltaOp]:
        """One key-set add as (new reset keys, the ORSet op it emitted)."""
        nk = self.keys.reset_delta().add(node, key)
        return nk.reset_delta(), nk.delta  # type: ignore[return-value]

    def put(self, node: str, key, value: ReplicatedData,
            _tag: Optional[type] = None) -> "ORMap":
        new_keys, key_op = self._key_add_op(node, key)
        entries = dict(self.entries)
        entries[key] = value
        op = ORMapPutDeltaOp(key_op, key, value, _tag or ORMap)
        return ORMap(new_keys, entries, _delta=self._push_delta(op))

    def updated(self, node: str, key, initial: ReplicatedData,
                modify: Callable[[ReplicatedData], ReplicatedData],
                _tag: Optional[type] = None) -> "ORMap":
        return self.updated_many(node, [(key, initial, modify)], _tag)

    def updated_many(self, node: str, changes, _tag: Optional[type] = None
                     ) -> "ORMap":
        """`updated` of each (key, initial, modify) of `changes` in turn,
        with one copy of the key set and of the entries (a port addition:
        the gateway's replica feed changes hundreds of entries of a large
        map in one update, and a copy per entry made its time grow with
        the map's size)."""
        tag = _tag or ORMap
        element_map, vv = dict(self.keys.element_map), self.keys.vvector
        entries = dict(self.entries)
        delta = self._delta
        for key, initial, modify in changes:
            # the key set's add and the op it emits (ORSet.add)
            vv = vv.increment(node)
            dot = VersionVector.one(node, vv.version_at(node))
            element_map[key] = dot
            key_op = ORSetAddDeltaOp(ORSet({key: dot}, dot))
            cur = entries.get(key, initial)
            if isinstance(cur, DeltaReplicatedData):
                # ship the value's OWN delta (reference: valueDeltas branch
                # of ORMap.updated) — a counter increment gossips
                # {node: count}
                new_val = modify(cur.reset_delta())
                vd = new_val.delta \
                    if isinstance(new_val, DeltaReplicatedData) else None
                if vd is not None:
                    op: ORMapDeltaOp = ORMapUpdateDeltaOp(key_op, {key: vd},
                                                          tag)
                    entries[key] = new_val.reset_delta()
                else:  # modify produced no delta: ship the full value
                    op = ORMapPutDeltaOp(key_op, key, new_val, tag)
                    entries[key] = new_val
            else:
                new_val = modify(cur)
                op = ORMapUpdateDeltaOp(key_op, {key: new_val}, tag)
                entries[key] = new_val
            delta = op if delta is None else delta.merge(op)
        return ORMap(ORSet(element_map, vv), entries, _delta=delta)

    def remove(self, node: str, key, _tag: Optional[type] = None) -> "ORMap":
        nk = self.keys.reset_delta().remove(node, key)
        entries = dict(self.entries)
        entries.pop(key, None)
        op = ORMapRemoveDeltaOp(nk.delta, key,  # type: ignore[arg-type]
                                _tag or ORMap)
        return ORMap(nk.reset_delta(), entries, _delta=self._push_delta(op))

    def remove_key(self, node: str, key,
                   _tag: Optional[type] = None) -> "ORMap":
        """Remove the key but KEEP its value as a tombstone (reference:
        ORMap.removeKey) — the ORMultiMap clear-then-remove path, so the
        value's causal context survives for concurrent binding updates."""
        nk = self.keys.reset_delta().remove(node, key)
        op = ORMapRemoveKeyDeltaOp(nk.delta, key,  # type: ignore[arg-type]
                                   _tag or ORMap)
        return ORMap(nk.reset_delta(), self.entries,
                     _delta=self._push_delta(op))

    def merge(self, other: "ORMap") -> "ORMap":
        return self._merge(other, retain_deleted=False)

    def merge_retaining_deleted_values(self, other: "ORMap") -> "ORMap":
        """(reference: ORMap.mergeRetainingDeletedValues) — tombstone
        entries whose keys left the key set survive the merge; the
        ORMultiMap merge path."""
        return self._merge(other, retain_deleted=True)

    def _merge(self, other: "ORMap", retain_deleted: bool) -> "ORMap":
        merged_keys = self.keys.merge(other.keys)
        keep = set(merged_keys.element_map)
        if retain_deleted:
            keep |= set(self.entries) | set(other.entries)
        entries: Dict[Any, ReplicatedData] = {}
        for key in keep:
            mine, theirs = self.entries.get(key), other.entries.get(key)
            if mine is not None and theirs is not None:
                entries[key] = mine.merge(theirs)
            elif mine is not None:
                entries[key] = mine
            elif theirs is not None:
                entries[key] = theirs
        return ORMap(merged_keys, entries, self._delta)

    @property
    def delta(self) -> Optional[ORMapDeltaOp]:
        return self._delta

    def reset_delta(self) -> "ORMap":
        return ORMap(self.keys.reset_delta(), self.entries)

    def merge_delta(self, delta) -> "ORMap":
        """Apply an op-based delta (reference: ORMap.mergeDelta /
        dryMergeDelta); a plain ORMap (legacy full-state delta) still
        full-merges."""
        if isinstance(delta, ORMapDeltaOp):
            return self._dry_merge_delta(delta, retain_deleted=False)
        return self.merge(delta)

    def merge_delta_retaining_deleted_values(self, delta) -> "ORMap":
        if isinstance(delta, ORMapDeltaOp):
            return self._dry_merge_delta(delta, retain_deleted=True)
        return self.merge_retaining_deleted_values(delta)

    def _dry_merge_delta(self, delta: ORMapDeltaOp,
                         retain_deleted: bool) -> "ORMap":
        """The op fold (reference: ORMap.dryMergeDelta): ops build a
        side-map of values which then FULL-MERGES with the local entries
        per key — so concurrent puts converge commutatively (register
        merge picks the winner) instead of diverging by application
        order. Update values apply under the causal guard: a value delta
        lands only if its key survived the key-set merge (an add our
        vvector already observed-and-removed stays removed)."""
        ops = delta.ops if isinstance(delta, ORMapDeltaGroup) else (delta,)
        merged_keys = self.keys
        merged_values: Dict[Any, Any] = {}
        tombstoned: Dict[Any, ReplicatedData] = {}
        for op in ops:
            if isinstance(op, ORMapDeltaGroup):
                raise ValueError("ORMap DeltaGroup must not be nested")
            if isinstance(op, ORMapPutDeltaOp):
                merged_keys = merged_keys.merge_delta(op.key_op)
                merged_values[op.key] = op.value
            elif isinstance(op, ORMapRemoveDeltaOp):
                merged_values.pop(op.key, None)
                merged_keys = merged_keys.merge_delta(op.key_op)
            elif isinstance(op, ORMapRemoveKeyDeltaOp):
                if op.key in self.entries:
                    tombstoned[op.key] = self.entries[op.key]
                merged_keys = merged_keys.merge_delta(op.key_op)
            elif isinstance(op, ORMapUpdateDeltaOp):
                merged_keys = merged_keys.merge_delta(op.key_op)
                for k, vd in op.values.items():
                    if k not in merged_keys.element_map:
                        # causal guard: the key's add was already observed
                        # AND removed here — the stale value delta must
                        # not resurrect it
                        continue
                    cur = merged_values.get(k)
                    if cur is None:
                        # seed from the local entry (reference parity): the
                        # value delta applies ONTO what this replica holds,
                        # not onto a zero-reconstruction whose vvector would
                        # dominate-and-drop the local elements on merge
                        cur = tombstoned.get(k, self.entries.get(k))
                    if cur is not None:
                        merged_values[k] = (
                            cur.merge_delta(vd)
                            if isinstance(cur, DeltaReplicatedData)
                            else cur.merge(vd))
                    else:
                        # zero-tag value reconstruction: an op-style value
                        # delta (ORSetDeltaOp) rebuilds against its zero;
                        # counter deltas ARE valid state (absolute counts)
                        z = getattr(vd, "zero", None)
                        merged_values[k] = \
                            z().merge_delta(vd) if z is not None else vd
            else:
                raise ValueError(f"unknown ORMap delta op {op!r}")
        keep = set(merged_keys.element_map)
        if retain_deleted:
            keep |= set(self.entries) | set(tombstoned) | set(merged_values)
        entries: Dict[Any, ReplicatedData] = {}
        for key in keep:
            mine = self.entries.get(key)
            theirs = merged_values.get(key)
            if mine is not None and theirs is not None:
                entries[key] = mine.merge(theirs)
            elif mine is not None:
                entries[key] = mine
            elif theirs is not None:
                entries[key] = theirs
        return ORMap(merged_keys, entries, self._delta)

    def modified_by_nodes(self) -> FrozenSet[str]:
        out = set(self.keys.modified_by_nodes())
        for v in self.entries.values():
            if isinstance(v, RemovedNodePruning):
                out |= v.modified_by_nodes()
        return frozenset(out)

    def prune(self, removed: str, collapse_into: str) -> "ORMap":
        entries = {
            k: (v.prune(removed, collapse_into)
                if isinstance(v, RemovedNodePruning) and v.needs_pruning_from(removed)
                else v)
            for k, v in self.entries.items()}
        return ORMap(self.keys.prune(removed, collapse_into), entries)

    def prune_cleanup(self, removed: str) -> "ORMap":
        entries = {
            k: (v.prune_cleanup(removed) if isinstance(v, RemovedNodePruning) else v)
            for k, v in self.entries.items()}
        return ORMap(self.keys.prune_cleanup(removed), entries)

    def __eq__(self, other):
        return (isinstance(other, ORMap) and self.keys == other.keys
                and self.entries == other.entries)

    def __hash__(self):
        return hash((self.keys, frozenset(self.entries)))

    def __repr__(self):
        return f"ORMap({dict(self.entries)!r})"


class ORMultiMap(DeltaReplicatedData, Generic[A]):
    """key -> ORSet of values (reference: ORMultiMap.scala, the
    withValueDeltas variant): binding changes ship as the value set's OWN
    op deltas inside ORMap UpdateDeltaOps, and key removal is
    clear-then-remove_key so the emptied set survives as a tombstone
    carrying its causal context — a concurrent add_binding then converges
    (removed elements stay removed, the new binding lands) instead of
    resurrecting the whole set. Tombstones are invisible through
    get/entries/contains (filtered to live keys) and survive merges via
    merge_retaining_deleted_values."""

    __slots__ = ("underlying",)

    def __init__(self, underlying: Optional[ORMap] = None):
        self.underlying = underlying or ORMap()

    @staticmethod
    def empty() -> "ORMultiMap":
        return ORMultiMap()

    def _live(self, key) -> bool:
        return key in self.underlying.keys.element_map

    def get(self, key) -> FrozenSet:
        if not self._live(key):
            return frozenset()
        s = self.underlying.get(key)
        return s.elements if isinstance(s, ORSet) else frozenset()

    def contains(self, key) -> bool:
        return self._live(key) and key in self.underlying

    @property
    def entries(self) -> Dict[Any, FrozenSet]:
        return {k: v.elements for k, v in self.underlying.entries.items()
                if isinstance(v, ORSet) and self._live(k)}

    def add_binding(self, node: str, key, value) -> "ORMultiMap":
        return ORMultiMap(self.underlying.updated(
            node, key, ORSet(), lambda s: s.add(node, value),
            _tag=ORMultiMap))

    def remove_binding(self, node: str, key, value) -> "ORMultiMap":
        if value not in self.get(key):
            return self
        u = self.underlying.updated(
            node, key, ORSet(), lambda s: s.remove(node, value),
            _tag=ORMultiMap)
        got = u.get(key)
        if isinstance(got, ORSet) and not got.element_map:
            u = u.remove_key(node, key, _tag=ORMultiMap)
        return ORMultiMap(u)

    def replace_binding(self, node: str, key, old, new) -> "ORMultiMap":
        if old == new:  # guard: add-then-remove of the same element would
            return self  # observe the fresh dot and delete the binding
        return self.add_binding(node, key, new).remove_binding(node, key, old)

    def put(self, node: str, key, values) -> "ORMultiMap":
        vals = list(values)

        def replace(s: ORSet) -> ORSet:
            out = s.clear()  # clear observes the old dots (value delta)
            for v in vals:
                out = out.add(node, v)
            return out
        return ORMultiMap(self.underlying.updated(
            node, key, ORSet(), replace, _tag=ORMultiMap))

    def remove(self, node: str, key) -> "ORMultiMap":
        u = self.underlying.updated(
            node, key, ORSet(), lambda s: s.clear(), _tag=ORMultiMap)
        return ORMultiMap(u.remove_key(node, key, _tag=ORMultiMap))

    def merge(self, other: "ORMultiMap") -> "ORMultiMap":
        return ORMultiMap(self.underlying.merge_retaining_deleted_values(
            other.underlying))

    @property
    def delta(self) -> Optional[ORMapDeltaOp]:
        return self.underlying.delta

    def reset_delta(self) -> "ORMultiMap":
        return ORMultiMap(self.underlying.reset_delta())

    def merge_delta(self, delta) -> "ORMultiMap":
        if isinstance(delta, ORMultiMap):
            return self.merge(delta)
        return ORMultiMap(
            self.underlying.merge_delta_retaining_deleted_values(delta))

    def __eq__(self, other):
        return isinstance(other, ORMultiMap) and self.underlying == other.underlying

    def __hash__(self):
        return hash(self.underlying)

    def __repr__(self):
        return f"ORMultiMap({self.entries!r})"


class PNCounterMap(DeltaReplicatedData):
    """key -> PNCounter (reference: PNCounterMap.scala). Increments ship
    as the counter's own delta ({node: absolute count}) inside an ORMap
    UpdateDeltaOp — O(entry) gossip; the reference's documented
    remove-vs-concurrent-update anomaly applies (see ORMap docstring)."""

    __slots__ = ("underlying",)

    def __init__(self, underlying: Optional[ORMap] = None):
        self.underlying = underlying or ORMap()

    @staticmethod
    def empty() -> "PNCounterMap":
        return PNCounterMap()

    def get(self, key) -> Optional[int]:
        c = self.underlying.get(key)
        return c.value if isinstance(c, PNCounter) else None

    @property
    def entries(self) -> Dict[Any, int]:
        return {k: v.value for k, v in self.underlying.entries.items()
                if isinstance(v, PNCounter)}

    def increment(self, node: str, key, n: int = 1) -> "PNCounterMap":
        return PNCounterMap(self.underlying.updated(
            node, key, PNCounter(), lambda c: c.increment(node, n),
            _tag=PNCounterMap))

    def decrement(self, node: str, key, n: int = 1) -> "PNCounterMap":
        return PNCounterMap(self.underlying.updated(
            node, key, PNCounter(), lambda c: c.decrement(node, n),
            _tag=PNCounterMap))

    def increment_many(self, node: str, amounts) -> "PNCounterMap":
        """`increment` of each (key, n) of `amounts` in turn (`decrement`
        by -n where n < 0), with one copy of the map (a port addition)."""
        return PNCounterMap(self.underlying.updated_many(node, [
            (key, PNCounter(), lambda c, n=n: c.increment(node, n)
             if n >= 0 else c.decrement(node, -n))
            for key, n in amounts], _tag=PNCounterMap))

    def remove(self, node: str, key) -> "PNCounterMap":
        return PNCounterMap(self.underlying.remove(node, key,
                                                   _tag=PNCounterMap))

    def merge(self, other: "PNCounterMap") -> "PNCounterMap":
        return PNCounterMap(self.underlying.merge(other.underlying))

    @property
    def delta(self) -> Optional[ORMapDeltaOp]:
        return self.underlying.delta

    def reset_delta(self) -> "PNCounterMap":
        return PNCounterMap(self.underlying.reset_delta())

    def merge_delta(self, delta) -> "PNCounterMap":
        if isinstance(delta, PNCounterMap):
            return self.merge(delta)
        return PNCounterMap(self.underlying.merge_delta(delta))

    def __eq__(self, other):
        return isinstance(other, PNCounterMap) and self.underlying == other.underlying

    def __hash__(self):
        return hash(self.underlying)

    def __repr__(self):
        return f"PNCounterMap({self.entries!r})"


class LWWMap(DeltaReplicatedData, Generic[A]):
    """key -> LWWRegister (reference: LWWMap.scala). A put ships one
    PutDeltaOp carrying one register; the dry-merge's final full-merge
    per key keeps concurrent puts commutative (timestamp winner)."""

    __slots__ = ("underlying",)

    def __init__(self, underlying: Optional[ORMap] = None):
        self.underlying = underlying or ORMap()

    @staticmethod
    def empty() -> "LWWMap":
        return LWWMap()

    def get(self, key):
        r = self.underlying.get(key)
        return r.value if isinstance(r, LWWRegister) else None

    def contains(self, key) -> bool:
        return key in self.underlying

    @property
    def entries(self) -> Dict[Any, Any]:
        return {k: v.value for k, v in self.underlying.entries.items()
                if isinstance(v, LWWRegister)}

    def put(self, node: str, key, value,
            clock: Optional[Callable[[int, Any], int]] = None) -> "LWWMap":
        cur = self.underlying.get(key)
        reg = (cur.with_value(node, value, clock) if isinstance(cur, LWWRegister)
               else LWWRegister.create(node, value, clock))
        return LWWMap(self.underlying.put(node, key, reg, _tag=LWWMap))

    def remove(self, node: str, key) -> "LWWMap":
        return LWWMap(self.underlying.remove(node, key, _tag=LWWMap))

    def merge(self, other: "LWWMap") -> "LWWMap":
        return LWWMap(self.underlying.merge(other.underlying))

    @property
    def delta(self) -> Optional[ORMapDeltaOp]:
        return self.underlying.delta

    def reset_delta(self) -> "LWWMap":
        return LWWMap(self.underlying.reset_delta())

    def merge_delta(self, delta) -> "LWWMap":
        if isinstance(delta, LWWMap):
            return self.merge(delta)
        return LWWMap(self.underlying.merge_delta(delta))

    def __eq__(self, other):
        return isinstance(other, LWWMap) and self.underlying == other.underlying

    def __hash__(self):
        return hash(self.underlying)

    def __repr__(self):
        return f"LWWMap({self.entries!r})"
