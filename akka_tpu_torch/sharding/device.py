"""Device-backed cluster sharding: entities as rows of a sharded system.

Port of `akka_tpu/sharding/device.py` (the region's data plane and ask
path). `DeviceShardRegion` lays a sharded entity type out as rows of a
`ShardedBatchedSystem`: a placement table maps each logical shard onto one
physical block of `entities_per_shard` contiguous rows, rebalance copies a
block's state to a spare block and re-points the messages in flight, and
cross-shard tells ride the system's exchange.

Layout: logical shard s occupies ONE physical block; block b lives on shard
b // blocks_per_device of the shard axis (on one card, `n_devices` is the
shard count, default 1). The placement table is on the device as
ctx.tables["shard_row_base"] (block * entities_per_shard per logical
shard), so behaviors address any entity as
`tables["shard_row_base"][shard] + index` and placement changes never
touch them. One spare block becomes the promise block, whose rows answer
asks (batched/bridge.py's convention).

Durability is the reference's: `attach_journal` arms the tell WAL, the
checkpoint directory and the `entities.log` of first allocations;
`attach_entity_journal` arms the per-entity event journal the ask engine
group-commits each ok wave into before its acks; `checkpoint` writes the
slab snapshot, the placement sidecar (`region.json`) and compacts the
journals; `restore`, in a fresh process, loads the sidecar, respawns the
remembered entities (`DeviceEntity.remember_store`, the entity journal),
writes the snapshot into the live tensors, replays the WAL and pins the
durable column to the entity journal's acked frontier.

Observability is the reference's: `attach_tracer` wires a causal tracer
(event/tracing.py) into the ask engine, whose wave and member spans are
then stamped on this region's step axis; the journals take the system's
flight recorder and, for the entity journal, a metrics registry.

A region's "devices" are shard slots (parallel/mesh.py): `n_devices` is
the shard count of the system's axis, `mesh=` may give the slots, and
`failover(survivors)` rebuilds the region on a subset of one card's slots
from the latest snapshot and the WAL, as the reference's does.

Over a mesh that carries a process group the region is one rank of an
SPMD program, as the reference's region over a multi-process mesh is:
every rank makes the same calls (entity refs, asks, rebalances,
checkpoints, restores) and gets the same replies. Its system holds the
rank's block of the shard axis (batched/sharded.py); every device write
goes through the system's `set_rows`/`move_rows` (each rank writes its
own rows) and every read through a collective, so every rank takes the
same branch of the ask loop. Only rank 0 writes the journals, the
snapshots, `entities.log` and `region.json`; the other ranks' journals
follow (`writer=False`) and read those files at restore. `failover` over
several ranks raises NotImplementedError naming ROADMAP A10.3, and so
does the continuous wave scheduler (ask_batch.py), whose rounds follow
wall-clock arrivals that ranks do not share.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..batched import Emit, behavior
from ..batched.behavior import BatchedBehavior
from ..batched.sharded import ShardedBatchedSystem
from ..parallel.mesh import make_mesh, mesh_of


@dataclass
class DeviceEntity:
    """Spec for a device-resident sharded entity type.

    delivery_backend: None/"auto", "ranked" or "cuda" (ops/segment.py).
    lease: optional coordination lease (`acquire()`, `settings.lease_name`);
    rebalance must acquire it first. remember_store: optional durable
    remember-entities store (sharding/remember.py): first allocations are
    add()ed, and restore() respawns every remembered id before the
    replay. spill_capacity (a port addition, default None = the system's
    default) is forwarded to the sharded system: with mailbox_slots > 0
    and spill_capacity=0 the mailboxes are bounded, the ring-slots
    kernel's mode. metrics_enabled (a port addition, default False) is
    forwarded too: it compiles the metric slab and its epoch into the
    region's step, for `system.drain_metrics()`."""

    type_name: str
    behavior: BatchedBehavior
    n_shards: int = 256
    entities_per_shard: int = 4096
    n_devices: Optional[int] = None
    spare_blocks: Optional[int] = None   # default: one per device
    payload_width: int = 4
    out_degree: int = 1
    mailbox_slots: int = 0
    host_inbox_per_shard: int = 256
    extra_behaviors: Sequence[BatchedBehavior] = field(default_factory=tuple)
    delivery_backend: Optional[str] = None
    lease: Optional[Any] = None
    remember_store: Optional[Any] = None
    spill_capacity: Optional[int] = None
    metrics_enabled: bool = False


class DeviceEntityRef:
    """Host handle to one device entity (EntityRef analogue)."""

    __slots__ = ("region", "shard", "index", "entity_id")

    def __init__(self, region: "DeviceShardRegion", shard: int, index: int,
                 entity_id: str):
        self.region = region
        self.shard = shard
        self.index = index
        self.entity_id = entity_id

    @property
    def row(self) -> int:
        return self.region.row_of(self.shard, self.index)

    def tell(self, payload, mtype: int = 0) -> None:
        self.region.system.tell(self.row, payload, mtype)

    def read_state(self, col: str):
        return self.region.system.read_state(col, np.asarray([self.row]))[0]

    def __repr__(self):
        return (f"DeviceEntityRef({self.region.type_name}/"
                f"{self.entity_id} shard={self.shard} row={self.row})")


class DeviceShardRegion:
    """Owns the ShardedBatchedSystem and the logical -> physical placement.

    device defaults to CUDA and raises without a card unless device="cpu"
    is passed. mesh: a mesh of shard slots (parallel/mesh.py), of one card
    or over a process group's ranks (the module docstring);
    `spec.n_devices` defaults to its size (else to 1)."""

    def __init__(self, spec: DeviceEntity, mesh=None, device=None):
        self.type_name = spec.type_name
        self.spec = spec
        if mesh is not None:
            mesh = mesh_of(mesh)
        n_devices = spec.n_devices or (mesh.size if mesh is not None else 1)
        spare = spec.spare_blocks if spec.spare_blocks is not None \
            else n_devices
        # pad spares so every shard of the axis hosts the same number of
        # blocks; the promise rows take one spare (or padding) block, and
        # only a region with no free block at all pays for an extra stripe
        total_blocks = spec.n_shards + spare
        if total_blocks % n_devices:
            total_blocks += n_devices - total_blocks % n_devices
        if total_blocks == spec.n_shards:  # zero spares and no padding
            total_blocks += n_devices
        self.n_devices = n_devices
        self.blocks_per_device = total_blocks // n_devices
        self.total_blocks = total_blocks
        self.eps = spec.entities_per_shard
        capacity = total_blocks * self.eps

        self.system = ShardedBatchedSystem(
            capacity=capacity,
            behaviors=[spec.behavior, *spec.extra_behaviors,
                       self._promise_behavior(spec)],
            mesh=mesh, n_devices=n_devices,
            payload_width=spec.payload_width, out_degree=spec.out_degree,
            host_inbox_per_shard=spec.host_inbox_per_shard,
            mailbox_slots=spec.mailbox_slots,
            spill_capacity=spec.spill_capacity,
            reroute_strays=True,  # messages follow rebalanced shards
            delivery_backend=spec.delivery_backend,
            # the latch bit of the attention word says "some promise row
            # replied", so the ask engine reads the promise block only then
            attention_latch_col="__promise_replied",
            metrics_enabled=spec.metrics_enabled, device=device)
        self._ask_latch_wired = True

        # initial allocation: shard s -> block s, striped over the shards
        # of the axis round-robin
        order = np.arange(spec.n_shards, dtype=np.int32)
        stripe = (order % n_devices) * self.blocks_per_device + \
            (order // n_devices)
        self._shard_block = stripe.astype(np.int32)
        used = set(int(b) for b in self._shard_block)
        free = sorted(set(range(total_blocks)) - used)
        # the last free block becomes the promise block (never a shard
        # home, never a rebalance target); its rows resolve asks
        self._promise_block = free.pop()
        self._free_blocks: List[int] = free
        self._promise_free: List[int] = list(range(self.eps))
        # slots whose ask timed out with the reply still in flight: parked
        # until the row's `__promise_replied` latch shows the late reply
        # landed, then returned to the free list
        self._promise_retired: List[int] = []
        self._promise_spawned = False
        self._stat_ask_exhausted = 0  # typed AskPoolExhausted fast-fails
        # the ask engine reads these: a None tracer (attach_tracer wires
        # one) keeps it on its one-predicate quiet path; _wave_seq numbers
        # every wave
        self.tracer = None
        self._wave_seq = 0
        self._lock = threading.Lock()
        # asks and maintenance (checkpoint, rebalance, restore) serialize:
        # all of them step or rewrite the shared runtime. Reentrant,
        # because rebalance checkpoints under its own hold. The lock order
        # is _ask_lock, then _lock, then the system's _lock.
        self._ask_lock = threading.RLock()
        self._stray_steps_left = 0         # hand-off drain window
        # durability (attach_journal): the WAL, the slab snapshots and the
        # placement sidecar make the region restorable in a fresh process
        self.checkpoint_dir: Optional[str] = None
        self._journal = None
        self._ents_fh = None
        # durable entity layer (attach_entity_journal): per-entity events
        # group-committed at the ask-wave boundary; restore replays them
        # into the durable state column
        self._entity_journal = None
        self._durable_col = "total"
        self._per_event_fsync = False
        self._durable_replayed_totals: Optional[Dict[str, float]] = None
        # wall ms of the last restore(): load, h2d, replay (and steps)
        self.restore_timings: Dict[str, float] = {}

        # entity registry: per-shard entity_id -> index, and the reverse
        # view the wave-boundary event commit names entities by
        self._entities: List[Dict[str, int]] = [dict()
                                                for _ in range(spec.n_shards)]
        self._rev: List[Dict[int, str]] = [dict()
                                           for _ in range(spec.n_shards)]
        self._spawned = np.zeros((spec.n_shards,), np.int32)

        self._sync_tables()

    # ----------------------------------------------------------------- ask
    @staticmethod
    def _promise_behavior(spec: DeviceEntity) -> BatchedBehavior:
        """Promise rows: a reply emitted by an entity crosses the exchange
        into this row, which latches it; the host reads the latch."""
        P, k = spec.payload_width, spec.out_degree
        cols = {"__promise_reply": ((P,), torch.float32),
                "__promise_replied": ((), torch.bool)}

        def latch(state, inbox, ctx):
            got = inbox.count > 0
            return ({"__promise_reply": torch.where(
                         got[:, None], inbox.sum, state["__promise_reply"]),
                     "__promise_replied": state["__promise_replied"] | got},
                    Emit.none(got.shape[0], k, P, device=got.device))

        if spec.mailbox_slots > 0:
            @behavior("__shard_promise", cols, inbox="slots")
            def promise(state, mailbox, ctx):
                return latch(state, mailbox.reduce(), ctx)
            return promise
        return behavior("__shard_promise", cols)(latch)

    def _ensure_promise_rows(self) -> None:
        with self._lock:
            if self._promise_spawned:
                return
            self._promise_spawned = True
        sys = self.system
        base = self._promise_block * self.eps
        rows = slice(base, base + self.eps)
        sys.set_rows(sys.behavior_id, rows,
                     len(sys.behaviors) - 1)  # registered last
        sys.set_rows(sys.alive, rows, True)

    def ask(self, shard: int, index: int, message, steps: int = 2,
            max_extra_steps: int = 8):
        """Request/response to entity (shard, index): the reply-to promise
        row rides the payload's LAST column (the entity answers with
        `Emit.single(reply_dst(inbox.sum), ...)`); returns the reply
        payload. Runs `steps` steps, then single steps up to
        `max_extra_steps` more before raising TimeoutError. A timed-out
        ask's slot is retired until its late reply is seen to land.
        A batch of one through the ask engine (ask_batch.py)."""
        out = self.ask_many([(shard, index, message)], steps=steps,
                            max_extra_steps=max_extra_steps)[0]
        if isinstance(out, BaseException):
            raise out
        return out

    def attach_tracer(self, tracer) -> None:
        """Wire the causal tracer (event/tracing.py) into the ask engine:
        wave and member spans are emitted for sampled asks, and the
        tracer's step source becomes this region's system, the step axis
        of the spans describing its waves (read through `self.system` at
        each stamp, so it follows a system the region replaces). None
        detaches it."""
        self.tracer = tracer
        if tracer is not None:
            tracer.step_fn = lambda: self.system._host_step

    def ask_many(self, requests: Sequence[Any], steps: int = 2,
                 max_extra_steps: int = 8,
                 ctxs: Optional[Sequence[Any]] = None) -> List[Any]:
        """Coalesced asks: `requests` is a sequence of
        `(shard, index, message)`; every member gets its own promise row,
        all the tells go out in one flush, and the batch shares one step
        budget. Returns a list aligned with `requests`: the reply payload
        (np.ndarray), or the member's exception instance
        (AskPoolExhausted / TimeoutError / ValueError). Asks to the SAME
        entity serialize across waves within the batch (linearized
        per-entity totals). `ctxs`: optional aligned per-member span
        contexts (one window carries many traces)."""
        from .ask_batch import BatchAsk, execute_ask_batch
        batch = [BatchAsk(int(s), int(i), m, int(steps),
                          int(max_extra_steps)) for s, i, m in requests]
        if ctxs is not None:
            for a, c in zip(batch, ctxs):
                a.trace = c
        with self._ask_lock:
            execute_ask_batch(self, batch)
        return [a.outcome for a in batch]

    def _reclaim_promise_slots(self) -> int:
        """Return retired ask slots whose `__promise_replied` latch is now
        True to the free list: the late reply has landed, so no message in
        flight can target the row any more (every ask resets the latch
        before use). Returns the number reclaimed."""
        with self._lock:
            retired = list(self._promise_retired)
        if not retired:
            return 0
        base = self._promise_block * self.eps
        landed, _ = self.system.read_promise_block(base, self.eps,
                                                   "__promise_replied")
        freed = [s for s in retired if bool(landed[s])]
        with self._lock:
            for s in freed:
                self._promise_retired.remove(s)
                self._promise_free.append(s)
        return len(freed)

    # ------------------------------------------------------------ addressing
    def shard_of(self, entity_id: str) -> int:
        """extractShardId: a process-stable hash, FNV-1a over the id's
        UTF-8 bytes (never Python's salted hash())."""
        h = 2166136261
        for byte in entity_id.encode("utf-8"):
            h = ((h ^ byte) * 16777619) & 0xFFFFFFFF
        return h % self.spec.n_shards

    def row_of(self, shard: int, index: int) -> int:
        return int(self._shard_block[shard]) * self.eps + index

    def device_of_shard(self, shard: int) -> int:
        return int(self._shard_block[shard]) // self.blocks_per_device

    def _sync_tables(self) -> None:
        self.system.set_tables({
            "shard_row_base": torch.from_numpy(
                self._shard_block.astype(np.int32) * np.int32(self.eps))})

    # ------------------------------------------------------------- entities
    def entity_ref(self, entity_id: str,
                   remember: bool = True) -> DeviceEntityRef:
        """Resolve the device entity for an id, allocating its row on first
        use (StartEntity semantics). `remember=False` (a port addition)
        does not add a new id to the remember store: the respawn of ids
        the store gave back."""
        return self.entity_refs([entity_id], remember)[0]

    def entity_refs(self, entity_ids: Sequence[str],
                    remember: bool = True) -> List[DeviceEntityRef]:
        """`entity_ref` of each id, in batches (a port addition): one flush
        of entities.log, the new ids given to the remember store in one
        call where it takes a batch (`add_many`, with their rows), and the
        new rows made live in one write of the tables."""
        refs, new = [], []
        for eid in entity_ids:
            ref, is_new = self._allocate(eid)
            refs.append(ref)
            if is_new and remember:
                new.append(ref)
        with self._lock:
            if self._ents_fh is not None:
                self._ents_fh.flush()
        store = self.spec.remember_store
        if new and store is not None:
            add_many = getattr(store, "add_many", None)
            if add_many is not None:
                add_many(self.type_name, [(str(r.shard), r.entity_id,
                                           r.index) for r in new])
            else:
                for r in new:
                    store.add(self.type_name, str(r.shard), r.entity_id)
        self._spawn(refs)
        return refs

    def _allocate(self, entity_id: str) -> Tuple[DeviceEntityRef, bool]:
        """The entity's ref, its row allocated (and written to
        entities.log, flushed by the caller) on first use; whether it was
        new."""
        shard = self.shard_of(entity_id)
        new = False
        with self._lock:
            idx = self._entities[shard].get(entity_id)
            if idx is None:
                new = True
                idx = len(self._entities[shard])
                if idx >= self.eps:
                    raise RuntimeError(
                        f"shard {shard} full ({self.eps} entities)")
                self._entities[shard][entity_id] = idx
                self._rev[shard][idx] = entity_id
                if self._ents_fh is not None:
                    # a tell journaled to an entity allocated after the
                    # last snapshot must find its row alive on replay
                    self._ents_fh.write(f"{shard}\t{idx}\t{entity_id}\n")
        return DeviceEntityRef(self, shard, idx, entity_id), new

    def _spawn(self, refs: Sequence[DeviceEntityRef]) -> None:
        """Make live every row of each ref's shard up to the ref's, in one
        write of `behavior_id` and `alive` for all of them."""
        top: Dict[int, int] = {}
        for r in refs:
            top[r.shard] = max(top.get(r.shard, -1), r.index)
        spans = []
        with self._lock:
            for shard, idx in top.items():
                start_idx = int(self._spawned[shard])
                if idx < start_idx:
                    continue
                self._spawned[shard] = idx + 1
                base = int(self._shard_block[shard]) * self.eps
                spans.append((base + start_idx, base + idx + 1))
        if not spans:
            return
        rows = slice(*spans[0]) if len(spans) == 1 else np.concatenate(
            [np.arange(a, b, dtype=np.int64) for a, b in spans])
        # device writes go under the ask lock (never during a step), taken
        # outside the registry lock
        with self._ask_lock:
            sys = self.system
            sys.set_rows(sys.behavior_id, rows, 0)
            sys.set_rows(sys.alive, rows, True)

    def allocate_all(self) -> None:
        """Activate every entity slot at once (bench path: 256 x 4096 rows
        live without a million Python calls)."""
        sys = self.system
        alive = np.zeros((sys.capacity,), bool)
        behavior_id = np.zeros((sys.capacity,), np.int32)
        for s in range(self.spec.n_shards):
            base = int(self._shard_block[s]) * self.eps
            alive[base:base + self.eps] = True
            self._spawned[s] = self.eps
        # keep the promise rows an earlier ask spawned (rows never asked
        # stay dead, so the alive mask stays exact)
        with self._lock:
            if self._promise_spawned:
                pbase = self._promise_block * self.eps
                alive[pbase:pbase + self.eps] = True
                behavior_id[pbase:pbase + self.eps] = len(sys.behaviors) - 1
        every = slice(0, sys.capacity)
        sys.set_rows(sys.alive, every, alive)
        sys.set_rows(sys.behavior_id, every, behavior_id)

    # ------------------------------------------------------------- rebalance
    def rebalance(self, shard: int, to_device: Optional[int] = None) -> int:
        """Move one logical shard's block to a spare block (on shard
        `to_device` of the axis, if given): its rows are copied, and the
        messages in flight to the old block, in the inbox and in the host
        staging queue, are re-pointed. Returns the new block index."""
        with self._ask_lock:
            return self._rebalance_locked(shard, to_device)

    def _rebalance_locked(self, shard: int,
                          to_device: Optional[int] = None) -> int:
        lease = self.spec.lease
        if lease is not None and not lease.acquire():
            raise RuntimeError(
                f"rebalance of shard {shard} denied: coordination lease "
                f"{lease.settings.lease_name!r} is held elsewhere")
        # hand-off window: the stray-forwarding step runs until the
        # messages in flight to the old block have drained
        self.system.enter_stray_mode()
        self._stray_steps_left = max(self._stray_steps_left, 3)
        with self._lock:
            old_block = int(self._shard_block[shard])
            candidates = self._free_blocks
            if not candidates:
                raise RuntimeError("no spare blocks to rebalance into")
            if to_device is None:
                new_block = candidates[0]
            else:
                on_dev = [b for b in candidates
                          if b // self.blocks_per_device == to_device]
                if not on_dev:
                    raise RuntimeError(f"no spare block on device {to_device}")
                new_block = on_dev[0]
            self._free_blocks.remove(new_block)
            self._free_blocks.append(old_block)
            self._free_blocks.sort()
            self._shard_block[shard] = new_block

        sys = self.system
        eps = self.eps
        old = slice(old_block * eps, (old_block + 1) * eps)
        new = slice(new_block * eps, (new_block + 1) * eps)
        sys.move_rows(old, new)
        sys.set_rows(sys.alive, old, False)
        delta = (new_block - old_block) * eps
        in_old = (sys.inbox_dst >= old.start) & (sys.inbox_dst < old.stop)
        sys.inbox_dst.add_(in_old.to(torch.int32) * delta)
        with sys._lock:
            sys._host_staged = [
                (d + delta if old.start <= d < old.stop else d, t, p)
                for d, t, p in sys._host_staged]
        self._sync_tables()
        if self.checkpoint_dir is not None:
            # the WAL records tells, not placement moves: drain the
            # hand-off window and snapshot now, so recovery never replays
            # post-move traffic onto pre-move block homes
            guard = 64  # bounded: each pass forwards strays one hop
            while self._stray_steps_left > 0 and guard > 0:
                guard -= self._stray_steps_left
                self.run(self._stray_steps_left)
            self.checkpoint()
        return new_block

    # ------------------------------------------------------------ durability
    def attach_journal(self, directory: str, fsync_every_n: int = 1):
        """Arm the write-ahead tell journal and the checkpoint directory:
        every staged tell is journaled before it is staged (appends flush
        per record, so kill -9 loses no staged tell; fsync every
        `fsync_every_n` appends), and every first allocation is a line of
        `entities.log`. checkpoint() and restore() need this. Returns the
        TellJournal."""
        from ..persistence.tell_journal import TellJournal
        os.makedirs(directory, exist_ok=True)
        self.checkpoint_dir = directory
        self._journal = TellJournal(
            os.path.join(directory, "tells.wal"),
            flight_recorder=self.system.flight_recorder,
            fsync_every_n=fsync_every_n, writer=self._writes_files)
        self.system.tell_journal = self._journal
        if self._writes_files:
            with self._lock:
                self._ents_fh = open(
                    os.path.join(directory, "entities.log"), "a")
        return self._journal

    @property
    def _writes_files(self) -> bool:
        """Whether this region writes the journals' files: always on one
        card, rank 0 only over a process group."""
        return self.system.mesh.rank == 0

    def attach_entity_journal(self, directory: Optional[str] = None,
                              fsync_every_n: int = 1,
                              snapshot_every: int = 64,
                              compact_every: int = 8192,
                              state_col: str = "total",
                              registry=None,
                              per_event_fsync: bool = False):
        """Arm the durable entity layer: every ok ask wave's events
        (entity_id, op, value) land as ONE group-committed record in
        `entities.journal` before the wave's outcomes reach the caller.
        `fsync_every_n` counts waves (1 = one fsync per wave; appends
        always flush, so a process kill -9 loses nothing at any n).
        restore() then pins each entity's `state_col` to the journal's
        fold (snapshot + event tail), the acked frontier.
        `per_event_fsync=True` is the A/B leg (one record + fsync per
        event). `registry`: an optional MetricsRegistry
        (event/metrics.py) for the journal's counters and histograms.
        Returns the EntityJournal."""
        from ..persistence.entity_journal import EntityJournal
        directory = directory or self.checkpoint_dir
        if directory is None:
            raise RuntimeError(
                "attach_entity_journal needs a directory (or "
                "attach_journal first)")
        os.makedirs(directory, exist_ok=True)
        self._durable_col = state_col
        self._per_event_fsync = per_event_fsync
        # a follower folds the file as it opens: over a process group,
        # wait until rank 0 has committed every wave before this call
        self.system.barrier()
        self._entity_journal = EntityJournal(
            os.path.join(directory, "entities.journal"),
            flight_recorder=self.system.flight_recorder,
            fsync_every_n=fsync_every_n, snapshot_every=snapshot_every,
            compact_every=compact_every, registry=registry,
            writer=self._writes_files)
        return self._entity_journal

    def detach_entity_journal(self) -> None:
        """Disarm (A/B legs): close the journal and stop the wave-boundary
        commits; what is journaled stays on disk."""
        ej, self._entity_journal = self._entity_journal, None
        self._per_event_fsync = False
        if ej is not None:
            ej.close()

    def _commit_entity_events(self, resolved) -> None:
        """Wave-boundary group commit, called by the ask engine with the
        wave's ok members while the caller holds `_ask_lock`: name each
        (shard, index) through the reverse registry, drop no-op events (a
        gateway get is add(0)), and append everything as one record. The
        fsync (every fsync_every_n waves) happens here, before any ack
        leaves.

        Members are `(shard, index, message)` or, with the gateway's
        idempotent-session dedup, `(shard, index, message, dedup_key,
        outcome)`: keyed members also record their ok reply
        `(tenant, id, status, value)` in the same record."""
        ej = self._entity_journal
        if ej is None:
            return
        from ..persistence.entity_journal import OP_ADD
        from ..serialization.frames import ST_OK
        events = []
        replies = []
        with self._lock:
            for member in resolved:
                shard, index, message = member[0], member[1], member[2]
                body = np.asarray(message, np.float64).reshape(-1)
                value = float(body[0]) if body.size else 0.0
                if len(member) >= 5 and member[3] is not None:
                    out = np.asarray(member[4], np.float64).reshape(-1)
                    replies.append((member[3][0], member[3][1], ST_OK,
                                    float(out[0]) if out.size else 0.0))
                if value == 0.0:
                    continue
                eid = self._rev[shard].get(index)
                if eid is not None:
                    events.append((eid, OP_ADD, value))
        if events or replies:
            ej.append_wave(int(self.system._host_step), events,
                           per_event_fsync=self._per_event_fsync,
                           replies=replies)

    def _respawn_remembered(self) -> None:
        """Re-host every remembered entity with zero client traffic: the
        union of the remember store's ids and the entity journal's fold,
        allocating rows for ids the sidecar and entities.log missed. Runs
        before the replay, so replayed totals find their rows alive.
        Sorted order makes the placement deterministic, and the store's
        ids are not added back to it (the reference adds them again). A
        store that records each id's row (`remembered_rows`, the ddata
        store) re-hosts those ids first, by shard and row: each takes the
        row it had, so the WAL's tells, which name rows, replay onto the
        right entities even when entities.log is lost (the reference
        sorts those ids too, and misplaces them). An id that cannot take
        its recorded row (a row of the shard unrecorded, or held by
        another id) raises RuntimeError."""
        stored, placed = set(), []
        store = self.spec.remember_store
        rows_of = getattr(store, "remembered_rows", None)
        if store is not None:
            for shard in range(self.spec.n_shards):
                if rows_of is None:
                    stored.update(store.remembered(self.type_name,
                                                   str(shard)))
                    continue
                for eid, index in rows_of(self.type_name,
                                          str(shard)).items():
                    if index is None:
                        stored.add(eid)
                    else:
                        placed.append((shard, index, eid))
        placed.sort()
        refs = self.entity_refs([eid for _s, _i, eid in placed],
                                remember=False)
        for (shard, index, eid), ref in zip(placed, refs):
            if ref.index != index:
                raise RuntimeError(
                    f"remembered entity {eid!r} of shard {shard} had row "
                    f"{index} and would be re-hosted at row {ref.index}")
        journal = set()
        if self._entity_journal is not None:
            journal = set(self._entity_journal.totals())
        given = stored | {eid for _s, _i, eid in placed}
        for eid in sorted(stored | journal):
            self.entity_ref(eid, remember=eid not in given)

    def _replay_entities(self) -> Dict[str, float]:
        """Write the entity journal's fold (snapshot + event tail: the
        acked frontier) into the durable state column in one scatter.
        Runs after the slab + WAL replay: the WAL may have re-applied
        writes that were never acked (in flight at the crash, timed-out
        asks); overwriting with the fold pins the restored state to what
        clients were acknowledged."""
        ej = self._entity_journal
        if ej is None:
            return {}
        totals = ej.totals()
        self._durable_replayed_totals = totals
        if not totals:
            return totals
        rows = [ref.row for ref in self.entity_refs(list(totals))]
        col = self.system.state[self._durable_col]
        self.system.set_rows(col, np.asarray(rows, np.int64),
                             np.asarray(list(totals.values())))
        return totals

    def _sidecar_path(self) -> str:
        return os.path.join(self.checkpoint_dir, "region.json")

    def _write_sidecar(self) -> None:
        """Placement and entity registry beside the slab snapshot (which
        holds state by row): which logical shard owns which block, which
        entity id owns which row. Promise slots held by asks in flight at
        the barrier are written as retired: their replies land in the
        restored run (snapshot inbox or WAL), and the reclaim frees
        them. Only the region that writes the journals' files writes
        it."""
        if not self._writes_files:
            return
        with self._lock:
            retired = list(self._promise_retired)
            taken = set(range(self.eps)) - set(self._promise_free) \
                - set(retired)
            doc = {"shard_block": [int(b) for b in self._shard_block],
                   "free_blocks": list(self._free_blocks),
                   "promise_block": int(self._promise_block),
                   "promise_spawned": bool(self._promise_spawned),
                   "promise_free": list(self._promise_free),
                   "promise_retired": retired + sorted(taken),
                   "entities": [dict(d) for d in self._entities],
                   "spawned": [int(s) for s in self._spawned]}
        tmp = self._sidecar_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._sidecar_path())

    def checkpoint(self, keep: int = 3) -> str:
        """Quiescent-barrier slab snapshot (ShardedBatchedSystem.checkpoint:
        the card is synchronized before the slabs are read), placement
        sidecar, WAL and entity-journal compaction; `keep` snapshots are
        kept. Returns the snapshot's path. Over a process group every
        rank returns once rank 0 has written every file."""
        if self.checkpoint_dir is None:
            raise RuntimeError("attach_journal(directory) before checkpoint")
        with self._ask_lock:
            path = self.system.checkpoint(self.checkpoint_dir, keep=keep)
            self._write_sidecar()
            if self._entity_journal is not None:
                # every event so far is in the live fold: rewrite the log
                # as one snap-all record (a bounded replay tail)
                self._entity_journal.compact()
            # allocations up to here are in the sidecar: reset the log
            with self._lock:
                if self._ents_fh is not None:
                    self._ents_fh.close()
                    self._ents_fh = open(
                        os.path.join(self.checkpoint_dir, "entities.log"),
                        "w")
            self.system.barrier()
        return path

    def restore(self) -> int:
        """Crash recovery in a fresh process: build an identically-spec'd
        region, attach_journal (and attach_entity_journal) on the same
        directory, then restore(): loads the placement sidecar, merges
        entities.log, respawns the remembered entities, re-points the
        device tables, writes the latest slab snapshot into the live
        tensors, replays the WAL to the crash frontier with a 2-step
        flush, and pins the durable column to the entity journal's fold.
        Timings land in `restore_timings`. Returns the recovered host
        step counter."""
        from ..persistence.slab_snapshot import latest_slab_path
        if self.checkpoint_dir is None:
            raise RuntimeError("attach_journal(directory) before restore")
        with self._ask_lock:
            path = latest_slab_path(self.checkpoint_dir)
            if path is None:
                raise FileNotFoundError(
                    f"no slab snapshot under {self.checkpoint_dir}")
            self.system.barrier()  # rank 0's attaches have repaired
            with open(self._sidecar_path()) as f:
                doc = json.load(f)
            self._load_sidecar(doc)
            self._merge_entity_log()
            self.system.barrier()  # read before rank 0 appends again
            self._respawn_remembered()
            self._sync_tables()  # the replayed steps read the tables
            step = self._restore_and_replay(path)
            t0 = time.perf_counter()
            self._replay_entities()
            self.system.block_until_ready()
            self.restore_timings["replay_ms"] += \
                (time.perf_counter() - t0) * 1e3
            return step

    def _merge_entity_log(self) -> None:
        """Fold entities.log into the registry: the allocations since the
        last sidecar write (checkpoint truncates the log once the sidecar
        covers it, so duplicates appear only across a crash in
        between)."""
        path = os.path.join(self.checkpoint_dir, "entities.log")
        if not os.path.exists(path):
            return
        with open(path) as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) != 3:
                    continue  # torn tail of a crashed append
                shard, idx = int(parts[0]), int(parts[1])
                with self._lock:
                    self._entities[shard].setdefault(parts[2], idx)
                    self._rev[shard][self._entities[shard][parts[2]]] = \
                        parts[2]
                    self._spawned[shard] = max(int(self._spawned[shard]),
                                               idx + 1)

    def _restore_and_replay(self, path: str) -> int:
        """Slab restore, host-side row re-activation, THEN the WAL replay
        (replayed tells to entities allocated after the snapshot must find
        their rows alive), then a 2-step flush so the crash-frontier batch
        is applied to state, not just re-staged."""
        from ..persistence.slab_snapshot import load_slab_tree
        from ..persistence.tell_journal import replay_journal
        sys = self.system
        t0 = time.perf_counter()
        tree = load_slab_tree(path)
        t1 = time.perf_counter()
        step = sys.restore_tree(tree, journal=None)
        self._reactivate_rows()
        sys.block_until_ready()
        t2 = time.perf_counter()
        if self._journal is not None:
            step = replay_journal(sys, self._journal)
        sys.run(2)
        sys.block_until_ready()
        self.restore_timings = {
            "load_ms": (t1 - t0) * 1e3, "h2d_ms": (t2 - t1) * 1e3,
            "replay_ms": (time.perf_counter() - t2) * 1e3,
            "snapshot_step": float(tree["step_count"]),
            "replayed_steps": float(sys._host_step - int(
                tree["step_count"]))}
        return step

    def _reactivate_rows(self) -> None:
        """Every registered entity row alive with the entity behavior, and
        the promise block with the promise behavior if it was spawned."""
        sys = self.system
        rows: List[int] = []
        with self._lock:
            for shard in range(self.spec.n_shards):
                base = int(self._shard_block[shard]) * self.eps
                rows.extend(range(base, base + int(self._spawned[shard])))
            promise = self._promise_spawned
        if rows:
            idx = np.asarray(rows, np.int64)
            sys.set_rows(sys.behavior_id, idx, 0)
            sys.set_rows(sys.alive, idx, True)
        if promise:
            pbase = self._promise_block * self.eps
            prow = slice(pbase, pbase + self.eps)
            sys.set_rows(sys.behavior_id, prow, len(sys.behaviors) - 1)
            sys.set_rows(sys.alive, prow, True)

    def _load_sidecar(self, doc: Dict[str, Any]) -> None:
        with self._lock:
            self._shard_block = np.asarray(doc["shard_block"], np.int32)
            self._free_blocks = [int(b) for b in doc["free_blocks"]]
            self._promise_block = int(doc["promise_block"])
            self._promise_spawned = bool(doc["promise_spawned"])
            self._promise_free = [int(s) for s in doc["promise_free"]]
            self._promise_retired = [int(s) for s in doc["promise_retired"]]
            self._entities = [{str(k): int(v) for k, v in d.items()}
                              for d in doc["entities"]]
            self._rev = [{v: k for k, v in d.items()}
                         for d in self._entities]
            self._spawned = np.asarray(doc["spawned"], np.int32)

    def failover(self, survivors: Sequence[Any]) -> int:
        """Evict lost shard slots and rebuild the region on the survivors
        (slots of the region's mesh, `system.mesh.slots`) from the latest
        snapshot and the WAL, the sentinel's force-evict recipe applied
        to the region. The placement table is in row space, so shard
        homes, entity rows and the promise block all survive; only
        blocks_per_device changes. total_blocks must divide by the
        survivor count. The tell journal is re-armed after the replay,
        and the entity journal's fold overwrites the durable column.
        Returns the recovered step. Over several ranks it raises
        NotImplementedError: failover across ranks is ROADMAP A10.3."""
        if self.system.mesh.group is not None:
            raise NotImplementedError(
                "DeviceShardRegion.failover over a mesh of ranks: "
                "failover across ranks (every rank agreeing on the lost "
                "slots, evicting only a live rank's) is ROADMAP A10.3")
        with self._ask_lock:
            return self._failover_locked(survivors)

    def _failover_locked(self, survivors: Sequence[Any]) -> int:
        from ..persistence.slab_snapshot import latest_slab_path
        if self.checkpoint_dir is None:
            raise RuntimeError("attach_journal(directory) before failover")
        n_surv = len(survivors)
        if n_surv < 1 or self.total_blocks % n_surv:
            raise RuntimeError(
                f"cannot re-stripe {self.total_blocks} blocks over "
                f"{n_surv} survivors")
        path = latest_slab_path(self.checkpoint_dir)
        if path is None:
            raise FileNotFoundError(
                f"no slab snapshot under {self.checkpoint_dir}")
        old = self.system
        old_journal = self._journal
        spec = self.spec
        mesh = make_mesh(devices=list(survivors), axis_name=old.axis)
        new = ShardedBatchedSystem(
            capacity=old.capacity,
            behaviors=[spec.behavior, *spec.extra_behaviors,
                       self._promise_behavior(spec)],
            mesh=mesh, n_devices=n_surv,
            payload_width=spec.payload_width, out_degree=spec.out_degree,
            host_inbox_per_shard=spec.host_inbox_per_shard,
            mailbox_slots=spec.mailbox_slots,
            spill_capacity=spec.spill_capacity,
            reroute_strays=True,
            delivery_backend=spec.delivery_backend,
            attention_latch_col="__promise_replied",
            metrics_enabled=spec.metrics_enabled)
        new.flight_recorder = old.flight_recorder
        # the old system's graphs and their pool go now, before the new
        # step is captured (the region's lock keeps every caller out)
        old._graphs.clear()
        self.n_devices = n_surv
        self.blocks_per_device = self.total_blocks // n_surv
        self._stray_steps_left = 0
        self.system = new
        del old  # its tensors go before the restore allocates
        self._sync_tables()  # before replay: behaviors read shard_row_base
        step = self._restore_and_replay(path)
        new.tell_journal = old_journal  # re-arm AFTER replay (no re-journal)
        # durable entity layer: the in-process journal's fold is current,
        # so the survivors get the same acked-frontier overwrite a fresh
        # process's restore gets (asks in flight just failed)
        self._replay_entities()
        return step

    # ----------------------------------------------------------------- stats
    def stats(self) -> Dict[str, Any]:
        """ClusterShardingStats analogue."""
        per_device: Dict[int, int] = {}
        for s in range(self.spec.n_shards):
            d = self.device_of_shard(s)
            per_device[d] = per_device.get(d, 0) + int(self._spawned[s])
        return {"type": self.type_name,
                "shards": self.spec.n_shards,
                "entities": int(self._spawned.sum()),
                "entities_per_device": per_device,
                "free_blocks": list(self._free_blocks)}

    def ask_pool_stats(self) -> Dict[str, Any]:
        """Promise-slot occupancy of this region's ask block (the
        admission signal). `retired` slots are timed-out asks still
        counted in flight; `exhausted` counts AskPoolExhausted
        fast-fails."""
        with self._lock:
            free = len(self._promise_free)
            retired = len(self._promise_retired)
            exhausted = self._stat_ask_exhausted
        size = self.eps
        in_flight = max(0, size - free)
        return {"size": size, "free": free, "in_flight": in_flight,
                "retired": retired, "exhausted": exhausted,
                "occupancy": (in_flight / size) if size else 1.0}

    # ------------------------------------------------------------------ run
    def run(self, n_steps: int = 1) -> None:
        """Step the region. The stray-forwarding step is confined to the
        hand-off window after a rebalance: a long run() leaves it as soon
        as the window has drained."""
        while n_steps > 0 and self._stray_steps_left > 0:
            k = min(n_steps, self._stray_steps_left)
            self.system.run(k)
            n_steps -= k
            self._stray_steps_left -= k
            if self._stray_steps_left <= 0:
                self.system.block_until_ready()
                if not self.system.exit_stray_mode():
                    self._stray_steps_left = 1  # still draining: retry
        if n_steps > 0:
            self.system.run(n_steps)

    def block_until_ready(self) -> None:
        self.system.block_until_ready()
