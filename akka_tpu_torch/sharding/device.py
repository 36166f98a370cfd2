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

Not ported yet: the durability and failover half of the reference module
(`attach_journal` ... `failover`, ROADMAP A8/A10: `checkpoint`, `restore`
and `failover` raise NotImplementedError naming their item), the
remember-entities store, and `attach_tracer` (ROADMAP A9: `tracer` stays
None, so the ask engine runs the reference's no-tracer path).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..batched import Emit, behavior
from ..batched.behavior import BatchedBehavior
from ..batched.bridge import read_promise_block
from ..batched.sharded import ShardedBatchedSystem


@dataclass
class DeviceEntity:
    """Spec for a device-resident sharded entity type.

    delivery_backend: None/"auto", "ranked" or "cuda" (ops/segment.py).
    lease: optional coordination lease (`acquire()`, `settings.lease_name`);
    rebalance must acquire it first. spill_capacity (a port addition,
    default None = the system's default) is forwarded to the sharded
    system: with mailbox_slots > 0 and spill_capacity=0 the mailboxes are
    bounded, the ring-slots kernel's mode."""

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
    spill_capacity: Optional[int] = None


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
    is passed; mesh must be None (one card)."""

    def __init__(self, spec: DeviceEntity, mesh=None, device=None):
        self.type_name = spec.type_name
        self.spec = spec
        n_devices = spec.n_devices or 1
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
            attention_latch_col="__promise_replied", device=device)
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
        # the ask engine reads these: a None tracer keeps it on its
        # one-predicate quiet path (no tracer is wired in yet, ROADMAP
        # A9); _wave_seq numbers every wave
        self.tracer = None
        self._wave_seq = 0
        self._lock = threading.Lock()
        # asks and maintenance (rebalance) serialize: both step or rewrite
        # the shared runtime. The lock order is _ask_lock, then _lock.
        self._ask_lock = threading.RLock()
        self._stray_steps_left = 0         # hand-off drain window

        # entity registry: per-shard entity_id -> index
        self._entities: List[Dict[str, int]] = [dict()
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
        sys.behavior_id[rows] = len(sys.behaviors) - 1  # registered last
        sys.alive[rows] = True

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
        landed, _ = read_promise_block(self.system.state, base, self.eps,
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
    def entity_ref(self, entity_id: str) -> DeviceEntityRef:
        """Resolve the device entity for an id, allocating its row on first
        use (StartEntity semantics)."""
        shard = self.shard_of(entity_id)
        with self._lock:
            idx = self._entities[shard].get(entity_id)
            if idx is None:
                idx = len(self._entities[shard])
                if idx >= self.eps:
                    raise RuntimeError(
                        f"shard {shard} full ({self.eps} entities)")
                self._entities[shard][entity_id] = idx
        self._ensure_spawned(shard, idx)
        return DeviceEntityRef(self, shard, idx, entity_id)

    def _ensure_spawned(self, shard: int, idx: int) -> None:
        with self._lock:
            if idx < self._spawned[shard]:
                return
            start_idx = int(self._spawned[shard])
            self._spawned[shard] = idx + 1
            base = int(self._shard_block[shard]) * self.eps
        rows = slice(base + start_idx, base + idx + 1)
        # device writes go under the ask lock (never during a step), taken
        # outside the registry lock
        with self._ask_lock:
            sys = self.system
            sys.behavior_id[rows] = 0
            sys.alive[rows] = True

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
        sys.alive = torch.from_numpy(alive).to(sys.device)
        sys.behavior_id = torch.from_numpy(behavior_id).to(sys.device)

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
        for arr in sys.state.values():
            arr[new] = arr[old]
        sys.behavior_id[new] = sys.behavior_id[old]
        sys.alive[new] = sys.alive[old]
        sys.alive[old] = False
        delta = (new_block - old_block) * eps
        in_old = (sys.inbox_dst >= old.start) & (sys.inbox_dst < old.stop)
        sys.inbox_dst.add_(in_old.to(torch.int32) * delta)
        with sys._lock:
            sys._host_staged = [
                (d + delta if old.start <= d < old.stop else d, t, p)
                for d, t, p in sys._host_staged]
        self._sync_tables()
        return new_block

    # ------------------------------------------------- durability, failover
    def checkpoint(self, keep: int = 3) -> str:
        """Not ported yet: slab snapshots and the journals are ROADMAP
        A8. The gateway's admin channel replies `admin_fault:` with this
        error."""
        raise NotImplementedError(
            "DeviceShardRegion.checkpoint is not ported yet (ROADMAP A8: "
            "slab snapshot, tell journal, entity journal)")

    def restore(self) -> int:
        """Not ported yet (ROADMAP A8)."""
        raise NotImplementedError(
            "DeviceShardRegion.restore is not ported yet (ROADMAP A8: "
            "slab snapshot, tell journal, entity journal)")

    def failover(self, survivors: Sequence[Any]) -> int:
        """Not ported yet: rebuilding the region on surviving cards is
        ROADMAP A10."""
        raise NotImplementedError(
            "DeviceShardRegion.failover is not ported yet (ROADMAP A10: "
            "more than one device)")

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
