"""BatchedRuntimeHandle: the host-ActorRef <-> device-row bridge.

Port of `akka_tpu/batched/bridge.py` at commit 5d9b7cd. This is the
mechanism behind the `tpu-batched` dispatcher type: Props carrying a
device behavior spawn rows in the dispatcher-owned BatchedSystem behind
ordinary ActorRefs, `ref.tell` stages into the device inbox, and `ask`
completes through promise rows read back after a step (the reference call
stack replaced is ActorRef.! -> Dispatcher.dispatch -> Mailbox.run ->
receive; dispatch/Dispatchers.scala:121-259 is the extension seam).

Pieces:
- MessageCodec: host message object <-> (mtype, payload row). The default
  codec passes (mtype, payload) tuples and bare numbers/arrays through.
- BatchedRuntimeHandle: a lazily built BatchedSystem, row allocation,
  promise rows for ask, and an auto-pump thread that steps the device
  while host work is pending.
- DeviceActorRef: a watchable ActorRef bound to one row (late tells after
  stop go to dead letters).
- DeviceBlockRef: one ref addressing a spawned block (bulk tells
  broadcast; `block[i]` derives the per-row ref).

Ask/reply convention: the encoded payload's LAST column carries the
reply-to row id as a value cast; replying behaviors emit to
`reply_dst(payload)`. Promise rows run a reduce-kind behavior that latches
the first reply. The cast is exact only while every row id fits the
payload dtype's integer range (2^24 for float32, 2^11 for float16, 2^8 for
bfloat16); the handle refuses, at construction, capacities whose reply ids
would round.

Where the port differs from the reference:
- The handle runs on `device` (default CUDA, which raises without a card;
  "cpu" on request), and takes the system's `spill_capacity` (0 bounds a
  slots mailbox at its slots, the ring kernel K2's mode). On a card every step is a replay of the system's
  CUDA graph, captured when the runtime is built (batched/graphs.py), and
  every device call of the handle (spawn, stop, the latch writes, reads,
  the capture itself) runs under `_step_lock`.
- The graph writes each step's attention word into one carried tensor, so
  the depth-k pump snapshots each enqueued step's word into pinned host
  memory as it enqueues the step (core.snapshot_word) and retires the
  snapshots in order; the reference fetches a fresh attention array per
  step.
- Latch writes and rebuilds are in-place writes on the carried tensors: a
  rebuild's new system adopts the old system's tensors before its first
  capture, the old graphs are dropped, and the new step is captured.
- bf16 payloads have no numpy dtype: the default codec encodes them as
  float32 rows (staging casts them), and replies and reads come back as
  float32.
- Host tells stage in the system's native stager or Python list
  (`native_staging`, forwarded to BatchedSystem); a rebuild's new system
  shares the old one's staging buffer.
"""

from __future__ import annotations

import math
import os
import threading
import time
import traceback
from collections import deque
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..actor.messages import DeadLetter
from ..actor.ref import ActorRef, InternalActorRef
from ..dispatch import sysmsg
from ..pattern.backoff import backoff_delay
from ..pattern.circuit_breaker import (CircuitBreaker,
                                       CircuitBreakerOpenException)
from ..utils.device import resolve_device
from .behavior import BatchedBehavior, Emit, behavior as behavior_deco
from .core import BatchedSystem, _numpy_dtype, snapshot_word
from .metrics_slab import ASK_ARM_COL
from .sentinel import ShardProgressMonitor
from .supervision import ATT_FAILED_BIT, ATT_FLAGS, ATT_LATCH_BIT


class AskPoolExhausted(RuntimeError):
    """Every promise row is claimed by an in-flight (or quarantined) ask:
    the ask fails fast and typed instead of queueing or burning its
    timeout. Admission layers catch it to shed load: it is the ask pool's
    backpressure signal, as mailbox_overflow is for tells. Sized by the
    tpu-batched dispatcher's `promise-rows` key."""


class RecoveredAskLost(Exception):
    """Failed into ask futures that were outstanding when the runtime was
    restored from a checkpoint: the snapshot overwrites the promise-row
    latches, so the reply can never arrive."""


# --------------------------------------------------------------------- codec
class MessageCodec:
    """Host message object <-> fixed-schema device row."""

    def encode(self, message: Any, reply_to: int = -1
               ) -> Tuple[int, np.ndarray]:
        raise NotImplementedError

    def decode(self, payload: np.ndarray) -> Any:
        raise NotImplementedError


class DefaultCodec(MessageCodec):
    """(mtype, payload) tuples pass through; bare scalars/arrays get type 0.
    reply_to (when >= 0) is written into the last payload column. `dtype`
    is a numpy dtype or a torch payload dtype (bf16 encodes as float32)."""

    def __init__(self, payload_width: int, dtype=np.float32):
        self.payload_width = payload_width
        self.dtype = _numpy_dtype(dtype) if isinstance(dtype, torch.dtype) \
            else np.dtype(dtype)

    def encode(self, message: Any, reply_to: int = -1
               ) -> Tuple[int, np.ndarray]:
        if isinstance(message, tuple) and len(message) == 2 and \
                isinstance(message[0], (int, np.integer)):
            mtype, body = message
        else:
            mtype, body = 0, message
        row = np.zeros(self.payload_width, self.dtype)
        arr = np.atleast_1d(np.asarray(body, self.dtype)).reshape(-1)
        row[: arr.shape[0]] = arr[: self.payload_width]
        if reply_to >= 0:
            row[-1] = reply_to
        return int(mtype), row

    def decode(self, payload: np.ndarray) -> Any:
        return payload


def reply_dst(payload: torch.Tensor) -> torch.Tensor:
    """For behaviors: the reply-to row ids encoded in the payloads' last
    column ([n, P] -> [n] int32; the ask convention)."""
    return payload[..., -1].to(torch.int32)


def max_exact_row_id(dtype: torch.dtype) -> int:
    """Largest row id a value cast into `dtype` round-trips exactly.

    Integers: the dtype's max. Floats: every integer up to
    2^(mantissa bits + 1) is exact (float32 -> 2^24, float16 -> 2^11,
    bfloat16 -> 2^8)."""
    if dtype.is_floating_point:
        return int(round(2.0 / torch.finfo(dtype).eps))
    return int(torch.iinfo(dtype).max)


def read_promise_block(state: Dict[str, torch.Tensor], base: int, n: int,
                       replied_col: str, reply_col: Optional[str] = None
                       ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """One host fetch of a promise block's latch (and, optionally, reply)
    columns, rows [base, base + n). Returns `(replied, replies)` numpy
    arrays (`replies` is None unless `reply_col` is given; bf16 replies
    come back as float32), copies that later steps do not change; the copy
    waits for every step already enqueued."""
    # deferred: slab_snapshot imports this package
    from ..persistence.slab_snapshot import host_array
    replied = host_array(state[replied_col][base:base + n])
    if reply_col is None:
        return replied, None
    return replied, host_array(state[reply_col][base:base + n])


def _slice_init(value, idx_or_mask, n_rows: int):
    """The per-row slice of an init value: arrays whose leading dim matches
    the spawn's row count are per-row (spawn_block broadcast semantics);
    anything else is a scalar/broadcast value."""
    v = np.asarray(value)
    if v.ndim >= 1 and v.shape[0] == n_rows:
        return v[idx_or_mask]
    return value


# ----------------------------------------------------------------- the handle
class _SpawnRecord:
    __slots__ = ("behavior", "n", "init_state", "rows")

    def __init__(self, behavior, n, init_state, rows):
        self.behavior = behavior
        self.n = n
        self.init_state = init_state
        self.rows = rows


class BatchedRuntimeHandle:
    """Owns the device runtime for one tpu-batched dispatcher.

    The runtime is built lazily at the first step, so behaviors registered
    in any spawn order land in one behavior switch; spawning a NEW behavior
    type after the build rebuilds the system and keeps all state, rows and
    in-flight inbox contents (behavior ids are append-only, so existing
    behavior_id columns stay valid).
    """

    PROMISE_REPLY = "__promise_reply"
    PROMISE_REPLIED = "__promise_replied"

    def __init__(self, capacity: int = 1 << 20, payload_width: int = 8,
                 out_degree: int = 1, host_inbox: int = 4096,
                 mailbox_slots: int = 0, promise_rows: int = 256,
                 auto_step_interval: float = 0.001,
                 payload_dtype=torch.float32, event_stream=None,
                 flight_recorder=None, failure_policy: str = "restart",
                 pipeline_depth: int = 2,
                 delivery_backend: Optional[str] = None,
                 checkpoint_interval_steps: int = 0,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_keep: int = 3,
                 wal_fsync_every_n: int = 1,
                 sentinel_threshold: float = 8.0,
                 sentinel_heartbeat_interval: float = 0.1,
                 sentinel_acceptable_pause: float = 3.0,
                 sentinel_max_failovers: int = 3,
                 sentinel_depth_recovery_rounds: int = 64,
                 metrics_enabled: bool = False,
                 metrics_registry=None, device=None,
                 spill_capacity: Optional[int] = None,
                 native_staging: Optional[bool] = None):
        self.capacity = capacity
        self.payload_width = payload_width
        self.out_degree = out_degree
        self.host_inbox = host_inbox
        self.mailbox_slots = mailbox_slots
        self.promise_rows_n = promise_rows
        self.auto_step_interval = auto_step_interval
        self.payload_dtype = payload_dtype
        # raises here, not at the first tell, when CUDA is asked for and
        # no card is present
        self.device = resolve_device(device)
        # depth-k dispatch pipeline: the pump and step(n) keep up to this
        # many steps in flight before waiting on the oldest one's attention
        # word (1 = synchronous)
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.delivery_backend = delivery_backend
        # slots mode: None keeps the system's default spill region (the
        # ranked kernels); 0 bounds each mailbox at its slots, which the
        # ring-mailbox kernel K2 delivers
        self.spill_capacity = spill_capacity
        # where tells stage (BatchedSystem's native_staging: None takes the
        # native stager when its library builds, True requires it)
        self.native_staging = native_staging
        # ask reply routing rides a VALUE CAST of the reply row id into the
        # payload dtype's last column: refuse any capacity whose ids would
        # round (a bf16 payload system with 1M rows would misroute replies)
        limit = max_exact_row_id(payload_dtype)
        if capacity - 1 > limit:
            name = str(payload_dtype).removeprefix("torch.")
            raise ValueError(
                f"capacity {capacity} exceeds the exactly-representable "
                f"row-id range of payload_dtype {name} (max id {limit}): "
                f"ask reply ids are value-cast into the last payload column "
                f"and would silently round — use float32/int32 payloads "
                f"or capacity <= {limit + 1}")
        self.event_stream = event_stream
        self.flight_recorder = flight_recorder
        if failure_policy not in ("restart", "stop", "suspend"):
            raise ValueError(f"unknown failure_policy {failure_policy!r}")
        self.failure_policy = failure_policy
        self._reported_failed: set = set()  # rows already published
        # (rows, init_state) per spawn: a restart re-applies the spawn-time
        # init (Props re-instantiation), not zeros. Rows are stored
        # explicitly: free-list reuse makes spawn results non-contiguous.
        self._spawn_inits: List[Tuple[np.ndarray, Dict[str, Any]]] = []
        self.default_codec = DefaultCodec(payload_width, payload_dtype)

        self._behaviors: List[BatchedBehavior] = []
        self._spawns: List[_SpawnRecord] = []
        self._next_row = 0
        self._runtime: Optional[BatchedSystem] = None
        self._lock = threading.RLock()

        # detection-only shard sentinel: every drain feeds the attention
        # word's progress lane to a phi-accrual detector, so a hung device
        # surfaces as a device_suspected flight-recorder event.
        # max_failovers and depth_recovery_rounds are carried in stats for
        # parity with MeshSentinel; the handle fails over nothing, so they
        # stay inert, as in the reference.
        self.sentinel_max_failovers = int(sentinel_max_failovers)
        self.sentinel_depth_recovery_rounds = int(
            sentinel_depth_recovery_rounds)
        self._sentinel = ShardProgressMonitor(
            threshold=sentinel_threshold,
            heartbeat_interval=sentinel_heartbeat_interval,
            acceptable_pause=sentinel_acceptable_pause)
        self._sentinel_reported: set = set()

        # ask machinery
        self._promise_base: Optional[int] = None
        self._promise_free: List[int] = []
        self._waiters: Dict[int, Tuple[Future, MessageCodec]] = {}
        self._waiter_deadlines: Dict[int, Tuple[Optional[float], float]] = {}
        # timed-out asks whose reply may still be in flight: the slot is
        # quarantined (not freed) until the late reply latches or a hard
        # deadline passes, so no new ask receives the old question's answer
        self._promise_zombies: Dict[int, float] = {}
        self._stat_ask_exhausted = 0  # typed fast-fails (AskPoolExhausted)

        # pump
        self._pump_thread: Optional[threading.Thread] = None
        self._pump_wake = threading.Event()
        self._shutdown = False
        self._pending_tells = 0  # wake hint of the staging path
        # serializes every device call of the handle: steps, spawns, stops,
        # latch writes, reads and the graph capture
        self._step_lock = threading.Lock()

        # pipeline telemetry (plain ints mutated under the GIL): drains
        # that paid the wide promise readback (wide_resolves) against
        # those that got away with host-only deadline bookkeeping
        # (host_checks)
        self._stat_steps = 0
        self._stat_drains = 0
        self._stat_wide_resolves = 0
        self._stat_host_checks = 0
        self._stat_reported = np.zeros((4,), np.int64)  # FR delta snapshot
        # per-iteration host cost of step(n) (enqueue + forced drains)
        self._dispatch_s: deque = deque(maxlen=4096)
        self._dispatch_seq = 0
        self._dispatch_sorted: Tuple[int, List[float]] = (-1, [])

        # auto-checkpoint cadence: every checkpoint_interval_steps
        # dispatched steps the pump snapshots into checkpoint_dir, keeping
        # checkpoint_keep. checkpoint_dir alone (interval 0) still arms the
        # write-ahead tell journal for manual checkpoint()/restore().
        # Snapshot failures degrade (circuit breaker + backoff + a
        # flight-recorder warning); the step loop never stalls on them.
        self.checkpoint_interval_steps = max(0, int(checkpoint_interval_steps))
        self.checkpoint_dir = checkpoint_dir or None
        self.checkpoint_keep = max(1, int(checkpoint_keep))
        self.wal_fsync_every_n = max(1, int(wal_fsync_every_n))
        self._journal = None  # persistence.tell_journal.TellJournal
        self._ckpt_last_step = 0
        self._ckpt_failures = 0
        self._ckpt_retry_at = 0.0
        # scheduler=None: only the sync path is used, which never schedules
        self._ckpt_breaker = CircuitBreaker(
            None, max_failures=3, call_timeout=60.0, reset_timeout=5.0,
            exponential_backoff_factor=2.0, max_reset_timeout=300.0)
        self._ckpt_stats = {"checkpoints": 0, "failures": 0,
                            "last_step": 0, "last_duration_s": 0.0,
                            "last_size_bytes": 0, "last_path": None}

        # telemetry plane: metrics_enabled compiles the metric slab into
        # the step; the registry takes the *_stats() dicts as collectors
        # and ingests the slab at the pump's busy->idle edge and at the
        # checkpoint barrier. A caller-supplied registry is shared;
        # otherwise the handle owns one and closes it.
        self.metrics_enabled = bool(metrics_enabled)
        self._owns_registry = metrics_registry is None and self.metrics_enabled
        if metrics_registry is None and self.metrics_enabled:
            from ..event.metrics import MetricsRegistry
            metrics_registry = MetricsRegistry()
        self.metrics_registry = metrics_registry
        if self.metrics_registry is not None:
            reg = self.metrics_registry
            reg.register_collector("pipeline", self.pipeline_stats)
            reg.register_collector("checkpoint", self.checkpoint_stats)
            reg.register_collector("sentinel", self._sentinel_metrics)
            reg.register_collector("ask_pool", self.ask_pool_stats)

    # -------------------------------------------------------------- behaviors
    def _behavior_index(self, b: BatchedBehavior) -> int:
        with self._lock:  # registration races spawn()/runtime() callers
            for i, x in enumerate(self._behaviors):
                if x is b:
                    return i
            self._behaviors.append(b)
            if self._runtime is not None:
                self._rebuild()
            return len(self._behaviors) - 1

    def _promise_behavior(self) -> BatchedBehavior:
        p_w, k, dtype = self.payload_width, self.out_degree, self.payload_dtype
        reply_col, replied_col = self.PROMISE_REPLY, self.PROMISE_REPLIED

        @behavior_deco("__promise",
                       {reply_col: ((p_w,), dtype),
                        replied_col: ((), torch.bool)})
        def promise(state, inbox, ctx):
            got = inbox.count > 0
            # latch the FIRST reply (AskSupport: first answer wins)
            take = got & ~state[replied_col]
            return ({reply_col: torch.where(take[:, None],
                                            inbox.sum.to(dtype),
                                            state[reply_col]),
                     replied_col: state[replied_col] | got},
                    Emit.none(got.shape[0], k, p_w, dtype, got.device))

        return promise

    def _system(self, behaviors: List[BatchedBehavior]) -> BatchedSystem:
        rt = BatchedSystem(
            capacity=self.capacity, behaviors=behaviors,
            payload_width=self.payload_width, out_degree=self.out_degree,
            host_inbox=self.host_inbox, payload_dtype=self.payload_dtype,
            device=self.device, mailbox_slots=self.mailbox_slots,
            spill_capacity=self.spill_capacity,
            native_staging=self.native_staging,
            delivery_backend=self.delivery_backend,
            # the promise-latch column feeds ATT_LATCH_BIT of the attention
            # word: the pump pays the promise-block readback only when some
            # row latched a reply
            attention_latch_col=self.PROMISE_REPLIED,
            metrics_enabled=self.metrics_enabled)
        if self.event_stream is not None:
            rt.on_dropped = self._publish_dropped
            rt.on_dead_letter = self._publish_dead_letters
        fr = self.flight_recorder
        # a disabled recorder would cost the step a supervision read
        rt.flight_recorder = fr if fr is not None and \
            getattr(fr, "enabled", True) else None
        return rt

    # ------------------------------------------------------------------ spawn
    def spawn(self, b: BatchedBehavior, n: int = 1,
              init_state: Optional[Dict[str, Any]] = None) -> np.ndarray:
        """Allocate n rows of behavior b. Returns global row ids."""
        with self._lock:
            self._behavior_index(b)
            if self._runtime is not None:
                with self._step_lock:  # slab writes must not race a step
                    rows = self._runtime.spawn_block(
                        self._behaviors.index(b), n, init_state)
                if init_state:
                    self._spawn_inits.append(
                        (np.asarray(rows, np.int32), dict(init_state)))
                return rows
            # pre-build: the top promise_rows_n rows are reserved for ask()
            if self._next_row + n > self.capacity - self.promise_rows_n:
                raise RuntimeError("device actor capacity exhausted")
            rows = np.arange(self._next_row, self._next_row + n,
                             dtype=np.int32)
            self._next_row += n
            self._spawns.append(_SpawnRecord(b, n, init_state, rows))
            if init_state:
                self._spawn_inits.append((rows.copy(), dict(init_state)))
            return rows

    def stop_rows(self, rows) -> None:
        self._ensure_runtime()
        arr = np.atleast_1d(np.asarray(rows, np.int32))
        with self._step_lock:
            # re-resolve under the lock: a rebuild swaps the runtime
            self._runtime.stop_block(arr)
        with self._lock:
            # prune init records under the lock spawn() appends with: a
            # recycled row's new occupant must never inherit the old
            # spawn's init values on restart
            pruned = []
            for rec_rows, init in self._spawn_inits:
                mask = ~np.isin(rec_rows, arr)
                if mask.all():
                    pruned.append((rec_rows, init))
                elif mask.any():
                    pruned.append((rec_rows[mask],
                                   {c: _slice_init(v, mask, rec_rows.size)
                                    for c, v in init.items()}))
            self._spawn_inits = pruned

    def generation_of(self, rows) -> np.ndarray:
        """Incarnation generations for rows (pre-build rows are gen 0:
        nothing can have stopped yet). Does not force the runtime build."""
        arr = np.atleast_1d(np.asarray(rows, np.int64))
        with self._lock:
            if self._runtime is None:
                return np.zeros(arr.shape, np.int64)
            return self._runtime.generation_of(arr)

    def read_state(self, col: str, rows=None) -> np.ndarray:
        """A host copy of a state column (all rows, or `rows`), taken
        under the step lock, after every step already enqueued (bf16
        columns come back as float32)."""
        from ..persistence.slab_snapshot import host_array
        self._ensure_runtime()
        with self._step_lock:
            col_t = self._runtime.state[col]
            if rows is not None:
                col_t = col_t[torch.as_tensor(
                    np.asarray(rows, np.int64).reshape(-1),
                    device=col_t.device)]
            out = host_array(col_t)
        if rows is not None and np.ndim(rows) == 0:
            return out[0]
        return out

    # ---------------------------------------------------------------- runtime
    def _ensure_runtime(self) -> BatchedSystem:
        with self._lock:
            if self._runtime is None:
                self._build()
            return self._runtime

    @property
    def runtime(self) -> BatchedSystem:
        return self._ensure_runtime()

    def _build(self) -> None:
        """Build the system, replay the recorded spawns, place the promise
        rows after them and capture the step, all under the step lock (no
        other device call of the handle runs mid-capture)."""
        behaviors = list(self._behaviors) + [self._promise_behavior()]
        with self._step_lock:
            rt = self._system(behaviors)
            for rec in self._spawns:
                got = rt.spawn_block(behaviors.index(rec.behavior), rec.n,
                                     rec.init_state)
                assert got[0] == rec.rows[0], "spawn replay out of order"
            # promise rows live right after the replayed spawns (their
            # slice of capacity was reserved by spawn()'s pre-build check)
            self._promise_base = int(rt.spawn_block(
                len(behaviors) - 1, self.promise_rows_n)[0])
            self._promise_free = list(range(self.promise_rows_n))
            self._spawns.clear()  # only after full success: a retry replays
            rt.warmup()  # capture now; asks must not spend their timeout
        if self.checkpoint_dir is not None and self._journal is None:
            # the WAL is armed with the runtime: staged batches journal
            # before staging from the first tell on. An unwritable dir
            # degrades (no journal, a warning): durability is best-effort
            try:
                from ..persistence.tell_journal import TellJournal
                self._journal = TellJournal(
                    os.path.join(self.checkpoint_dir, "tells.wal"),
                    flight_recorder=self.flight_recorder,
                    fsync_every_n=self.wal_fsync_every_n)
            except OSError as e:
                fr = self.flight_recorder
                if fr is not None and fr.enabled:
                    fr.checkpoint_failed("batched",
                                         f"journal open: {e!r}"[:200], 0)
        rt.tell_journal = self._journal
        self._runtime = rt

    def _rebuild(self) -> None:
        """A new behavior type arrived after the build: a new system with
        the extended (append-only) behavior list takes over every carried
        tensor. Holds the step lock for the whole swap."""
        with self._step_lock:
            self._rebuild_locked()

    def _rebuild_locked(self) -> None:
        old = self._runtime
        behaviors = list(self._behaviors) + [self._promise_behavior()]
        rt = self._system(behaviors)
        if rt.inbox_dst.shape != old.inbox_dst.shape:
            raise ValueError(
                "a behavior that switches the handle's delivery mode (a "
                "slots behavior on a reduce-mode handle) cannot join after "
                "the runtime is built: set the dispatcher's mailbox-slots")
        # the new system adopts the old carried tensors before its first
        # capture, so its graph steps the same storage; columns a new
        # behavior adds keep their fresh reserved fill
        for col, arr in old.state.items():
            if col in rt.state:
                rt.state[col] = arr
        for f in ("behavior_id", "alive", "step_count", "mail_dropped",
                  "sup_counts", "attention", "metrics", "metrics_epoch",
                  "inbox_dst", "inbox_type", "inbox_payload", "inbox_valid",
                  "inbox_enq"):
            setattr(rt, f, getattr(old, f))
        # the promise behavior moved to the new tail index: remap in place
        old_promise_idx = len(old.behaviors) - 1
        new_promise_idx = len(behaviors) - 1
        rt.behavior_id.masked_fill_(rt.behavior_id == old_promise_idx,
                                    new_promise_idx)
        # host bookkeeping carries over: supervision and metrics report
        # marks, allocation, staging (the shared staging buffer and lock,
        # so a tell staged through a stale reference lands in the next
        # flush),
        # incarnations, dead letters, the step counter and the WAL
        rt._sup_reported = old._sup_reported
        rt._overflow_reported = old._overflow_reported
        rt._metrics_seen_epoch = old._metrics_seen_epoch
        with old._lock:
            rt._next_row = old._next_row
            rt._free_rows = list(old._free_rows)
            fresh, rt._staging = rt._staging, old._staging
            fresh.close()
            rt.dead_lettered = old.dead_lettered
        rt._lock = old._lock
        rt._generation = old._generation
        rt.on_dead_letter = old.on_dead_letter
        rt._host_step = old._host_step
        rt.tell_journal = old.tell_journal
        old._graphs.clear()
        rt.warmup()
        self._runtime = rt

    def _publish_dropped(self, n: int) -> None:
        es = self.event_stream
        if es is not None:
            es.publish(DroppedDeviceMessages(n))

    def _publish_dead_letters(self, n: int) -> None:
        es = self.event_stream
        if es is not None:
            es.publish(DeviceDeadLetters(n))

    # ------------------------------------------------------------------- tell
    def tell(self, row: int, message: Any,
             codec: Optional[MessageCodec] = None, expect_gen=None) -> None:
        mtype, payload = (codec or self.default_codec).encode(message)
        self._ensure_runtime()
        self._stage_tell(row, payload, mtype, expect_gen)
        self._wake_pump()

    def tell_rows(self, rows: np.ndarray, message: Any,
                  codec: Optional[MessageCodec] = None,
                  expect_gen=None) -> None:
        mtype, payload = (codec or self.default_codec).encode(message)
        self._ensure_runtime()
        self._stage_tell(rows, payload, mtype, expect_gen)
        self._wake_pump()

    def _stage_tell(self, dst, payload, mtype, expect_gen) -> None:
        """Stage and count under the step lock: an enqueue zeroes
        `_pending_tells` for exactly the tells its flush drains.
        `_has_pending` also reads the staging list itself, so the counter
        is a wake hint, not ground truth."""
        with self._step_lock:
            rt = self._runtime  # re-resolve: a rebuild swaps under the lock
            rt.tell(dst, payload, mtype, expect_gen=expect_gen)
            self._pending_tells += 1

    # -------------------------------------------------------------------- ask
    def ask(self, row: int, message: Any, timeout: float = 5.0,
            codec: Optional[MessageCodec] = None, expect_gen=None) -> Future:
        rt0 = self._ensure_runtime()
        fut: Future = Future()
        if expect_gen is not None and \
                int(rt0.generation_of(row)[0]) != int(expect_gen):
            # stale incarnation: fail fast instead of burning the timeout
            rt0.tell(row, np.zeros(self.payload_width, np.float32),
                     expect_gen=expect_gen)  # count + publish the dead letter
            fut.set_exception(RuntimeError(
                f"ask to dead incarnation of device row {row} "
                f"(expected gen {expect_gen})"))
            return fut
        with self._lock:
            if not self._promise_free:
                self._stat_ask_exhausted += 1
                fut.set_exception(AskPoolExhausted(
                    f"promise rows exhausted ({self.promise_rows_n} in "
                    f"flight; raise the dispatcher's promise-rows key)"))
                return fut
            slot = self._promise_free.pop()
        prow = self._promise_base + slot
        c = codec or self.default_codec
        mtype, payload = c.encode(message, reply_to=prow)
        with self._lock:
            self._waiters[prow] = (fut, c)
            # deadline None: the clock starts at the first completed step,
            # so the capture of a fresh runtime never eats the ask budget
            self._waiter_deadlines[prow] = (None, timeout)
        with self._step_lock:
            rt = self._runtime  # re-resolve: a rebuild swaps under the lock
            # re-arm the latch in place before the request is staged
            rt.state[self.PROMISE_REPLIED][prow] = False
            if self.metrics_enabled:
                # arm the ask-latency clock (metrics_slab HIST_ASK)
                rt.state[ASK_ARM_COL][prow] = rt._host_step
            # expect_gen rides to the stage-time check too: it closes the
            # window against a concurrent stop+respawn of the row
            rt.tell(row, payload, mtype, expect_gen=expect_gen)
        self._wake_pump()
        return fut

    def ask_sync(self, row: int, message: Any, timeout: float = 5.0,
                 codec: Optional[MessageCodec] = None) -> Any:
        return self.ask(row, message, timeout, codec).result(timeout + 1.0)

    def _resolve_waiters(self) -> None:
        with self._lock:
            waiting = list(self._waiters.items())
            have_zombies = bool(self._promise_zombies)
        if not waiting and not have_zombies:
            return
        base, np_ = self._promise_base, self.promise_rows_n
        with self._step_lock:
            rt = self._runtime  # re-resolve: a rebuild swaps under the lock
            replied_blk, replies_blk = read_promise_block(
                rt.state, base, np_, self.PROMISE_REPLIED,
                self.PROMISE_REPLY)
        now = time.monotonic()
        clear_slots: List[int] = []
        for prow, (fut, c) in waiting:
            done = bool(replied_blk[prow - base])
            if not done:
                deadline, timeout = self._waiter_deadlines.get(
                    prow, (now, 0.0))
                if deadline is None:
                    # first post-step visit: start the timeout clock now
                    with self._lock:
                        if prow in self._waiter_deadlines:
                            self._waiter_deadlines[prow] = (now + timeout,
                                                            timeout)
                    continue
                if now <= deadline:
                    continue
            # atomic claim: only the thread that pops the waiter completes
            # the future and releases the slot
            with self._lock:
                if self._waiters.pop(prow, None) is None:
                    continue  # another resolver claimed it
                _, timeout = self._waiter_deadlines.pop(prow, (0.0, 0.0))
                if done:
                    self._promise_free.append(prow - base)
                    clear_slots.append(prow - base)
                else:
                    # timed out with the reply possibly in flight:
                    # quarantine the slot until the late reply latches or
                    # a hard deadline passes
                    self._promise_zombies[prow] = now + max(5.0 * timeout,
                                                            30.0)
            if done:
                if not fut.done():
                    fut.set_result(c.decode(replies_blk[prow - base]))
            elif not fut.done():
                from ..pattern.ask import AskTimeoutException
                fut.set_exception(AskTimeoutException(
                    f"device ask timed out after [{timeout}s]"))
        # reap quarantined slots: a latched late reply (or the hard
        # deadline) makes the slot safe to reuse
        with self._lock:
            for prow, kill_at in list(self._promise_zombies.items()):
                if replied_blk[prow - base] or now > kill_at:
                    del self._promise_zombies[prow]
                    self._promise_free.append(prow - base)
                    if replied_blk[prow - base]:
                        clear_slots.append(prow - base)
        # lower the consumed latches so ATT_LATCH_BIT drops once every
        # resolved reply is read
        if clear_slots:
            self._clear_latches(clear_slots)

    def _clear_latches(self, slots: List[int]) -> None:
        """Lower PROMISE_REPLIED for freed slots: one masked in-place fill
        over the promise block, under the step lock, so it is ordered after
        every enqueued step. Slots still owned by a live ask are untouched,
        so a latch racing in from a concurrent ask is never lost."""
        mask = np.zeros((self.promise_rows_n,), np.bool_)
        mask[np.asarray(slots, np.int64)] = True
        base, np_ = self._promise_base, self.promise_rows_n
        with self._step_lock:
            rt = self._runtime  # re-resolve: a rebuild swaps under the lock
            col = rt.state[self.PROMISE_REPLIED]
            col[base:base + np_].masked_fill_(
                torch.from_numpy(mask).to(col.device), False)

    # ------------------------------------------------------------------- pump
    def _wake_pump(self) -> None:
        if self._pump_thread is None:
            with self._lock:
                if self._pump_thread is None and not self._shutdown:
                    t = threading.Thread(target=self._pump_loop,
                                         name="akka-tpu-device-pump",
                                         daemon=True)
                    self._pump_thread = t
                    t.start()
        self._pump_wake.set()

    def _has_pending(self) -> bool:
        return bool(self._waiters) or self._fresh_tells()

    def _fresh_tells(self) -> bool:
        """Staged-but-unflushed tells: the `_pending_tells` wake hint or
        the staging buffer's own length (the buffer is authoritative, so a
        hint lost to a race never strands staged mail)."""
        rt = self._runtime
        if rt is None:
            return False
        return self._pending_tells > 0 or len(rt._staging) > 0

    def _pump_loop(self) -> None:
        """While host work is pending, step the device; otherwise park on
        the wake event. A step failure must not kill the pump (outstanding
        asks would hang): it is reported and the loop continues."""
        while not self._shutdown:
            try:
                self._pump_once()
            except Exception:  # noqa: BLE001 — the pump must survive
                traceback.print_exc()
                # timeouts are enforced in _resolve_waiters: on a failing
                # step, outstanding asks must still time out
                try:
                    self._resolve_waiters()
                except Exception:  # noqa: BLE001
                    pass
                time.sleep(0.5)

    def _enqueue_step(self, inflight: deque) -> None:
        """Dispatch one flush+step and queue a host snapshot of its
        attention word (the carried word is overwritten by the next step).
        The step lock covers only the enqueue: staging overlaps device
        execution, and tells staged while older steps run ride the next
        enqueue's flush together."""
        with self._step_lock:
            rt = self._runtime  # re-resolve: a rebuild swaps under the lock
            self._pending_tells = 0  # this step's flush drains all staged
            rt.step()
            inflight.append(snapshot_word(rt.attention))
        self._stat_steps += 1
        self._maybe_checkpoint()

    def _drain_one(self, inflight: deque) -> int:
        """Retire the OLDEST in-flight step: wait for its attention word's
        host copy (the step's sync) and run only the host work its bits
        call for. Returns the flag word."""
        host, copied = inflight.popleft()
        if copied is not None:
            copied.synchronize()
        att = host.numpy()
        self._stat_drains += 1
        for s, phi, det in self._sentinel.observe(att):
            if s not in self._sentinel_reported:
                self._sentinel_reported.add(s)
                if self.flight_recorder is not None:
                    self.flight_recorder.device_suspected(
                        "bridge", shard=int(s), phi=float(phi), detector=det)
        flags = int(att.reshape(-1)[ATT_FLAGS])
        self._service(flags)
        return flags

    def _service(self, flags: int) -> None:
        """Post-drain host work, gated on the attention bits: the promise
        block readback and the failed-row scan run only when their bit says
        there is something to read."""
        if flags & ATT_LATCH_BIT:
            self._stat_wide_resolves += 1
            self._resolve_waiters()
        elif self._waiters or self._promise_zombies:
            self._stat_host_checks += 1
            self._check_waiters_host()
        if flags & ATT_FAILED_BIT:
            self._handle_failures()
        elif self._reported_failed:
            self._reported_failed.clear()

    def _check_waiters_host(self) -> None:
        """Deadline bookkeeping with no device read (the no-latch drain):
        start first-visit timeout clocks, fail expired asks into
        quarantine, and reap zombies past their hard deadline."""
        now = time.monotonic()
        with self._lock:
            waiting = list(self._waiters.items())
        for prow, (fut, _c) in waiting:
            deadline, timeout = self._waiter_deadlines.get(prow, (now, 0.0))
            if deadline is None:
                with self._lock:
                    if prow in self._waiter_deadlines:
                        self._waiter_deadlines[prow] = (now + timeout,
                                                        timeout)
                continue
            if now <= deadline:
                continue
            with self._lock:
                if self._waiters.pop(prow, None) is None:
                    continue  # another resolver claimed it
                _, timeout = self._waiter_deadlines.pop(prow, (0.0, 0.0))
                self._promise_zombies[prow] = now + max(5.0 * timeout, 30.0)
            if not fut.done():
                from ..pattern.ask import AskTimeoutException
                fut.set_exception(AskTimeoutException(
                    f"device ask timed out after [{timeout}s]"))
        with self._lock:
            for prow, kill_at in list(self._promise_zombies.items()):
                if now > kill_at:
                    del self._promise_zombies[prow]
                    self._promise_free.append(prow - self._promise_base)

    def _pump_once(self) -> None:
        depth = self.pipeline_depth
        inflight: deque = deque()  # (host word, copy event), oldest first
        while not self._shutdown:
            if self._has_pending():
                self._ensure_runtime()
                self._enqueue_step(inflight)
                while len(inflight) >= depth:
                    self._drain_one(inflight)
                if self._waiters and not self._fresh_tells():
                    # an outstanding ask with nothing newly staged: the reply
                    # needs more steps (multi-hop) or never comes. Drain now
                    # so a latched reply resolves without pipeline latency,
                    # then pace the freewheel (a fresh tell/ask cuts it)
                    while inflight:
                        self._drain_one(inflight)
                    if self._waiters and self.auto_step_interval > 0:
                        self._pump_wake.wait(self.auto_step_interval)
                        self._pump_wake.clear()
                continue
            if inflight:
                # pending work exhausted: retire the tail (a drain may
                # resolve waiters or surface failures)
                self._drain_one(inflight)
                continue
            # busy->idle edge: the slab drain point (one scalar fetch when
            # nothing accumulated) and the pipeline delta report
            self.drain_metrics()
            fr = self.flight_recorder
            if fr is not None and fr.enabled:
                self._report_pipeline(fr)
            self._pump_wake.wait(timeout=0.05)
            self._pump_wake.clear()
            if self._promise_zombies and not self._shutdown:
                # quarantined slots: step at a low cadence so their late
                # replies free them, without burning the device
                self._pump_wake.wait(timeout=0.25)
                self._pump_wake.clear()
                if self._has_pending():
                    continue  # fresh work takes the fast path above
                self._ensure_runtime()
                self._enqueue_step(inflight)
                self._drain_one(inflight)

    def step(self, n: int = 1, depth: Optional[int] = None) -> None:
        """Explicit stepping (pump-free driving) as a depth-k pipeline: up
        to `depth` (default: pipeline_depth) steps stay in flight, so tells
        staged meanwhile coalesce into the next enqueue's flush.
        Synchronous at return: all n steps have completed and waiters and
        failures were serviced. Depth changes overlap, never results."""
        self._ensure_runtime()
        d = self.pipeline_depth if depth is None else max(1, int(depth))
        inflight: deque = deque()
        for _ in range(n):
            t0 = time.perf_counter()
            self._enqueue_step(inflight)
            while len(inflight) >= d:
                self._drain_one(inflight)
            self._dispatch_s.append(time.perf_counter() - t0)
            self._dispatch_seq += 1
        while inflight:
            self._drain_one(inflight)
        # a quiescent point: it doubles as a slab drain point
        self.drain_metrics()

    # ------------------------------------------------- checkpoint / recovery
    def checkpoint(self, directory: Optional[str] = None) -> str:
        """Checkpoint barrier: under the step lock (no new enqueues) the
        system synchronizes the card, so every dispatched step has retired,
        and snapshots its slabs; attention snapshots the pump still holds
        stay valid. The tell journal compacts to records at or after the
        snapshot's step. Returns the snapshot path."""
        d = directory or self.checkpoint_dir
        if d is None:
            raise ValueError(
                "no checkpoint directory: pass one or configure "
                "checkpoint-dir on the dispatcher")
        self._ensure_runtime()
        t0 = time.perf_counter()
        with self._step_lock:
            rt = self._runtime  # re-resolve: a rebuild swaps under the lock
            path = rt.checkpoint(d, keep=self.checkpoint_keep)
            step = rt._host_step
        elapsed = time.perf_counter() - t0
        size = 0
        try:
            if os.path.isdir(path):
                for root, _dirs, files in os.walk(path):
                    size += sum(os.path.getsize(os.path.join(root, f))
                                for f in files)
            else:
                size = os.path.getsize(path)
        except OSError:
            pass
        st = self._ckpt_stats
        st["checkpoints"] += 1
        st["last_step"] = step
        st["last_duration_s"] = round(elapsed, 6)
        st["last_size_bytes"] = int(size)
        st["last_path"] = path
        fr = self.flight_recorder
        if fr is not None and fr.enabled:
            fr.device_checkpoint("batched", step, elapsed, int(size), path)
        # the checkpoint barrier is the other slab drain point
        self.drain_metrics()
        return path

    def restore(self, path: Optional[str] = None) -> int:
        """Recovery: load a snapshot (default: the newest in
        checkpoint_dir) into the system's tensors, replay the write-ahead
        journal to the crash frontier, and fail every outstanding ask with
        RecoveredAskLost (the snapshot overwrote their latches). Every
        promise slot returns to the free list with its latch lowered.
        Returns the recovered host step counter."""
        if path is None and self.checkpoint_dir is None:
            raise ValueError("no checkpoint directory configured")
        self._ensure_runtime()
        with self._lock, self._step_lock:
            if path is None:
                # resolve inside the step lock: an auto-checkpoint both
                # writes newer snapshots and compacts the journal past them
                from ..persistence.slab_snapshot import latest_slab_path
                path = latest_slab_path(self.checkpoint_dir)
                if path is None:
                    raise FileNotFoundError(
                        f"no snapshot under {self.checkpoint_dir}")
            rt = self._runtime  # re-resolve: a rebuild swaps under the lock
            orphaned = list(self._waiters.items())
            self._waiters.clear()
            self._waiter_deadlines.clear()
            self._promise_zombies.clear()
            self._promise_free = list(range(self.promise_rows_n))
            for prow, (fut, _c) in orphaned:
                if not fut.done():
                    fut.set_exception(RecoveredAskLost(
                        f"ask on promise row {prow} was outstanding when "
                        f"the runtime restored from {path}; its reply "
                        f"cannot be recovered"))
            step = rt.restore(path, journal=self._journal)
            # lower every promise latch: the snapshot may carry a latched
            # pre-crash reply whose asker was just failed above
            base = self._promise_base
            if base is not None:
                rt.state[self.PROMISE_REPLIED][
                    base:base + self.promise_rows_n] = False
            self._pending_tells = 0
            self._reported_failed.clear()
        self._wake_pump()  # replayed frontier tells may be staged
        return step

    def _maybe_checkpoint(self) -> None:
        """Auto-cadence hook on the enqueue path: snapshot every
        checkpoint_interval_steps dispatched steps. Snapshot failures
        degrade: the breaker stops hammering a sick filesystem, the backoff
        gate paces retries, and a checkpoint_failed flight-recorder warning
        is the only symptom."""
        if self.checkpoint_interval_steps <= 0 or self.checkpoint_dir is None:
            return
        if self._stat_steps - self._ckpt_last_step < \
                self.checkpoint_interval_steps:
            return
        now = time.monotonic()
        if now < self._ckpt_retry_at:
            return
        self._ckpt_last_step = self._stat_steps
        try:
            self._ckpt_breaker.with_sync_circuit_breaker(self.checkpoint)
            self._ckpt_failures = 0
        except CircuitBreakerOpenException as e:
            self._ckpt_retry_at = now + max(float(e.remaining), 0.1)
        except Exception as e:  # noqa: BLE001 — degrade, never stall
            self._ckpt_failures += 1
            self._ckpt_stats["failures"] += 1
            self._ckpt_retry_at = now + backoff_delay(
                self._ckpt_failures, 0.5, 30.0)
            fr = self.flight_recorder
            if fr is not None and fr.enabled:
                fr.checkpoint_failed("batched", repr(e)[:200],
                                     self._ckpt_failures)

    def checkpoint_stats(self) -> Dict[str, Any]:
        """Snapshots taken/failed, last duration/size/step/path."""
        return dict(self._ckpt_stats)

    def pipeline_stats(self) -> Dict[str, Any]:
        """Configured depth, steps enqueued and drained, drains that paid
        the promise readback against host-only deadline checks, and the
        dispatch percentiles of step(n) (enqueue + forced drains)."""
        seq, d = self._dispatch_sorted
        if seq != self._dispatch_seq:
            d = sorted(self._dispatch_s)
            self._dispatch_sorted = (self._dispatch_seq, d)

        def pct(q: float) -> float:
            # nearest rank: rank ceil(q*n), 1-based
            if not d:
                return 0.0
            return round(d[max(math.ceil(q * len(d)) - 1, 0)] * 1e6, 1)

        return {"depth": self.pipeline_depth,
                "steps": self._stat_steps,
                "drains": self._stat_drains,
                "wide_resolves": self._stat_wide_resolves,
                "host_checks": self._stat_host_checks,
                "dispatch_p50_us": pct(0.50),
                "dispatch_p99_us": pct(0.99)}

    def ask_pool_stats(self) -> Dict[str, Any]:
        """Promise-pool occupancy: claimed slots (waiters + quarantined
        zombies), typed fast-fails so far, and the claimed fraction."""
        with self._lock:
            free = len(self._promise_free)
            zombies = len(self._promise_zombies)
            waiting = len(self._waiters)
            exhausted = self._stat_ask_exhausted
        size = self.promise_rows_n
        in_flight = max(0, size - free)
        return {"size": size, "free": free, "in_flight": in_flight,
                "waiting": waiting, "zombies": zombies,
                "exhausted": exhausted,
                "occupancy": (in_flight / size) if size else 1.0}

    def sentinel_stats(self) -> Dict[str, Any]:
        """Drains observed, shards suspected (this handle's device is
        shard 0), and the failover budget carried for parity."""
        return {"drains": self._sentinel.drains,
                "suspected": sorted(self._sentinel.suspected()),
                "max_failovers": self.sentinel_max_failovers,
                "depth_recovery_rounds": self.sentinel_depth_recovery_rounds}

    def _sentinel_metrics(self) -> Dict[str, Any]:
        """sentinel_stats plus the gauges the registry surfaces: the
        suspicion count and shard 0's phi."""
        st = self.sentinel_stats()
        st["suspected_count"] = len(st.pop("suspected", ()))
        try:
            st["phi"] = float(self._sentinel.phi(0))
        except Exception:  # noqa: BLE001 — phi before the first heartbeat
            st["phi"] = 0.0
        return st

    def drain_metrics(self) -> None:
        """Epoch-gated slab drain into the registry: one scalar read when
        nothing accumulated, the slab when the epoch moved. Called at the
        pump's busy->idle edge, the checkpoint barrier and step()'s
        return."""
        reg = self.metrics_registry
        if reg is None or not self.metrics_enabled:
            return
        with self._step_lock:  # a drain must not race a fresh enqueue
            rt = self._runtime
            if rt is None:
                return
            drained = rt.drain_metrics()
            host_step = rt._host_step
        if drained is not None:
            step, lanes = drained
            reg.ingest_device_slab(lanes, step)
        else:
            reg.set_step(host_step)

    def _report_pipeline(self, fr) -> None:
        """Emit the pipeline counters' deltas as one device_pipeline event
        (at the pump's busy->idle edge and at shutdown)."""
        totals = np.asarray([self._stat_steps, self._stat_drains,
                             self._stat_wide_resolves,
                             self._stat_host_checks], np.int64)
        delta = totals - self._stat_reported
        if not delta.any():
            return
        self._stat_reported = totals
        fr.device_pipeline("batched", self.pipeline_depth, int(delta[0]),
                           int(delta[1]), int(delta[2]), int(delta[3]))

    def _handle_failures(self) -> None:
        """Host-mediated supervision of the device error lane: rows that
        set `_failed` are restarted with their spawn-time init (default),
        stopped, or left suspended, per failure_policy; each failure is
        published once (suspended rows keep the flag and do not
        re-report)."""
        rt = self._runtime
        if rt is None or "_failed" not in rt.state:
            return
        with self._step_lock:
            rt = self._runtime
            if not rt.any_failed():  # one device scalar on the hot path
                if self._reported_failed:
                    self._reported_failed.clear()
                return
            failed = rt.failed_rows()
            current = set(int(r) for r in failed)
            new = current - self._reported_failed
            if self.failure_policy == "restart":
                rt.restart_rows(failed)
                # re-apply the spawn-time init of the restarted rows (an
                # Akka restart re-instantiates from Props); per-row inits
                # are sliced to the failed positions
                for rows, init in self._spawn_inits:
                    pos = np.nonzero(np.isin(rows, failed))[0]
                    if pos.size:
                        hit = torch.as_tensor(rows[pos].astype(np.int64),
                                              device=rt.device)
                        for col, value in init.items():
                            arr = rt.state[col]
                            arr[hit] = torch.as_tensor(
                                np.asarray(_slice_init(value, pos,
                                                       rows.size)),
                                dtype=arr.dtype, device=arr.device)
                self._reported_failed.clear()
            elif self.failure_policy == "stop":
                rt.stop_block(failed)
                rt.clear_failed(failed)  # a dead row must not re-report
                self._reported_failed.clear()
            else:  # suspend: the flag stays (that IS the suspension)
                self._reported_failed = current
        if not new:
            return
        new_arr = np.asarray(sorted(new), np.int32)
        es = self.event_stream
        if es is not None:
            es.publish(DeviceActorFailed(new_arr, self.failure_policy))
        fr = self.flight_recorder
        if fr is not None and fr.enabled:
            for r in new_arr[:64]:
                fr.actor_failed(f"device-row-{int(r)}", "error-lane")

    def shutdown(self) -> None:
        self._shutdown = True
        self._pump_wake.set()
        t = self._pump_thread
        if t is not None:
            t.join(timeout=2.0)
        fr = self.flight_recorder
        if fr is not None and fr.enabled:
            self._report_pipeline(fr)  # flush the final pipeline deltas
        try:
            self.drain_metrics()  # final slab frame before sinks close
        except Exception:  # noqa: BLE001 — shutdown must not raise
            pass
        if self._owns_registry and self.metrics_registry is not None:
            self.metrics_registry.close()
        if self._journal is not None:
            self._journal.close()


class DeviceActorFailed:
    """EventStream notification: device rows raised their `_failed` error
    lane and were handled per the handle's failure_policy."""

    __slots__ = ("rows", "action")

    def __init__(self, rows, action: str):
        self.rows = rows
        self.action = action

    def __repr__(self):
        return f"DeviceActorFailed(rows={list(self.rows)!r}, action={self.action})"


class DroppedDeviceMessages:
    """EventStream notification: host tells dropped on host-inbox
    overflow."""

    __slots__ = ("count",)

    def __init__(self, count: int):
        self.count = count

    def __repr__(self):
        return f"DroppedDeviceMessages({self.count})"


class DeviceDeadLetters:
    """EventStream notification: tells dead-lettered because their pinned
    incarnation generation no longer matches the row (the target was
    stopped, and possibly respawned, after the ref was captured)."""

    __slots__ = ("count",)

    def __init__(self, count: int):
        self.count = count

    def __repr__(self):
        return f"DeviceDeadLetters({self.count})"


# ------------------------------------------------------------------- the refs
class DeviceActorRef(InternalActorRef):
    """An ActorRef whose mailbox is a device row. Watchable; tells after
    stop go to dead letters. The ref pins the row's incarnation generation
    at creation: a tell through a stale ref (the row was stopped and the
    slot respawned) dead-letters instead of reaching the new occupant."""

    __slots__ = ("path", "_handle", "row", "gen", "_codec", "_system",
                 "_stopped", "_watched_by", "_wlock", "_parent")

    def __init__(self, system, handle: BatchedRuntimeHandle, row: int, path,
                 codec: Optional[MessageCodec] = None, gen=None,
                 parent: Optional[ActorRef] = None):
        self.path = path
        self._parent = parent
        self._system = system
        self._handle = handle
        self.row = int(row)
        self.gen = (int(gen) if gen is not None
                    else int(handle.generation_of(row)[0]))
        self._codec = codec
        self._stopped = False
        self._watched_by: set = set()
        self._wlock = threading.Lock()

    def tell(self, message: Any, sender: Optional[ActorRef] = None) -> None:
        if self._stopped:
            self._system.dead_letters.tell(
                DeadLetter(message, sender, self), sender)
            return
        self._handle.tell(self.row, message, self._codec, expect_gen=self.gen)

    def ask(self, message: Any, timeout: float = 5.0) -> Future:
        return self._handle.ask(self.row, message, timeout, self._codec,
                                expect_gen=self.gen)

    def ask_sync(self, message: Any, timeout: float = 5.0) -> Any:
        return self.ask(message, timeout).result(timeout + 1.0)

    def read_state(self, col: str) -> np.ndarray:
        return self._handle.read_state(col, np.asarray([self.row]))[0]

    def send_system_message(self, message: sysmsg.SystemMessage) -> None:
        if isinstance(message, sysmsg.Watch):
            with self._wlock:
                if self._stopped:
                    message.watcher.send_system_message(
                        sysmsg.DeathWatchNotification(
                            self, existence_confirmed=True))
                else:
                    self._watched_by.add(message.watcher)
        elif isinstance(message, sysmsg.Unwatch):
            with self._wlock:
                self._watched_by.discard(message.watcher)
        elif isinstance(message, sysmsg.Terminate):
            self.stop()  # the parent stops its children

    def stop(self) -> None:
        with self._wlock:
            if self._stopped:
                return
            self._stopped = True
            watchers = list(self._watched_by)
            self._watched_by.clear()
        self._handle.stop_rows([self.row])
        _notify_stopped(self, watchers)

    @property
    def is_terminated(self) -> bool:
        return self._stopped


class DeviceBlockRef(InternalActorRef):
    """One ref for a spawned block of device actors. `tell` broadcasts to
    every row (one staged batch, not n Python calls); `block[i]` derives
    the per-row ref."""

    __slots__ = ("path", "_handle", "rows", "gens", "_codec", "_system",
                 "_parent", "_stopped", "_wlock")

    def __init__(self, system, handle: BatchedRuntimeHandle, rows: np.ndarray,
                 path, codec: Optional[MessageCodec] = None,
                 parent: Optional[ActorRef] = None):
        self.path = path
        self._parent = parent
        self._stopped = False
        self._wlock = threading.Lock()
        self._system = system
        self._handle = handle
        self.rows = rows
        self.gens = handle.generation_of(rows)  # pinned incarnations
        self._codec = codec

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, i: int) -> DeviceActorRef:
        return DeviceActorRef(self._system, self._handle, self.rows[i],
                              self.path / str(i), self._codec,
                              gen=self.gens[i])

    def tell(self, message: Any, sender: Optional[ActorRef] = None) -> None:
        self._handle.tell_rows(self.rows, message, self._codec,
                               expect_gen=self.gens)

    def read_state(self, col: str) -> np.ndarray:
        return self._handle.read_state(col, self.rows)

    def send_system_message(self, message: sysmsg.SystemMessage) -> None:
        if isinstance(message, sysmsg.Terminate):
            self.stop()  # the parent stops its children

    def stop(self) -> None:
        with self._wlock:
            if self._stopped:
                return
            self._stopped = True
        self._handle.stop_rows(self.rows)
        _notify_stopped(self, [])

    @property
    def is_terminated(self) -> bool:
        return self._stopped


def _notify_stopped(ref, watchers) -> None:
    """A stopped device ref's DeathWatchNotification to its watchers and
    to its parent (a port repair: the parent, whose own termination waits
    for its children, is notified as a host actor's parent is)."""
    for w in list(watchers) + ([ref._parent] if ref._parent is not None
                               else []):
        w.send_system_message(
            sysmsg.DeathWatchNotification(ref, existence_confirmed=True))


# ----------------------------------------------------------------- device props
class DeviceSpec:
    """Attached to Props to mark a device actor (the deploy-info analogue,
    actor/Deployer.scala)."""

    __slots__ = ("behavior", "n", "init_state", "codec")

    def __init__(self, behavior: BatchedBehavior, n: int = 1,
                 init_state: Optional[Dict[str, Any]] = None,
                 codec: Optional[MessageCodec] = None):
        self.behavior = behavior
        self.n = n
        self.init_state = init_state
        self.codec = codec


def device_props(b: BatchedBehavior, n: int = 1,
                 init_state: Optional[Dict[str, Any]] = None,
                 codec: Optional[MessageCodec] = None,
                 dispatcher: Optional[str] = None):
    """Props for a device-resident actor (block). Spawn with
    system.actor_of(device_props(my_behavior), "name")."""
    from ..actor.props import Props
    return Props(factory=_no_factory, cls=None, dispatcher=dispatcher,
                 device=DeviceSpec(b, n, init_state, codec))


def _no_factory():  # pragma: no cover — device props build no host actor
    raise RuntimeError("device props have no host-side actor factory")


def get_handle(system, dispatcher_id: Optional[str] = None
               ) -> BatchedRuntimeHandle:
    """The dispatcher-owned device runtime handle of a system."""
    from ..dispatch.batched import TpuBatchedDispatcher
    did = dispatcher_id or system.dispatchers.DEFAULT_DISPATCHER_ID
    disp = system.dispatchers.lookup(did)
    if not isinstance(disp, TpuBatchedDispatcher):
        # fall back to the dedicated device dispatcher id
        disp = system.dispatchers.lookup("akka.actor.tpu-dispatcher")
    return disp.handle(system)
