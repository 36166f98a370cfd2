"""BatchedSystem: the SoA device runtime, millions of actors per card.

Port of `akka_tpu/batched/core.py` (single device). State is a dict of
[capacity, ...] columns (the union of all behavior schemas); messages are
(dst, type, payload, valid) SoA blocks; one `step` delivers every in-flight
message and runs every live actor's update on the device.

Where the reference donates its carry to a jitted program, the port keeps
every carried tensor in place (the same storage from construction on, on
every device): each step writes its emissions over the inbox it has just
delivered (retained spill first, host rows cleared) and copies its new
state columns, counters and attention word into the carried tensors;
`spawn_block`/`stop_block`/`seed_inbox`/`restart_rows`/`clear_failed`,
the host flush and `restore` write rows in place too.

On a card the step is captured once as a CUDA graph (batched/graphs.py,
the reference's `_step_jit`): `run(n)` flushes the staged tells and
replays it n times (the reference's `lax.scan`), `step()` flushes and
replays it once, and `warmup()` captures it ahead of the first step
(otherwise the first `run`/`step` does, as `jax.jit` compiles at first
call). On the CPU the same in-place step runs eagerly. The flush copies
the staged tells through fresh pinned host blocks, so the pads can be
refilled while an earlier flush's copy is still in flight.
`run_pipelined` keeps up to `depth` steps in flight, synchronising on a
host copy of each step's attention word. Host tells stage in the native
stager (native/, a preallocated C++ buffer: one atomic reserve and a
memcpy a batch) or in a Python list (`native_staging`), and ride into the
next `step()` with its flush.

Telemetry: with metrics on, the step keeps the metric slab
(batched/metrics_slab.py) and its epoch word, the slab's running sum as
a carried int32 scalar that every step writes in place (so the captured
graph writes it too); `drain_metrics()` reads that one scalar and fetches
the slab only when it moved. With a `flight_recorder`, `step`/`run` emit
`device_flush`/`device_step` (dispatch time) and the supervision counters'
delta, `warmup` a `device_compile`, `read_attention` a `shard_overflow`
on growth; with none, the hooks cost an attribute read each and no host
sync.

Durability: with a `TellJournal` in `tell_journal`, every staged batch is
journaled before it is staged; `checkpoint` snapshots the slabs
(persistence/slab_snapshot.py) and compacts the journal, and `restore`
loads a snapshot in place and replays the journal to the crash frontier.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..event.flight_recorder import trace_span
from ..utils.device import resolve_device
from . import graphs
from .behavior import BatchedBehavior
from .metrics_slab import (ASK_ARM_COL, ASK_ARM_SPEC, accumulate_step,
                           empty_slab, slab_dict, slab_epoch)
from .staging import ListStaging, NativeStaging
from .step import (StepCore, fault_any_failed, fault_clear_failed,
                   fault_failed_rows, fault_restart_rows, write_back)
from .supervision import (ATT_WORDS, N_COUNTERS, SUP_COLUMNS, counts_dict,
                          decode_attention, reserved_fill)


def snapshot_word(word: torch.Tensor):
    """Start the host copy of a step's attention word, which the next
    step overwrites in place: returns `(host, copied)`, where `copied` is
    the CUDA event recorded behind the copy (wait on it before reading
    `host`), or None on the CPU, where the copy is done on return."""
    host = torch.empty(word.shape, dtype=word.dtype,
                       pin_memory=word.is_cuda)
    host.copy_(word, non_blocking=True)
    copied = None
    if word.is_cuda:
        copied = torch.cuda.Event()
        copied.record()
    return host, copied


def host_to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """`arr` for a copy onto `device`, without waiting for the card: on
    CUDA it goes through a fresh pinned block (PyTorch's caching host
    allocator reuses a block only once the copy that reads it has
    completed), so the caller may rewrite `arr` at once. On the CPU the
    caller's copy reads `arr` itself."""
    t = torch.from_numpy(arr)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def drive_pipelined(step_once: Callable[[], None],
                    latest_handle: Callable[[], torch.Tensor],
                    n_steps: int, depth: int,
                    on_drain: Optional[Callable[[np.ndarray], None]] = None,
                    ) -> None:
    """Enqueue-ahead step loop: dispatch up to `depth` steps before waiting
    on the oldest. Each step's attention word is copied to the host as it
    is dispatched (`snapshot_word`: the carried word is overwritten by the
    next step), and waiting for the oldest copy is the sync. With
    `on_drain`, every retired step's word is handed to the callback and
    the tail is drained before returning; without it the tail stays in
    flight."""
    if depth < 1:
        raise ValueError("depth must be >= 1")
    inflight: deque = deque()  # (host word, copy event), oldest first

    def drain_one() -> None:
        host, copied = inflight.popleft()
        if copied is not None:
            copied.synchronize()
        if on_drain is not None:
            on_drain(host.numpy())

    for _ in range(n_steps):
        step_once()
        inflight.append(snapshot_word(latest_handle()))
        while len(inflight) >= depth:
            drain_one()
    while on_drain is not None and inflight:
        drain_one()


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """Host staging dtype for a payload dtype (bf16 stages as float32)."""
    if dtype == torch.bfloat16:
        return np.dtype(np.float32)
    return torch.empty((0,), dtype=dtype).numpy().dtype


# the carried tensors besides the state columns (graphs.shadow_of clones
# them for the warm-up)
CARRY = ("behavior_id", "alive", "step_count", "mail_dropped", "sup_counts",
         "attention", "metrics", "metrics_epoch", "inbox_dst", "inbox_type",
         "inbox_payload", "inbox_valid", "inbox_enq")


class BatchedSystem:
    """Single-device batched actor space.

    capacity: max live actors (rows); out_degree K: max emissions per actor
    per step; payload_width P: message payload columns; host_inbox: rows
    reserved for host tells per flush; mailbox_slots S: 0 = commutative
    reduction inboxes, >0 = per-message mailboxes of S ordered
    (type, payload) slots (required when any behavior has inbox="slots").
    delivery_backend: None/"auto", "ranked" or "cuda" (ops/segment.py;
    None reads the process default when the step is captured).
    topology: an ops.segment.StaticTopology over the n x K emission slots
    (reduce mode only): compiled routing, no rank and no ring kernel; its
    tensors move to the system's device once, here.
    device: where the system runs; defaults to CUDA and raises without a
    card unless device="cpu" is passed. On a card every step is a replay
    of the step's CUDA graph.
    native_staging: where host tells stage until the next flush. None
    takes the native stager (native/queues.py NativeStager) when its
    library is built or can be built now, else the Python list; True
    takes the stager and raises RuntimeError when the library cannot be
    built; False takes the Python list. In slots mode a staged row
    carries its type tag bitcast into the staging dtype, which is exact
    only for a 4-byte staging dtype: float32, int32 and bf16 (which stages
    as float32) take the stager there, and float16 or 8-byte payloads keep
    the Python list (True raises ValueError). A full stager drops a whole
    batch (all or nothing, counted in `dropped_messages`); the Python list
    drops what passes `host_inbox` at the flush. No environment variable
    switches it.
    """

    def __init__(self, capacity: int, behaviors: Sequence[BatchedBehavior],
                 payload_width: int = 4, out_degree: int = 1,
                 host_inbox: int = 1024, payload_dtype=torch.float32,
                 device=None, delivery: str = "auto",
                 need_max: bool = False, topology=None,
                 mailbox_slots: int = 0,
                 native_staging: Optional[bool] = None,
                 spill_capacity: Optional[int] = None,
                 delivery_backend: Optional[str] = None,
                 attention_latch_col: Optional[str] = None,
                 metrics_enabled: bool = False):
        if not behaviors:
            raise ValueError("at least one behavior required")
        self.device = dev = resolve_device(device)
        self.capacity = n = int(capacity)
        self.behaviors = list(behaviors)
        self.payload_width = int(payload_width)
        self.out_degree = int(out_degree)
        self.host_inbox = int(host_inbox)
        self.payload_dtype = payload_dtype
        self.delivery = delivery
        self.delivery_backend = delivery_backend
        self.need_max = need_max
        self.mailbox_slots = int(mailbox_slots)
        if self.mailbox_slots == 0 and any(b.inbox == "slots"
                                           for b in behaviors):
            # a slots behavior present => the whole system steps in slots
            self.mailbox_slots = max(2, self.out_degree)
        # slots mode defaults to UNBOUNDED mailboxes: overflow past the S
        # slots and suspended-row mail ride a spill region at the FRONT of
        # the inbox; spill_capacity=0 opts into bounded drop-and-count
        if self.mailbox_slots > 0:
            self.spill_cap = (int(spill_capacity)
                              if spill_capacity is not None
                              else max(self.host_inbox,
                                       4 * self.mailbox_slots))
        else:
            self.spill_cap = 0

        # unified state schema (union of behavior columns)
        self.state_spec: Dict[str, Tuple[Tuple[int, ...], Any]] = {}
        for b in self.behaviors:
            for col, spec in b.state_spec.items():
                spec = (tuple(spec[0]), spec[1])
                if col in self.state_spec and self.state_spec[col] != spec:
                    raise ValueError(
                        f"behavior {b.name}: state column {col!r} conflicts "
                        f"({self.state_spec[col]} vs {spec})")
                self.state_spec[col] = spec
        if any(getattr(b, "supervisor", None) is not None for b in behaviors):
            for col, spec in SUP_COLUMNS.items():
                self.state_spec.setdefault(col, spec)
        elif any(getattr(b, "nonfinite_guard", False) for b in behaviors):
            self.state_spec.setdefault("_failed", SUP_COLUMNS["_failed"])
        self.metrics_on = bool(metrics_enabled)
        if self.metrics_on and attention_latch_col is not None:
            self.state_spec.setdefault(ASK_ARM_COL, ASK_ARM_SPEC)

        self.state: Dict[str, torch.Tensor] = {
            k: torch.full((n,) + shape, reserved_fill(k), dtype=dtype,
                          device=dev)
            for k, (shape, dtype) in self.state_spec.items()}
        i32 = torch.int32
        self.behavior_id = torch.zeros((n,), dtype=i32, device=dev)
        self.alive = torch.zeros((n,), dtype=torch.bool, device=dev)
        self.step_count = torch.zeros((), dtype=i32, device=dev)
        self.mail_dropped = torch.zeros((), dtype=i32, device=dev)
        self.sup_counts = torch.zeros((N_COUNTERS,), dtype=i32, device=dev)
        # the counters the flight recorder last reported (their delta is
        # the next device_supervision event)
        self._sup_reported = np.zeros((N_COUNTERS,), np.int64)
        self.attention = torch.zeros((ATT_WORDS,), dtype=i32, device=dev)
        self.metrics = empty_slab(device=dev)
        # the metrics epoch: the slab's running sum, written in place by
        # every step (0 while metrics are off); drain_metrics compares it
        # with the value of its last drain
        self.metrics_epoch = torch.zeros((), dtype=i32, device=dev)
        self._metrics_seen_epoch = 0

        # inbox layout: [spill_cap | n*K emissions | host_inbox]; spill
        # first so redelivered (older) mail sorts before fresh emissions
        m = self.spill_cap + n * self.out_degree + self.host_inbox
        self.inbox_dst = torch.full((m,), -1, dtype=i32, device=dev)
        self.inbox_type = torch.zeros((m,), dtype=i32, device=dev)
        self.inbox_payload = torch.zeros((m, self.payload_width),
                                         dtype=payload_dtype, device=dev)
        self.inbox_valid = torch.zeros((m,), dtype=torch.bool, device=dev)
        # enqueue-step column for the sojourn-age lane; (0,) when metrics
        # are off
        self.inbox_enq = torch.zeros((m,) if self.metrics_on else (0,),
                                     dtype=i32, device=dev)

        self._next_row = 0
        self._free_rows: List[int] = []
        self._lock = threading.Lock()
        # per-row incarnation counter: bumped on stop and restart, checked
        # by tells that carry expect_gen (host-authoritative)
        self._generation = np.zeros((n,), np.int64)
        self.dead_lettered = 0  # generation-mismatch tells (guarded by _lock)
        self.on_dead_letter: Optional[Callable[[int], None]] = None
        self.on_dropped: Optional[Callable[[int], None]] = None
        # optional flight recorder (event/flight_recorder.py SPI): step,
        # flush, compile, supervision and overflow events; None = no cost
        self.flight_recorder = None
        # (mailbox_overflow, exchange_dropped) already reported through
        # shard_overflow: the counters are cumulative, a warning marks
        # growth
        self._overflow_reported = (0, 0)
        # host mirror of the dispatched-step counter
        self._host_step = 0
        # write-ahead tell journal (persistence/tell_journal.py): staged
        # batches are journaled BEFORE staging; None = no WAL
        self.tell_journal = None
        self._np_payload_dtype = _numpy_dtype(payload_dtype)
        self._staging = self._make_staging(native_staging)
        # the step's CUDA graph on a card; the eager step on the CPU (and
        # in a comparison's eager twin, which sets _eager itself)
        self._eager = dev.type != "cuda"
        self._graphs = graphs.GraphSet(dev, "BatchedSystem")

        # reusable host pads for the flush (one fixed [host_inbox] shape)
        self._flush_dst = np.full((self.host_inbox,), -1, np.int32)
        self._flush_type = np.zeros((self.host_inbox,), np.int32)
        self._flush_payload = np.zeros(
            (self.host_inbox, self.payload_width), self._np_payload_dtype)
        self._flush_valid = np.zeros((self.host_inbox,), np.bool_)

        self._core = StepCore(self.behaviors, n_local=n,
                              payload_width=self.payload_width,
                              out_degree=self.out_degree,
                              payload_dtype=payload_dtype,
                              slots=self.mailbox_slots, need_max=need_max,
                              topology=topology, delivery=delivery,
                              spill_cap=self.spill_cap,
                              delivery_backend=delivery_backend,
                              attention_latch_col=attention_latch_col,
                              device=dev)

    def _make_staging(self, native_staging: Optional[bool]):
        """The staging buffer (batched/staging.py) that `native_staging`
        picks; see the class docstring."""
        slots = self.mailbox_slots > 0
        exact = not slots or self._np_payload_dtype.itemsize == 4
        if native_staging and not exact:
            raise ValueError(
                f"native_staging=True: a slots-mode stager row carries "
                f"its type tag bitcast into the staging dtype, exact "
                f"only for 4 bytes, not {self._np_payload_dtype}")
        if native_staging is None:
            from ..native import lib as native_lib
            native_staging = exact and native_lib.available()
        if native_staging:
            return NativeStaging(self.host_inbox, self.payload_width,
                                 self._np_payload_dtype, slots,
                                 self._report_dropped)
        return ListStaging(self.host_inbox, self.payload_width,
                           self._np_payload_dtype, self._report_dropped)

    def _report_dropped(self, n: int) -> None:
        if self.on_dropped is not None:
            self.on_dropped(n)

    @property
    def native_staging(self) -> bool:
        """Whether host tells stage in the native stager."""
        return self._staging.native

    def _index(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids, np.int64), device=self.device)

    # ------------------------------------------------------------- lifecycle
    def spawn_block(self, behavior: BatchedBehavior | int, n: int,
                    init_state: Optional[Dict[str, Any]] = None
                    ) -> np.ndarray:
        """Allocate n actors with the given behavior (host-side slow path).
        Fresh capacity is handed out contiguously; once the tail is
        exhausted, rows freed by stop_block are reused, with their state
        reset and stale inbox rows and staged tells scrubbed. Capture a
        row's incarnation with `generation_of(ids)` and pass `expect_gen`
        to tell() to pin it. Returns the global ids."""
        b_idx = behavior if isinstance(behavior, int) \
            else self.behaviors.index(behavior)
        with self._lock:
            start = self._next_row
            fresh = min(n, self.capacity - start)
            reused = n - fresh
            if reused > len(self._free_rows):
                raise RuntimeError(
                    f"actor capacity exhausted ({n} requested, "
                    f"{self.capacity - start} fresh + "
                    f"{len(self._free_rows)} free)")
            self._next_row = start + fresh
            recycled: List[int] = []
            if reused:
                recycled = sorted(self._free_rows[-reused:])
                del self._free_rows[-reused:]
        ids = np.concatenate([
            np.arange(start, start + fresh, dtype=np.int32),
            np.asarray(recycled, dtype=np.int32)])
        idx = self._index(ids)
        self.behavior_id[idx] = b_idx
        self.alive[idx] = True
        if reused:
            rec_arr = np.asarray(recycled, np.int32)
            ridx = self._index(rec_arr)
            for col, arr in self.state.items():
                arr[ridx] = reserved_fill(col)
            stale = torch.isin(self.inbox_dst, ridx.to(torch.int32))
            self.inbox_valid.masked_fill_(stale, False)

            def scrub(d, t, p):
                keep = ~np.isin(d, rec_arr)
                return d[keep], t[keep], p[keep]
            self._staging.rewrite(scrub)
        for col, value in (init_state or {}).items():
            if col not in self.state:
                raise KeyError(f"unknown state column {col!r}")
            arr = self.state[col]
            arr[idx] = torch.as_tensor(value, dtype=arr.dtype,
                                       device=self.device)
        return ids

    def stop_block(self, ids) -> None:
        """Mark actors dead and recycle their rows. Bumps the rows'
        incarnation generation so stale expect_gen tells dead-letter."""
        arr = np.unique(np.atleast_1d(np.asarray(ids, np.int32)))
        self.alive[self._index(arr)] = False
        with self._lock:
            self._generation[arr] += 1
            seen = set(self._free_rows)
            self._free_rows.extend(int(i) for i in arr if int(i) not in seen)

    def generation_of(self, ids) -> np.ndarray:
        """Current incarnation generation of the given rows."""
        arr = np.atleast_1d(np.asarray(ids, np.int64))
        with self._lock:
            return self._generation[arr].copy()

    # ------------------------------------------------------------------ tell
    def tell(self, dst, payload, mtype: int = 0, expect_gen=None) -> None:
        """Host-side tell: staged, flushed into the inbox on the next step.
        dst: int or [k] array; payload: [P] or [k, P]; mtype: message-type
        tag (int or [k]) delivered in slots mode. expect_gen (int or [k]):
        the sender's captured incarnation generation; a mismatch
        dead-letters the message instead of delivering it to the row's
        next occupant."""
        dst_arr = np.atleast_1d(np.asarray(dst, dtype=np.int32))
        if expect_gen is not None:
            gens = np.broadcast_to(
                np.atleast_1d(np.asarray(expect_gen, np.int64)),
                dst_arr.shape)
            with self._lock:
                ok = self._generation[dst_arr] == gens
            if not ok.all():
                n_dead = int((~ok).sum())
                with self._lock:
                    self.dead_lettered += n_dead
                if self.on_dead_letter is not None:
                    self.on_dead_letter(n_dead)
                if not ok.any():
                    return
                dst_arr = dst_arr[ok]
                payload = np.asarray(payload, dtype=self._np_payload_dtype)
                if payload.ndim > 1:
                    payload = payload[ok]
                if np.ndim(mtype) > 0:
                    mtype = np.asarray(mtype, np.int32)[ok]
        pl = np.asarray(payload, dtype=self._np_payload_dtype)
        if pl.ndim == 1:
            pl = np.broadcast_to(pl[None, :], (dst_arr.shape[0], pl.shape[0]))
        if pl.shape[-1] != self.payload_width:
            pad = self.payload_width - pl.shape[-1]
            if pad < 0:
                raise ValueError(f"payload wider than {self.payload_width}")
            pl = np.pad(pl, [(0, 0)] * (pl.ndim - 1) + [(0, pad)])
        mt = np.broadcast_to(np.atleast_1d(np.asarray(mtype, np.int32)),
                             (dst_arr.shape[0],))
        if self.tell_journal is not None:
            # WAL: the normalized, generation-filtered batch, before it is
            # staged; recovery re-stages exactly this batch at this step
            # counter, with no expect_gen re-check
            self.tell_journal.append(self._host_step, "tell", dst_arr, pl, mt)
        self._staging.stage(dst_arr, mt, pl)

    def seed_inbox(self, dst, payload, mtype=0) -> None:
        """Bulk device-side injection: overwrite the first len(dst) inbox
        rows (the fast path for benches and bulk tells)."""
        if self.tell_journal is not None:
            # seeds write inbox rows directly, so a seed record at the
            # snapshot's own step may already be in the snapshot: replay
            # writes the same rows with the same values
            self.tell_journal.append(self._host_step, "seed", dst, payload,
                                     mtype)
        dst = torch.as_tensor(dst, dtype=torch.int32, device=self.device)
        payload = torch.as_tensor(payload, dtype=self.payload_dtype,
                                  device=self.device)
        k = dst.shape[0]
        if payload.dim() == 1:
            payload = payload[None, :].expand(k, self.payload_width)
        if k > self.inbox_dst.shape[0]:
            raise ValueError("seed exceeds inbox capacity")
        self.inbox_dst[:k] = dst
        self.inbox_type[:k] = torch.as_tensor(mtype, dtype=torch.int32,
                                              device=self.device)
        self.inbox_payload[:k] = payload
        self.inbox_valid[:k] = True

    def _drain_to_pad(self) -> int:
        """Drain the staged host tells into the reusable pads (each
        staging path applies its own drops). The native stager's
        reduce-mode rows carry no type, and the pad's type column is left
        as it was, as the reference leaves it. Returns the number of
        staged rows."""
        dsts, types, payloads = self._staging.drain()
        k = dsts.shape[0]
        if k == 0:
            return 0
        self._flush_dst[:k] = dsts
        if types is not None:
            self._flush_type[:k] = types
        self._flush_payload[:k] = payloads
        self._flush_valid[:k] = True
        self._flush_valid[k:] = False
        self._flush_dst[k:] = -1
        return k

    def _flush(self) -> None:
        """Overwrite the host region of the inbox with the pads (copied
        through fresh pinned blocks: the next `_drain_to_pad` may rewrite
        the pads before these copies run). With metrics on, flushed rows
        stamp the enqueue column with the flushing step's counter."""
        base = self.spill_cap + self.capacity * self.out_degree
        dev = self.device
        self.inbox_dst[base:] = host_to_device(self._flush_dst, dev)
        self.inbox_type[base:] = host_to_device(self._flush_type, dev)
        self.inbox_payload[base:] = host_to_device(self._flush_payload, dev)
        self.inbox_valid[base:] = host_to_device(self._flush_valid, dev)
        if self.metrics_on:
            self.inbox_enq[base:] = self.step_count

    def _flush_staged(self) -> None:
        k = self._drain_to_pad()
        if k == 0:
            return
        self._flush()
        if self.flight_recorder is not None:
            self.flight_recorder.device_flush("batched", k)

    # ------------------------------------------------------------------ step
    def _step_impl(self, attend: bool = True) -> None:
        """One delivery + update step over the carry held on `self`, which
        it updates in place (the body of the step's CUDA graph)."""
        n, sc = self.capacity, self.spill_cap
        nk = n * self.out_degree
        state, old_alive, step = self.state, self.alive, self.step_count
        (new_state, behavior_id, alive, emits, dropped, spill, sup_delta,
         dcount) = self._core.run_local(
            state, self.behavior_id, self.alive, self.inbox_dst,
            self.inbox_type, self.inbox_payload, self.inbox_valid, step)
        if self.metrics_on:
            self.metrics.copy_(accumulate_step(
                self.metrics, state, new_state, old_alive, dcount,
                self.inbox_valid, self.inbox_enq, step,
                latch_col=self._core.attention_latch_col))

        # write emissions in place over the delivered inbox: rows
        # [sc, sc+n*K) are the emission slots, retained spill goes first,
        # host rows are cleared
        self.inbox_dst[sc:sc + nk] = emits.dst.reshape(-1)
        self.inbox_dst[sc + nk:] = -1
        if self.mailbox_slots > 0:  # the type column is unread in reduce
            self.inbox_type[sc:sc + nk] = emits.type.reshape(-1)
            self.inbox_type[sc + nk:] = 0
        self.inbox_payload[sc:sc + nk] = emits.payload.reshape(
            -1, self.payload_width)
        self.inbox_payload[sc + nk:] = 0
        self.inbox_valid[sc:sc + nk] = emits.valid.reshape(-1)
        self.inbox_valid[sc + nk:] = False
        if self.metrics_on:
            # emissions carry this step's counter; retained spill is
            # re-stamped at injection
            self.inbox_enq[:sc + nk] = step
            self.inbox_enq[sc + nk:] = 0
        if spill is not None:  # spill is None iff sc == 0
            sp_dst, sp_type, sp_pl, sp_v = spill
            self.inbox_dst[:sc] = sp_dst
            self.inbox_type[:sc] = sp_type
            self.inbox_payload[:sc] = sp_pl
            self.inbox_valid[:sc] = sp_v
        write_back(self.state, self.behavior_id, self.alive, new_state,
                   behavior_id, alive)
        self.mail_dropped.add_(dropped)
        self.sup_counts.add_(sup_delta)
        self.step_count.add_(1)
        if attend:
            self._attend()

    def _attend(self) -> None:
        """The words the host reads after a step, from the new carry: the
        attention word and, with metrics on, the metrics epoch."""
        self.attention.copy_(self._core.attention_word(
            self.state, self.mail_dropped, self.sup_counts,
            self.step_count))
        if self.metrics_on:
            self.metrics_epoch.copy_(slab_epoch(self.metrics))

    def _warm(self) -> None:
        """Eager warm-up steps over clones of the carry (the live carry is
        untouched)."""
        graphs.warm(graphs.shadow_of(self, CARRY)._step_impl, self.device)

    def _graph(self) -> graphs.StepGraph:
        return self._graphs.get(None, self._step_impl, self._warm)

    def _advance(self, n_steps: int) -> None:
        """n steps: replays of the step's graph on a card; on the CPU the
        eager step, the attention word packed once at the end."""
        if not self._eager and n_steps > 0:
            self._graph().replay(n_steps)
            return
        for _ in range(n_steps):
            self._step_impl(attend=False)
        self._attend()

    def warmup(self) -> None:
        """Capture the step's CUDA graph ahead of the first step, as the
        reference's warmup() compiles its programs: eager warm-up steps on
        a side stream over clones of the carry, then the capture. The live
        carry is untouched. A no-op on the CPU and once captured. Raises
        GraphCaptureError, naming the behavior, if a behavior cannot run
        inside the graph. With a flight recorder, emits device_compile
        with the time it took."""
        t0 = time.perf_counter()
        if not self._eager:
            self._graph()
        if self.flight_recorder is not None:
            self.flight_recorder.device_compile(
                "batched", time.perf_counter() - t0)

    def step(self) -> None:
        """One delivery+update step. Staged host tells are flushed into the
        inbox as part of the same step."""
        k = self._drain_to_pad()
        t0 = time.perf_counter()
        with trace_span("akka.device.step"):
            if k > 0:
                self._flush()
            self._advance(1)
        self._host_step += 1
        fr = self.flight_recorder
        if fr is not None:
            # elapsed_s is dispatch time: the card may still be running
            # the step
            if k > 0:
                fr.device_flush("batched", k)
            fr.device_step("batched", 1, time.perf_counter() - t0)
            self._report_supervision(fr)

    def run(self, n_steps: int) -> None:
        """n steps on the device without host syncs (the bench hot loop);
        staged tells are flushed once before the first."""
        self._flush_staged()
        t0 = time.perf_counter()
        with trace_span(f"akka.device.run[{n_steps}]"):
            self._advance(n_steps)
        self._host_step += int(n_steps)
        fr = self.flight_recorder
        if fr is not None:
            fr.device_step("batched", n_steps, time.perf_counter() - t0)
            self._report_supervision(fr)

    def run_pipelined(self, n_steps: int, depth: int = 2,
                      on_attention: Optional[Callable[[Dict[str, Any]],
                                                      None]] = None) -> None:
        """n single steps with up to `depth` in flight: step k+1 is
        enqueued before step k completes. Host tells staged between steps
        ride in the next one. With `on_attention`, every retired step's
        decoded attention word is delivered in order and the tail is
        drained before returning."""
        cb = None
        if on_attention is not None:
            cb = lambda w: on_attention(decode_attention(w))  # noqa: E731
        drive_pipelined(self.step, lambda: self.attention, n_steps, depth,
                        on_drain=cb)

    def block_until_ready(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------- checkpoint / recovery
    def checkpoint(self, directory: str, keep: Optional[int] = None) -> str:
        """Checkpoint barrier: synchronize the card, then snapshot the
        schema-v3 slab tree (state columns with the supervision columns,
        the inbox, the aggregate counters, the attention word and the
        metric slab) as `<directory>/slab-<step>.npz`. With a tell journal
        attached, the journal is compacted to the records at or after the
        snapshot's step; `keep` bounds the snapshots kept (oldest
        removed). Returns the snapshot's path."""
        from ..persistence.slab_snapshot import gc_slabs, save_slabs
        self.block_until_ready()
        path = save_slabs(self, directory)
        if self.tell_journal is not None:
            self.tell_journal.compact(self._host_step)
        if keep is not None:
            gc_slabs(directory, keep)
        return path

    def restore(self, path: str, journal=None) -> int:
        """Crash recovery: load a snapshot (schema v1-v3) into this system,
        writing each slab into its existing tensor, and reset the host step
        counter from its step_count. The caller builds a same-config
        system and re-runs its spawns first: behaviors are code, not
        snapshot data, so the host allocation state (free rows,
        generations) comes from the spawns. The staged host tells are
        dropped: whatever was staged but not flushed at the crash replays
        from the journal. With `journal`, the journaled batches past the
        snapshot's step are replayed to the crash frontier. Returns the
        restored host step counter.

        The metrics epoch is re-armed from the restored slab and the
        drained value reset to 0, so a restored non-empty slab drains at
        the next drain_metrics(), before any step. With metrics off the
        epoch stays 0 (the reference sums a restored slab there too, until
        its next step writes 0)."""
        from ..persistence.slab_snapshot import restore_slabs
        from ..persistence.tell_journal import replay_journal
        self.block_until_ready()
        restore_slabs(self, path)
        self._host_step = int(self.step_count.item())
        if self.metrics_on:
            self.metrics_epoch.copy_(slab_epoch(self.metrics))
        self._metrics_seen_epoch = 0
        self._staging.clear()
        if journal is not None:
            replay_journal(self, journal)
        return self._host_step

    def read_attention(self) -> Dict[str, Any]:
        """Decode the newest host-attention word (a tiny read that syncs
        the newest step). With a flight recorder, growth of the mailbox
        or exchange overflow since the last read raises one
        shard_overflow warning (shard 0: the single device)."""
        word = decode_attention(self.attention)
        fr = self.flight_recorder
        if fr is not None:
            mail = int(word.get("mail_dropped", 0))
            exch = int(word.get("exchange_dropped", 0))
            seen_mail, seen_exch = self._overflow_reported
            if mail > seen_mail or exch > seen_exch:
                fr.shard_overflow("batched", shard=0, mailbox_overflow=mail,
                                  dropped=exch)
                self._overflow_reported = (mail, exch)
        return word

    # ----------------------------------------------------- in-step metrics
    def metrics_epoch_value(self) -> int:
        """One scalar read of the metrics epoch (the slab's running sum;
        0 while metrics are off). Like read_attention it syncs the newest
        step."""
        return int(self.metrics_epoch.item())

    def read_metrics(self) -> Dict[str, np.ndarray]:
        """Host copy of the metric slab as named [N_BUCKETS] int64 lanes."""
        return slab_dict(self.metrics)

    def drain_metrics(self):
        """Epoch-gated slab drain for the registry: `(step, {lane:
        [N_BUCKETS] int64})` when the slab grew since the last drain,
        else None (and None while metrics are off). The quiet path costs
        one scalar read, the epoch; `MetricsRegistry.ingest_device_slab`
        takes the result."""
        if not self.metrics_on:
            return None
        epoch = self.metrics_epoch_value()
        if epoch == self._metrics_seen_epoch:
            return None
        self._metrics_seen_epoch = epoch
        return int(self.step_count.item()), slab_dict(self.metrics)

    # -------------------------------------------------------- fault handling
    def any_failed(self) -> bool:
        return fault_any_failed(self.state)

    def failed_rows(self) -> np.ndarray:
        """Rows whose behavior raised the `_failed` flag (suspended until
        restarted)."""
        return fault_failed_rows(self.state)

    def restart_rows(self, ids,
                     init_state: Optional[Dict[str, Any]] = None) -> None:
        """Host-mediated restart-with-reset-state: reset the rows' state
        (reserved columns re-armed), clear the failure flag, keep the
        behavior. A restart is a new incarnation: the rows' generation
        bumps."""
        fault_restart_rows(self.state, ids, init_state)
        arr = np.unique(np.atleast_1d(np.asarray(ids, np.int32)))
        with self._lock:
            self._generation[arr] += 1

    def clear_failed(self, ids) -> None:
        fault_clear_failed(self.state, ids)

    @property
    def supervision_counts(self) -> Dict[str, int]:
        """Aggregate in-step supervision counters (failed/resumed/
        restarted/stopped/escalated/dead_letters)."""
        return counts_dict(self.sup_counts)

    def any_escalated(self) -> bool:
        if "_escalated" not in self.state:
            return False
        return bool(self.state["_escalated"].any().item())

    def escalated_rows(self) -> np.ndarray:
        if "_escalated" not in self.state:
            return np.empty((0,), np.int32)
        flags = self.state["_escalated"].cpu().numpy()
        return np.nonzero(flags)[0].astype(np.int32)

    def _report_supervision(self, fr) -> None:
        """Emit the supervision counters' delta since the last report as
        one device_supervision event, when supervision is compiled in and
        something happened (a small device read, made only with a
        recorder attached)."""
        if not self._core.sup.active:
            return
        totals = self.sup_counts.cpu().numpy().astype(np.int64)
        delta = totals - self._sup_reported
        if not delta.any():
            return
        self._sup_reported = totals
        fr.device_supervision("batched", int(self.step_count.item()),
                              *(int(x) for x in delta))

    def set_behavior(self, ids, behavior: BatchedBehavior | int) -> None:
        """Host-side become: rewrite the rows' behavior index."""
        b_idx = behavior if isinstance(behavior, int) \
            else self.behaviors.index(behavior)
        self.behavior_id[self._index(np.atleast_1d(ids))] = b_idx

    @property
    def free_row_count(self) -> int:
        with self._lock:
            return len(self._free_rows) + (self.capacity - self._next_row)

    # ------------------------------------------------------------------ read
    def read_state(self, col: str, ids=None) -> np.ndarray:
        """Host copy of one state column (rows `ids`, or all)."""
        arr = self.state[col]
        if ids is not None:
            arr = arr[self._index(ids)]
        return arr.to("cpu", copy=True).numpy()  # not a view of the carry

    @property
    def dropped_messages(self) -> int:
        """Total host tells dropped on host-inbox overflow, by the
        staging path's own rule (batched/staging.py)."""
        return self._staging.dropped

    @property
    def mailbox_overflow(self) -> int:
        """Messages lost on the device (slots mode only): spill-region
        overflow, or with spill_capacity=0 every message past the S
        slots."""
        return int(self.mail_dropped.item())

    @property
    def live_count(self) -> int:
        return int(self.alive.sum().item())

    @property
    def pending_messages(self) -> int:
        return int(self.inbox_valid.sum().item())
