"""BatchedSystem: the SoA device runtime, millions of actors per card.

Port of `akka_tpu/batched/core.py` (single device). State is a dict of
[capacity, ...] columns (the union of all behavior schemas); messages are
(dst, type, payload, valid) SoA blocks; one `step` delivers every in-flight
message and runs every live actor's update on the device.

Where the reference donates its carry to a jitted program, the port updates
the inbox buffers in place: each step writes its emissions over the inbox
it has just delivered (retained spill first, host rows cleared), and
`spawn_block`/`stop_block`/`seed_inbox`/the host flush write rows in place.
State columns are replaced by each step's new tensors.

`run(n)` is a Python loop over the step (the reference's `lax.scan`), and
`run_pipelined` keeps up to `depth` steps in flight, synchronising on each
step's attention word. Host tells stage in a Python list (the reference's
C++ NativeStager is not ported yet) and ride into the next `step()` with
its flush. `checkpoint`/`restore` are not ported yet.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from .behavior import BatchedBehavior
from .metrics_slab import (ASK_ARM_COL, ASK_ARM_SPEC, accumulate_step,
                           empty_slab, slab_dict)
from .step import (StepCore, fault_any_failed, fault_clear_failed,
                   fault_failed_rows, fault_restart_rows)
from .supervision import (ATT_WORDS, N_COUNTERS, SUP_COLUMNS, counts_dict,
                          decode_attention, reserved_fill)


def drive_pipelined(step_once: Callable[[], None],
                    latest_handle: Callable[[], torch.Tensor],
                    n_steps: int, depth: int,
                    on_drain: Optional[Callable[[np.ndarray], None]] = None,
                    ) -> None:
    """Enqueue-ahead step loop: dispatch up to `depth` steps before waiting
    on the oldest, keyed off each step's attention-word tensor. Reading a
    word to the host is the sync. With `on_drain`, every retired step's
    word is handed to the callback and the tail is drained before
    returning; without it the tail stays in flight."""
    if depth < 1:
        raise ValueError("depth must be >= 1")
    inflight: deque = deque()  # attention-word tensors, oldest first

    def drain_one() -> None:
        word = inflight.popleft().cpu().numpy()
        if on_drain is not None:
            on_drain(word)

    for _ in range(n_steps):
        step_once()
        inflight.append(latest_handle())
        while len(inflight) >= depth:
            drain_one()
    while on_drain is not None and inflight:
        drain_one()


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """Host staging dtype for a payload dtype (bf16 stages as float32)."""
    if dtype == torch.bfloat16:
        return np.dtype(np.float32)
    return torch.empty((0,), dtype=dtype).numpy().dtype


class BatchedSystem:
    """Single-device batched actor space.

    capacity: max live actors (rows); out_degree K: max emissions per actor
    per step; payload_width P: message payload columns; host_inbox: rows
    reserved for host tells per flush; mailbox_slots S: 0 = commutative
    reduction inboxes, >0 = per-message mailboxes of S ordered
    (type, payload) slots (required when any behavior has inbox="slots").
    delivery_backend: None/"auto", "ranked" or "cuda" (ops/segment.py).
    device: where the system runs; defaults to CUDA and raises without a
    card unless device="cpu" is passed.
    """

    def __init__(self, capacity: int, behaviors: Sequence[BatchedBehavior],
                 payload_width: int = 4, out_degree: int = 1,
                 host_inbox: int = 1024, payload_dtype=torch.float32,
                 device=None, delivery: str = "auto",
                 need_max: bool = False, topology=None,
                 mailbox_slots: int = 0,
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
        self.attention = torch.zeros((ATT_WORDS,), dtype=i32, device=dev)
        self.metrics = empty_slab(device=dev)

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
        self._host_staged: List[Tuple[int, int, np.ndarray]] = []
        self._lock = threading.Lock()
        self._dropped_host = 0  # guarded by _lock
        # per-row incarnation counter: bumped on stop and restart, checked
        # by tells that carry expect_gen (host-authoritative)
        self._generation = np.zeros((n,), np.int64)
        self.dead_lettered = 0  # generation-mismatch tells (guarded by _lock)
        self.on_dead_letter: Optional[Callable[[int], None]] = None
        self.on_dropped: Optional[Callable[[int], None]] = None
        # host mirror of the dispatched-step counter
        self._host_step = 0
        self._np_payload_dtype = _numpy_dtype(payload_dtype)

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
            with self._lock:
                rec_set = set(int(i) for i in rec_arr)
                self._host_staged = [e for e in self._host_staged
                                     if e[0] not in rec_set]
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
        with self._lock:
            for d, t, p in zip(dst_arr, mt, pl):
                self._host_staged.append((int(d), int(t), p))

    def seed_inbox(self, dst, payload, mtype=0) -> None:
        """Bulk device-side injection: overwrite the first len(dst) inbox
        rows (the fast path for benches and bulk tells)."""
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
        """Drain staged host tells into the reusable pads, applying
        overflow-drop accounting. Returns the number of staged rows."""
        with self._lock:
            staged, self._host_staged = self._host_staged, []
        if not staged:
            return 0
        if len(staged) > self.host_inbox:
            n_drop = len(staged) - self.host_inbox
            with self._lock:
                self._dropped_host += n_drop
            if self.on_dropped is not None:
                self.on_dropped(n_drop)
            staged = staged[: self.host_inbox]
        k = len(staged)
        self._flush_dst[:k] = [d for d, _, _ in staged]
        self._flush_type[:k] = [t for _, t, _ in staged]
        self._flush_payload[:k] = np.stack([p for _, _, p in staged])
        self._flush_valid[:k] = True
        self._flush_valid[k:] = False
        self._flush_dst[k:] = -1
        return k

    def _flush(self) -> None:
        """Overwrite the host region of the inbox with the pads. With
        metrics on, flushed rows stamp the enqueue column with the flushing
        step's counter."""
        base = self.spill_cap + self.capacity * self.out_degree
        dev = self.device
        self.inbox_dst[base:] = torch.from_numpy(self._flush_dst).to(dev)
        self.inbox_type[base:] = torch.from_numpy(self._flush_type).to(dev)
        self.inbox_payload[base:] = torch.from_numpy(
            self._flush_payload).to(dev, self.payload_dtype)
        self.inbox_valid[base:] = torch.from_numpy(self._flush_valid).to(dev)
        if self.metrics_on:
            self.inbox_enq[base:] = self.step_count

    def _flush_staged(self) -> None:
        if self._drain_to_pad():
            self._flush()

    # ------------------------------------------------------------------ step
    def _step_impl(self, attend: bool = True) -> None:
        """One delivery + update step over the carry held on `self`."""
        n, sc = self.capacity, self.spill_cap
        nk = n * self.out_degree
        state, old_alive, step = self.state, self.alive, self.step_count
        (new_state, behavior_id, alive, emits, dropped, spill, sup_delta,
         dcount) = self._core.run_local(
            state, self.behavior_id, self.alive, self.inbox_dst,
            self.inbox_type, self.inbox_payload, self.inbox_valid, step)
        if self.metrics_on:
            self.metrics = accumulate_step(
                self.metrics, state, new_state, old_alive, dcount,
                self.inbox_valid, self.inbox_enq, step,
                latch_col=self._core.attention_latch_col)

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
        self.state, self.behavior_id, self.alive = new_state, behavior_id, \
            alive
        self.mail_dropped = self.mail_dropped + dropped
        self.sup_counts = self.sup_counts + sup_delta
        self.step_count = step + 1
        if attend:
            self._attend()

    def _attend(self) -> None:
        self.attention = self._core.attention_word(
            self.state, self.mail_dropped, self.sup_counts, self.step_count)

    def step(self) -> None:
        """One delivery+update step. Staged host tells are flushed into the
        inbox as part of the same step."""
        k = self._drain_to_pad()
        with torch.profiler.record_function("akka.device.step"):
            if k > 0:
                self._flush()
            self._step_impl()
        self._host_step += 1

    def run(self, n_steps: int) -> None:
        """n steps on the device without host syncs (the bench hot loop);
        staged tells are flushed once before the first."""
        self._flush_staged()
        with torch.profiler.record_function(f"akka.device.run[{n_steps}]"):
            for _ in range(n_steps):
                self._step_impl(attend=False)
            self._attend()
        self._host_step += int(n_steps)

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

    def read_attention(self) -> Dict[str, Any]:
        """Decode the newest host-attention word (a tiny read that syncs
        the newest step)."""
        return decode_attention(self.attention)

    def read_metrics(self) -> Dict[str, np.ndarray]:
        """Host copy of the metric slab as named [N_BUCKETS] int64 lanes."""
        return slab_dict(self.metrics)

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
        self.state = fault_restart_rows(self.state, ids, init_state)
        arr = np.unique(np.atleast_1d(np.asarray(ids, np.int32)))
        with self._lock:
            self._generation[arr] += 1

    def clear_failed(self, ids) -> None:
        self.state = fault_clear_failed(self.state, ids)

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
        return arr.cpu().numpy()

    @property
    def dropped_messages(self) -> int:
        """Total host tells dropped on host-inbox overflow."""
        with self._lock:
            return self._dropped_host

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
