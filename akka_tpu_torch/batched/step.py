"""StepCore: the deliver -> update core of the batched device runtime.

Port of `akka_tpu/batched/step.py`. One step delivers the step's messages
into per-actor inboxes, runs every live actor's behavior over the batch
(each behavior on all rows, selected by behavior id, as the reference's
vmapped `lax.switch` does), applies supervision, and hands the emitted
messages back to the caller, who writes them as the next inbox.

Two delivery modes:
- reduce: one segment reduction -> Inbox(sum, max, count).
- slots:  ordered delivery -> per-actor Mailbox of up to S discrete
  (type, payload) messages in per-sender FIFO order.

`topology` (StaticTopology compiled routing) is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.segment import deliver, deliver_slots
from .behavior import BatchedBehavior, Ctx, Emit, Inbox, Mailbox, rows
from .supervision import (N_COUNTERS, SupervisionTables, apply_supervision,
                          pack_attention, reserved_fill)


def _select(mask: torch.Tensor, new: torch.Tensor,
            old: torch.Tensor) -> torch.Tensor:
    """Row-wise select of an [n, ...] column, kept in the old dtype."""
    return torch.where(rows(mask, old), new.to(old.dtype), old)


class StepCore:
    """The deliver+update function of the batched runtime.

    n_local: actors owned by this caller (rows in the state slabs it
    passes); n_global: total actor-id space (== n_local on one device).
    slots=0 selects reduce mode; slots>0 per-message mailboxes of S slots.
    """

    def __init__(self, behaviors: Sequence[BatchedBehavior], n_local: int,
                 payload_width: int, out_degree: int, payload_dtype,
                 slots: int = 0, need_max: bool = False, topology=None,
                 delivery: str = "auto", n_global: Optional[int] = None,
                 spill_cap: int = 0,
                 delivery_backend: Optional[str] = None,
                 attention_latch_col: Optional[str] = None, device=None):
        if topology is not None:
            raise NotImplementedError(
                "StaticTopology routing (deliver_static) is not ported yet; "
                "build the system with topology=None (dynamic delivery)")
        self.behaviors = list(behaviors)
        self.n_local = int(n_local)
        self.n_global = int(n_global if n_global is not None else n_local)
        self.payload_width = int(payload_width)
        self.out_degree = int(out_degree)
        self.payload_dtype = payload_dtype
        self.slots = int(slots)
        self.need_max = need_max
        self.delivery = delivery
        # kernel implementation seam (ops/segment.py): None/"auto",
        # "ranked" or "cuda"
        self.delivery_backend = delivery_backend
        self.spill_cap = int(spill_cap)
        self.attention_latch_col = attention_latch_col
        self.device = device

        if self.slots == 0:
            bad = [b.name for b in self.behaviors if b.inbox == "slots"]
            if bad:
                raise ValueError(
                    f"behaviors {bad} need per-message mailboxes: construct "
                    f"the system with mailbox_slots > 0")
        self.sup = SupervisionTables(self.behaviors, device)
        # which behaviors consume ordered slots: overflow past the slot cap
        # is a real drop only for these
        self._slots_kind = torch.tensor(
            [b.inbox == "slots" for b in self.behaviors], dtype=torch.bool,
            device=device)

    # -------------------------------------------------------------- branch
    def _branch(self, b: BatchedBehavior, state, delivered, ctx: Ctx):
        """One behavior over all rows, with activity gating (rows with no
        mail keep their state and emit nothing, unless always_on) and the
        opt-in non-finite guard. Returns (full state dict, Emit)."""
        if self.slots > 0:
            mailbox: Mailbox = delivered
            arg = mailbox if b.inbox == "slots" else mailbox.reduce()
            count = mailbox.count
        else:
            arg = delivered
            count = delivered.count
        new_cols, emit = b.receive(dict(state), arg, ctx)
        emit = emit.with_type()
        active = (count > 0) | b.always_on
        merged = dict(state)
        for col, v in new_cols.items():
            merged[col] = _select(active, v, state[col])
        if b.nonfinite_guard:
            # a new state row carrying NaN/Inf marks the row failed; the
            # update layer then discards it (pre-failure state kept)
            bad = torch.zeros_like(active)
            for v in new_cols.values():
                if v.is_floating_point():
                    bad |= ~torch.isfinite(v).reshape(v.shape[0], -1).all(1)
            merged["_failed"] = merged["_failed"] | (bad & active)
        emit = Emit(dst=torch.where(active[:, None], emit.dst, -1),
                    payload=emit.payload,
                    valid=emit.valid & active[:, None],
                    type=emit.type)
        return merged, emit

    # ------------------------------------------------------------- deliver
    def deliver(self, inbox_dst, inbox_type, inbox_payload, inbox_valid,
                dst_offset=None, slots_kind_row=None, suspended=None):
        """Route this step's messages into per-actor inboxes. dst_offset
        maps global recipient ids to local rows (None on one device)."""
        n = self.n_local
        dst = inbox_dst if dst_offset is None else inbox_dst - dst_offset
        if self.slots > 0:
            return deliver_slots(dst, inbox_type, inbox_payload, inbox_valid,
                                 n, self.slots, self.need_max,
                                 spill_cap=self.spill_cap,
                                 slots_kind=slots_kind_row,
                                 suspended=suspended,
                                 backend=self.delivery_backend)
        return deliver(dst, inbox_payload, inbox_valid, n, self.need_max,
                       mode=self.delivery, backend=self.delivery_backend)

    # -------------------------------------------------------------- update
    def update(self, state, behavior_id, alive, delivered, step_count,
               id_base=0, tables=()):
        """Behavior switch over all local rows, then the supervision pass.
        Returns (new_state, new_behavior_id, new_alive, emits, sup_delta)
        with emits shaped [n_local, K(, P)] and sup_delta the
        [N_COUNTERS] int32 counter increment. Dead rows neither update nor
        emit; STOP-directive rows come back dead in new_alive."""
        n = self.n_local
        dev = behavior_id.device
        ids = torch.arange(n, dtype=torch.int32, device=dev) + id_base
        ctx = Ctx(actor_id=ids, step=step_count, n_actors=self.n_global,
                  tables=tables)
        d = delivered
        if self.slots > 0:
            inbox = Mailbox(types=d.types, payload=d.payload, valid=d.valid,
                            count=d.count, sum=d.sum, max=d.max)
        else:
            inbox = Inbox(sum=d.sum, max=d.max, count=d.count)

        outs = [self._branch(b, state, inbox, ctx) for b in self.behaviors]
        new_state, emit = outs[0]
        if len(outs) > 1:
            # lax.switch semantics: every branch ran; select by the
            # (clamped) behavior id
            bid = behavior_id.clamp(0, len(outs) - 1)
            new_state = dict(new_state)
            for b, (st_b, em_b) in enumerate(outs[1:], start=1):
                sel = bid == b
                new_state = {c: _select(sel, st_b[c], v)
                             for c, v in new_state.items()}
                emit = Emit(*(_select(sel, x, y)
                              for x, y in zip(em_b, emit)))

        # an already-failed row is suspended (no update, no emissions); a
        # row failing THIS step keeps its pre-failure state and emits
        # nothing; only the flag itself sticks
        no = torch.zeros((n,), dtype=torch.bool, device=dev)
        was_failed = state.get("_failed", no)
        live = alive & ~was_failed
        now_failed = new_state.get("_failed", no)
        apply = live & ~now_failed
        new_state = {c: _select(apply, v, state[c])
                     for c, v in new_state.items()}
        if "_failed" in new_state:
            new_state["_failed"] = torch.where(live, now_failed, was_failed)
        emits = Emit(dst=torch.where(apply[:, None], emit.dst, -1),
                     payload=emit.payload,
                     valid=emit.valid & apply[:, None],
                     type=emit.type)

        # device-side become: behaviors write the target behavior index into
        # the reserved `_become` column; the runtime applies it and re-arms
        # the column to -1
        new_behavior_id = behavior_id
        if "_become" in new_state:
            req = new_state["_become"]
            new_behavior_id = torch.where(req >= 0, req.to(torch.int32),
                                          behavior_id)
            new_state["_become"] = torch.full_like(req, -1)
        # supervision: table lookups use the PRE-become behavior id
        new_alive = alive
        sup_delta = torch.zeros((N_COUNTERS,), dtype=torch.int32,
                                device=dev)
        if self.sup.active and "_failed" in new_state:
            new_state, new_alive, sup_delta = apply_supervision(
                self.sup, new_state, behavior_id, alive,
                old_failed=state["_failed"], delivered_count=d.count,
                step=step_count)
        return new_state, new_behavior_id, new_alive, emits, sup_delta

    def attention_word(self, state, mail_dropped, sup_counts, step_count,
                       exch_dropped=None):
        """[ATT_WORDS] int32 host-attention word for the step that produced
        these carries."""
        return pack_attention(state, mail_dropped, sup_counts, step_count,
                              latch_col=self.attention_latch_col,
                              exch_dropped=exch_dropped)

    def run_local(self, state, behavior_id, alive, inbox_dst, inbox_type,
                  inbox_payload, inbox_valid, step_count, dst_offset=None,
                  id_base=0, tables=()):
        """deliver + update in one call. Returns (new_state,
        new_behavior_id, new_alive, emits, dropped, spill, sup_delta,
        delivered_count): dropped is this step's real message-loss count,
        spill a (dst, type, payload, valid) tuple of retained mail for the
        FRONT of the next inbox (None when spill_cap == 0), and
        delivered_count the [n_local] int32 per-row delivery count."""
        slots_kind_row = suspended = None
        if self.slots > 0 and self.spill_cap > 0:
            slots_kind_row = self._slots_kind[behavior_id.long()]
            if "_failed" in state:
                # suspended = failed-but-restartable; supervised rows are
                # excluded (their down-time mail is dead-lettered)
                suspended = state["_failed"] & alive
                if self.sup.active:
                    suspended = suspended & \
                        ~self.sup.enabled[behavior_id.long()]
        d = self.deliver(inbox_dst, inbox_type, inbox_payload, inbox_valid,
                         dst_offset, slots_kind_row, suspended)
        new_state, new_behavior_id, alive, emits, sup_delta = self.update(
            state, behavior_id, alive, d, step_count, id_base, tables)
        spill = None
        if self.slots > 0 and self.spill_cap > 0:
            sd = d.spill_dst
            if dst_offset is not None:
                sd = torch.where(d.spill_valid, sd + dst_offset, -1)
            spill = (sd, d.spill_type, d.spill_payload, d.spill_valid)
            dropped = d.dropped
        elif self.slots > 0:
            # bounded mailbox: per-recipient overflow, masked to slots-kind
            # recipients (reduce-kind consume everything via aggregation)
            over = (d.count - self.slots).clamp(min=0)
            dropped = torch.where(self._slots_kind[behavior_id.long()],
                                  over, 0).sum().to(torch.int32)
        else:
            dropped = torch.zeros((), dtype=torch.int32,
                                  device=inbox_dst.device)
        return (new_state, new_behavior_id, alive, emits, dropped, spill,
                sup_delta, d.count)


# -------------------------------------------------- shared fault handling
# Host-side error-lane helpers.

def _index(ids, device) -> torch.Tensor:
    return torch.as_tensor(np.atleast_1d(np.asarray(ids, np.int64)),
                           device=device)


def fault_any_failed(state) -> bool:
    """One device scalar, not the whole column."""
    if "_failed" not in state:
        return False
    return bool(state["_failed"].any().item())


def fault_failed_rows(state) -> np.ndarray:
    if "_failed" not in state:
        return np.empty((0,), np.int32)
    flags = state["_failed"].cpu().numpy()
    return np.nonzero(flags)[0].astype(np.int32)


def fault_restart_rows(state, ids, init_state=None):
    """Restart-with-reset-state: the rows' columns reset (reserved columns
    re-armed) in a new state dict; mutates nothing. `_gen` is bumped, not
    reset: a host restart is a new incarnation."""
    out = dict(state)
    for col, arr in out.items():
        idx = _index(ids, arr.device)
        if col == "_gen":
            out[col] = arr.index_put((idx,), torch.ones_like(idx, dtype=arr
                                                             .dtype),
                                     accumulate=True)
            continue
        out[col] = arr.index_put(
            (idx,), torch.tensor(reserved_fill(col), dtype=arr.dtype,
                                 device=arr.device))
    for col, value in (init_state or {}).items():
        arr = out[col]
        out[col] = arr.index_put(
            (_index(ids, arr.device),),
            torch.as_tensor(value, dtype=arr.dtype, device=arr.device))
    return out


def fault_clear_failed(state, ids):
    """Clear only the failure flag (and `_escalated`: the host clearing a
    row IS the escalation's resolution). Returns a new state dict."""
    if "_failed" not in state:
        return state
    out = dict(state)
    for col in ("_failed", "_escalated"):
        if col in out:
            arr = out[col]
            out[col] = arr.index_put(
                (_index(ids, arr.device),),
                torch.zeros((), dtype=arr.dtype, device=arr.device))
    return out
