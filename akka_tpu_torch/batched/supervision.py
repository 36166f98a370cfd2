"""In-step vectorized supervision: 'let it crash' inside the device step.

Port of `akka_tpu/batched/supervision.py`. Each BatchedBehavior may carry a
LaneSupervisor; StepCore.update applies its directive as masked row ops in
the same step that detects the failure, with a step-count time base:

  RESUME    clear `_failed`, keep state (the failing receive's update was
            already discarded by the step).
  RESTART   re-initialize the row's behavior columns and bump its device
            generation `_gen`; restarts are counted within a `within_steps`
            window and back off exponentially (min_backoff_steps << retries,
            capped at max_backoff_steps), the row suspended meanwhile.
  STOP      the row dies (alive=False), `_failed` clears, `_gen` bumps.
            Retries-exhausted RESTART degrades to STOP.
  ESCALATE  the row stays suspended and `_escalated` raises for the host.

Everything is branch-free masked arithmetic over [n] columns. The reference
gates the pass behind `lax.cond` on "any row failed"; the port runs it
unconditionally, which gives the same result (every mask is empty on a
quiet step) without a host sync.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from .behavior import rows


class Directive(Enum):
    """Resume/Restart/Stop/Escalate (the port's copy of
    akka_tpu.actor.supervision.Directive)."""

    RESUME = "resume"
    RESTART = "restart"
    STOP = "stop"
    ESCALATE = "escalate"


# Directive -> lane code (order matches the reference)
LANE_RESUME, LANE_RESTART, LANE_STOP, LANE_ESCALATE = 0, 1, 2, 3
_LANE_CODE = {Directive.RESUME: LANE_RESUME, Directive.RESTART: LANE_RESTART,
              Directive.STOP: LANE_STOP, Directive.ESCALATE: LANE_ESCALATE}

# aggregate counter slots (the [N_COUNTERS] int32 vector in the step carry)
(FAILED, RESUMED, RESTARTED, STOPPED, ESCALATED, DEAD_LETTERS) = range(6)
N_COUNTERS = 6
COUNTER_NAMES = ("failed", "resumed", "restarted", "stopped", "escalated",
                 "dead_letters")

# per-row bookkeeping columns, added to the state schema when any behavior
# carries a supervisor; they survive an in-step restart
SUP_COLUMNS: Dict[str, Any] = {
    "_failed": ((), torch.bool),
    "_retries": ((), torch.int32),       # restarts inside the current window
    "_window_start": ((), torch.int32),  # step the window opened
    "_restart_at": ((), torch.int32),    # pending backoff restart (-1 = none)
    "_escalated": ((), torch.bool),
    "_gen": ((), torch.int32),           # device-side incarnation counter
}
_RESERVED = frozenset(SUP_COLUMNS)


def reserved_fill(col: str) -> int:
    """Re-arm value a reserved column takes on init/reset (everything else
    zeros)."""
    return -1 if col in ("_become", "_restart_at") else 0


@dataclass(frozen=True)
class LaneSupervisor:
    """Per-behavior supervision spec (OneForOne: a failure touches only its
    own row). max_nr_of_retries=-1 is unlimited, within_steps=0 one
    unbounded window, 0 retries means STOP; min/max_backoff_steps give the
    exponential restart delay in steps; restart_state holds scalar column
    overrides applied on restart."""

    directive: Directive = Directive.RESTART
    max_nr_of_retries: int = -1
    within_steps: int = 0
    min_backoff_steps: int = 0
    max_backoff_steps: int = 0
    restart_state: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if self.directive not in _LANE_CODE:
            raise ValueError(f"unknown directive {self.directive!r}")
        if self.min_backoff_steps < 0 or self.max_backoff_steps < 0:
            raise ValueError("backoff steps must be >= 0")


class SupervisionTables:
    """One small [n_behaviors] row per supervision parameter, gathered by
    behavior_id into row columns inside the step. Built once per
    StepCore, on its device."""

    def __init__(self, behaviors: Sequence[Any], device=None):
        sups = [getattr(b, "supervisor", None) for b in behaviors]
        self.active = any(s is not None for s in sups)
        self.device = device
        self._restart_state = [dict(s.restart_state) if s else {}
                               for s in sups]
        self._fill_cache: Dict[tuple, torch.Tensor] = {}
        default = LaneSupervisor()  # placeholder row for unsupervised ids

        def row(fn, dtype=torch.int32):
            return torch.tensor([fn(s if s is not None else default)
                                 for s in sups], dtype=dtype, device=device)

        self.enabled = torch.tensor([s is not None for s in sups],
                                    dtype=torch.bool, device=device)
        self.directive = row(lambda s: _LANE_CODE[s.directive])
        self.max_retries = row(lambda s: s.max_nr_of_retries)
        self.window = row(lambda s: s.within_steps)
        self.min_backoff = row(lambda s: s.min_backoff_steps)
        self.max_backoff = row(lambda s: s.max_backoff_steps)

    def fill_row(self, col: str, dtype) -> torch.Tensor:
        """[n_behaviors] restart fill values for one state column: the
        reserved re-arm value or zero, unless the behavior's restart_state
        overrides it."""
        key = (col, dtype)
        if key not in self._fill_cache:
            base = reserved_fill(col)
            vals = np.asarray([rs.get(col, base)
                               for rs in self._restart_state])
            self._fill_cache[key] = torch.as_tensor(vals).to(
                dtype=dtype, device=self.device)
        return self._fill_cache[key]


def apply_supervision(tables: SupervisionTables,
                      state: Dict[str, torch.Tensor],
                      behavior_id: torch.Tensor, alive: torch.Tensor,
                      old_failed: torch.Tensor,
                      delivered_count: torch.Tensor, step: torch.Tensor,
                      n_shards: Optional[int] = None):
    """The vectorized supervisor, right after the behavior switch. Returns
    (new_state, new_alive, counts_delta [N_COUNTERS] int32), or with
    `n_shards` the counts of each of that many equal contiguous blocks of
    rows ([n_shards, N_COUNTERS]).

    `state` is the post-switch state (failing rows already hold their
    pre-failure columns plus a sticky `_failed`); `old_failed` is the flag
    BEFORE the switch, so `failed & ~old_failed` isolates this step's fresh
    failures. `delivered_count` ([n] int32) prices dead letters for mail
    that reached a row already down when the step began.
    """
    i32 = torch.int32
    bid = behavior_id.long()
    st = dict(state)
    enabled = tables.enabled[bid]
    code = tables.directive[bid]
    failed = st["_failed"]
    fresh = failed & ~old_failed & alive

    def total(x):
        if n_shards is None:
            return x.sum(dtype=torch.int64)
        return x.reshape(n_shards, -1).sum(1, dtype=torch.int64)

    dead_dst = enabled & (old_failed | ~alive)
    dead = total(torch.where(dead_dst, delivered_count, 0))

    act = fresh & enabled
    resume = act & (code == LANE_RESUME)
    want_restart = act & (code == LANE_RESTART)
    escalate = act & (code == LANE_ESCALATE)

    # -- restart permission: retries within a step-count window ----------
    win = tables.window[bid]
    expired = (win > 0) & ((step - st["_window_start"]) >= win)
    eff_retries = torch.where(want_restart & expired, 0, st["_retries"])
    maxr = tables.max_retries[bid]
    permitted = (maxr < 0) | (eff_retries < maxr)

    # -- exponential backoff in steps: min << retries, capped -------------
    minb = tables.min_backoff[bid]
    cap = torch.maximum(tables.max_backoff[bid], minb)
    raw = torch.bitwise_left_shift(minb, eff_retries.clamp(max=24))
    delay = torch.where(minb > 0,
                        torch.where(raw < minb, cap,  # int32 wrap -> cap
                                    torch.minimum(raw, cap)), 0)

    scheduled = want_restart & permitted
    restart_now = scheduled & (delay == 0)
    restart_later = scheduled & (delay > 0)
    exhausted = want_restart & ~permitted
    # a backoff restart coming due: the row failed in an earlier step and
    # its delay has elapsed (it resumes processing NEXT step)
    due = failed & ~fresh & alive & enabled & \
        (st["_restart_at"] >= 0) & (step >= st["_restart_at"])

    do_restart = restart_now | due
    stop = (act & (code == LANE_STOP)) | exhausted

    # -- restart: re-initialize the row's behavior columns ----------------
    for col, v in list(st.items()):
        if col in _RESERVED:
            continue
        fill = tables.fill_row(col, v.dtype)[bid]
        st[col] = torch.where(rows(do_restart, v),
                              rows(fill, v).expand_as(v), v)

    # -- bookkeeping -------------------------------------------------------
    st["_window_start"] = torch.where(scheduled & (eff_retries == 0), step,
                                      st["_window_start"]).to(i32)
    st["_retries"] = torch.where(scheduled, eff_retries + 1,
                                 st["_retries"]).to(i32)
    st["_restart_at"] = torch.where(
        restart_later, step + delay,
        torch.where(due, -1, st["_restart_at"])).to(i32)
    st["_escalated"] = st["_escalated"] | escalate
    st["_gen"] = (st["_gen"] + (do_restart | stop).to(i32)).to(i32)
    st["_failed"] = failed & ~(resume | do_restart | stop)
    new_alive = alive & ~stop

    counts = torch.stack([total(fresh), total(resume), total(do_restart),
                          total(stop), total(escalate), dead], -1).to(i32)
    return st, new_alive, counts


def counts_dict(vec) -> Dict[str, int]:
    """[N_COUNTERS] vector -> named dict (host side)."""
    arr = np.asarray(torch.as_tensor(vec).cpu()).reshape(-1, N_COUNTERS) \
        .sum(0)
    return {name: int(arr[i]) for i, name in enumerate(COUNTER_NAMES)}


# --------------------------------------------------------------------------
# Host-attention word: one tiny int32 vector per step that a pipelined run
# reads (the sync point) instead of wide per-column fetches.

ATT_WORDS = 6
(ATT_FLAGS, ATT_DROPPED, ATT_DEAD_LETTERS, ATT_STEP,
 ATT_EXCH_DROPPED, ATT_PROGRESS) = range(ATT_WORDS)

# ATT_FLAGS bit layout
ATT_FAILED_BIT = 1     # some row holds `_failed`
ATT_ESCALATED_BIT = 2  # some row holds `_escalated`
ATT_LATCH_BIT = 4      # some promise row latched a reply


def attention_flags(state: Dict[str, torch.Tensor],
                    latch_col: Optional[str] = None, blocks: int = 1,
                    device=None) -> torch.Tensor:
    """[blocks] int32 flag words over the state columns, one per equal
    contiguous block of rows; absent columns contribute zero."""
    i32 = torch.int32
    flags = torch.zeros((blocks,), dtype=i32, device=device)
    for col, bit in (("_failed", ATT_FAILED_BIT),
                     ("_escalated", ATT_ESCALATED_BIT),
                     (latch_col, ATT_LATCH_BIT)):
        if col is not None and col in state:
            flags = flags | (state[col].reshape(blocks, -1) != 0).any(1) \
                .to(i32) * bit
    return flags


def pack_attention(state: Dict[str, torch.Tensor], mail_dropped, sup_counts,
                   step_count, latch_col: Optional[str] = None,
                   exch_dropped=None, progress=None,
                   n_shards: Optional[int] = None) -> torch.Tensor:
    """[ATT_WORDS] int32 attention word for one step. `mail_dropped` /
    `sup_counts` may be scalars or per-shard blocks; both reduce to
    totals. `progress` defaults to step_count (the heartbeat lane).

    With `n_shards`, one word per equal contiguous block of rows
    ([n_shards, ATT_WORDS]), each from its own rows and its own counters
    (mail_dropped, exch_dropped: [D]; sup_counts: [D, N_COUNTERS]), as the
    reference packs one word per shard of its mesh."""
    i32 = torch.int32
    d = 1 if n_shards is None else n_shards
    step = torch.as_tensor(step_count).to(i32).reshape(())
    dev = step.device

    def per_block(x):
        return torch.as_tensor(x).reshape(d, -1).sum(1).to(i32)

    dead = torch.as_tensor(sup_counts).reshape(d, -1, N_COUNTERS)[
        :, :, DEAD_LETTERS]
    exch = (per_block(exch_dropped) if exch_dropped is not None
            else torch.zeros((d,), dtype=i32, device=dev))
    prog = (torch.as_tensor(progress).to(i32).reshape(())
            if progress is not None else step)
    word = torch.stack([attention_flags(state, latch_col, d, dev),
                        per_block(mail_dropped), per_block(dead),
                        step.expand(d), exch, prog.expand(d)], 1)
    return word if n_shards is not None else word[0]


def decode_attention(word) -> Dict[str, Any]:
    """Host-side decode of attention word(s): [ATT_WORDS] or, sharded,
    [n_shards, ATT_WORDS]. Flags OR across shards, counters sum, step
    takes the max; per-shard counter columns are surfaced raw."""
    a = np.asarray(torch.as_tensor(word).cpu(), np.int64) \
        .reshape(-1, ATT_WORDS)
    flags = int(np.bitwise_or.reduce(a[:, ATT_FLAGS])) if a.size else 0
    return {
        "flags": flags,
        "any_failed": bool(flags & ATT_FAILED_BIT),
        "any_escalated": bool(flags & ATT_ESCALATED_BIT),
        "any_latched": bool(flags & ATT_LATCH_BIT),
        "mail_dropped": int(a[:, ATT_DROPPED].sum()),
        "dead_letters": int(a[:, ATT_DEAD_LETTERS].sum()),
        "step": int(a[:, ATT_STEP].max()) if a.size else 0,
        "exchange_dropped": int(a[:, ATT_EXCH_DROPPED].sum()),
        "mail_dropped_per_shard": a[:, ATT_DROPPED].copy(),
        "dropped_per_shard": a[:, ATT_EXCH_DROPPED].copy(),
        "progress_per_shard": a[:, ATT_PROGRESS].copy(),
    }
