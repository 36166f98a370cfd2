"""Ask micro-batching: concurrent region asks share step rounds.

Port of the synchronous engine of `akka_tpu/sharding/ask_batch.py`
(`BatchAsk`, `execute_ask_batch` and its stage helpers).
`execute_ask_batch(region, batch)` gives each ask its promise row, stages
all the tells as one flush, runs one shared step budget, and resolves every
latch from one read of the promise block. The caller holds
`region._ask_lock`. A batch of one runs the exact schedule of a solo ask,
`[steps] + [1] * max_extra_steps`, so solo results are bit-identical.

One scheduling rule is load-bearing: the dense inbox SUMS payloads, so two
asks to the SAME entity row in one step round would sum their reply-row
columns and misroute both replies. The engine therefore stages at most one
ask in flight per destination row; duplicates wait for the occupant to
resolve and ride a later round, which also linearizes per-entity totals.

Not ported yet: the futures front end (`AskBatcher`,
`ContinuousWaveScheduler`, `wait_adaptive_close`; ROADMAP A7), the tracer
spans (A9: this is the reference's no-tracer path) and the entity-journal
commit (A8).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..batched.bridge import (AskPoolExhausted, max_exact_row_id,
                              read_promise_block)
from ..batched.supervision import decode_attention

__all__ = ["BatchAsk", "execute_ask_batch"]


class BatchAsk:
    """One ask riding a batch: request in, outcome (the reply payload or
    the member's exception instance) out."""

    __slots__ = ("shard", "index", "message", "steps", "max_extra_steps",
                 "slot", "prow", "row", "start", "outcome")

    def __init__(self, shard: int, index: int, message: Any,
                 steps: int = 2, max_extra_steps: int = 8):
        self.shard = shard
        self.index = index
        self.message = message
        self.steps = steps
        self.max_extra_steps = max_extra_steps
        self.slot: Optional[int] = None
        self.prow: Optional[int] = None
        self.row: Optional[int] = None
        self.start = 0
        self.outcome: Any = None


def _reset_batch_latches(region, slots: Sequence[int]) -> None:
    """Lower `__promise_replied` for the batch's slots before reuse, in one
    indexed write. Slots not in the batch (retired timeouts waiting for
    their late reply) are left as they are."""
    col = region.system.state["__promise_replied"]
    base = region._promise_block * region.eps
    idx = np.asarray(list(slots), np.int64) + base
    col[idx] = False


def _assemble_slots(region, batch: Sequence[BatchAsk]) -> List[BatchAsk]:
    """One promise slot per member; an empty pool is a typed per-member
    fast-fail (AskPoolExhausted), not a batch failure. The caller holds
    `region._ask_lock`. Returns the live members, each with slot, prow and
    row assigned."""
    sys = region.system
    eps = region.eps
    base = region._promise_block * eps
    limit = max_exact_row_id(sys.payload_dtype)
    live: List[BatchAsk] = []
    for a in batch:
        with region._lock:
            if not region._promise_free:
                region._stat_ask_exhausted += 1
                a.outcome = AskPoolExhausted(
                    f"promise rows exhausted ({eps} slots, "
                    f"{len(region._promise_retired)} retired)")
                continue
            a.slot = region._promise_free.pop()
        prow = base + a.slot
        if prow > limit:
            with region._lock:
                region._promise_free.append(a.slot)
            a.slot = None
            a.outcome = ValueError(
                f"promise row {prow} not exactly representable in "
                f"{str(sys.payload_dtype).removeprefix('torch.')} payloads")
            continue
        a.prow = prow
        a.row = region.row_of(a.shard, a.index)
        live.append(a)
    return live


def _stage_tell(sys, a: BatchAsk, cum: int) -> None:
    """Stage one ask's tell into the next flush: the message body, the
    reply-to promise row in the last column, and `start` stamped with the
    step count the timeout runs against."""
    payload = np.zeros((sys.payload_width,), np.float32)
    body = np.atleast_1d(np.asarray(a.message, np.float32)).reshape(-1)
    payload[:min(len(body), sys.payload_width - 1)] = \
        body[:sys.payload_width - 1]
    payload[-1] = float(a.prow)
    sys.tell(a.row, payload)
    a.start = cum


def execute_ask_batch(region, batch: Sequence[BatchAsk]) -> None:
    """Run a batch of asks through shared step rounds. The caller holds
    `region._ask_lock`. Fills each member's `.outcome` with the reply
    payload (np.ndarray) or an exception instance (AskPoolExhausted /
    ValueError / TimeoutError); never raises for per-ask conditions, so one
    member's timeout cannot fail its batch-mates."""
    region._ensure_promise_rows()
    region._reclaim_promise_slots()  # once per batch
    sys = region.system
    eps = region.eps
    base = region._promise_block * eps

    live = _assemble_slots(region, batch)
    if not live:
        return
    region._wave_seq += 1
    _reset_batch_latches(region, [a.slot for a in live])

    waiting = list(live)
    in_flight: Dict[int, BatchAsk] = {}  # row -> its one ask in flight
    cum = 0  # steps run so far in this batch

    def stage_ready() -> None:
        nonlocal waiting
        rest: List[BatchAsk] = []
        for a in waiting:
            if a.row in in_flight:
                rest.append(a)
                continue
            _stage_tell(sys, a, cum)
            in_flight[a.row] = a
        waiting = rest

    stage_ready()
    first = True
    while in_flight:
        # one `steps`-deep round for the whole wave, then single steps
        n_steps = min(a.steps for a in in_flight.values()) if first else 1
        first = False
        sys.run(n_steps)
        cum += n_steps
        # "any reply?" rides the attention word: its small read is also
        # the run's sync, and the promise block is read only when the
        # latch bit says some latch is high
        att = decode_attention(sys.attention)
        replied_blk = reply_blk = None
        if att["any_latched"] or not region._ask_latch_wired:
            replied_blk, reply_blk = read_promise_block(
                sys.state, base, eps, "__promise_replied", "__promise_reply")
        done_rows: List[int] = []
        for row, a in in_flight.items():
            if replied_blk is not None and bool(replied_blk[a.slot]):
                a.outcome = np.asarray(reply_blk[a.slot])
                with region._lock:
                    region._promise_free.append(a.slot)
                done_rows.append(row)
            elif cum - a.start >= a.steps + a.max_extra_steps:
                # timed out: RETIRE the slot, so a late reply lands in a
                # row no future ask reads; _reclaim_promise_slots returns
                # it once the straggler's latch shows
                with region._lock:
                    region._promise_retired.append(a.slot)
                a.outcome = TimeoutError(
                    f"ask to shard {a.shard} index {a.index} unanswered "
                    f"after {a.steps + a.max_extra_steps} steps")
                done_rows.append(row)
        for row in done_rows:
            del in_flight[row]
        if waiting:  # duplicates deferred from earlier rounds
            stage_ready()
