"""Ask micro-batching: coalesce concurrent region asks into shared step
rounds.

Port of `akka_tpu/sharding/ask_batch.py`. Collect the asks that arrive
within an adaptive window, give each its promise row, stage ALL the tells
as one coalesced flush, run ONE shared step budget, and resolve every
latch from one read of the promise block.

Three layers:

- `execute_ask_batch(region, batch)`: the synchronous engine. The caller
  holds `region._ask_lock`; a batch of one runs the exact schedule of a
  solo ask, `[steps] + [1] * max_extra_steps`, so solo results are
  bit-identical.
- `ContinuousWaveScheduler`: the engine split at its stage/resolve seam.
  Waves stage under the ask lock for the staging instant only; one runner
  thread drives shared step rounds for every open wave, keeping a few
  rounds enqueued ahead of the one it waits on.
- `AskBatcher`: the thread-safe futures front end the gateway uses.
  `submit()` returns a Future; a lazily started daemon dispatcher thread
  closes batches (N pending or T seconds, whichever first) and runs them
  through the engine or the scheduler.

On the card, the runner's enqueue-ahead starts a non-blocking copy of each
round's attention word into pinned host memory and records a CUDA event
behind it (`batched.core.snapshot_word`); retiring the oldest round waits
on that event only, not on the rounds dispatched since (a plain `.cpu()`
of the oldest word would wait for all of them, since every round runs on
the default stream). The copy is enqueued right behind the round's graph
replays and before the next round's, so it reads that round's word,
which the next round overwrites in place. On the CPU the same copy is
synchronous.

One scheduling rule is load-bearing: the dense inbox SUMS payloads, so
two asks to the SAME entity row in one step round would sum their
reply-row columns and misroute both replies. The engine therefore stages
at most one ask in flight per destination row; duplicates wait for the
occupant to resolve and ride a later round, which also linearizes
per-entity totals.

The tracer hooks are the reference's: a region's `tracer` is None (one
predicate per hook) until `DeviceShardRegion.attach_tracer` wires one
in, and then sampled asks emit the wave and member spans, stamped on
the region's step axis. The entity-journal commit sites stay behind
`getattr(region, "_entity_journal", None)`: a region without
`attach_entity_journal` pays one attribute read.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ..batched.core import snapshot_word
from ..event.tracing import NOOP_SPAN, current_ctx, reset_ctx, set_ctx

__all__ = ["BatchAsk", "execute_ask_batch", "AskBatcher",
           "ContinuousWaveScheduler", "wait_adaptive_close"]

# idle-poll backoff bounds for the dispatcher/runner loops: an idle loop
# parks IDLE_WAIT_MIN after its last work and
# doubles up to IDLE_WAIT_MAX; submit's Event.set() re-arms tight polling
# instantly, so the backoff trades idle CPU wakeups for nothing else
IDLE_WAIT_MIN = 1e-3
IDLE_WAIT_MAX = 0.25


def wait_adaptive_close(work: threading.Event, window_s: float,
                        full, idle=None) -> None:
    """THE adaptive window-close wait, shared by the ask dispatcher and
    the ingest aggregator (gateway/aggregator.py): block until `full()`
    says the window is worth closing or `window_s` has elapsed since the
    window opened — whichever first — waking early whenever `work` is
    set by a new arrival. `full` must take its own lock.

    `idle`: optional predicate saying the pipeline
    downstream of this window has nothing in flight. When it holds, the
    window closes IMMEDIATELY — a lone request under light load must not
    eat the whole adaptive window when no concurrent work could possibly
    coalesce with it. Under load the predicate is False (a wave/window
    is executing) and the adaptive wait behaves exactly as before: the
    execution time of the in-flight work IS the batching window.
    Callers must set `work` whenever `idle` transitions to True, or a
    request arriving mid-flight waits the full deadline."""
    deadline = time.perf_counter() + window_s
    while not full():
        if idle is not None and idle():
            return
        remain = deadline - time.perf_counter()
        if remain <= 0:
            return
        work.wait(remain)
        work.clear()


class BatchAsk:
    """One ask riding a batch: request in, outcome (reply payload or the
    per-ask exception instance) out.

    `trace` is the submitter's span context (event/tracing.py SpanCtx,
    None when the request is unsampled) snapshotted at submit time —
    that snapshot is what carries causality across the dispatcher
    thread hop and into columnar waves."""

    __slots__ = ("shard", "index", "message", "steps", "max_extra_steps",
                 "slot", "prow", "row", "start", "outcome", "future",
                 "t_submit", "trace", "t_stage", "step_stage", "wave",
                 "was_deferred", "resolve_seq", "dedup_key")

    def __init__(self, shard: int, index: int, message: Any,
                 steps: int = 2, max_extra_steps: int = 8,
                 trace=None):
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
        self.future: Optional[Future] = None
        self.t_submit = 0.0
        self.trace = trace
        self.t_stage = 0.0
        self.step_stage = 0
        # continuous wave scheduling: owning wave handle, the
        # per-wave deferred marker (the engine infers it from `start`,
        # which is a GLOBAL step count under the scheduler), and the
        # global resolve ordinal of an ok outcome — what lets the
        # gateway's replica publishes stay per-entity monotone when wave
        # resolve boundaries complete out of submit order
        self.wave = None
        self.was_deferred = False
        self.resolve_seq = 0
        # idempotent-session dedup key: the gateway's
        # (tenant, request_id) for this member, or None. Rides the ask to
        # the journal commit sites so the wave's group commit records the
        # reply under the same fsync as the events it acknowledges.
        self.dedup_key = None


def _reset_batch_latches(region, slots: Sequence[int]) -> None:
    """Lower `__promise_replied` for the batch's slots before reuse, in one
    indexed write. Slots NOT in the batch (live asks of a previous wave,
    retired timeouts waiting for their late reply) are left as they
    are."""
    col = region.system.state["__promise_replied"]
    base = region._promise_block * region.eps
    idx = np.asarray(list(slots), np.int64) + base
    region.system.set_rows(col, idx, False)


def _assemble_slots(region, batch: Sequence[BatchAsk]) -> List[BatchAsk]:
    """Stage-phase slot assembly (shared by the serialized engine and the
    continuous scheduler): one promise slot per member;
    pool overflow is a typed per-member fast-fail (the admission layer
    sheds on it), not a batch failure. Caller holds `region._ask_lock`.
    Returns the live members, each with slot/prow/row assigned."""
    from ..batched.bridge import AskPoolExhausted, max_exact_row_id

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


def _stage_tell(sys, a: BatchAsk, cum: int) -> bool:
    """Stage ONE ask's tell into the next flush (shared stage phase):
    payload body + reply-to promise row in the last column, `start`
    stamped with the step count the timeout clock runs against. False,
    and nothing staged, when the flush has no host row left in the
    row's shard: the flush would skip the tell and the ask could only
    time out, so both engines keep it for a later round (a port fix;
    the reference stages it and loses it)."""
    payload = np.zeros((sys.payload_width,), np.float32)
    body = np.atleast_1d(
        np.asarray(a.message, np.float32)).reshape(-1)
    payload[:min(len(body), sys.payload_width - 1)] = \
        body[:sys.payload_width - 1]
    payload[-1] = float(a.prow)
    if not sys.try_tell(a.row, payload):
        return False
    a.start = cum
    if a.trace is not None:
        a.t_stage = time.monotonic()
        a.step_stage = int(sys._host_step)
    return True


def execute_ask_batch(region, batch: Sequence[BatchAsk]) -> None:
    """Run a batch of asks through shared step rounds. Caller holds
    `region._ask_lock`. Fills each member's `.outcome` with the reply
    payload (np.ndarray) or an exception instance (AskPoolExhausted /
    ValueError / TimeoutError) — never raises for per-ask conditions, so
    one member's timeout cannot fail its batch-mates."""
    from ..batched.supervision import decode_attention

    region._ensure_promise_rows()
    region._reclaim_promise_slots()  # once per BATCH, not once per ask
    sys = region.system
    eps = region.eps
    base = region._promise_block * eps

    live = _assemble_slots(region, batch)
    if not live:
        return

    # every wave (= one engine invocation, serialized by _ask_lock) gets
    # a monotone wave_id; the same counter is what AskBatcher.stats()
    # surfaces as last_wave_id, so span wave_ids and collector stats can
    # be cross-checked
    region._wave_seq = wave_id = getattr(region, "_wave_seq", 0) + 1
    tracer = getattr(region, "tracer", None)
    wspan = NOOP_SPAN
    if tracer is not None:
        sampled = [a for a in live if a.trace is not None]
        if sampled:
            # ONE wave span regardless of how many sampled members ride
            # it: rooted in the first member's trace, joined to the rest
            # by wave_id + member_traces (the request-tree join key)
            wspan = tracer.begin(
                "ask.wave", sampled[0].trace, parent=0, wave_id=wave_id,
                n_members=len(live), n_sampled=len(sampled),
                member_traces=[a.trace.trace_id for a in sampled])
    cum = 0  # steps run so far in this batch
    rounds = 0
    try:
        # stage/resolve phase attribution: the three
        # coarse children — wave.stage (latch reset + coalesced flush),
        # wave.inflight_wait (the step rounds) and wave.resolve (journal
        # commit) — retro-emitted around the existing fine-grained kids,
        # so the bench artifact shows where a serialized wave's latency
        # actually lives. Quiet path: tracer None or unsampled wave keeps
        # the one-predicate cost (emit on a None ctx is a no-op).
        t_stage0 = time.monotonic() if tracer is not None else 0.0
        with wspan.child("wave.latch_reset", wave_id=wave_id):
            _reset_batch_latches(region, [a.slot for a in live])

        # -- wave scheduling: at most ONE in-flight ask per destination
        # row (see module docstring); each wave's tells coalesce into
        # the next run's single flush
        waiting = list(live)
        in_flight = {}  # row -> BatchAsk
        ok_resolved: List[BatchAsk] = []  # replied members, wave order

        def stage_ready() -> None:
            nonlocal waiting
            rest: List[BatchAsk] = []
            for a in waiting:
                if a.row in in_flight or not _stage_tell(sys, a, cum):
                    rest.append(a)
                    continue
                in_flight[a.row] = a
            waiting = rest

        def resolve_member(a: BatchAsk, outcome: str) -> None:
            # retro-emitted: the member's in-flight window (staged ->
            # resolved), parented under the SUBMITTER's span so the
            # request tree crosses the thread hop intact
            tracer.emit("ask.member", a.trace, t0=a.t_stage,
                        t1=time.monotonic(), step0=a.step_stage,
                        step1=int(sys._host_step), wave_id=wave_id,
                        slot=a.slot, row=a.row, deferred=a.start > 0,
                        outcome=outcome)

        with wspan.child("wave.flush", wave_id=wave_id, coalesced=True,
                         n_staged=len(waiting)):
            stage_ready()
        t_wait0 = time.monotonic() if tracer is not None else 0.0
        if tracer is not None:
            tracer.emit("wave.stage", wspan.ctx, t0=t_stage0, t1=t_wait0,
                        wave_id=wave_id, n_staged=len(in_flight),
                        n_deferred=len(waiting))
        first = True
        rounds = 0
        while in_flight or waiting:
            # shared budget: one `steps`-deep round for the whole wave,
            # then single steps — a batch of one runs the exact schedule
            # the pre-batching ask() ran ([steps] + [1]*max_extra_steps);
            # a round with nothing in flight (the flush was full) frees
            # the host rows for the waiting asks
            n_steps = min((a.steps for a in in_flight.values()),
                          default=1) if first else 1
            first = False
            rounds += 1
            with wspan.child("wave.step_round", wave_id=wave_id,
                             n_steps=n_steps, round=rounds) as rspan:
                sys.run(n_steps)
                rspan.set(host_step=int(sys._host_step))
            cum += n_steps
            # "all replied?" rides the attention word: its small host
            # read doubles as the run's sync, and the wide promise-block
            # readback is paid only when ATT_LATCH_BIT says some latch
            # is actually high
            att = decode_attention(sys.attention_words())
            replied_blk = reply_blk = None
            if att["any_latched"] or not getattr(region, "_ask_latch_wired",
                                                 False):
                with wspan.child("wave.readback", wave_id=wave_id,
                                 round=rounds):
                    replied_blk, reply_blk = sys.read_promise_block(
                        base, eps, "__promise_replied", "__promise_reply")
            done_rows: List[int] = []
            for row, a in in_flight.items():
                if replied_blk is not None and bool(replied_blk[a.slot]):
                    a.outcome = np.asarray(reply_blk[a.slot])
                    ok_resolved.append(a)
                    with region._lock:
                        region._promise_free.append(a.slot)
                    if a.trace is not None and tracer is not None:
                        resolve_member(a, "reply")
                    done_rows.append(row)
                elif cum - a.start >= a.steps + a.max_extra_steps:
                    # timed out: RETIRE the slot (late replies must land
                    # in a row no future ask will read);
                    # _reclaim_promise_slots returns it once the
                    # straggler's latch shows up
                    with region._lock:
                        region._promise_retired.append(a.slot)
                    a.outcome = TimeoutError(
                        f"ask to shard {a.shard} index {a.index} "
                        f"unanswered after "
                        f"{a.steps + a.max_extra_steps} steps")
                    if a.trace is not None and tracer is not None:
                        resolve_member(a, "timeout")
                    done_rows.append(row)
            for row in done_rows:
                del in_flight[row]
            if waiting:  # duplicates, and asks past a full flush
                with wspan.child("wave.flush", wave_id=wave_id,
                                 deferred=True, n_staged=len(waiting)):
                    stage_ready()

        t_res0 = time.monotonic() if tracer is not None else 0.0
        if tracer is not None:
            tracer.emit("wave.inflight_wait", wspan.ctx, t0=t_wait0,
                        t1=t_res0, wave_id=wave_id, rounds=rounds)

        # durable entity layer: ONE group-committed journal
        # write for the whole wave's ok events, BEFORE outcomes reach the
        # callers — an acked write is on disk by the time the ack exists.
        # Regions without attach_entity_journal pay one attribute read.
        if ok_resolved and \
                getattr(region, "_entity_journal", None) is not None:
            with wspan.child("wave.journal", wave_id=wave_id,
                             n_events=len(ok_resolved)):
                region._commit_entity_events(
                    [(a.shard, a.index, a.message, a.dedup_key, a.outcome)
                     for a in ok_resolved])
        if tracer is not None:
            tracer.emit("wave.resolve", wspan.ctx, t0=t_res0,
                        t1=time.monotonic(), wave_id=wave_id,
                        n_ok=len(ok_resolved))
    finally:
        wspan.finish(rounds=rounds, steps=cum)


class _WaveHandle:
    """One wave open on the continuous scheduler: completion latch,
    resolve-boundary callback, wave span, and the members' resolve
    bookkeeping. `done` is set strictly AFTER the wave's journal group
    commit and after every member future holds its outcome."""

    __slots__ = ("batch", "remaining", "ok", "done", "on_resolve",
                 "wspan", "wave_id", "t_stage1")

    def __init__(self, batch: List[BatchAsk]):
        self.batch = batch
        self.remaining = 0
        self.ok: List[BatchAsk] = []  # replied members, resolve order
        self.done = threading.Event()
        self.on_resolve: Optional[Callable[["_WaveHandle"], None]] = None
        self.wspan = NOOP_SPAN
        self.wave_id = 0
        self.t_stage1 = 0.0

    def outcomes(self) -> List[Any]:
        return [a.outcome for a in self.batch]


class ContinuousWaveScheduler:
    """Continuous wave formation: overlap wave N+1's
    staging with wave N's device rounds.

    The serialized engine holds `region._ask_lock` for a whole
    stage→step→poll round, so concurrent waves pay their device rounds
    back to back. This scheduler splits the engine at its stage/resolve
    seam:

    - `submit_wave` holds the lock only for the STAGING INSTANT (slot
      assembly, latch reset, coalesced tell flush) and returns a handle
      immediately — the submitting thread is free to decode and
      admission-charge the next window while the device runs.
    - ONE runner thread drives shared single-step rounds for ALL open
      waves, keeping rounds dispatched ahead of the one it waits on
      (the enqueue-ahead deque of attention-word host copies, each with
      the CUDA event of its round; waiting on the oldest event is that
      round's sync) and paying the wide promise-block readback only
      when the packed attention word says some latch is actually high.
    - members of EVERY open wave resolve off the same readback as their
      latches land; a wave's resolve boundary (journal group commit →
      member futures → `on_resolve`) fires when its LAST member
      retires, preserving the commit-before-ack ordering per wave.

    Cross-wave scheduling rule: the dense-inbox reduce still SUMS
    payloads, so the one-in-flight-ask-per-destination-row rule extends
    across waves — `_row_owner` maps each destination row to its single
    in-flight ask and `_deferred` holds the row's FIFO of late joiners
    (from the SAME wave or any later one), staged into the next step
    round the moment the row frees. Per-entity linearization is
    therefore submit order, exactly as under the serialized engine.
    A round's flush holds `host_inbox` tells a system shard and skips
    the rest, so an ask that finds its shard's host rows full defers
    the same way (a port fix: the reference stages it, the flush skips
    its tell, and the ask times out).

    Locking: every piece of scheduler wave state (_row_owner, _deferred,
    _waves, _cum, _resolve_seq) is mutated only under `region._ask_lock`
    — the same lock checkpoint/rebalance/failover/sum already take, so
    maintenance ops interleave between rounds instead of between waves.
    `self._lock` guards only the overlap statistics.

    A region over a mesh of ranks is refused (NotImplementedError naming
    ROADMAP A10.3): its rounds follow wall-clock arrivals, which the
    ranks of an SPMD program do not share; such a region serves through
    the serialized engine (`ask_many`)."""

    def __init__(self, region, depth: int = 4):
        if region.system.mesh.group is not None:
            raise NotImplementedError(
                "the continuous wave scheduler over a region of ranks: "
                "its rounds follow wall-clock arrivals, which ranks do not "
                "share (ROADMAP A10.3); use the serialized engine")
        self.region = region
        self.depth = max(1, int(depth))
        # attention rounds kept in flight ahead of the drain: 2 lets
        # round k+1 dispatch while round k syncs; deeper only delays
        # resolution within the timeout budget
        self._ahead = min(self.depth, 2)
        self._lock = threading.Lock()
        self._work = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self._waves: List[_WaveHandle] = []      # open waves, submit order
        self._row_owner: Dict[int, BatchAsk] = {}
        self._deferred: List[BatchAsk] = []      # submit-order FIFO
        self._deferred_rows: Dict[int, int] = {}  # row -> queued count
        self._cum = 0          # global steps this scheduler has run
        self._att_q: deque = deque()  # (cum_at_dispatch, attention handle)
        self._resolve_seq = 0
        # overlap accounting (satellite: overlap_ratio in ask_batch stats)
        self._open = 0
        self._t_mark: Optional[float] = None
        self._busy_s = 0.0
        self._overlap_s = 0.0
        self._waves_done = 0
        # idle-wakeup accounting: the runner backs
        # off exponentially while idle instead of spinning at a fixed
        # 0.25 s poll — these count the empty wakeups that remain
        self._idle_wakeups = 0
        self._t_loop0: Optional[float] = None
        # idle-transition hook (wait_adaptive_close fast-close): callers
        # park on their own events; the scheduler pokes this when the
        # last open wave resolves
        self.on_idle: Optional[Callable[[], Any]] = None

    # -------------------------------------------------------------- submit
    def submit_wave(self, batch: Sequence[BatchAsk],
                    on_resolve=None) -> _WaveHandle:
        """Stage one wave and return immediately. The lock is held for
        the staging instant only; rounds run on the scheduler thread.
        Per-member typed failures (pool exhaustion, unrepresentable
        rows) land in `.outcome` at submit, never raise. A wave with no
        live members completes synchronously on the submitting thread
        (journal n/a — nothing resolved ok)."""
        region = self.region
        with self._lock:
            if self._closed:
                raise RuntimeError("ContinuousWaveScheduler is closed")
        h = _WaveHandle(list(batch))
        h.on_resolve = on_resolve
        tracer = getattr(region, "tracer", None)
        with region._ask_lock:
            region._ensure_promise_rows()
            region._reclaim_promise_slots()
            sys = region.system
            try:
                live = _assemble_slots(region, h.batch)
            except BaseException as e:  # noqa: BLE001 — never half-resolve
                for a in h.batch:
                    if a.outcome is None:
                        a.outcome = e
                live = []
            h.remaining = len(live)
            region._wave_seq = wave_id = \
                getattr(region, "_wave_seq", 0) + 1
            h.wave_id = wave_id
            if tracer is not None:
                sampled = [a for a in live if a.trace is not None]
                if sampled:
                    h.wspan = tracer.begin(
                        "ask.wave", sampled[0].trace, parent=0,
                        wave_id=wave_id, n_members=len(live),
                        n_sampled=len(sampled), continuous=True,
                        member_traces=[a.trace.trace_id for a in sampled])
            t_stage0 = time.monotonic() if tracer is not None else 0.0
            staged = 0
            if live:
                with h.wspan.child("wave.latch_reset", wave_id=wave_id):
                    _reset_batch_latches(region, [a.slot for a in live])
                for a in live:
                    a.wave = h
                    # a row already in flight OR with older deferred
                    # waiters queues behind them — cross-wave FIFO per
                    # destination row, never a queue jump; so does an
                    # ask whose shard's host rows the next flush has
                    # filled (_stage_tell stages nothing then)
                    if a.row in self._row_owner \
                            or self._deferred_rows.get(a.row) \
                            or not _stage_tell(sys, a, self._cum):
                        a.was_deferred = True
                        self._deferred.append(a)
                        self._deferred_rows[a.row] = \
                            self._deferred_rows.get(a.row, 0) + 1
                    else:
                        self._row_owner[a.row] = a
                        staged += 1
            h.t_stage1 = time.monotonic() if tracer is not None else 0.0
            if tracer is not None:
                tracer.emit("wave.stage", h.wspan.ctx, t0=t_stage0,
                            t1=h.t_stage1, wave_id=wave_id,
                            n_staged=staged,
                            n_deferred=h.remaining - staged)
            if h.remaining:
                self._waves.append(h)
                self._mark_open(+1)
        if not h.remaining:
            self._complete(h)
            return h
        with self._lock:
            if self._thread is None:
                t = threading.Thread(target=self._loop, daemon=True,
                                     name="akka-tpu-wave-scheduler")
                self._thread = t
                t.start()
        self._work.set()
        return h

    # -------------------------------------------------------------- runner
    def _loop(self) -> None:
        # exponential idle backoff: park 1 ms after
        # work, doubling to 250 ms while nothing arrives; `_work.set()`
        # interrupts the wait instantly, so the re-arm to tight polling
        # costs zero latency when work shows up
        idle_wait = IDLE_WAIT_MIN
        with self._lock:
            if self._t_loop0 is None:
                self._t_loop0 = time.monotonic()
        while True:
            fired = self._work.wait(idle_wait)
            self._work.clear()
            if fired:
                idle_wait = IDLE_WAIT_MIN
            else:
                idle_wait = min(idle_wait * 2.0, IDLE_WAIT_MAX)
                with self._lock:
                    self._idle_wakeups += 1
            while True:
                region = self.region
                with region._ask_lock:
                    if not self._row_owner and not self._deferred:
                        # nothing in flight: stale pre-stage attention
                        # snapshots resolve nobody — drop them
                        self._att_q.clear()
                        break
                    sys = region.system
                    self._stage_deferred_locked(sys)
                    # the serialized engine's step schedule, continuous
                    # form: when every in-flight ask still needs k > 1
                    # steps before its reply can latch (fresh stages with
                    # steps=2), run all k in ONE dispatch — same device
                    # work, half the dispatch+sync round trips; any ask
                    # whose reply could land now pins the round to 1 so
                    # resolution is never delayed
                    n_steps = 1
                    if self._row_owner:
                        n_steps = max(1, min(
                            a.steps - (self._cum - a.start)
                            for a in self._row_owner.values()))
                    sys.run(n_steps)
                    self._cum += n_steps
                    # the enqueue-ahead deque: this round's attention
                    # word, its host copy started behind the round
                    self._att_q.append(
                        (self._cum, *snapshot_word(sys.attention)))
                    # latency policy: once some in-flight ask has
                    # run its full step budget, its reply may already be
                    # latched — resolution beats enqueue-ahead, so drain
                    # the whole deque; only fresh stages (no latchable
                    # reply yet) keep `_ahead` rounds enqueued
                    reply_due = any(
                        self._cum - a.start >= a.steps
                        for a in self._row_owner.values())
                ahead = 1 if reply_due else self._ahead
                while len(self._att_q) >= ahead:
                    self._drain_one()
            with self._lock:
                if self._closed:
                    return

    def _stage_deferred_locked(self, sys) -> None:
        """Admit late joiners into the NEXT step round of the open
        schedule: deferred asks whose destination row has freed, and
        whose shard has host rows left in this round's flush, stage now
        (coalescing into this round's single flush), in submit order —
        the first waiter per row wins, later ones keep waiting."""
        if not self._deferred:
            return
        rest: List[BatchAsk] = []
        for a in self._deferred:
            if a.row in self._row_owner \
                    or not _stage_tell(sys, a, self._cum):
                rest.append(a)
                continue
            self._row_owner[a.row] = a
            n = self._deferred_rows.get(a.row, 1) - 1
            if n:
                self._deferred_rows[a.row] = n
            else:
                self._deferred_rows.pop(a.row, None)
        self._deferred = rest

    def _drain_one(self) -> None:
        """Retire the oldest in-flight round: waiting on its attention
        copy's event is that round's sync (the rounds dispatched after it
        keep running); the wide promise-block readback is paid only when
        the packed latch
        bit says some reply actually landed. Resolves members of ALL
        open waves, then fires any completed wave's resolve boundary."""
        from ..batched.supervision import decode_attention

        cum_at, att_host, copied = self._att_q.popleft()
        if copied is not None:
            copied.synchronize()  # this round only, not the ones after it
        att = decode_attention(att_host)
        region = self.region
        finished: List[_WaveHandle] = []
        with region._ask_lock:
            sys = region.system
            eps = region.eps
            base = region._promise_block * eps
            replied_blk = reply_blk = None
            if att["any_latched"] or not getattr(region,
                                                 "_ask_latch_wired", False):
                replied_blk, reply_blk = sys.read_promise_block(
                    base, eps, "__promise_replied", "__promise_reply")
            tracer = getattr(region, "tracer", None)
            done_rows: List[int] = []
            for row, a in self._row_owner.items():
                h = a.wave
                if replied_blk is not None and bool(replied_blk[a.slot]):
                    a.outcome = np.asarray(reply_blk[a.slot])
                    self._resolve_seq += 1
                    a.resolve_seq = self._resolve_seq
                    h.ok.append(a)
                    with region._lock:
                        region._promise_free.append(a.slot)
                    if a.trace is not None and tracer is not None:
                        tracer.emit(
                            "ask.member", a.trace, t0=a.t_stage,
                            t1=time.monotonic(), step0=a.step_stage,
                            step1=int(sys._host_step), wave_id=h.wave_id,
                            slot=a.slot, row=row, deferred=a.was_deferred,
                            outcome="reply")
                elif cum_at - a.start >= a.steps + a.max_extra_steps:
                    # timed out: RETIRE the slot (the late reply must
                    # land in a row no future ask will read); reclaimed
                    # once the straggler's latch shows up — exactly the
                    # serialized engine's semantics, counted against the
                    # steps that had run when THIS round was dispatched
                    with region._lock:
                        region._promise_retired.append(a.slot)
                    a.outcome = TimeoutError(
                        f"ask to shard {a.shard} index {a.index} "
                        f"unanswered after "
                        f"{a.steps + a.max_extra_steps} steps")
                    if a.trace is not None and tracer is not None:
                        tracer.emit(
                            "ask.member", a.trace, t0=a.t_stage,
                            t1=time.monotonic(), step0=a.step_stage,
                            step1=int(sys._host_step), wave_id=h.wave_id,
                            slot=a.slot, row=row, deferred=a.was_deferred,
                            outcome="timeout")
                else:
                    continue
                done_rows.append(row)
                h.remaining -= 1
            for row in done_rows:
                del self._row_owner[row]
            for h in [w for w in self._waves if w.remaining == 0]:
                self._waves.remove(h)
                self._mark_open(-1)
                # per-wave resolve boundary, part 1 (under the lock):
                # the group commit — one fsync'd record for the
                # wave's ok events BEFORE any outcome reaches a caller
                if h.ok and getattr(region, "_entity_journal",
                                    None) is not None:
                    with h.wspan.child("wave.journal", wave_id=h.wave_id,
                                       n_events=len(h.ok)):
                        region._commit_entity_events(
                            [(a.shard, a.index, a.message, a.dedup_key,
                              a.outcome) for a in h.ok])
                finished.append(h)
        for h in finished:
            self._complete(h)

    def _complete(self, h: _WaveHandle) -> None:
        """Resolve boundary, part 2 (outside the lock): member futures,
        the `on_resolve` callback (the gateway's reply encode / replica
        publish / SLO round ride here), the completion latch, and the
        wave span's stage-attribution children."""
        region = self.region
        tracer = getattr(region, "tracer", None)
        t_res0 = time.monotonic()
        if tracer is not None and h.wspan is not NOOP_SPAN:
            tracer.emit("wave.inflight_wait", h.wspan.ctx, t0=h.t_stage1,
                        t1=t_res0, wave_id=h.wave_id)
        for a in h.batch:
            if a.future is not None and not a.future.done():
                if isinstance(a.outcome, BaseException):
                    a.future.set_exception(a.outcome)
                else:
                    a.future.set_result(a.outcome)
        if h.on_resolve is not None:
            try:
                h.on_resolve(h)
            except Exception:  # noqa: BLE001 — the runner must survive
                pass           # a resolve callback's failure
        h.done.set()
        with self._lock:
            self._waves_done += 1
        if tracer is not None and h.wspan is not NOOP_SPAN:
            tracer.emit("wave.resolve", h.wspan.ctx, t0=t_res0,
                        t1=time.monotonic(), wave_id=h.wave_id,
                        n_ok=len(h.ok))
        h.wspan.finish(n_ok=len(h.ok))
        if self.idle():
            cb = self.on_idle
            if cb is not None:
                cb()

    # --------------------------------------------------------------- state
    def idle(self) -> bool:
        """True when no wave is open (racy read — a timing hint for the
        adaptive window close, not a synchronization primitive)."""
        return not self._row_owner and not self._deferred \
            and not self._waves

    def quiesce(self, timeout: float = 30.0) -> bool:
        """Block until every open wave has resolved (conserved-value
        probes read device state directly — they must not observe a
        half-applied wave). Returns False on timeout."""
        deadline = time.monotonic() + timeout
        while not self.idle():
            if time.monotonic() >= deadline:
                return False
            time.sleep(1e-3)
        return True

    def _mark_open(self, delta: int) -> None:
        now = time.monotonic()
        with self._lock:
            if self._t_mark is not None:
                span = now - self._t_mark
                if self._open >= 1:
                    self._busy_s += span
                if self._open >= 2:
                    self._overlap_s += span
            self._t_mark = now
            self._open += delta

    def stats(self) -> Dict[str, float]:
        """Overlap evidence for the ask_batch collector: overlap_ratio
        is the fraction of wave-busy wall time during which two or more
        waves were open — 0.0 means the pipeline degenerated to the
        serialized one-wave-at-a-time schedule."""
        with self._lock:
            busy, over = self._busy_s, self._overlap_s
            up = (time.monotonic() - self._t_loop0) \
                if self._t_loop0 is not None else 0.0
            return {"open_waves": float(self._open),
                    "waves_resolved": float(self._waves_done),
                    "busy_s": busy, "overlap_s": over,
                    "overlap_ratio": (over / busy) if busy > 0 else 0.0,
                    "idle_wakeups": float(self._idle_wakeups),
                    "idle_wakeups_per_s":
                        (self._idle_wakeups / up) if up > 0 else 0.0}

    def open_wave_depth(self) -> float:
        """Open waves over pipeline depth, 0..1+:
        the pressure form of the promise-pool headroom — 1.0 means the
        wave pipeline is full and the next window will block on a slot,
        so admission should start shedding BEFORE the pool drains."""
        with self._lock:
            return self._open / self.depth

    # ----------------------------------------------------------- lifecycle
    def close(self, timeout: float = 10.0) -> None:
        """Drain: open waves resolve (their members reply or time out —
        the step budget bounds the wait) before the runner exits; any
        member still unresolved after `timeout` gets a typed RuntimeError
        so no caller hangs on a dead scheduler."""
        with self._lock:
            self._closed = True
            t = self._thread
        self._work.set()
        if t is not None:
            t.join(timeout)
        with self.region._ask_lock:
            leftovers, self._waves = self._waves, []
            self._row_owner.clear()
            self._deferred = []
            self._deferred_rows.clear()
            # commit-before-ack holds even for a force-drained wave: its
            # already-resolved members' events hit the journal before
            # their outcomes reach any caller below
            for h in leftovers:
                if h.ok and getattr(self.region, "_entity_journal",
                                    None) is not None:
                    self.region._commit_entity_events(
                        [(a.shard, a.index, a.message, a.dedup_key,
                          a.outcome) for a in h.ok])
        for h in leftovers:
            for a in h.batch:
                if a.outcome is None:
                    a.outcome = RuntimeError(
                        "ContinuousWaveScheduler is closed")
            h.remaining = 0
            self._complete(h)


class AskBatcher:
    """Thread-safe futures front end over `execute_ask_batch`.

    `submit()` appends to the pending list and returns a Future; a
    daemon dispatcher thread (started on first submit, the bridge pump
    idiom) closes a batch when `max_batch` asks are pending or
    `window_s` has elapsed since it saw the first one — whichever first
    — and runs it under the region's ask lock. Callers never become
    batch leaders, so no connection handler gets stuck dispatching other
    tenants' traffic under sustained load.

    With a MetricsRegistry: `gateway_ask_batch_size` and
    `gateway_ask_batch_window_us` histograms, plus an "ask_batch"
    collector exposing the summary counters.

    A region over a mesh of ranks is refused (NotImplementedError naming
    ROADMAP A10.3), as by ContinuousWaveScheduler: batches close on
    wall-clock windows, which the ranks of an SPMD program do not share,
    so two ranks could form different waves and their collectives would
    not match; such a region serves through `ask_many`."""

    def __init__(self, region, max_batch: int = 32,
                 window_s: float = 200e-6, steps: int = 2,
                 max_extra_steps: int = 8, registry=None,
                 continuous: bool = False, pipeline_depth: int = 4):
        if region.system.mesh.group is not None:
            raise NotImplementedError(
                "the ask batcher over a region of ranks: its batches close "
                "on wall-clock windows, which ranks do not share (ROADMAP "
                "A10.3); use the serialized engine")
        self.region = region
        # a batch larger than the promise pool would guarantee typed
        # exhaustion for the overflow members; cap it at the pool size
        pool = int(getattr(region, "eps", max_batch))
        self.max_batch = max(1, min(int(max_batch), pool))
        self.window_s = float(window_s)
        self.steps = int(steps)
        self.max_extra_steps = int(max_extra_steps)
        self._lock = threading.Lock()
        self._work = threading.Event()
        # continuous wave formation: waves go through the
        # scheduler instead of running the engine inline, so up to
        # `pipeline_depth` waves overlap on the bridge. continuous=False
        # keeps the serialized engine path byte-for-byte (the A/B escape
        # hatch the acceptance criteria pin).
        self.continuous = bool(continuous)
        self.pipeline_depth = max(1, int(pipeline_depth))
        self._sched: Optional[ContinuousWaveScheduler] = None
        if self.continuous:
            self._sched = ContinuousWaveScheduler(
                region, depth=self.pipeline_depth)
            self._sched.on_idle = self._work.set
        self._inflight_sem = threading.BoundedSemaphore(self.pipeline_depth)
        self._executing = 0  # serialized engine calls in flight (idle hint)
        self._pending: List[BatchAsk] = []
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self._batches = 0
        self._asks = 0
        self._multi = 0
        self._max_seen = 0
        self._idle_wakeups = 0
        self._t_loop0: Optional[float] = None
        self._h_size = self._h_wait = None
        if registry is not None:
            self._h_size = registry.histogram(
                "gateway_ask_batch_size",
                "asks coalesced per shared device step round")
            self._h_wait = registry.histogram(
                "gateway_ask_batch_window_us",
                "microseconds an ask waited for its batch to close")
            registry.register_collector("ask_batch", self.stats)

    # ------------------------------------------------------------- submit
    def submit(self, shard: int, index: int, message: Any,
               steps: Optional[int] = None,
               max_extra_steps: Optional[int] = None,
               dedup_key=None) -> Future:
        a = BatchAsk(int(shard), int(index), message,
                     self.steps if steps is None else int(steps),
                     self.max_extra_steps if max_extra_steps is None
                     else int(max_extra_steps),
                     # the submitter's span ctx crosses the dispatcher
                     # thread hop pinned to the ask itself (None when the
                     # request is unsampled — the one read the quiet path
                     # pays)
                     trace=current_ctx())
        a.dedup_key = dedup_key
        a.future = Future()
        a.t_submit = time.perf_counter()
        with self._lock:
            if self._closed:
                raise RuntimeError("AskBatcher is closed")
            self._pending.append(a)
            if self._thread is None:
                t = threading.Thread(target=self._loop,
                                     name="akka-tpu-ask-batcher",
                                     daemon=True)
                self._thread = t
                t.start()
        self._work.set()
        return a.future

    def ask(self, shard: int, index: int, message: Any,
            steps: Optional[int] = None,
            max_extra_steps: Optional[int] = None,
            dedup_key=None):
        """Submit and wait: returns the reply payload or raises the
        per-ask exception (TimeoutError / AskPoolExhausted / ...)."""
        return self.submit(shard, index, message, steps,
                           max_extra_steps, dedup_key=dedup_key).result()

    def ask_many(self, requests: Sequence[Any],
                 ctxs: Optional[Sequence[Any]] = None,
                 with_seqs: bool = False,
                 keys: Optional[Sequence[Any]] = None):
        """Columnar wave entry: `requests` is a sequence of
        `(shard, index, message)` decoded from one binary window.
        Returns outcomes aligned with `requests` — the reply payload or
        the per-ask exception INSTANCE (never raises per-ask).

        `ctxs`: optional aligned per-member span contexts —
        one binary window carries MANY traces, so the ambient contextvar
        cannot represent it; the gateway passes each sampled record's
        root ctx explicitly.

        A multi-request wave IS already a batch, so it skips the
        per-call future hop and the dispatcher window entirely: the
        caller's thread runs `execute_ask_batch` directly under the
        region's ask lock (serialized with dispatcher batches by that
        same lock — wave linearization per entity is unchanged). A
        wave of one submits through the dispatcher as usual so it can
        coalesce with concurrent single asks.

        Continuous mode: the wave is STAGED on the scheduler
        and this thread blocks only on its own wave's resolve boundary —
        other threads' waves overlap it on the bridge instead of queuing
        behind `_ask_lock`. `with_seqs=True` additionally returns the
        per-member resolve ordinals (aligned, 0 for failures) the
        gateway uses to keep replica publishes per-entity monotone when
        resolve boundaries complete out of submit order; in serialized
        mode the seqs are None — waves resolve in submit order there, so
        publish order needs no filter.

        `keys`: optional aligned dedup keys — the gateway's
        (tenant, request_id) per member, pinned to the BatchAsk so the
        journal commit sites can record the reply with the wave."""
        reqs = list(requests)
        if not reqs:
            return ([], None) if with_seqs else []
        if self._sched is not None:
            batch = [BatchAsk(int(s), int(i), m, self.steps,
                              self.max_extra_steps) for s, i, m in reqs]
            if ctxs is not None:
                for a, c in zip(batch, ctxs):
                    a.trace = c
            if keys is not None:
                for a, k in zip(batch, keys):
                    a.dedup_key = k
            if len(batch) == 1:
                # a wave of one rides the dispatcher window exactly as
                # in serialized mode, so concurrent solo asks coalesce
                # into SHARED waves — without this, 64 solo callers
                # would stage 64 one-member waves and pay the per-wave
                # overhead 64 times instead of once
                a = batch[0]
                a.future = Future()
                a.t_submit = time.perf_counter()
                with self._lock:
                    if self._closed:
                        raise RuntimeError("AskBatcher is closed")
                    self._pending.append(a)
                    if self._thread is None:
                        t = threading.Thread(
                            target=self._loop, name="akka-tpu-ask-batcher",
                            daemon=True)
                        self._thread = t
                        t.start()
                self._work.set()
                try:
                    a.future.result(60.0)
                except BaseException:  # noqa: BLE001 — outcome convention
                    pass
                outcomes = [a.outcome]
                if with_seqs:
                    return outcomes, [a.resolve_seq]
                return outcomes
            with self._lock:
                if self._closed:
                    raise RuntimeError("AskBatcher is closed")
            handles = [self._submit_wave(batch[lo:lo + self.max_batch])
                       for lo in range(0, len(batch), self.max_batch)]
            for h in handles:
                h.done.wait(60.0)
            outcomes = [a.outcome for a in batch]
            if with_seqs:
                return outcomes, [a.resolve_seq for a in batch]
            return outcomes
        if len(reqs) == 1:
            s, i, m = reqs[0]
            tok = None
            if ctxs is not None and ctxs[0] is not None:
                tok = set_ctx(ctxs[0])  # submit() snapshots it per ask
            try:
                out = [self.ask(s, i, m, dedup_key=keys[0]
                                if keys is not None else None)]
            except BaseException as e:  # noqa: BLE001 — outcome convention
                out = [e]
            finally:
                if tok is not None:
                    reset_ctx(tok)
            return (out, None) if with_seqs else out
        with self._lock:
            if self._closed:
                raise RuntimeError("AskBatcher is closed")
        batch = [BatchAsk(int(s), int(i), m, self.steps,
                          self.max_extra_steps) for s, i, m in reqs]
        if ctxs is not None:
            for a, c in zip(batch, ctxs):
                a.trace = c
        if keys is not None:
            for a, k in zip(batch, keys):
                a.dedup_key = k
        region = self.region
        t0 = time.perf_counter()
        # waves larger than the promise pool ride consecutive sub-batches
        # (the submit path's max_batch cap, applied here without futures)
        for lo in range(0, len(batch), self.max_batch):
            sub = batch[lo:lo + self.max_batch]
            with self._lock:
                self._executing += 1
            try:
                with region._ask_lock:
                    execute_ask_batch(region, sub)
            except BaseException as e:  # noqa: BLE001 — never half-resolve
                for a in sub:
                    if a.outcome is None:
                        a.outcome = e
            finally:
                with self._lock:
                    self._executing -= 1
                    if self._executing == 0:
                        # idle transition: wake the dispatcher so a solo
                        # submit that arrived mid-wave closes now instead
                        # of eating the rest of its adaptive window
                        self._work.set()
            with self._lock:
                self._batches += 1
                self._asks += len(sub)
                self._max_seen = max(self._max_seen, len(sub))
                if len(sub) > 1:
                    self._multi += 1
            if self._h_size is not None:
                self._h_size.observe(float(len(sub)))
            if self._h_wait is not None:
                # columnar waves never wait for a window to close: the
                # whole wave arrived at once, so its wait is dispatch lag
                self._h_wait.observe((time.perf_counter() - t0) * 1e6)
        outcomes = [a.outcome for a in batch]
        return (outcomes, None) if with_seqs else outcomes

    def ask_many_async(self, requests: Sequence[Any],
                       ctxs: Optional[Sequence[Any]] = None,
                       on_done: Optional[Callable[
                           [List[Any], List[int]], Any]] = None,
                       keys: Optional[Sequence[Any]] = None) -> None:
        """Continuous-mode async wave entry: stage the wave
        NOW on the calling thread (preserving per-connection submit
        order — staging order IS the linearization order) and return
        immediately; `on_done(outcomes, seqs)` fires on the scheduler
        thread at the LAST chunk's resolve boundary, with both lists
        aligned to `requests` (seqs are the global resolve ordinals, 0
        for failed members). This is what lets the gateway resolve
        window N while the aggregator decodes and admission-charges
        window N+1."""
        if self._sched is None:
            raise RuntimeError("ask_many_async requires continuous=True")
        with self._lock:
            if self._closed:
                raise RuntimeError("AskBatcher is closed")
        reqs = list(requests)
        batch = [BatchAsk(int(s), int(i), m, self.steps,
                          self.max_extra_steps) for s, i, m in reqs]
        if ctxs is not None:
            for a, c in zip(batch, ctxs):
                a.trace = c
        if keys is not None:
            for a, k in zip(batch, keys):
                a.dedup_key = k
        if not batch:
            if on_done is not None:
                on_done([], [])
            return
        chunks = [batch[lo:lo + self.max_batch]
                  for lo in range(0, len(batch), self.max_batch)]
        state = {"left": len(chunks)}
        state_lock = threading.Lock()

        def _chunk_done(_h) -> None:
            with state_lock:
                state["left"] -= 1
                last = state["left"] == 0
            if last and on_done is not None:
                on_done([a.outcome for a in batch],
                        [a.resolve_seq for a in batch])

        for c in chunks:
            self._submit_wave(c, on_resolve=_chunk_done)

    def _submit_wave(self, sub: List[BatchAsk], on_resolve=None):
        """Stage one wave on the continuous scheduler with the batcher's
        stats/histograms recorded at ITS resolve boundary (the engine
        paths record after their synchronous run; here the wave is still
        in flight when submit returns)."""
        t0 = time.perf_counter()

        def _done(h) -> None:
            with self._lock:
                self._batches += 1
                self._asks += len(sub)
                self._max_seen = max(self._max_seen, len(sub))
                if len(sub) > 1:
                    self._multi += 1
            if self._h_size is not None:
                self._h_size.observe(float(len(sub)))
            if self._h_wait is not None:
                self._h_wait.observe((time.perf_counter() - t0) * 1e6)
            if on_resolve is not None:
                on_resolve(h)

        return self._sched.submit_wave(sub, on_resolve=_done)

    # ---------------------------------------------------------- dispatcher
    def _full(self) -> bool:
        with self._lock:
            return len(self._pending) >= self.max_batch

    def idle(self) -> bool:
        """Downstream idleness: nothing is executing below the window.
        Public because the ingest aggregator folds it into ITS
        window-close predicate."""
        if self._sched is not None:
            return self._sched.idle()
        with self._lock:
            return self._executing == 0

    def open_wave_depth(self) -> float:
        """Pressure form of wave-pipeline fullness, 0..1+: continuous
        mode reports the scheduler's open waves
        over `pipeline_depth`; the serialized engine reports in-flight
        engine calls over the same depth (0 or 1/depth — it can never
        pipeline)."""
        if self._sched is not None:
            return self._sched.open_wave_depth()
        with self._lock:
            return self._executing / self.pipeline_depth

    def _solo_idle(self) -> bool:
        """The solo-latency fast-close predicate:
        exactly ONE ask is pending AND nothing is executing downstream,
        so nothing could possibly coalesce with it — close immediately.
        Two or more pending asks ARE concurrency (and downstream
        idleness flickers true between waves), so under load the
        adaptive wait behaves exactly as before."""
        with self._lock:
            if len(self._pending) > 1:
                return False
        return self.idle()

    def _loop(self) -> None:
        idle_wait = IDLE_WAIT_MIN  # exponential idle backoff
        with self._lock:
            if self._t_loop0 is None:
                self._t_loop0 = time.monotonic()
        while True:
            fired = self._work.wait(idle_wait)
            self._work.clear()
            if fired:
                idle_wait = IDLE_WAIT_MIN
            else:
                idle_wait = min(idle_wait * 2.0, IDLE_WAIT_MAX)
                with self._lock:
                    self._idle_wakeups += 1
            if self._closed:
                self._fail_pending(RuntimeError("AskBatcher is closed"))
                return
            while True:
                with self._lock:
                    if not self._pending:
                        break
                # adaptive window: wait for the batch to fill, close on
                # max_batch pending, window_s elapsed, or the pipeline
                # going idle (solo fast-close) — whichever first
                wait_adaptive_close(self._work, self.window_s, self._full,
                                    idle=self._solo_idle)
                if self._sched is not None:
                    # wave-slot admission BEFORE the window closes: while
                    # this thread waits for one of the `pipeline_depth`
                    # in-flight waves to free a slot, late arrivals keep
                    # joining the still-open window instead of eating a
                    # whole extra wave cycle — the window closes as late
                    # as the pipeline allows
                    while not self._inflight_sem.acquire(timeout=0.25):
                        with self._lock:
                            closed = self._closed
                        if closed:
                            self._fail_pending(
                                RuntimeError("AskBatcher is closed"))
                            return
                with self._lock:
                    close_batch = self._pending[:self.max_batch]
                    del self._pending[:self.max_batch]
                if close_batch:
                    self._run_batch(close_batch)
                elif self._sched is not None:
                    self._inflight_sem.release()

    def _run_batch(self, close_batch: List[BatchAsk]) -> None:
        t_close = time.perf_counter()
        if self._h_wait is not None:
            for a in close_batch:
                self._h_wait.observe((t_close - a.t_submit) * 1e6)
        if self._sched is not None:
            # continuous: stage and move on — the dispatcher is free to
            # close the NEXT window while this wave's rounds run. The
            # scheduler sets the futures at the resolve boundary; the
            # wave slot (pipeline_depth semaphore) was acquired by the
            # dispatcher loop BEFORE the window closed, so a submit
            # storm cannot outrun the promise pool unboundedly.

            def _release(_h) -> None:
                self._inflight_sem.release()

            try:
                self._submit_wave(close_batch, on_resolve=_release)
            except BaseException as e:  # noqa: BLE001 — never hang waiters
                self._inflight_sem.release()
                for a in close_batch:
                    if a.future is not None and not a.future.done():
                        a.future.set_exception(e)
            return
        region = self.region
        with self._lock:
            self._executing += 1
        try:
            with region._ask_lock:
                execute_ask_batch(region, close_batch)
        except BaseException as e:  # noqa: BLE001 — waiters must never hang
            for a in close_batch:
                if a.outcome is None:
                    a.outcome = e
        finally:
            with self._lock:
                self._executing -= 1
                if self._executing == 0:
                    self._work.set()
        with self._lock:
            self._batches += 1
            self._asks += len(close_batch)
            self._max_seen = max(self._max_seen, len(close_batch))
            if len(close_batch) > 1:
                self._multi += 1
        if self._h_size is not None:
            self._h_size.observe(float(len(close_batch)))
        for a in close_batch:
            if isinstance(a.outcome, BaseException):
                a.future.set_exception(a.outcome)
            else:
                a.future.set_result(a.outcome)

    # ------------------------------------------------------------ lifecycle
    def _fail_pending(self, exc: BaseException) -> None:
        with self._lock:
            pending, self._pending = self._pending, []
        for a in pending:
            if a.future is not None and not a.future.done():
                a.future.set_exception(exc)

    def quiesce(self, timeout: float = 30.0) -> bool:
        """Block until no wave is in flight (continuous mode; serialized
        engine calls are synchronous, so there is nothing to wait on).
        Consistency reads (`sum_all`, conserved-value probes) call this
        so they never observe a half-resolved wave's device state as
        final."""
        if self._sched is not None:
            return self._sched.quiesce(timeout)
        return True

    def close(self, timeout: float = 10.0) -> None:
        with self._lock:
            self._closed = True
            t = self._thread
        self._work.set()
        if t is not None:
            t.join(timeout)
        if self._sched is not None:
            self._sched.close(timeout)
        self._fail_pending(RuntimeError("AskBatcher is closed"))

    # ---------------------------------------------------------------- stats
    def stats(self):
        """Numeric summary (registry-collector compatible)."""
        with self._lock:
            b, n = self._batches, self._asks
            up = (time.monotonic() - self._t_loop0) \
                if self._t_loop0 is not None else 0.0
            idle = self._idle_wakeups
            out = {"batches": float(b), "asks": float(n),
                   # idle-backoff evidence: empty
                   # dispatcher wakeups and their rate — bounded by
                   # 1/IDLE_WAIT_MAX (= 4/s) once the backoff saturates
                   "idle_wakeups": float(idle),
                   "idle_wakeups_per_s": (idle / up) if up > 0 else 0.0,
                   "mean_batch_size": (n / b) if b else 0.0,
                   "max_batch_size": float(self._max_seen),
                   "multi_ask_batches": float(self._multi),
                   "pending": float(len(self._pending)),
                   # the engine's wave counter: every
                   # execute_ask_batch invocation is one wave, and this
                   # is the id the newest wave's spans carry — the
                   # cross-check key between the trace timeline and
                   # these stats
                   "last_wave_id": float(
                       getattr(self.region, "_wave_seq", 0))}
        # overlap evidence: fraction of wave-busy
        # wall time with >= 2 waves open on the bridge. Serialized mode
        # reports 0.0 by construction — the A/B artifact's fingerprint.
        if self._sched is not None:
            sst = self._sched.stats()
            out["overlap_ratio"] = sst["overlap_ratio"]
            out["waves_overlap_s"] = sst["overlap_s"]
            out["waves_busy_s"] = sst["busy_s"]
            out["runner_idle_wakeups"] = sst["idle_wakeups"]
            out["runner_idle_wakeups_per_s"] = sst["idle_wakeups_per_s"]
            out["open_wave_depth"] = self._sched.open_wave_depth()
        else:
            out["overlap_ratio"] = 0.0
            out["waves_overlap_s"] = 0.0
            out["waves_busy_s"] = 0.0
            out["runner_idle_wakeups"] = 0.0
            out["runner_idle_wakeups_per_s"] = 0.0
            out["open_wave_depth"] = 0.0
        return out
