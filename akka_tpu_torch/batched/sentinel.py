"""MeshSentinel: shard-failure detection and failover over shard slots.

Port of `akka_tpu/batched/sentinel.py` (commit 94ce108). The reference
closes the manual-restore loop with Akka's cluster availability stance
(phi-accrual detection -> member eviction -> the survivors keep serving)
over a device mesh; here the mesh is an ordered list of shard slots of one
card (parallel/mesh.py), so evicting a slot rebuilds the system on the
remaining slots of the same card.

  Detection   every step's attention word ([n_shards, ATT_WORDS],
              supervision.py) carries each shard's ATT_PROGRESS lane. The
              depth-k pipeline copies each enqueued step's word into
              pinned host memory behind a CUDA event (core.snapshot_word,
              as the bridge's pump does: the graph overwrites the carried
              word every step), and each drain feeds the host copy, after
              an optional chaos DeviceLossInjector, to a per-shard
              phi-accrual detector (ShardProgressMonitor). poll() is the
              wall-clock deadline lane for total drain silence.

  Eviction    under the step lock: the attention words of steps in flight
              are discarded (on one card the evicted slot's steps still
              finish on the shared stream; the reference abandons them),
              `device_suspected`/`device_evicted` events fire, and every
              outstanding ask fails fast with RecoveredAskLost.

  Failover    rebuild the ShardedBatchedSystem on the surviving slots,
              re-run the recorded spawns, restore the latest snapshot
              (`_restore_resharded` when the shard count changed), replay
              the tell WAL and capture the new step's graph; the old
              system's graphs and their pool are dropped first. Repeated
              failovers degrade instead of flapping: a circuit breaker
              counts them, a backoff re-arms detection, every failover
              after the first halves the pipeline depth (restored after
              `depth_recovery_rounds` healthy drains), and once the breaker
              opens the sentinel halts (SentinelHalted).

  Elastic     `scale_to(slots)` drains to the barrier, takes host copies
              of the slab tree under the step lock, rebuilds on the new
              slots and restores from that in-memory tree; the fsync'd
              snapshot and the journal compaction run on a background
              thread over those host copies (never views of the live
              carry, which every step writes in place). Asks in flight
              survive a re-shard.

Capacity stays constant across rebuilds (the snapshot's actor ids are the
behaviors' coordinates), so it must divide by every survivor count to
tolerate; a failover onto a count that does not halts with the
reference's reason. MTTR (suspicion -> first post-failover drain) is
measured with time.perf_counter even under an injected detection clock,
and that drain waits on its step's CUDA event.

ShardProgressMonitor and SentinelHalted are shared with the bridge's pump
(detection only, on a single system).
"""

from __future__ import annotations

import os
import threading
import time as _time
from collections import deque
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..parallel.mesh import (DEFAULT_POOL_SLOTS, make_mesh,
                             check_one_card, shard_slots)
from ..pattern.backoff import backoff_delay
from ..pattern.circuit_breaker import CircuitBreaker
from ..remote.failure_detector import (DeadlineFailureDetector,
                                       FailureDetectorRegistry,
                                       PhiAccrualFailureDetector)
from .behavior import BatchedBehavior, Emit
from .behavior import behavior as behavior_deco
from .core import _numpy_dtype, host_to_device, snapshot_word
from .sharded import ShardedBatchedSystem
from .supervision import (ATT_FLAGS, ATT_LATCH_BIT, ATT_PROGRESS, ATT_WORDS,
                          decode_attention)


class SentinelHalted(RuntimeError):
    """Terminal degraded state: the failover breaker tripped (or a rebuild
    was impossible) and the sentinel stopped stepping instead of flapping
    through an eviction storm. The journal and snapshots are intact — a
    human (or a supervisor tier above) decides what runs next."""


class ShardProgressMonitor:
    """Per-shard failure detection over host-observed attention words.

    Feed every drained [n_shards, ATT_WORDS] fetch to observe(): a shard
    whose ATT_PROGRESS lane advanced heartbeats its phi-accrual detector;
    a frozen lane accrues phi with the injected clock until the threshold
    trips. check_deadline() is the whole-mesh fallback for total drain
    silence (hung dispatch): when no observation at all arrived within
    the deadline, the stalest shard — lowest progress, then lowest index —
    is the suspect, because per-shard phi cannot localize a fault that
    produces no words. Shared by the MeshSentinel (acts on suspicion) and
    the bridge pump (detection-only telemetry on a single device)."""

    def __init__(self, threshold: float = 8.0,
                 heartbeat_interval: float = 0.1,
                 acceptable_pause: float = 1.0,
                 clock=_time.monotonic):
        self.clock = clock
        self.threshold = float(threshold)
        self.heartbeat_interval = float(heartbeat_interval)
        self.acceptable_pause = float(acceptable_pause)
        est = max(self.heartbeat_interval, 1e-6)
        self._phi = FailureDetectorRegistry(
            lambda: PhiAccrualFailureDetector(
                threshold=self.threshold,
                acceptable_heartbeat_pause=self.acceptable_pause,
                first_heartbeat_estimate=est,
                min_std_deviation=est / 4.0,
                clock=clock))
        self._deadline = DeadlineFailureDetector(
            acceptable_heartbeat_pause=self.acceptable_pause,
            heartbeat_interval=self.heartbeat_interval, clock=clock)
        self._progress: Dict[int, int] = {}   # shard -> last seen lane value
        self._suspected: set = set()
        self.drains = 0

    def observe(self, att) -> List[Tuple[int, float, str]]:
        """One drained attention fetch. Returns newly suspected shards as
        (shard, phi, detector) triples, at most once per shard until
        unsuspect()/reset()."""
        att = np.asarray(att).reshape(-1, ATT_WORDS)
        self.drains += 1
        self._deadline.heartbeat()
        for s in range(att.shape[0]):
            prog = int(att[s, ATT_PROGRESS])
            last = self._progress.get(s)
            if last is None or prog > last:
                self._progress[s] = prog
                self._phi.heartbeat(s)
        newly = []
        for s in range(att.shape[0]):
            if s in self._suspected:
                continue
            if self._phi.is_monitoring(s) and not self._phi.is_available(s):
                self._suspected.add(s)
                newly.append((s, self._phi.phi(s), "phi-accrual"))
        return newly

    def check_deadline(self) -> Optional[Tuple[int, float, str]]:
        """Whole-mesh drain-silence check (the hung-dispatch lane). Returns
        one (shard, phi, "deadline") suspect or None."""
        if not self._deadline.is_monitoring or self._deadline.is_available:
            return None
        if not self._progress:
            return None
        stale = min(self._progress, key=lambda s: (self._progress[s], s))
        if stale in self._suspected:
            return None
        self._suspected.add(stale)
        return (stale, float("inf"), "deadline")

    def phi(self, shard: int) -> float:
        return self._phi.phi(shard)

    def suspected(self) -> set:
        return set(self._suspected)

    def unsuspect(self, shards) -> None:
        """Withdraw suspicion (detection suspended during the post-failover
        backoff window) — the shard re-trips on a later observation if its
        lane is still frozen."""
        for s in shards:
            self._suspected.discard(s)

    def reset(self) -> None:
        """Forget everything — shard indices renumber after a failover."""
        self._phi.reset()
        self._deadline = DeadlineFailureDetector(
            acceptable_heartbeat_pause=self.acceptable_pause,
            heartbeat_interval=self.heartbeat_interval, clock=self.clock)
        self._progress.clear()
        self._suspected.clear()


class MeshSentinel:
    """Self-healing runner around a ShardedBatchedSystem on shard slots of
    one card (the module docstring has the full story). Drive with
    step(n); tell()/ask() stage messages; a chaos DeviceLossInjector
    (testkit/chaos.py) may sit on the drain path to rehearse losses
    deterministically.

    devices: the slots (parallel/mesh.ShardSlot) of the mesh, default the
    first `n_devices` of a pool of DEFAULT_POOL_SLOTS slots on `device`'s
    card (a port addition: default CUDA, raising without a card unless
    device="cpu"); all of them on one card (slots of several ranks raise
    NotImplementedError naming ROADMAP A10.3). payload_dtype is a torch
    dtype. spill_capacity (a port addition, default None = the system's
    default) is forwarded to the system."""

    PROMISE_REPLY = "__promise_reply"
    PROMISE_REPLIED = "__promise_replied"

    def __init__(self, capacity: int, behaviors: Sequence[BatchedBehavior],
                 checkpoint_dir: str,
                 n_devices: Optional[int] = None,
                 devices: Optional[Sequence[Any]] = None,
                 payload_width: int = 4, out_degree: int = 1,
                 host_inbox_per_shard: int = 256,
                 payload_dtype=torch.float32, axis_name: str = "shards",
                 mailbox_slots: int = 0,
                 delivery_backend: Optional[str] = None,
                 remote_capacity_per_pair: Optional[int] = None,
                 pipeline_depth: int = 2, min_pipeline_depth: int = 1,
                 checkpoint_interval_steps: int = 8,
                 checkpoint_keep: int = 3,
                 wal_fsync_every_n: int = 1,
                 detector_threshold: float = 8.0,
                 heartbeat_interval: float = 0.1,
                 acceptable_pause: float = 1.0,
                 max_failovers: int = 3,
                 failover_min_backoff: float = 0.5,
                 failover_max_backoff: float = 30.0,
                 depth_recovery_rounds: int = 64,
                 promise_rows: int = 0,
                 clock=_time.monotonic,
                 flight_recorder=None,
                 injector=None,
                 metrics_enabled: bool = False,
                 metrics_registry=None,
                 spill_capacity: Optional[int] = None,
                 device=None):
        if pipeline_depth < 1 or min_pipeline_depth < 1:
            raise ValueError("pipeline depths must be >= 1")
        self._capacity_arg = int(capacity)
        if devices is None:
            pool = shard_slots(max(DEFAULT_POOL_SLOTS, n_devices or 0),
                               device)
            devices = pool[:n_devices] if n_devices else pool
        self.devices = list(devices)
        check_one_card(self.devices, "MeshSentinel")
        # the card: the one all slots lie on (several raise: one process
        # per card)
        self.device = make_mesh(devices=self.devices,
                                axis_name=axis_name).device
        self.behaviors = list(behaviors)
        self.payload_width = int(payload_width)
        self.out_degree = int(out_degree)
        self.host_inbox = int(host_inbox_per_shard)
        self.payload_dtype = payload_dtype
        self.axis_name = axis_name
        self.mailbox_slots = int(mailbox_slots)
        self.spill_capacity = spill_capacity
        self.delivery_backend = delivery_backend
        self.remote_capacity_per_pair = remote_capacity_per_pair
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_interval = int(checkpoint_interval_steps)
        self.checkpoint_keep = int(checkpoint_keep)
        self.min_pipeline_depth = int(min_pipeline_depth)
        self.max_failovers = int(max_failovers)
        self.promise_rows_n = int(promise_rows)
        self.clock = clock
        self.flight_recorder = flight_recorder
        self.injector = injector
        # telemetry plane: slab compiled into the sharded step when on;
        # phi/suspicion surface as gauges through the registered collector
        self.metrics_enabled = bool(metrics_enabled)
        self.metrics_registry = metrics_registry
        if self.metrics_registry is not None:
            self.metrics_registry.register_collector(
                "mesh_sentinel", self._sentinel_metrics)
        self._fo_min_backoff = float(failover_min_backoff)
        self._fo_max_backoff = float(failover_max_backoff)

        from ..persistence.tell_journal import TellJournal
        os.makedirs(checkpoint_dir, exist_ok=True)
        self._journal = TellJournal(os.path.join(checkpoint_dir, "tells.wal"),
                                    flight_recorder,
                                    fsync_every_n=wal_fsync_every_n)

        self._monitor = ShardProgressMonitor(
            threshold=detector_threshold,
            heartbeat_interval=heartbeat_interval,
            acceptable_pause=acceptable_pause, clock=clock)
        # each failover is one breaker failure, not one protected call:
        # successful rebuilds must not reset the count, or an eviction
        # storm would flap forever. After max_failovers the breaker is
        # open and the next suspicion halts (the huge reset timeout keeps
        # it from quietly re-arming).
        self._breaker = CircuitBreaker(None, max_failures=self.max_failovers,
                                       call_timeout=float("inf"),
                                       reset_timeout=1e9)
        self._step_lock = threading.RLock()
        # (pinned host copy of the attention word, its CUDA event) per
        # step in flight, oldest first
        self._inflight: deque = deque()
        self._depth = int(pipeline_depth)
        # degrade-ladder recovery: after depth_recovery_rounds consecutive
        # healthy drains past the detection backoff window, _depth snaps
        # back to the configured value; 0 keeps it halved
        self._depth_cfg = int(pipeline_depth)
        self.depth_recovery_rounds = int(depth_recovery_rounds)
        self._healthy_rounds = 0
        self._halted: Optional[str] = None
        self._failovers = 0
        self._detect_after = 0.0   # clock() before which suspicion waits
        self._mttr_t0: Optional[float] = None
        self.failover_stats: List[Dict[str, Any]] = []
        # elastic mesh (scale_to): one record per voluntary re-shard, and
        # its own breaker and backoff, so a flapping autoscaler degrades
        # to "stay at the current width"; the failover breaker stays
        # reserved for losses
        self.reshard_stats: List[Dict[str, Any]] = []
        self._scale_breaker = CircuitBreaker(None,
                                             max_failures=self.max_failovers,
                                             call_timeout=float("inf"),
                                             reset_timeout=1e9)
        self._scale_failures = 0
        self._scale_after = 0.0    # clock() before which scale_to refuses
        self._snapshot_writer: Optional[threading.Thread] = None
        # wall ms of the last rebuild's parts (failover or re-shard; a
        # port addition): load, build, restore, replay, capture
        self.rebuild_timings: Dict[str, float] = {}
        self._autoscaler = None    # attach_autoscaler: polled per round
        self._snapshotted = False
        self._last_ckpt = 0
        self._spawned = False      # the spawn topology freezes at step 1

        self._waiters: Dict[int, Tuple[Future, float]] = {}
        self._zombies: set = set()
        self._promise_free: List[int] = []
        self._promise_base = 0

        self._spawns: List[Tuple[int, int, Optional[Dict[str, Any]]]] = []
        if self.promise_rows_n > 0:
            # promise rows live at the bottom of the id space (the first
            # spawn record), so their base survives every rebuild
            self._spawns.append((len(self.behaviors), self.promise_rows_n,
                                 None))
        self.system = self._build_system(self.devices)
        self.capacity = self.system.capacity
        self._promise_free = list(range(self.promise_rows_n))

    # ---------------------------------------------------------------- build
    def _all_behaviors(self) -> List[BatchedBehavior]:
        bs = list(self.behaviors)
        if self.promise_rows_n > 0:
            bs.append(self._promise_behavior())
        return bs

    def _promise_behavior(self) -> BatchedBehavior:
        p_w, k = self.payload_width, self.out_degree
        reply_col, replied_col = self.PROMISE_REPLY, self.PROMISE_REPLIED

        @behavior_deco("__promise",
                       {reply_col: ((p_w,), self.payload_dtype),
                        replied_col: ((), torch.bool)})
        def promise(state, inbox, ctx):
            got = inbox.count > 0
            take = got & ~state[replied_col]  # the first answer wins
            reply = state[reply_col]
            return ({reply_col: torch.where(take[:, None],
                                            inbox.sum.to(reply.dtype),
                                            reply),
                     replied_col: state[replied_col] | got},
                    Emit.none(got.shape[0], k, p_w, device=got.device))

        return promise

    def _build_system(self, devices: Sequence[Any]) -> ShardedBatchedSystem:
        mesh = make_mesh(devices=list(devices), axis_name=self.axis_name)
        # the first build may round capacity up (divisibility); the
        # rounded value then pins the actor-id space for every rebuild
        cap = getattr(self, "capacity", None) or self._capacity_arg
        extra = ({"remote_capacity_per_pair": self.remote_capacity_per_pair}
                 if self.remote_capacity_per_pair is not None else {})
        sys_ = ShardedBatchedSystem(
            cap, self._all_behaviors(), mesh=mesh,
            payload_width=self.payload_width, out_degree=self.out_degree,
            host_inbox_per_shard=self.host_inbox,
            payload_dtype=self.payload_dtype, axis_name=self.axis_name,
            mailbox_slots=self.mailbox_slots,
            spill_capacity=self.spill_capacity,
            delivery_backend=self.delivery_backend,
            attention_latch_col=(self.PROMISE_REPLIED
                                 if self.promise_rows_n > 0 else None),
            metrics_enabled=self.metrics_enabled, **extra)
        sys_.flight_recorder = self.flight_recorder
        sys_.tell_journal = self._journal
        for b_idx, n, init in self._spawns:
            sys_.spawn_block(b_idx, n, init)
        return sys_

    # ---------------------------------------------------------------- actors
    def spawn(self, behavior: BatchedBehavior, n: int = 1,
              init_state: Optional[Dict[str, Any]] = None) -> np.ndarray:
        """Allocate n rows of `behavior`. The spawn is recorded so every
        rebuild replays the identical row layout; the topology freezes at
        the first step (a spawn after stepping would be lost by the next
        snapshot restore)."""
        if self._spawned:
            raise RuntimeError(
                "MeshSentinel topology is frozen after the first step: "
                "spawn every block before stepping")
        b_idx = (behavior if isinstance(behavior, int)
                 else self.behaviors.index(behavior))
        with self._step_lock:
            rows = self.system.spawn_block(b_idx, n, init_state)
            self._spawns.append(
                (b_idx, n, dict(init_state) if init_state else None))
        return rows

    def tell(self, dst: int, payload, mtype: int = 0) -> None:
        if self._halted:
            raise SentinelHalted(self._halted)
        with self._step_lock:
            self.system.tell(int(dst), payload, mtype)

    def ask(self, dst: int, payload, mtype: int = 0,
            timeout: float = 5.0) -> Future:
        """Stage a tell carrying a reserved promise row in the LAST payload
        column (the bridge's DefaultCodec convention: the target behavior
        emits its reply to that row). Resolves from the promise block on
        a latched drain; times out against the sentinel clock; fails with
        RecoveredAskLost if a failover evicts the mesh underneath it."""
        if self.promise_rows_n <= 0:
            raise RuntimeError("construct MeshSentinel with promise_rows > 0 "
                               "to use ask()")
        fut: Future = Future()
        with self._step_lock:
            if self._halted:
                fut.set_exception(SentinelHalted(self._halted))
                return fut
            if not self._promise_free:
                from .bridge import AskPoolExhausted
                fut.set_exception(AskPoolExhausted(
                    f"promise rows exhausted ({self.promise_rows_n} in "
                    f"flight)"))
                return fut
            slot = self._promise_free.pop()
            prow = self._promise_base + slot
            pl = np.zeros(self.payload_width,
                          dtype=_numpy_dtype(self.payload_dtype))
            arr = np.asarray(payload).reshape(-1)
            pl[: arr.shape[0]] = arr
            pl[-1] = prow
            self.system.tell(int(dst), pl, mtype)
            self._waiters[prow] = (fut, self.clock() + float(timeout))
        return fut

    # -------------------------------------------------------------- stepping
    @property
    def host_step(self) -> int:
        return self.system._host_step

    @property
    def pipeline_depth(self) -> int:
        return self._depth

    @property
    def halted(self) -> Optional[str]:
        return self._halted

    def step(self, n: int = 1) -> None:
        """Drive n steps through the depth-k pipeline, detecting and
        failing over as drains come back. Raises SentinelHalted once the
        breaker has tripped the sentinel into its terminal state."""
        if self._halted:
            raise SentinelHalted(self._halted)
        for _ in range(n):
            self._enqueue_step()
            while len(self._inflight) >= self._depth:
                self._drain_one()
            if self._halted:
                raise SentinelHalted(self._halted)
        while self._inflight:
            self._drain_one()
        if self._halted:
            raise SentinelHalted(self._halted)
        if self._autoscaler is not None:
            # one control tick per pump round, at the idle edge: the
            # policy's hysteresis windows count pump rounds, and
            # scale_to's drain loop is a no-op here
            self._autoscaler.poll()

    def attach_autoscaler(self, autoscaler) -> None:
        """Poll `autoscaler` (batched/autoscale.MeshAutoscaler) once per
        step() pump round; pass None to detach."""
        self._autoscaler = autoscaler

    def _enqueue_step(self) -> None:
        if not self._snapshotted:
            # step-0 snapshot: a loss before the first cadence checkpoint
            # must still have something to fail over from (the WAL replays
            # everything staged since)
            self.checkpoint()
        self._spawned = True
        with self._step_lock:
            self.system.run(1)
            # the next step overwrites the carried word: copy it now
            self._inflight.append(snapshot_word(self.system.attention))
        if (self.checkpoint_interval > 0
                and self.system._host_step - self._last_ckpt
                >= self.checkpoint_interval):
            self.checkpoint()

    def _drain_one(self) -> None:
        host, copied = self._inflight.popleft()
        if copied is not None:
            copied.synchronize()  # this step's completion, not later ones
        att = host.numpy().astype(np.int64).reshape(-1, ATT_WORDS)
        if self.injector is not None:
            att = self.injector.filter_attention(att)
        if self._mttr_t0 is not None:
            # the first completed post-failover step closes the MTTR clock
            mttr = _time.perf_counter() - self._mttr_t0
            self._mttr_t0 = None
            st = self.failover_stats[-1]
            st["mttr_s"] = mttr
            if self.flight_recorder is not None:
                self.flight_recorder.failover_completed(
                    "sentinel", lost_shards=st["lost_shards"],
                    survivors=st["survivors"],
                    step=int(self.system._host_step), mttr_s=mttr)
        flags = int(np.bitwise_or.reduce(att[:, ATT_FLAGS])) if att.size else 0
        if self.promise_rows_n > 0 and (flags & ATT_LATCH_BIT):
            self._resolve_waiters()
        self._check_ask_deadlines()
        self.system._note_shard_overflow(decode_attention(att))
        newly = self._monitor.observe(att)
        if newly:
            self._healthy_rounds = 0
            if self.clock() < self._detect_after:
                # post-failover backoff window: suspicion is deferred, not
                # acted on; a still-frozen lane re-trips once it closes
                self._monitor.unsuspect([s for s, _, _ in newly])
            else:
                self._on_suspected(newly)
        elif (self.depth_recovery_rounds > 0
              and self._depth < self._depth_cfg
              and self.clock() >= self._detect_after):
            # degrade-ladder recovery: drains count as healthy only once
            # the post-failover backoff window has closed; a full quiet
            # window restores the configured depth
            self._healthy_rounds += 1
            if self._healthy_rounds >= self.depth_recovery_rounds:
                restored_from, self._depth = self._depth, self._depth_cfg
                self._healthy_rounds = 0
                if self.flight_recorder is not None:
                    self.flight_recorder.event(
                        "pipeline_depth_restored", system="sentinel",
                        from_depth=restored_from, to_depth=self._depth_cfg,
                        step=int(self.system._host_step))

    def poll(self) -> None:
        """Wall-clock deadline lane for the no-drain (hung dispatch) case:
        call from a watchdog thread or a test; the drain path cannot
        observe its own silence. Suspects the stalest shard."""
        if self._halted:
            return
        hit = self._monitor.check_deadline()
        if hit is None:
            return
        if self.clock() < self._detect_after:
            self._monitor.unsuspect([hit[0]])
            return
        self._on_suspected([hit])

    def force_evict(self, shards: Sequence[int],
                    detector: str = "manual") -> None:
        """Operator-initiated eviction (Akka `down()`): the same
        quarantine and failover path as a detector's suspicion."""
        self._on_suspected([(int(s), float("inf"), detector)
                            for s in shards])

    # -------------------------------------------------------------- failover
    def _on_suspected(self, newly: List[Tuple[int, float, str]]) -> None:
        fr = self.flight_recorder
        if fr is not None:
            for s, phi, det in newly:
                fr.device_suspected("sentinel", shard=int(s),
                                    phi=float(phi), detector=det)
        self._failover([int(s) for s, _, _ in newly],
                       detector=newly[0][2])

    def _failover(self, lost: List[int], detector: str = "unknown") -> None:
        t0 = _time.perf_counter()
        fr = self.flight_recorder
        with self._step_lock:
            if self._halted:
                return
            if self._breaker.state == "open":
                self._halt(f"failover breaker open after {self._failovers} "
                           f"failovers (suspect shards {sorted(lost)})")
                return
            self._breaker.fail()  # each failover counts toward the trip
            self._failovers += 1
            step = int(self.system._host_step)
            # quarantine under the step lock: discard the words of steps
            # in flight and evict; nothing dispatches onto the lost mesh
            self._inflight.clear()
            if fr is not None:
                for s in lost:
                    fr.device_evicted("sentinel", shard=int(s), step=step)
            self._fail_waiters_lost(sorted(lost))
            survivors = [d for i, d in enumerate(self.devices)
                         if i not in set(lost)]
            try:
                if not survivors:
                    raise RuntimeError("no surviving devices")
                if self.capacity % len(survivors) != 0:
                    raise RuntimeError(
                        f"capacity {self.capacity} is not divisible by the "
                        f"surviving shard count {len(survivors)}: provision "
                        f"capacity as a multiple of every survivor count "
                        f"to tolerate")
                self._rebuild(survivors)
            except Exception as e:  # noqa: BLE001 — a failed rebuild halts
                self._halt(f"failover rebuild failed: {e}")
                return
            # degrade ladder: every failover after the first halves the
            # pipeline depth (recovers after depth_recovery_rounds)
            if self._failovers > 1:
                self._depth = max(self.min_pipeline_depth, self._depth // 2)
            self._healthy_rounds = 0
            self._detect_after = self.clock() + backoff_delay(
                self._failovers, self._fo_min_backoff, self._fo_max_backoff)
            self._monitor.reset()
            self.failover_stats.append({
                "at_clock": float(self.clock()),
                "lost_shards": sorted(lost),
                "survivors": len(survivors),
                "detector": detector,
                "evicted_at_step": step,
                "restored_step": int(self.system._host_step),
                "rebuild_s": _time.perf_counter() - t0,
                "pipeline_depth": self._depth,
                "mttr_s": None,  # closes on the first post-failover drain
            })
            self._mttr_t0 = t0

    def _replace_system(self, devices: Sequence[Any], tree) -> None:
        """Build the system on `devices`, restore the slab tree `tree` (or
        the snapshot at that path) into it, replay the WAL and capture its
        step; then it replaces the current one, whose graphs and their
        pool are dropped. A failure leaves the current system in place.
        The parts' wall times land in `rebuild_timings` (ms)."""
        from ..persistence.slab_snapshot import load_slab_tree
        from ..persistence.tell_journal import replay_journal
        t0 = _time.perf_counter()
        if isinstance(tree, str):
            tree = load_slab_tree(tree)
        t1 = _time.perf_counter()
        new = self._build_system(devices)
        t2 = _time.perf_counter()
        new.restore_tree(tree)
        new.block_until_ready()
        t3 = _time.perf_counter()
        replay_journal(new, self._journal)
        new.block_until_ready()
        t4 = _time.perf_counter()
        new.warmup()  # the capture is part of the rebuild (MTTR, pause)
        t5 = _time.perf_counter()
        old, self.system = self.system, new
        self.devices = list(devices)
        old._graphs.clear()
        self.rebuild_timings = {
            "load_ms": (t1 - t0) * 1e3, "build_ms": (t2 - t1) * 1e3,
            "restore_ms": (t3 - t2) * 1e3, "replay_ms": (t4 - t3) * 1e3,
            "capture_ms": (t5 - t4) * 1e3,
            "replayed_steps": new._host_step - int(
                np.asarray(tree["step_count"]).max())}

    def _rebuild(self, survivors: List[Any]) -> None:
        from ..persistence.slab_snapshot import latest_slab_path
        path = latest_slab_path(self.checkpoint_dir)
        if path is None:
            raise RuntimeError("no snapshot to fail over from")
        # the lost mesh never steps again: its graphs go before the new
        # system allocates
        self.system._graphs.clear()
        self._replace_system(survivors, path)
        if self.promise_rows_n > 0:
            # latch state does not survive the rebuild: lower every latch
            # (a replayed ask may have re-latched during the WAL replay)
            # and reset the slot pool; the waiters already failed
            self._lower_latches(range(self.promise_rows_n))
            self._promise_free = list(range(self.promise_rows_n))
            self._zombies.clear()
        self._last_ckpt = self.system._host_step

    # ---------------------------------------------------------- elastic mesh
    def scale_to(self, devices: Sequence[Any], trigger: str = "manual",
                 signal: str = "manual",
                 value: float = 0.0) -> Optional[Dict[str, Any]]:
        """Bounded-pause live re-shard onto the slots `devices` (grow or
        shrink), the inverse of `_failover` minus the loss. Under the step
        lock: drain the depth-k pipeline to the barrier, take host copies
        of the slab tree at the frontier, rebuild the ShardedBatchedSystem
        on the new slots and restore straight from that in-memory tree
        (`_restore_resharded` re-places rows, and the WAL tail re-stages
        journaled but undispatched tells), capture its step, then resume.
        The fsync'd snapshot write and the journal compaction run on a
        background thread over the host copies.

        Outstanding asks survive (unlike a failover): the tree is taken at
        the live frontier, so the promise columns carry over bit-exactly
        and waiters resolve on post-re-shard drains.

        Returns the reshard_stats record (pause_s included), or None when
        `devices` already is the current mesh. Raises SentinelHalted when
        halted, ValueError on a width that does not divide capacity, and
        RuntimeError when the scale breaker is open or the anti-thrash
        backoff window has not closed. A rebuild failure keeps the
        still-healthy current system and counts against the scale
        breaker."""
        devices = list(devices)
        t0 = _time.perf_counter()
        with self._step_lock:
            if self._halted:
                raise SentinelHalted(self._halted)
            if len(devices) < 1:
                raise ValueError("cannot scale to zero devices")
            if self._scale_breaker.state == "open":
                raise RuntimeError(
                    f"scale breaker open after {self._scale_failures} "
                    f"failed re-shards: mesh stays at {len(self.devices)}")
            if self.clock() < self._scale_after:
                raise RuntimeError(
                    "re-shard refused: anti-thrash backoff window closes "
                    f"at clock {self._scale_after:.3f}")
            # drain to the barrier first: a suspicion surfacing on the way
            # down fails over (and may shrink self.devices) before the
            # target width is committed against the post-drain mesh
            while self._inflight:
                self._drain_one()
            if self._halted:
                raise SentinelHalted(self._halted)
            old_n, new_n = len(self.devices), len(devices)
            if devices == list(self.devices):
                return None
            if self.capacity % new_n != 0:
                raise ValueError(
                    f"capacity {self.capacity} is not divisible by {new_n} "
                    f"shards: provision capacity as a multiple of every "
                    f"mesh width to scale to")
            self.system.block_until_ready()
            step = int(self.system._host_step)
            from ..persistence.slab_snapshot import slab_pytree
            tree = slab_pytree(self.system)  # host copies, not views
            self._spawn_snapshot_writer(tree, step)
            try:
                self._replace_system(devices, tree)
            except Exception:
                # the current mesh is still healthy: scale-out is an
                # optimization, never a reason to go down
                self._scale_failures += 1
                self._scale_breaker.fail()
                self._scale_after = self.clock() + backoff_delay(
                    self._scale_failures, self._fo_min_backoff,
                    self._fo_max_backoff)
                raise
            self._snapshotted = True
            self._last_ckpt = step
            self._monitor.reset()   # shard indices renumbered
            self._healthy_rounds = 0
            self._detect_after = self.clock() + self._fo_min_backoff
            self._scale_after = self.clock() + self._fo_min_backoff
            pause = _time.perf_counter() - t0
            grow = new_n > old_n
            rec = {
                "at_clock": float(self.clock()),
                "direction": "grow" if grow else "shrink",
                "from_shards": old_n,
                "to_shards": new_n,
                "trigger": trigger,
                "signal": signal,
                "value": float(value),
                "step": step,
                "pause_s": pause,
            }
            self.reshard_stats.append(rec)
            fr = self.flight_recorder
            if fr is not None:
                if grow:
                    for s in range(old_n, new_n):
                        fr.device_rejoined("sentinel", shard=s, step=step)
                    fr.mesh_expanded("sentinel", from_shards=old_n,
                                     to_shards=new_n, step=step,
                                     pause_s=pause, trigger=trigger)
                else:
                    fr.mesh_narrowed("sentinel", from_shards=old_n,
                                     to_shards=new_n, step=step,
                                     pause_s=pause, trigger=trigger)
            return rec

    def expand(self, returned: Sequence[Any],
               trigger: str = "device_rejoined",
               signal: str = "manual",
               value: float = 0.0) -> Optional[Dict[str, Any]]:
        """Hot scale-out when evicted slots return (or fresh ones are
        added): widen the mesh to current + `returned`. Slots already in
        the mesh are skipped, so re-announcing one is idempotent."""
        current = list(self.devices)
        added = [d for d in returned if d not in current]
        if not added:
            return None
        return self.scale_to(current + added, trigger=trigger,
                             signal=signal, value=value)

    def _spawn_snapshot_writer(self, tree, step: int) -> None:
        """Durability off the pause path: write the fsync'd snapshot file,
        compact the WAL only after its covering snapshot is durable (the
        recovery invariant), then remove old snapshots, all overlapping
        the rebuild on a daemon thread. `tree` holds host copies taken
        under the step lock. Re-shards serialize on the previous writer;
        compaction during the main thread's WAL replay is safe
        (TellJournal.compact rewrites under the journal's lock, and
        readers of the old file see the same live records)."""
        prev = self._snapshot_writer
        if prev is not None and prev.is_alive():
            prev.join()

        def write() -> None:
            try:
                from ..persistence.slab_snapshot import (gc_slabs,
                                                         save_slab_tree)
                save_slab_tree(tree, self.checkpoint_dir, step)
                self._journal.compact(step)
                gc_slabs(self.checkpoint_dir, self.checkpoint_keep)
            except Exception as e:  # noqa: BLE001 — durability degraded,
                #                     the live re-shard itself succeeded
                if self.flight_recorder is not None:
                    self.flight_recorder.checkpoint_failed(
                        "sentinel", str(e), 1)

        t = threading.Thread(target=write, daemon=True,
                             name="sentinel-reshard-snapshot")
        self._snapshot_writer = t
        t.start()

    def _halt(self, reason: str) -> None:
        self._halted = reason
        self._inflight.clear()
        self._fail_waiters(SentinelHalted(reason))
        if self.flight_recorder is not None:
            self.flight_recorder.failover_halted(
                "sentinel", failovers=self._failovers, reason=reason)

    def _fail_waiters_lost(self, lost: List[int]) -> None:
        from .bridge import RecoveredAskLost  # deferred: bridge imports us
        self._fail_waiters(RecoveredAskLost(
            f"mesh failover evicted shards {lost}; outstanding asks "
            f"cannot resolve across the rebuild — re-issue against the "
            f"restored system"))

    def _fail_waiters(self, exc: Exception) -> None:
        for _prow, (fut, _dl) in list(self._waiters.items()):
            if not fut.done():
                fut.set_exception(exc)
        self._waiters.clear()
        self._zombies.clear()

    # ------------------------------------------------------------------ asks
    def _resolve_waiters(self) -> None:
        from .bridge import read_promise_block
        with self._step_lock:
            base, n = self._promise_base, self.promise_rows_n
            replied, reply = read_promise_block(
                self.system.state, base, n, self.PROMISE_REPLIED,
                self.PROMISE_REPLY)
            clear: List[int] = []
            for prow, (fut, _dl) in list(self._waiters.items()):
                i = prow - base
                if replied[i]:
                    if not fut.done():
                        fut.set_result(np.array(reply[i]))
                    del self._waiters[prow]
                    self._promise_free.append(i)
                    clear.append(i)
            for prow in list(self._zombies):
                i = prow - base
                if replied[i]:  # late reply to a timed-out ask: reclaim
                    self._zombies.discard(prow)
                    self._promise_free.append(i)
                    clear.append(i)
            owned = {p - base for p in self._waiters} | \
                {p - base for p in self._zombies}
            for i in np.nonzero(replied)[0]:
                i = int(i)
                if i not in owned and i not in clear:
                    clear.append(i)  # replayed ask with no waiter: lower only
            if clear:
                self._lower_latches(clear)

    def _check_ask_deadlines(self) -> None:
        if not self._waiters:
            return
        now = self.clock()
        with self._step_lock:
            for prow, (fut, deadline) in list(self._waiters.items()):
                if now >= deadline:
                    del self._waiters[prow]
                    # quarantine the slot until its latch is observed: a
                    # late reply must never resolve a reused slot
                    self._zombies.add(prow)
                    from ..pattern.ask import AskTimeoutException
                    if not fut.done():
                        fut.set_exception(AskTimeoutException(
                            f"ask on promise row {prow} timed out"))

    def _lower_latches(self, slots) -> None:
        """Lower promise latches in place (the step's graph reads the
        column's storage), ordered behind the steps already enqueued."""
        rows = [self._promise_base + int(s) for s in slots]
        if not rows:
            return
        col = self.system.state[self.PROMISE_REPLIED]
        col[host_to_device(np.asarray(rows, np.int64), col.device)] = False

    # ------------------------------------------------------------- telemetry
    def checkpoint(self) -> str:
        t0 = _time.perf_counter()
        with self._step_lock:
            path = self.system.checkpoint(self.checkpoint_dir,
                                          keep=self.checkpoint_keep)
        self._snapshotted = True
        self._last_ckpt = self.system._host_step
        if self.flight_recorder is not None:
            try:
                size = os.path.getsize(path) if os.path.isfile(path) else 0
            except OSError:
                size = 0
            self.flight_recorder.device_checkpoint(
                "sentinel", int(self.system._host_step),
                _time.perf_counter() - t0, size, path)
        self.drain_metrics()  # the checkpoint barrier is a slab drain point
        return path

    def read_state(self, col: str, ids=None) -> np.ndarray:
        return self.system.read_state(col, ids)

    def read_attention(self) -> Dict[str, Any]:
        return self.system.read_attention()

    def sentinel_stats(self) -> Dict[str, Any]:
        reshards = [dict(s) for s in self.reshard_stats]
        return {
            "devices": len(self.devices),
            "failovers": self._failovers,
            "halted": self._halted,
            "pipeline_depth": self._depth,
            "pipeline_depth_configured": self._depth_cfg,
            "drains": self._monitor.drains,
            "suspected": sorted(self._monitor.suspected()),
            "failover_stats": [dict(s) for s in self.failover_stats],
            "reshards": len(reshards),
            "reshard_stats": reshards,
            "last_reshard_pause_ms": (reshards[-1]["pause_s"] * 1e3
                                      if reshards else 0.0),
        }

    def _sentinel_metrics(self) -> Dict[str, Any]:
        """Numeric view for the MetricsRegistry collector: the suspicion
        count and the max phi across shards on top of the scalar
        sentinel_stats fields."""
        st = self.sentinel_stats()
        st["suspected_count"] = len(st.pop("suspected", ()))
        st.pop("failover_stats", None)
        st.pop("reshard_stats", None)
        st.pop("halted", None)
        phi = 0.0
        for s in range(len(self.devices)):
            try:
                phi = max(phi, float(self._monitor.phi(s)))
            except Exception:  # noqa: BLE001 — phi before first heartbeat
                break
        st["phi_max"] = phi
        return st

    def drain_metrics(self) -> None:
        """Epoch-gated device-slab drain into the registry (see
        BatchedRuntimeHandle.drain_metrics)."""
        reg = self.metrics_registry
        if reg is None or not self.metrics_enabled:
            return
        with self._step_lock:
            drained = self.system.drain_metrics()
            host_step = self.system._host_step
        if drained is not None:
            step, lanes = drained
            reg.ingest_device_slab(lanes, step)
        else:
            reg.set_step(host_step)

    def shutdown(self) -> None:
        writer = self._snapshot_writer
        if writer is not None and writer.is_alive():
            writer.join()  # snapshot durability before the journal closes
        with self._step_lock:
            self._inflight.clear()
            self._fail_waiters(SentinelHalted("sentinel shut down"))
            self._journal.close()
