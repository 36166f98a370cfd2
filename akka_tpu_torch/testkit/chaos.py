"""Deterministic fault injection for the batched device runtime.

Port of `akka_tpu/testkit/chaos.py`. The chaos decisions are pure
functions of (seed, step, lane): no RNG state rides the carry, no host
randomness, and the same seed gives the same fault schedule on every
delivery backend, on the CPU and the card, in the reference package and
in a plain numpy loop. An un-captured oracle can then replay the exact
schedule a captured chaos behavior saw, and supervision counters are
asserted equal, not approximately equal.

The primitive is an integer hash (the murmur3 finalizer over the packed
(seed, step, lane) words): `chaos_hash` is the tensor form used inside
behaviors, `chaos_hit`/`chaos_hit_np` the bit-identical tensor/numpy rate
tests built on it (`chaos_uniform_np` maps the hash to [0, 1) for oracles
that want a float). Fault kinds are composable masks over lanes:

  crash   the lane raises `_failed` this step (let-it-crash input)
  nan     the lane's state column is corrupted to NaN (pairs with
          BatchedBehavior.nonfinite_guard)
  drop    the lane's emissions this step are suppressed
  dup     the lane's slot-0 emission is duplicated into the last emit slot

`inject(behavior, ...)` wraps a BatchedBehavior with any subset of these:
the faults apply after the wrapped receive runs, so the wrapped behavior
never observes the chaos. The hash is tensor arithmetic only (no sync), so
an injected behavior stays capturable in a CUDA graph.

torch has no general uint32 arithmetic: the tensor hash runs in int64 on
values kept in [0, 2^32), through the helpers of utils/u32.py (every
32 x 32-bit product split into 16-bit halves, so that no intermediate
passes 2^48).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..batched.behavior import BatchedBehavior, Emit, rows
from ..utils.u32 import MASK32 as _MASK32
from ..utils.u32 import mul32 as _mul32
from ..utils.u32 import u32 as _u32

# murmur3 fmix32 constants: chosen for avalanche, not secrecy
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_STEP_MUL = 0x85EBCA77
_LANE_MUL = 0xC2B2AE3D
_SALT_MUL = 0x9E3779B9


def _fmix32_np(h) -> np.ndarray:
    # all arithmetic in uint64 with explicit 32-bit masking: no reliance
    # on numpy promotion rules or on wraparound of the multiplies
    h = np.asarray(h, np.uint64) & np.uint64(_MASK32)
    h = h ^ (h >> np.uint64(16))
    h = (h * np.uint64(_C1)) & np.uint64(_MASK32)
    h = h ^ (h >> np.uint64(13))
    h = (h * np.uint64(_C2)) & np.uint64(_MASK32)
    return h ^ (h >> np.uint64(16))


def _seed_word(seed: int, salt: int) -> int:
    return (seed & _MASK32) ^ ((salt * _SALT_MUL) & _MASK32)


def _hash_np(seed: int, step, lane, salt: int) -> np.ndarray:
    """The u32 hash of (seed, step, lane, salt) as uint64 values."""
    step = np.asarray(step, np.uint32)
    lane = np.asarray(lane, np.uint32)
    h = np.uint64(_seed_word(seed, salt))
    h = _fmix32_np((h + step.astype(np.uint64) * np.uint64(_STEP_MUL))
                   & np.uint64(_MASK32))
    return _fmix32_np((h + lane.astype(np.uint64) * np.uint64(_LANE_MUL))
                      & np.uint64(_MASK32))


def chaos_uniform_np(seed: int, step, lane, salt: int = 0) -> np.ndarray:
    """The u32 hash mapped to [0, 1) as float64 (exact: a 32-bit
    numerator over a power-of-two divisor)."""
    return _hash_np(seed, step, lane, salt).astype(np.float64) \
        / float(1 << 32)


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, _C1)
    h = h ^ (h >> 13)
    h = _mul32(h, _C2)
    return h ^ (h >> 16)


def chaos_hash(seed: int, step, lane, salt: int = 0) -> torch.Tensor:
    """Deterministic per-(step, lane) u32 hash, as an int64 tensor in
    [0, 2^32): pure integer arithmetic (bit-stable across devices),
    finalized with the murmur3 mixer. `step` and `lane` are tensors (on
    one device: the result lies there) or host integers/arrays, and
    broadcast against each other; `salt` decorrelates fault kinds sharing
    one seed. Compare against `_rate_threshold(rate)` rather than
    dividing."""
    dev = lane.device if isinstance(lane, torch.Tensor) else (
        step.device if isinstance(step, torch.Tensor) else None)
    h = _seed_word(seed, salt)
    h = _fmix32((_mul32(_u32(step, dev), _STEP_MUL) + h) & _MASK32)
    return _fmix32((_mul32(_u32(lane, dev), _LANE_MUL) + h) & _MASK32)


def _rate_threshold(rate: float) -> int:
    """rate in [0, 1] -> u32 threshold, shared by the tensor and numpy
    sides: hash < threshold <=> uniform < rate."""
    return min(int(round(rate * float(1 << 32))), 1 << 32)


def chaos_hit(seed: int, step, lane, rate: float,
              salt: int = 0) -> torch.Tensor:
    """bool tensor: does the (step, lane) cell fire at `rate`? Rates that
    quantize to 0 or 2^32 give all-False / all-True of the hash's
    shape."""
    thr = _rate_threshold(rate)
    h = chaos_hash(seed, step, lane, salt)
    if thr <= 0:
        return torch.zeros_like(h, dtype=torch.bool)
    if thr >= (1 << 32):
        return torch.ones_like(h, dtype=torch.bool)
    return h < thr


def chaos_hit_np(seed: int, step, lane, rate: float, salt: int = 0):
    """numpy twin of chaos_hit: the oracle's fault schedule."""
    thr = _rate_threshold(rate)
    if thr <= 0:
        return np.zeros(np.shape(lane), np.bool_)
    if thr >= (1 << 32):
        return np.ones(np.shape(lane), np.bool_)
    return _hash_np(seed, step, lane, salt) < np.uint64(thr)


# salts decorrelating the fault kinds (shared with oracles). LOSS/STALL
# key on (step, shard) instead of (step, lane): they model device faults
# (preemption, a hung dispatch), not actor faults
CRASH_SALT, NAN_SALT, DROP_SALT, DUP_SALT = 1, 2, 3, 4
LOSS_SALT, STALL_SALT = 5, 6


def loss_schedule(seed: int, steps: int, n_shards: int, rate: float,
                  salt: int = LOSS_SALT, device=None) -> torch.Tensor:
    """[steps, n_shards] bool tensor on `device` (default: the CPU, as a
    host schedule): does shard s suffer a device fault at step t? The same
    schedule as `loss_schedule_np` and the reference's, seed for seed."""
    step = torch.arange(steps, dtype=torch.int64,
                        device=device).repeat_interleave(n_shards)
    shard = torch.arange(n_shards, dtype=torch.int64,
                         device=device).repeat(steps)
    return chaos_hit(seed, step, shard, rate, salt).reshape(steps, n_shards)


def loss_schedule_np(seed: int, steps: int, n_shards: int, rate: float,
                     salt: int = LOSS_SALT) -> np.ndarray:
    """numpy twin of loss_schedule."""
    step = np.repeat(np.arange(steps, dtype=np.uint32), n_shards)
    shard = np.tile(np.arange(n_shards, dtype=np.uint32), steps)
    return chaos_hit_np(seed, step, shard, rate, salt).reshape(
        steps, n_shards)


class DeviceLossInjector:
    """Deterministic device-loss/stall injection for a mesh sentinel.

    A real shard loss is invisible to the host except through silence: the
    shard's attention row (its heartbeat) stops advancing. This injector
    reproduces that signature on a healthy mesh by rewriting the
    host-observed copy of the per-shard attention words ([n_shards,
    ATT_WORDS]): a chaos-chosen shard's row freezes at its last pre-fault
    observation. Device state is never touched; with `enabled=False` (or
    zero rates) the filter is the identity.

    Two fault kinds, both keyed on the (step, shard) schedule:

      loss_rate   permanent: the shard dies at its first scheduled step
                  and its row freezes for good (preemption)
      stall_rate  transient: the row freezes for `stall_steps` observed
                  steps, then thaws (a GC pause, a slow collective)
    """

    def __init__(self, seed: int, n_shards: int, loss_rate: float = 0.0,
                 stall_rate: float = 0.0, stall_steps: int = 4,
                 enabled: bool = True):
        self.seed = int(seed)
        self.n_shards = int(n_shards)
        self.loss_rate = float(loss_rate)
        self.stall_rate = float(stall_rate)
        self.stall_steps = int(stall_steps)
        self.enabled = bool(enabled)
        self._loss_at = {}        # shard -> first scheduled loss step
        self._loss_scanned = 0    # steps [0, _loss_scanned) already hashed
        self._frozen = {}         # shard -> frozen attention row (np copy)
        self._prev = {}           # shard -> last observed row (np copy)

    def lost_at(self, shard: int, upto_step: int):
        """First scheduled loss step for `shard` that is <= upto_step, or
        None: a pure function of (seed, schedule)."""
        if self.loss_rate <= 0.0:
            return None
        if upto_step >= self._loss_scanned:
            steps = np.arange(self._loss_scanned, upto_step + 1,
                              dtype=np.uint32)
            for s in range(self.n_shards):
                if s in self._loss_at:
                    continue
                hits = chaos_hit_np(self.seed, steps,
                                    np.full_like(steps, s),
                                    self.loss_rate, LOSS_SALT)
                idx = np.nonzero(hits)[0]
                if idx.size:
                    self._loss_at[s] = int(steps[idx[0]])
            self._loss_scanned = upto_step + 1
        at = self._loss_at.get(shard)
        return at if at is not None and at <= upto_step else None

    def _stalled(self, shard: int, step: int) -> bool:
        if self.stall_rate <= 0.0:
            return False
        lo = max(0, step - self.stall_steps + 1)
        steps = np.arange(lo, step + 1, dtype=np.uint32)
        return bool(chaos_hit_np(self.seed, steps, np.full_like(steps, shard),
                                 self.stall_rate, STALL_SALT).any())

    def filter_attention(self, att: np.ndarray) -> np.ndarray:
        """Apply the fault schedule to one host-observed attention fetch:
        rows of lost or stalled shards are replaced by their last healthy
        observation (a frozen heartbeat); everything else passes through.
        The identity when disabled."""
        if not self.enabled or (self.loss_rate <= 0.0
                                and self.stall_rate <= 0.0):
            return att
        att = np.array(att, copy=True).reshape(-1, att.shape[-1])
        from ..batched.supervision import ATT_STEP
        for s in range(min(self.n_shards, att.shape[0])):
            step = int(att[s, ATT_STEP])
            dead = self.lost_at(s, step) is not None
            if dead or self._stalled(s, step):
                if s not in self._frozen:
                    # freeze at the last observation before the fault (the
                    # dying step's completion never reaches the host); a
                    # shard lost before its first drain reports zeros
                    self._frozen[s] = self._prev.get(
                        s, np.zeros_like(att[s]))
                att[s] = self._frozen[s]
            else:
                self._frozen.pop(s, None)  # stall window over: thaw
                self._prev[s] = att[s].copy()
        return att


def inject(target: BatchedBehavior, seed: int, crash_rate: float = 0.0,
           nan_rate: float = 0.0, drop_rate: float = 0.0,
           dup_rate: float = 0.0,
           nan_col: Optional[str] = None) -> BatchedBehavior:
    """Wrap a BatchedBehavior with deterministic fault injection, keyed on
    (seed, ctx.step, ctx.actor_id) and applied after the wrapped receive:

      crash_rate  raise `_failed`: the runtime treats it as a failing
                  receive (the row's update this step is discarded, its
                  emissions suppressed, and its supervisor resolves the
                  failure inside the same step)
      nan_rate    overwrite `nan_col` (default: the first floating state
                  column) with NaN
      drop_rate   suppress all of the row's emissions this step
      dup_rate    copy the slot-0 emission into the last emit slot
                  (needs out_degree >= 2 to differ)

    The returned behavior shares the target's state spec (plus `_failed`
    when crashes are injected), so it replaces the target 1:1.
    """
    if nan_rate > 0:
        col = nan_col
        if col is None:
            for c, (_, dt) in target.state_spec.items():
                if dt.is_floating_point or dt.is_complex:
                    col = c
                    break
        if col is None:
            raise ValueError("nan_rate > 0 needs an inexact state column")
        if col not in target.state_spec:
            raise KeyError(f"unknown nan_col {col!r}")
        nan_col = col

    spec = dict(target.state_spec)
    if crash_rate > 0:
        spec.setdefault("_failed", ((), torch.bool))
    inner = target.receive

    def receive(state, delivered, ctx):
        new_state, emit = inner(state, delivered, ctx)
        lane = ctx.actor_id
        if crash_rate > 0:
            hit = chaos_hit(seed, ctx.step, lane, crash_rate, CRASH_SALT)
            new_state = dict(new_state)
            failed = new_state.get("_failed")
            new_state["_failed"] = hit if failed is None else failed | hit
        if nan_rate > 0:
            hit = chaos_hit(seed, ctx.step, lane, nan_rate, NAN_SALT)
            new_state = dict(new_state)
            v = new_state[nan_col]
            new_state[nan_col] = torch.where(rows(hit, v), float("nan"), v)
        if drop_rate > 0 or dup_rate > 0:
            emit = emit.with_type()
            if dup_rate > 0:
                hit = chaos_hit(seed, ctx.step, lane, dup_rate, DUP_SALT)
                dup = hit & emit.valid[:, 0]
                emit = Emit(*(_dup_last(x, dup) for x in emit))
            if drop_rate > 0:
                hit = chaos_hit(seed, ctx.step, lane, drop_rate,
                                DROP_SALT)[:, None]
                emit = Emit(dst=torch.where(hit, -1, emit.dst),
                            payload=emit.payload,
                            valid=emit.valid & ~hit,
                            type=emit.type)
        return new_state, emit

    return dataclasses.replace(target, state_spec=spec, receive=receive)


def _dup_last(col: torch.Tensor, dup: torch.Tensor) -> torch.Tensor:
    """An [n, K, ...] emit column with slot 0 copied into slot K-1 on the
    rows of `dup` (for `valid`, the copy of a valid slot 0 is True)."""
    out = col.clone()
    out[:, -1] = torch.where(rows(dup, col[:, 0]), col[:, 0], col[:, -1])
    return out
