"""Batched behaviors: per-actor update functions written over the batch.

Port of `akka_tpu/batched/behavior.py`. The reference writes a behavior as
scalar JAX for one actor and vmaps it; here the batch dimension is written
out. `receive(state_cols, inbox, ctx)` gets `[n, ...]` state columns, an
`Inbox` of `[n, P]`/`[n]` tensors (or a slots-mode `Mailbox` of
`[n, S, ...]` tensors) and `ctx.actor_id: [n]`, and returns `[n, ...]`
columns and an `Emit` of `[n, K]` tensors.

The runtime evaluates every behavior on all rows and selects by behavior
id, as the reference's vmapped `lax.switch` does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch


def tree_map(fn, *trees):
    """Map over matching tensors of nested dicts/tuples/lists (the carry
    of `Mailbox.fold`)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (tuple, list)):
        out = [tree_map(fn, *parts) for parts in zip(*trees)]
        return type(first)(*out) if hasattr(first, "_fields") \
            else type(first)(out)
    return fn(*trees)


def rows(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Broadcast an [n] row mask against an [n, ...] column."""
    return mask.reshape(mask.shape + (1,) * (like.dim() - 1))


class Inbox(NamedTuple):
    """What each actor sees from one step's reduce delivery."""

    sum: torch.Tensor    # [n, P] segment-sum of payloads addressed to a row
    max: torch.Tensor    # [n, P] segment-max
    count: torch.Tensor  # [n] int32 number of messages delivered


class Mailbox(NamedTuple):
    """Each actor's per-message mailbox for one step (slots mode): up to S
    discrete messages in arrival order; slot i is older than slot i+1."""

    types: torch.Tensor    # [n, S] int32 message-type tags
    payload: torch.Tensor  # [n, S, P]
    valid: torch.Tensor    # [n, S] bool
    count: torch.Tensor    # [n] int32 messages addressed (may exceed S)
    sum: torch.Tensor      # [n, P] exact sum over ALL addressed messages
    max: torch.Tensor      # [n, P] exact max (zeros unless need_max)

    def fold(self, init_carry, fn):
        """Process slots in FIFO order: fn(carry, mtype [n], payload [n, P])
        -> carry, applied per row only where that slot is valid (a loop
        over S in place of the reference's lax.scan). Returns the final
        carry."""
        carry = init_carry
        for s in range(self.types.shape[1]):
            v = self.valid[:, s]
            new = fn(carry, self.types[:, s], self.payload[:, s])
            carry = tree_map(lambda a, b: torch.where(rows(v, a), a, b),
                             new, carry)
        return carry

    def reduce(self) -> Inbox:
        """Commutative view so reduce-kind behaviors run unmodified inside a
        slots-mode system; the delivery's aggregation covers every
        addressed message, not just the S slot-resident ones."""
        return Inbox(sum=self.sum, max=self.max, count=self.count)


class Emit(NamedTuple):
    """Up to K outgoing messages from each actor in one step."""

    dst: torch.Tensor      # [n, K] int32 recipient ids (global); -1 = none
    payload: torch.Tensor  # [n, K, P]
    valid: torch.Tensor    # [n, K] bool
    type: Any = None       # [n, K] int32 message-type tags (None -> zeros)

    @staticmethod
    def none(n: int, out_degree: int, payload_width: int,
             dtype=torch.float32, device=None) -> "Emit":
        return Emit(
            dst=torch.full((n, out_degree), -1, dtype=torch.int32,
                           device=device),
            payload=torch.zeros((n, out_degree, payload_width), dtype=dtype,
                                device=device),
            valid=torch.zeros((n, out_degree), dtype=torch.bool,
                              device=device),
            type=torch.zeros((n, out_degree), dtype=torch.int32,
                             device=device))

    @staticmethod
    def single(dst, payload, out_degree: int, payload_width: int,
               when=True, dtype=torch.float32, mtype=0) -> "Emit":
        """One message per row in slot 0, the rest empty. dst: [n];
        payload: [n, w] or [w] (w <= payload_width, zero-padded), a tensor
        or Python numbers; when: [n] bool or a Python bool; mtype: int or
        [n]. Python values are written with fills, never copied from host
        memory, so the step stays capturable as a CUDA graph."""
        dst = torch.as_tensor(dst)
        n, dev = dst.shape[0], dst.device
        e = Emit.none(n, out_degree, payload_width, dtype, dev)
        if isinstance(payload, torch.Tensor) or \
                getattr(payload, "ndim", 0) > 1:
            pl = torch.as_tensor(payload, dtype=dtype, device=dev)
            e.payload[:, 0, :pl.shape[-1]] = pl
        else:
            for j, v in enumerate(_numbers(payload)):
                if v:
                    e.payload[:, 0, j].fill_(v)
        if _is_array(when):
            cond = torch.as_tensor(when, dtype=torch.bool,
                                   device=dev).expand(n)
        else:
            cond = torch.full((n,), bool(when), dtype=torch.bool, device=dev)
        e.dst[:, 0] = torch.where(cond, dst.to(torch.int32), -1)
        e.valid[:, 0] = cond
        if _is_array(mtype):
            e.type[:, 0] = torch.as_tensor(mtype, dtype=torch.int32,
                                           device=dev)
        elif mtype:
            e.type[:, 0].fill_(int(mtype))
        return e

    def with_type(self) -> "Emit":
        """Normalize: a None type column becomes zeros."""
        if self.type is None:
            return self._replace(type=torch.zeros_like(self.dst))
        return self


def _is_array(x) -> bool:
    """A tensor, or a host array with at least one dimension (a Python or
    numpy scalar is not)."""
    return isinstance(x, torch.Tensor) or getattr(x, "ndim", 0) > 0


def _numbers(values) -> list:
    """A Python number or a flat sequence of them (a numpy array too), as
    a list."""
    if hasattr(values, "tolist"):
        values = values.tolist()
    return list(values) if isinstance(values, (list, tuple)) else [values]


class Ctx(NamedTuple):
    """Per-step context, over the batch."""

    actor_id: torch.Tensor  # [n] int32 global ids of the rows
    step: torch.Tensor      # [] int32 global step counter (on the device)
    n_actors: int           # capacity of the actor space
    tables: Any = ()        # runtime lookup tables (dict of small tensors)


@dataclass
class BatchedBehavior:
    """The batched analogue of Behavior[T].

    Two inbox kinds (`inbox`): "reduce" (default) receives the commutative
    `Inbox`; "slots" receives a `Mailbox` of up to S discrete messages in
    per-sender FIFO order. A slots-mode system runs both kinds (reduce
    behaviors get `mailbox.reduce()`); a reduce-mode system rejects slots
    behaviors. A row runs only when its count > 0, unless `always_on`.

    `supervisor` (batched/supervision.py LaneSupervisor) applies a
    fault-handling directive inside the step to rows that set `_failed`.
    `nonfinite_guard` marks a row `_failed` when its new state holds
    NaN/Inf; the pre-failure state is kept, as for a failing receive.
    """

    name: str
    state_spec: Dict[str, Tuple[Tuple[int, ...], Any]]  # col -> (shape, dtype)
    receive: Callable[..., Tuple[Dict[str, torch.Tensor], Emit]]
    always_on: bool = False
    inbox: str = "reduce"  # "reduce" | "slots"
    supervisor: Any = None  # Optional[supervision.LaneSupervisor]
    nonfinite_guard: bool = False

    def init_state(self, n: int, device=None) -> Dict[str, torch.Tensor]:
        return {k: torch.zeros((n,) + tuple(shape), dtype=dtype,
                               device=device)
                for k, (shape, dtype) in self.state_spec.items()}


def behavior(name: str, state_spec: Dict[str, Tuple[Tuple[int, ...], Any]],
             always_on: bool = False, inbox: str = "reduce",
             supervisor: Any = None, nonfinite_guard: bool = False):
    """Decorator: @behavior("counter", {"count": ((), torch.int32)})"""

    def deco(fn) -> BatchedBehavior:
        return BatchedBehavior(name=name, state_spec=state_spec, receive=fn,
                               always_on=always_on, inbox=inbox,
                               supervisor=supervisor,
                               nonfinite_guard=nonfinite_guard)

    return deco
