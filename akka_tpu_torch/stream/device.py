"""Device pipelines: tensor-shaped streams run as one captured step.

Port of `akka_tpu/stream/device.py` (commit 001ef4f). The reference fuses
a chain of per-chunk tensor ops into one jitted function and runs stacked
chunks as one `lax.scan`. The port runs the chain over the chunks one by
one: on a card the chain is captured once per chunk shape as a CUDA graph
(static input and carry buffers, eager warm-up on a side stream first,
as batched/graphs.py captures the batched step) and replayed per chunk,
one host launch for the whole chain; on the CPU it runs eagerly. A chain
that cannot be captured (an op that reads a value on the host, or makes
a data-dependent shape) raises `GraphCaptureError` naming the op; it
never runs eagerly on a card instead.

Filter semantics are mask-based, as in the reference: chunks keep their
shape, `filter` zeroes failing lanes (later ops see zeros) and threads a
validity mask, and `compact()` drops invalid lanes on the host.

The scan carry may be a tensor or a tuple, list or dict of tensors, as a
`lax.scan` carry may be. Like `lax.scan`'s, its dtypes are fixed by the
initial carry: each step's new carry is cast to them (torch widens an
int32 sum to int64 where jnp keeps int32).

`as_flow()` turns the pipeline into an operator of the host stream DSL:
a `Flow().map` that runs the same step per element, a CUDA-graph replay
on a card, and threads the carry across elements.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from ..batched import graphs
from ..utils.device import resolve_device


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_zip(fn, a, b):
    """fn over matching leaves of two trees of one structure."""
    if isinstance(a, dict):
        return {k: _tree_zip(fn, a[k], b[k]) for k in a}
    if isinstance(a, (tuple, list)):
        return type(a)(_tree_zip(fn, x, y) for x, y in zip(a, b))
    return fn(a, b)


def _signature(tree):
    """What a captured step's buffers depend on: structure, shapes and
    dtypes of the tensor leaves."""
    if isinstance(tree, dict):
        return ("d",) + tuple((k, _signature(v)) for k, v in tree.items())
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__,) + tuple(_signature(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype)
    return ("const", tree)


def _fix_carry(new, old):
    """The new carry in the initial carry's dtypes (lax.scan's fixed
    carry type); non-tensor leaves stay as they were."""
    if isinstance(old, torch.Tensor):
        return torch.as_tensor(new, device=old.device).to(old.dtype)
    return old


class _Slot:
    """One captured chain: its static buffers and its graph."""

    __slots__ = ("x_in", "carry", "out", "mask", "graph")


class _GraphStep:
    """The chain as CUDA graphs, one per (chunk shape, dtype, carry
    signature). Calling it runs one chunk: the carry and chunk are copied
    into the static buffers, the graph replays, clones come back."""

    def __init__(self, step, device: torch.device):
        self.step = step
        self.device = device
        self.slots = {}
        self.captures = 0

    def slot(self, carry, chunk: torch.Tensor) -> _Slot:
        key = (tuple(chunk.shape), chunk.dtype, _signature(carry))
        s = self.slots.get(key)
        if s is not None:
            return s
        s = _Slot()
        s.x_in = chunk.clone()
        s.carry = _tree_map(
            lambda t: t.clone() if isinstance(t, torch.Tensor) else t, carry)
        shadow_x = s.x_in.clone()
        shadow_c = _tree_map(
            lambda t: t.clone() if isinstance(t, torch.Tensor) else t, carry)
        graphs.warm(lambda: self.step(shadow_c, shadow_x), self.device)

        def body():
            new, (out, mask) = self.step(s.carry, s.x_in)
            _tree_zip(lambda dst, src: dst.copy_(src)
                      if isinstance(dst, torch.Tensor) else None,
                      s.carry, new)
            s.out, s.mask = out, mask

        # a pool of the slot's own: its outputs stay live between replays
        s.graph = graphs.capture(body, self.device,
                                 torch.cuda.graph_pool_handle(),
                                 "DevicePipeline")
        self.captures += 1
        self.slots[key] = s
        return s

    @staticmethod
    def load(s: _Slot, carry) -> None:
        _tree_zip(lambda dst, src: dst.copy_(src)
                  if isinstance(dst, torch.Tensor) else None, s.carry, carry)

    def __call__(self, carry, chunk: torch.Tensor):
        s = self.slot(carry, chunk)
        self.load(s, carry)
        s.x_in.copy_(chunk)
        s.graph.replay()
        clone = lambda t: t.clone() if isinstance(t, torch.Tensor) else t  # noqa: E731
        return _tree_map(clone, s.carry), (s.out.clone(), s.mask.clone())


def _uniform(seq):
    """The chunks of `seq`, each checked against the first's shape and
    dtype: a graph replay would otherwise broadcast or cast a ragged
    chunk into the captured input buffer."""
    first = None
    for i, x in enumerate(seq):
        if first is None:
            first = (x.shape, x.dtype)
        elif (x.shape, x.dtype) != first:
            raise ValueError(
                f"DevicePipeline.run: chunk {i} is {tuple(x.shape)} "
                f"{x.dtype}, chunk 0 {tuple(first[0])} {first[1]}")
        yield x


class DevicePipeline:
    """Chain of per-chunk tensor ops run as one step per chunk.

    ops:
    - map(fn):        chunk -> chunk (elementwise or any shape-preserving op)
    - filter(pred):   pred(chunk) -> bool mask over the leading axis;
                      failing lanes are zeroed and masked out
    - scan(fn, init): stateful across chunks: fn(carry, chunk) -> (carry, out)

    device: where the chain runs; defaults to CUDA and raises without a
    card unless device="cpu" is passed. Chunks are moved there.
    """

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._ops: List[Tuple] = []
        self._scan_init = None
        self._has_scan = False
        self._compiled = None
        # graph replays on a card; a comparison's eager twin sets this
        self._eager = self.device.type != "cuda"

    # -- builders (return self for chaining) ---------------------------------
    def map(self, fn: Callable) -> "DevicePipeline":
        self._ops.append(("map", fn))
        self._compiled = None
        return self

    def filter(self, pred: Callable) -> "DevicePipeline":
        self._ops.append(("filter", pred))
        self._compiled = None
        return self

    def scan(self, fn: Callable, init: Any) -> "DevicePipeline":
        if self._has_scan:
            raise ValueError("one scan per pipeline")
        self._ops.append(("scan", fn))
        self._scan_init = init
        self._has_scan = True
        self._compiled = None
        return self

    # -- compile --------------------------------------------------------------
    def _build_step(self):
        ops = list(self._ops)

        def call(i, kind, fn, *args):
            try:
                return fn(*args)
            except Exception as e:
                if not graphs.capturing():
                    raise
                name = getattr(fn, "__name__", type(fn).__name__)
                raise graphs.GraphCaptureError(
                    f"DevicePipeline op {i} ({kind} {name}) cannot be "
                    f"captured as a CUDA graph: {e}") from e

        def step(carry, chunk):
            mask = torch.ones((chunk.shape[0],), dtype=torch.bool,
                              device=chunk.device)
            x = chunk
            for i, (kind, fn) in enumerate(ops):
                if kind == "map":
                    x = call(i, kind, fn, x)
                elif kind == "filter":
                    keep = call(i, kind, fn, x).to(torch.bool)
                    mask = mask & keep
                    # zero failing lanes so later ops see neutral values
                    keep = keep.reshape((x.shape[0],) + (1,) * (x.dim() - 1))
                    x = torch.where(keep, x, torch.zeros_like(x))
                else:  # scan
                    new, x = call(i, kind, fn, carry, x)
                    carry = _tree_zip(_fix_carry, new, carry)
            return carry, (x, mask)
        return step

    def compile(self):
        """The chain as one callable step(carry, chunk) -> (carry, (out,
        mask)): on a card a CUDA graph per chunk shape, captured at its
        first call; on the CPU (or in an eager twin) the eager chain."""
        if self._compiled is None:
            step = self._build_step()
            self._compiled = step if self._eager \
                else _GraphStep(step, self.device)
        return self._compiled

    def _initial_carry(self):
        if self._scan_init is None:
            return 0
        return _tree_map(lambda v: torch.as_tensor(v, device=self.device),
                         self._scan_init)

    # -- run ------------------------------------------------------------------
    def run(self, chunks) -> Tuple[Any, Any, Any]:
        """Run over chunks: a stacked tensor or array [n_chunks, ...], or
        an iterable of chunks, which must share one shape and dtype (a
        ragged one raises ValueError, as stacking it would). Returns
        (outputs, masks, final_carry) with outputs [n_chunks, ...] and
        masks [n_chunks, chunk_len] stacked."""
        step = self.compile()
        carry = self._initial_carry()
        if isinstance(chunks, (torch.Tensor, np.ndarray)) and \
                chunks.ndim >= 2:
            xs = torch.as_tensor(chunks).to(self.device)
            seq = (xs[i] for i in range(xs.shape[0]))
            n = xs.shape[0]
        else:
            seq = _uniform(torch.as_tensor(c).to(self.device)
                           for c in chunks)
            n = None
        if isinstance(step, _GraphStep):
            return self._replay(step, carry, seq, n)
        outs, masks = [], []
        for x in seq:
            carry, (out, mask) = step(carry, x)
            outs.append(out)
            masks.append(mask)
        return torch.stack(outs), torch.stack(masks), carry

    @staticmethod
    def _replay(step: _GraphStep, carry, seq, n: Optional[int]):
        """One replay per chunk over the static buffers; the carry stays
        in the graph's buffer between chunks."""
        outs = masks = None
        kept: List[Tuple[torch.Tensor, torch.Tensor]] = []
        s = None
        for i, x in enumerate(seq):
            if s is None:
                s = step.slot(carry, x)
                step.load(s, carry)
            s.x_in.copy_(x)
            s.graph.replay()
            if n is None:
                kept.append((s.out.clone(), s.mask.clone()))
                continue
            if outs is None:
                outs = s.out.new_empty((n,) + tuple(s.out.shape))
                masks = s.mask.new_empty((n,) + tuple(s.mask.shape))
            outs[i].copy_(s.out)
            masks[i].copy_(s.mask)
        if s is None:
            raise ValueError("DevicePipeline.run: no chunks")
        if n is None:
            outs = torch.stack([o for o, _ in kept])
            masks = torch.stack([m for _, m in kept])
        final = _tree_map(
            lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
            s.carry)
        return outs, masks, final

    @staticmethod
    def compact(outs, masks) -> np.ndarray:
        """Host side: drop masked-out lanes and flatten chunk structure."""
        if isinstance(outs, torch.Tensor):
            outs = outs.cpu().numpy()
        if isinstance(masks, torch.Tensor):
            masks = masks.cpu().numpy()
        o = np.asarray(outs)
        m = np.asarray(masks).astype(bool)
        flat_o = o.reshape((-1,) + o.shape[2:])
        return flat_o[m.reshape(-1)]

    # -- host-stream integration ---------------------------------------------
    def as_flow(self):
        """A Flow operator running this pipeline per stream element (each
        element is one chunk, moved to the pipeline's device); emits
        (out_chunk, mask) pairs. The carry is threaded across elements, a
        stateful fused stage. The step is `compile()`'s, as `run` uses it:
        a CUDA graph replay on a card, the eager chain only on the CPU or
        in an eager twin."""
        from .dsl import Flow
        step = self.compile()
        state = {"carry": self._initial_carry()}

        def apply(chunk):
            x = torch.as_tensor(chunk, device=self.device)
            state["carry"], (out, mask) = step(state["carry"], x)
            return out, mask
        return Flow().map(apply)
