"""CUDA graphs of the batched step: the port's compiled step.

The reference compiles its step, its fused flush+step and `run(n)` as
donated `jax.jit` programs (`akka_tpu/batched/core.py`), and its sharded
`run` as one jitted `multi_step` scan (`akka_tpu/batched/sharded.py`).
On a card the port captures one step (the attention word included) as a
CUDA graph and replays it: `run(n)` is n replays, one host launch each
instead of the ~50-170 eager launches of a step.

A graph holds device addresses, so the systems keep their carry in place
(every carried tensor keeps its storage across steps, the port's form of
donation) and read no host data inside the step. Capture follows
PyTorch's recipe: a system's first capture is preceded by eager warm-up
steps on a side stream, over clones of the carry, so that every kernel
module is loaded and every cache the step reads is filled while the live
carry stays untouched; the capture itself runs nothing. Captures use
`capture_error_mode="thread_local"`, so a synchronising call of another
thread (the gateway's admission poll reads device counters) neither
fails nor invalidates a capture in progress.

A step that cannot be captured (a behavior that reads a tensor's value
with `.item()`, or copies host data to the card) raises
`GraphCaptureError`, naming the behavior where it can; nothing falls back
to eager.

Launch accounting: the ring-mailbox wrappers count at capture, where no
kernel launches. `capture` takes those counts back and records how many
K1/K2 launches the graph holds; `StepGraph.replay` adds them per replay,
so `cuda_mailbox.LAUNCHES` counts the launches the card really ran.
"""

from __future__ import annotations

import copy
import threading
import time
from typing import Callable, Dict, Optional

import torch

from ..ops import cuda_mailbox

# eager warm-up steps on clones before a system's first capture
WARM_STEPS = 3

_state = threading.local()


class GraphCaptureError(RuntimeError):
    """The step could not be captured as a CUDA graph."""


def capturing() -> bool:
    """True while this thread captures a step."""
    return getattr(_state, "capturing", False)


class StepGraph:
    """One captured step and the ring-kernel launches it holds."""

    __slots__ = ("graph", "launches")

    def __init__(self, graph, launches: Dict[str, int]):
        self.graph = graph
        self.launches = launches

    def replay(self, n: int = 1) -> None:
        """n replays on the current stream (one host launch each)."""
        for _ in range(n):
            self.graph.replay()
        for k, v in self.launches.items():
            cuda_mailbox.LAUNCHES[k] += v * n


def warm(step: Callable[[], None], device: torch.device,
         steps: int = WARM_STEPS) -> None:
    """Run `step` (over clones: the caller's concern) `steps` times on a
    side stream, and make the current stream wait for it."""
    if device.type != "cuda":
        for _ in range(steps):
            step()
        return
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        for _ in range(steps):
            step()
    cur.wait_stream(side)


def capture(step: Callable[[], None], device: torch.device, pool,
            label: str) -> StepGraph:
    """Capture one call of `step` as a CUDA graph in memory pool `pool`
    (shared by a system's graphs, which never run concurrently and keep
    no output in it). Raises GraphCaptureError if the step synchronises
    with the host or reads host memory."""
    before = dict(cuda_mailbox.LAUNCHES)
    graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize(device)
    stream = torch.cuda.Stream(device)
    _state.capturing = True
    try:
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=pool,
                                capture_error_mode="thread_local")
            try:
                step()
            except BaseException as e:
                _abandon(graph, device, pool)
                if isinstance(e, GraphCaptureError) or \
                        not isinstance(e, Exception):
                    raise  # named already, or an interrupt
                raise GraphCaptureError(
                    f"{label}: the step cannot be captured as a CUDA "
                    f"graph: {e}") from e
            graph.capture_end()
    finally:
        _state.capturing = False
        held = {k: cuda_mailbox.LAUNCHES[k] - before[k] for k in before}
        cuda_mailbox.LAUNCHES.update(before)
    return StepGraph(graph, {k: v for k, v in held.items() if v})


def _abandon(graph, device: torch.device, pool) -> None:
    """End a capture that an error invalidated, and stop the caching
    allocator from serving the capture stream out of `pool` (the failed
    `capture_end` leaves that to its caller); the pool is not reused."""
    try:
        graph.capture_end()
    except RuntimeError:
        pass  # the error invalidated the capture
    end = getattr(torch._C, "_cuda_endAllocateToPool", None) or \
        getattr(torch._C, "_cuda_endAllocateCurrentStreamToPool", None)
    if end is not None:
        index = device.index if device.index is not None \
            else torch.cuda.current_device()
        try:
            end(index, pool)
        except RuntimeError:
            pass  # capture_end already ended it


class GraphSet:
    """A system's captured steps, keyed by what their addresses and shapes
    depend on (the reference's jit is keyed on its argument shapes), with
    the capture counts and times it prints."""

    def __init__(self, device: torch.device, label: str):
        self.device = device
        self.label = label
        self.graphs: Dict[object, StepGraph] = {}
        self.pool = None
        self.warmed = False
        self.captures = 0
        self.capture_ms = 0.0
        self.warm_ms = 0.0

    def get(self, key, step: Callable[[], None],
            warm_up: Optional[Callable[[], None]] = None) -> StepGraph:
        """The graph of `key`, captured now if missing. `warm_up` runs
        before the set's first capture only."""
        g = self.graphs.get(key)
        if g is not None:
            return g
        if not self.warmed and warm_up is not None:
            t0 = time.perf_counter()
            warm_up()
            self.warm_ms += (time.perf_counter() - t0) * 1e3
        self.warmed = True
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        t0 = time.perf_counter()
        try:
            g = capture(step, self.device, self.pool, f"{self.label} {key}")
        except GraphCaptureError:
            self.pool = None  # a failed capture's pool is not reused
            raise
        self.capture_ms += (time.perf_counter() - t0) * 1e3
        self.captures += 1
        self.graphs[key] = g
        return g

    def clear(self) -> None:
        """Drop every graph, once none is in flight (their pool memory goes
        with them, and the next capture takes a new pool)."""
        if self.graphs:
            torch.cuda.synchronize(self.device)
            self.graphs.clear()
        self.pool = None

    def stats(self) -> Dict[str, float]:
        return {"captures": self.captures, "capture_ms": self.capture_ms,
                "warm_ms": self.warm_ms, "graphs": len(self.graphs)}


def shadow_of(system, fields):
    """A shallow copy of `system` whose carry (state columns and `fields`)
    is cloned: stepping it leaves the system's own tensors untouched."""
    shadow = copy.copy(system)
    shadow.state = {k: v.clone() for k, v in system.state.items()}
    for f in fields:
        setattr(shadow, f, getattr(system, f).clone())
    return shadow
