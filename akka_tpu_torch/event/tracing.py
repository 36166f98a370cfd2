"""Causal tracing: sampled request → wave → device-step spans.

A copy of `akka_tpu/event/tracing.py` (the port keeps its own copy of
every module it needs). `DeviceShardRegion.attach_tracer` wires a
`Tracer` into the region's ask engine (the gateway calls it when its
server has a tracer); the gateway and the ask front end use the context
helpers and `NOOP_SPAN`, and `tools/trace_export.py` merges the spans
with the flight recorder's events into one Perfetto document.

The flight recorder (flight_recorder.py) answers "what happened" as
discrete events; the metrics plane (metrics.py) answers "how is the
system doing" as aggregates on the shared `ATT_STEP` axis. Neither can
answer "what happened to THIS request" once a user-visible latency is
assembled from five asynchronous stages (decode, admission, wave
scheduling, shared step rounds, promise readback). This module is the
missing causal side: a span layer whose records carry

- identity: `trace` / `span` / `parent` ids (u64; a trace is one
  external request's journey),
- both clocks: wall `ts` at start plus monotonic `t0`/`t1` (the
  converter's alignment axis — flight-recorder rows carry the same
  `ts_mono`),
- the device step window: `step0`/`step1` on the `ATT_STEP` axis, so a
  span lines up with histograms and FR events without clock guessing.

Sampling is HEAD-BASED: one decision per trace, made at ingress, and the
decision is a pure function of the (deterministically generated) trace
id — same seed ⇒ same sampled set, which is what the tier-1 determinism
test pins. Unsampled requests get trace id 0 and every downstream hook
degrades to one predicate check (the FR noop contract: ≤1% quiet
overhead). `akka.tracing.force-tenants` / `force-request-ids` flip the
decision to "always" for debugging one tenant or one known-bad id.

Context propagates two ways:

- a `contextvars.ContextVar` carries the current span across call
  boundaries in one thread; `AskBatcher.submit` snapshots it into the
  `BatchAsk` so the trace survives the dispatcher thread hop,
- columnar waves (the binary window path) carry an explicit per-member
  ctx list — one window holds many traces, so a single ambient ctx
  cannot represent it.

Sinks mirror the flight recorder: a bounded in-memory ring (tests,
post-mortem) plus an optional JSONL file with the same writer
discipline (makedirs, line-buffered append, lock, close is idempotent).
Selection mirrors the FR SPI: `from_config` returns None unless
`akka.tracing.enabled` — a system without tracing holds no tracer and
pays one `is not None` per hook.
"""

from __future__ import annotations

import contextvars
import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

__all__ = ["SpanCtx", "Span", "Tracer", "NOOP_SPAN", "current_ctx",
           "set_ctx", "reset_ctx", "from_config"]

_M64 = (1 << 64) - 1

# the ambient span (one per thread of control): gateway roots set it,
# AskBatcher.submit snapshots it across the thread hop
_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "akka_tpu_torch_trace_ctx", default=None)


def current_ctx() -> Optional["SpanCtx"]:
    """The calling thread's current span context (None outside any
    sampled span) — the one read `AskBatcher.submit` pays per ask."""
    return _CURRENT.get()


def set_ctx(ctx) -> Any:
    """Install `ctx` as the ambient span context; returns the reset
    token. The explicit form of entering a span block, for callers that
    carry a ctx across an API boundary (columnar waves of one)."""
    return _CURRENT.set(ctx)


def reset_ctx(token) -> None:
    _CURRENT.reset(token)


def _splitmix64(x: int) -> int:
    """Deterministic id stream (the SplitMix64 finalizer): seed + ordinal
    in, well-mixed u64 out. Chosen over random.getrandbits so the same
    seed reproduces the same trace ids AND the same sampled set."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    z = x
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return (z ^ (z >> 31)) & _M64


class SpanCtx:
    """Immutable (trace, span) pair — what crosses thread/wave hops."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: int, span_id: int):
        self.trace_id = trace_id
        self.span_id = span_id

    def __repr__(self) -> str:
        return f"SpanCtx(trace={self.trace_id:#x}, span={self.span_id})"


class _NoopSpan:
    """The quiet-path span: every method is a no-op, `child` returns
    itself, so an unsampled request walks the whole serving path paying
    attribute reads and empty calls only."""

    __slots__ = ()
    ctx = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def begin(self, current: bool = False):
        return self

    def finish(self, **attrs) -> None: ...

    def set(self, **attrs) -> None: ...

    def child(self, name: str, **attrs):
        return self


NOOP_SPAN = _NoopSpan()


class Span:
    """One timed region of one trace. Use as a context manager (sets the
    ambient ctx for the block) or via begin()/finish() when the lifetime
    does not nest lexically (per-member engine spans, columnar roots)."""

    __slots__ = ("_tracer", "name", "trace_id", "span_id", "parent_id",
                 "ts", "t0", "t1", "step0", "step1", "attrs", "_token")

    def __init__(self, tracer: "Tracer", name: str, trace_id: int,
                 span_id: int, parent_id: int, attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.ts = 0.0
        self.t0 = 0.0
        self.t1 = 0.0
        self.step0 = 0
        self.step1 = 0
        self.attrs = attrs
        self._token = None

    @property
    def ctx(self) -> SpanCtx:
        return SpanCtx(self.trace_id, self.span_id)

    def begin(self, current: bool = False) -> "Span":
        self.ts = time.time()
        self.t0 = time.monotonic()
        self.step0 = self._tracer._step()
        if current:
            self._token = _CURRENT.set(self.ctx)
        return self

    def finish(self, **attrs) -> None:
        if attrs:
            self.attrs.update(attrs)
        self.t1 = time.monotonic()
        self.step1 = self._tracer._step()
        if self._token is not None:
            _CURRENT.reset(self._token)
            self._token = None
        self._tracer._emit(self)

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def child(self, name: str, **attrs) -> "Span":
        return self._tracer.span(name, self.ctx, **attrs)

    def __enter__(self) -> "Span":
        return self.begin(current=True)

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        self.finish()
        return False


class Tracer:
    """Head-sampled span recorder. Thread-safe; every public hook is
    fire-and-forget and must never raise into the serving path."""

    enabled = True

    def __init__(self, sample_rate: float = 1.0, seed: int = 0,
                 jsonl_path: Optional[str] = None, capacity: int = 8192,
                 step_fn: Optional[Callable[[], int]] = None,
                 force_tenants=(), force_request_ids=()):
        rate = min(max(float(sample_rate), 0.0), 1.0)
        self._rate_ppm = int(round(rate * 1_000_000))
        self.sample_rate = rate
        self._seed = int(seed) & _M64
        self._ordinal = 0
        self._span_seq = 0
        self.step_fn = step_fn
        self._force_tenants = frozenset(str(t) for t in force_tenants)
        self._force_ids = frozenset(int(i) for i in force_request_ids)
        self._lock = threading.Lock()
        self._buf: deque = deque(maxlen=capacity)
        self._path = jsonl_path
        self._fh = None
        if jsonl_path:
            os.makedirs(os.path.dirname(os.path.abspath(jsonl_path)),
                        exist_ok=True)
            self._fh = open(jsonl_path, "a", buffering=1)

    # ------------------------------------------------------------- sampling
    def sampled(self, trace_id: int) -> bool:
        """The head decision as a pure function of the trace id (ppm
        threshold on a well-mixed u64): deterministic per seed."""
        return (trace_id % 1_000_000) < self._rate_ppm

    def start_trace(self, tenant: Optional[str] = None,
                    request_id: Optional[int] = None) -> int:
        """Mint the next trace id and decide ONCE whether this trace is
        recorded: returns the (nonzero) trace id when sampled or forced,
        else 0 — and 0 is the one value every downstream hook checks."""
        with self._lock:
            self._ordinal += 1
            tid = _splitmix64(self._seed ^ self._ordinal)
        if tid == 0:  # reserve 0 for "unsampled"
            tid = 1
        if self.sampled(tid):
            return tid
        if tenant is not None and tenant in self._force_tenants:
            return tid
        if request_id is not None and int(request_id) in self._force_ids:
            return tid
        return 0

    # ---------------------------------------------------------------- spans
    def span(self, name: str, trace, parent: Optional[int] = None,
             **attrs):
        """Make an (unstarted when used via begin(); started on __enter__)
        span. `trace` is a trace id (int) or a SpanCtx; falsy ⇒ the noop
        span. With no explicit parent, a SpanCtx parents to its span and
        an int trace id parents to the ambient ctx when the trace
        matches (lexical nesting for free)."""
        if not trace:
            return NOOP_SPAN
        if isinstance(trace, SpanCtx):
            trace_id = trace.trace_id
            if parent is None:
                parent = trace.span_id
        else:
            trace_id = int(trace)
            if parent is None:
                cur = _CURRENT.get()
                parent = cur.span_id \
                    if cur is not None and cur.trace_id == trace_id else 0
        with self._lock:
            self._span_seq += 1
            sid = self._span_seq
        return Span(self, name, trace_id, sid, int(parent), dict(attrs))

    def begin(self, name: str, trace, parent: Optional[int] = None,
              current: bool = False, **attrs):
        """span() + begin() in one call — the non-lexical entry point."""
        return self.span(name, trace, parent, **attrs).begin(current)

    def emit(self, name: str, trace, t0: float, t1: float,
             parent: Optional[int] = None, step0: int = 0,
             step1: int = 0, **attrs) -> None:
        """Retro-emit a completed span from explicit timestamps (the
        engine's per-member spans: staged at one loop turn, resolved at
        a later one — no lexical block to wrap)."""
        sp = self.span(name, trace, parent, **attrs)
        if sp is NOOP_SPAN:
            return
        sp.ts = time.time() - (time.monotonic() - t0)
        sp.t0, sp.t1 = float(t0), float(t1)
        sp.step0, sp.step1 = int(step0), int(step1)
        self._emit(sp)

    def _step(self) -> int:
        fn = self.step_fn
        if fn is None:
            return 0
        try:
            return int(fn())
        except Exception:  # noqa: BLE001 — tracing must never raise
            return 0

    def _emit(self, span: Span) -> None:
        row = {"kind": "span", "name": span.name, "trace": span.trace_id,
               "span": span.span_id, "parent": span.parent_id,
               "ts": span.ts, "t0": span.t0, "t1": span.t1,
               "step0": span.step0, "step1": span.step1}
        if span.attrs:
            row.update(span.attrs)
        with self._lock:
            self._buf.append(row)
            if self._fh is not None:
                try:
                    self._fh.write(json.dumps(row, default=str) + "\n")
                except ValueError:  # closed file mid-shutdown
                    pass

    # ---------------------------------------------------------------- sinks
    def spans(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._buf)

    def of_trace(self, trace_id: int) -> List[Dict[str, Any]]:
        """Request-journey query: every span of one trace (exporter (a):
        the span JSONL is keyed by the same `trace` field)."""
        return [s for s in self.spans() if s["trace"] == trace_id]

    def of_name(self, name: str) -> List[Dict[str, Any]]:
        return [s for s in self.spans() if s["name"] == name]

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except Exception:  # noqa: BLE001
                    pass
                self._fh = None


def from_config(config) -> Optional[Tracer]:
    """`akka.tracing.enabled` gates the layer (default off ⇒ None — the
    quiet path is one `is not None`). With it on: `sample-rate` (0..1),
    `jsonl-path` for the span sink, `seed` for the deterministic id
    stream, `force-tenants` / `force-request-ids` for debugging."""
    if config is None or not config.get_bool("akka.tracing.enabled", False):
        return None
    return Tracer(
        sample_rate=config.get_float("akka.tracing.sample-rate", 1.0),
        seed=config.get_int("akka.tracing.seed", 0),
        jsonl_path=config.get_string("akka.tracing.jsonl-path", "") or None,
        capacity=config.get_int("akka.tracing.capacity", 8192),
        force_tenants=config.get_list("akka.tracing.force-tenants", []),
        force_request_ids=config.get_list(
            "akka.tracing.force-request-ids", []))
