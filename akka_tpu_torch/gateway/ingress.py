"""Ingress: the framed-TCP front door onto sharded device entities.

Port of `akka_tpu/gateway/ingress.py`. Both transports of the reference
are ported: "stream" (the default: a framed stage graph per connection
over `stream/tcp.py`, which needs the `ActorSystem` the server was given;
`start()` raises ValueError without one) and "evloop" (selector loop
threads, `gateway/evloop.py`, no system needed). The stream transport
binds the configured port once, port 0 included, and reads the bound
address back from its `ServerBinding`; the reference picks a free port
with a throwaway socket first and binds it again, a race. `stop()`
unbinds and waits until nothing listens. In-proc use (`handle_frame`,
`handle_frame_batch`, `submit_frames`) works with either setting. The
admin op `checkpoint` snapshots the region (it needs the region's
`attach_journal`), and a region restored before the gateway comes up
rehydrates the dedup table and the replica cache from its entity
journal; `failover` rebuilds the region on the first `value` shard slots
of its mesh (`DeviceShardRegion.failover`).
`counter_behavior` is written over the batch in torch.

Wire protocol — `simpleFramingProtocol` (stream/framing.py): every frame
is `[u32 big-endian length][body]`, and TWO body encodings coexist on
one connection, sniffed by the first body byte:

- **JSON** (first byte `{`) — the debuggable fallback and the admin
  channel. Requests:

      {"id": 7, "tenant": "t0", "entity": "acct-42", "op": "add",
       "value": 3}

  ops: "add" (apply value, reply new total — the acknowledged write),
  "get" (read total). Replies:

      {"id": 7, "status": "ok", "value": 45.0}
      {"id": 8, "status": "shed", "reason": "rate_limited",
       "retry_after_ms": 120}
      {"id": 9, "status": "error", "reason": "timeout"}

- **Binary** (first byte 0xAB — serialization/frames.py): a versioned
  fixed-schema batch of packed request records. A whole window decodes
  in ONE `np.frombuffer` pass into columns (op, entity, value) that
  feed the columnar ask wave (`RegionBackend.ask_many` ->
  `AskBatcher.ask_many` -> `execute_ask_batch`'s coalesced flush), and
  the reply wave encodes in one vectorized pass — zero per-request
  dict/object construction between wire bytes and the staging slab. A
  batch of one is the solo ask, bit-identical to its JSON twin.

"shed" is the admission layer speaking (typed backpressure — the client
knows why and when to retry); "error" is the runtime (ask timeout or
fault). The operator tenant `__admin` bypasses admission and reaches
control ops (sum / checkpoint / rebalance / failover / artifact / stats)
through the same front door — chaos is injected over the wire, the way
an operator would. Admin ops are JSON-only (a binary frame addressed to
the admin tenant gets a typed error): the operator channel stays
human-readable.

Request path: TCP bytes -> length-field decode -> handle_frame (admission
-> SLO clock -> backend ask) -> length-prefix encode -> TCP bytes. The
per-connection flow is ack-gated by the stream TCP layer (ONE Write in
flight), so a slow consumer throttles the producer instead of growing an
unbounded buffer — tested in tests/test_gateway.py. In-proc transports
(bench, batched load generators) can additionally hand
`handle_frame_batch` a window of frames: contiguous binary frames merge
into one decode + one ask wave.

ONE frame-size limit (`frames.DEFAULT_MAX_FRAME`) is the default at
BOTH ends — the server's framing stages and the client's FrameReader —
so a server-legal reply can never exceed what the client will reassemble
(the 1<<20 / 1<<16 mismatch is gone; pass `max_frame` to both ends
together to change it).

`handle_frame` is transport-free: the tier-1 smoke test and the
gateway-slo bench drive it in-proc; the chaos tier drives it over real
sockets from other OS processes.

Entity hosting: `RegionBackend` adapts a DeviceShardRegion — entities are
rows on the mesh, requests are region asks (reply-to promise row in the
payload's last column), writes are journaled tells (WAL) so acknowledged
writes survive kill -9. The counter entity keeps the reduction
COMMUTATIVE (the dense-inbox contract): "get" is add(0), and the reply is
always the post-apply total.
"""

from __future__ import annotations

import itertools
import json
import random
import socket
import struct
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..batched.bridge import AskPoolExhausted
from ..event.tracing import reset_ctx, set_ctx
from ..serialization import frames
from ..pattern.backoff import backoff_delay
from .admission import AdmissionController
from .dedup import DUPLICATE_INFLIGHT
from .slo import SloTracker

__all__ = ["encode_frame", "encode_body", "FrameReader", "counter_behavior",
           "RegionBackend", "GatewayServer", "GatewayClient",
           "DEFAULT_MAX_FRAME"]

ADMIN_TENANT = "__admin"

# one limit, both ends (see module docstring)
DEFAULT_MAX_FRAME = frames.DEFAULT_MAX_FRAME


# ---------------------------------------------------------------- wire codec
def encode_body(obj: Dict[str, Any]) -> bytes:
    """JSON reply/request body only — the stream encoder stage (or the
    in-proc caller) adds the length prefix."""
    return json.dumps(obj, separators=(",", ":")).encode("utf-8")


def encode_frame(obj: Dict[str, Any]) -> bytes:
    """Length-prefixed JSON frame: the ONE frame-encode helper (shared
    by server, client and the binary path via `frames.frame`)."""
    return frames.frame(encode_body(obj))


class FrameReader:
    """Incremental length-field frame reassembly for raw sockets (the
    client half; servers reuse the stream Framing stages). `feed` yields
    decoded JSON bodies; `feed_raw` yields raw bodies (the binary reply
    path decodes them with frames.decode_replies)."""

    def __init__(self, max_frame: int = DEFAULT_MAX_FRAME):
        self._buf = bytearray()
        self.max_frame = max_frame

    def feed_raw(self, data: bytes):
        self._buf.extend(data)
        while len(self._buf) >= 4:
            n = struct.unpack(">I", self._buf[:4])[0]
            if n > self.max_frame:
                raise ValueError(f"frame of {n} bytes exceeds "
                                 f"{self.max_frame}")
            if len(self._buf) < 4 + n:
                return
            body = bytes(self._buf[4:4 + n])
            del self._buf[:4 + n]
            yield body

    def feed(self, data: bytes):
        for body in self.feed_raw(data):
            yield json.loads(body)


# ------------------------------------------------------------ entity backend
def counter_behavior(payload_width: int, out_degree: int = 1):
    """The serving entity: an event-sourced additive counter. Payload
    [value, ..., reply_row]; the reduction sums concurrent adds (the
    dense-inbox commutative contract) and the reply, [new_total, 0, ...],
    is emitted to the reply-to row (bridge ask convention)."""
    import torch

    from ..batched import Emit, behavior
    from ..batched.bridge import reply_dst
    P, k = payload_width, out_degree

    @behavior("gw_counter", {"total": ((), torch.float32)})
    def counter(state, inbox, ctx):
        got = inbox.count > 0
        new_total = state["total"] + inbox.sum[:, 0]
        reply = torch.zeros((got.shape[0], P), dtype=torch.float32,
                            device=got.device)
        reply[:, 0] = new_total
        return ({"total": torch.where(got, new_total, state["total"])},
                Emit.single(reply_dst(inbox.sum), reply, k, P, when=got))

    return counter


class RegionBackend:
    """Adapts a DeviceShardRegion of counter entities to the gateway:
    ask(entity_id, value) -> new total (acknowledged = applied + WAL'd,
    when the region has attach_journal'd).

    Batched by default: `ask` submits to an AskBatcher
    (sharding/ask_batch.py) and waits on its future, so asks from
    concurrent connections coalesce into shared device step rounds —
    `handle_frame` stays synchronous per connection, batching emerges
    from concurrency. `batch=False` restores the serialized per-ask
    path (the bench A/B baseline); a single caller is bit-identical
    either way (a solo batch runs the exact old step schedule)."""

    def __init__(self, region, steps: int = 2, max_extra_steps: int = 16,
                 batch: bool = True, max_batch: int = 32,
                 batch_window_s: float = 200e-6, registry=None,
                 continuous: bool = False, pipeline_depth: int = 4):
        self.region = region
        self.steps = steps
        self.max_extra_steps = max_extra_steps
        # continuous wave formation: waves overlap on the
        # bridge via the ContinuousWaveScheduler instead of serializing
        # under _ask_lock; False keeps the serialized serve path
        # byte-for-byte
        self.continuous = bool(continuous) and batch
        self.batcher = None
        if batch:
            from ..sharding.ask_batch import AskBatcher
            self.batcher = AskBatcher(
                region, max_batch=max_batch, window_s=batch_window_s,
                steps=steps, max_extra_steps=max_extra_steps,
                registry=registry, continuous=continuous,
                pipeline_depth=pipeline_depth)

    def ask(self, entity_id: str, value: float) -> float:
        ref = self.region.entity_ref(entity_id)
        if self.batcher is not None:
            reply = self.batcher.ask(ref.shard, ref.index, [float(value)])
        else:
            reply = self.region.ask(ref.shard, ref.index, [float(value)],
                                    steps=self.steps,
                                    max_extra_steps=self.max_extra_steps)
        return float(np.asarray(reply)[0])

    def _resolve_wave(self, entity_ids: Sequence[str],
                      values: Sequence[float],
                      ctxs: Optional[Sequence[Any]],
                      keys: Optional[Sequence[Any]] = None):
        """Shared wave prep: entity ids resolved ONCE per unique id;
        unresolvable entities land their typed exception in `out`
        directly; the rest compact into (shard, index, payload) requests
        with aligned origin slots, span contexts and dedup keys."""
        refs: Dict[str, Any] = {}
        for e in entity_ids:
            if e not in refs:
                try:
                    refs[e] = self.region.entity_ref(e)
                except Exception as exc:  # noqa: BLE001 — per-entity typed
                    refs[e] = exc
        reqs, slots = [], []
        req_ctxs: Optional[List[Any]] = [] if ctxs is not None else None
        req_keys: Optional[List[Any]] = [] if keys is not None else None
        out: List[Any] = [None] * len(entity_ids)
        for i, (e, v) in enumerate(zip(entity_ids, values)):
            r = refs[e]
            if isinstance(r, BaseException):
                out[i] = r
                continue
            reqs.append((r.shard, r.index, [float(v)]))
            slots.append(i)
            if req_ctxs is not None:
                req_ctxs.append(ctxs[i])
            if req_keys is not None:
                req_keys.append(keys[i])
        return out, reqs, slots, req_ctxs, req_keys

    def ask_many(self, entity_ids: Sequence[str],
                 values: Sequence[float],
                 ctxs: Optional[Sequence[Any]] = None,
                 with_seqs: bool = False,
                 keys: Optional[Sequence[Any]] = None):
        """Columnar wave ask for a decoded binary window: entity ids are
        resolved ONCE per unique id, the whole wave rides
        `AskBatcher.ask_many` (one coalesced flush + one shared step
        budget, no per-call future hop) and the return is outcome-
        aligned — a float total or the per-ask exception INSTANCE
        (AskPoolExhausted / TimeoutError / ...), never a raise, so one
        member's failure cannot fail its wave-mates.

        `ctxs`: optional aligned per-request span contexts —
        one window carries many traces, so each sampled member's ctx
        travels next to its request instead of in the ambient var.

        `with_seqs`: also return the aligned per-member
        resolve ordinals (continuous mode; None under the serialized
        engine, where waves already resolve in submit order) — the
        gateway's replica-publish monotonicity key.

        `keys`: optional aligned per-request dedup keys —
        `(tenant, id)` tuples (or None) that ride the wave into the
        entity journal's group commit, so ok replies are durable before
        their acks (the reply-cache's commit-before-ack contract)."""
        out, reqs, slots, req_ctxs, req_keys = self._resolve_wave(
            entity_ids, values, ctxs, keys)
        seqs_out: Optional[List[int]] = None
        if reqs:
            rseqs = None
            if self.batcher is not None:
                if with_seqs:
                    replies, rseqs = self.batcher.ask_many(
                        reqs, req_ctxs, with_seqs=True, keys=req_keys)
                else:
                    replies = self.batcher.ask_many(reqs, req_ctxs,
                                                    keys=req_keys)
            else:
                replies = self.region.ask_many(
                    reqs, steps=self.steps,
                    max_extra_steps=self.max_extra_steps, ctxs=req_ctxs)
            for i, rep in zip(slots, replies):
                out[i] = rep if isinstance(rep, BaseException) \
                    else float(np.asarray(rep)[0])
            if rseqs is not None:
                seqs_out = [0] * len(entity_ids)
                for i, s in zip(slots, rseqs):
                    seqs_out[i] = int(s)
        return (out, seqs_out) if with_seqs else out

    def ask_many_async(self, entity_ids: Sequence[str],
                       values: Sequence[float],
                       ctxs: Optional[Sequence[Any]],
                       on_done: Callable[[List[Any], List[int]], Any],
                       keys: Optional[Sequence[Any]] = None) -> None:
        """Continuous-mode async wave: refs resolve and the
        wave STAGES on the calling thread (staging order is the
        linearization order, so per-connection ordering is preserved);
        `on_done(outcomes, seqs)` — both aligned with `entity_ids` —
        fires at the wave's resolve boundary on the scheduler thread.
        `keys` as in `ask_many`."""
        out, reqs, slots, req_ctxs, req_keys = self._resolve_wave(
            entity_ids, values, ctxs, keys)
        seqs_out = [0] * len(entity_ids)
        if not reqs:
            on_done(out, seqs_out)
            return

        def _done(replies: List[Any], rseqs: List[int]) -> None:
            for i, rep, s in zip(slots, replies, rseqs):
                out[i] = rep if isinstance(rep, BaseException) \
                    else float(np.asarray(rep)[0])
                seqs_out[i] = int(s)
            on_done(out, seqs_out)

        self.batcher.ask_many_async(reqs, req_ctxs, _done, keys=req_keys)

    def close(self) -> None:
        if self.batcher is not None:
            self.batcher.close()

    def sum_all(self) -> float:
        """Conserved-value probe: sum of every spawned entity's total."""
        region = self.region
        if self.batcher is not None:
            # continuous mode: open waves resolve before the probe reads
            # device state (serialized engine calls are synchronous under
            # the ask lock below, so this is a no-op there)
            self.batcher.quiesce()
        with region._ask_lock:  # quiesce vs concurrent asks/maintenance
            return self._sum_locked(region)

    @staticmethod
    def _sum_locked(region) -> float:
        region.block_until_ready()
        rows = []
        with region._lock:
            for shard, ents in enumerate(region._entities):
                base = int(region._shard_block[shard]) * region.eps
                rows.extend(base + idx for idx in ents.values())
        if not rows:
            return 0.0
        vals = region.system.read_state(
            "total", np.asarray(sorted(rows), np.int32))
        return float(np.asarray(vals, np.float64).sum())

    def pressure_signals(self) -> Dict[str, Callable[[], float]]:
        # includes open_wave_depth when this backend batches asks:
        # admission sheds on a full wave pipeline before the promise
        # pool is the thing that says no
        from .admission import region_pressure_signals
        return region_pressure_signals(self.region, batcher=self.batcher)


# -------------------------------------------------- mixed-encoding windows
# JSON rows that cannot map onto the wire op space get sentinel codes so
# they flow through the same post-admission typed-error branch their
# scalar twins used (charged, like any unknown op)
_OP_JSON_UNKNOWN = 255
_OP_JSON_BAD_VALUE = 254

_MISSING = object()  # raw_ids sentinel: "id": null must echo null


class _WindowAux:
    """JSON-origin overlays for a mixed-encoding record window: the
    record columns hold the wire-shaped view (fixed-width bytes, op
    codes); these per-row maps carry what only JSON can express — raw
    reply ids, op labels for reasons and span attrs, value-conversion
    failures, and reasons past the wire's 32-byte truncation."""

    __slots__ = ("json_rows", "raw_ids", "op_labels", "bad_values",
                 "reasons_full")

    def __init__(self) -> None:
        self.json_rows: set = set()        # rows decoded from JSON bodies
        self.raw_ids: Dict[int, Any] = {}      # row -> non-int64 JSON id
        self.op_labels: Dict[int, str] = {}    # row -> original op string
        self.bad_values: Dict[int, str] = {}   # row -> typed value reason
        self.reasons_full: Dict[int, str] = {}  # row -> untruncated reason


class _ServeState:
    """One record window's staged serve state, crossing the
    stage/resolve seam: the reply columns being filled, the
    per-row trace roots, the deferred SLO rounds, and the compacted ask
    wave (`serve` row indices with aligned vals/ents/ctxs). The
    synchronous path builds and consumes it on one thread; the
    continuous path hands it from the staging thread to the wave
    scheduler's resolve boundary."""

    __slots__ = ("aux", "ids", "ops", "tenants", "status", "reason",
                 "value", "retry", "step_lag", "traces", "roots",
                 "slo_outcomes", "slo_lat", "slo_rep", "serve", "vals",
                 "ents", "ctxs", "dedup", "dedup_keys", "dedup_alias",
                 "ask_keys")

    def __init__(self) -> None:
        self.slo_outcomes: Dict[bytes, List[str]] = {}
        self.slo_lat: Dict[bytes, List[Optional[float]]] = {}
        self.slo_rep: Dict[bytes, List[bool]] = {}
        # reply-cache dedup: flag column (None = dedup off),
        # row -> pending (tenant, id) key awaiting record/release, and
        # same-window duplicate row -> its source row
        self.dedup: Optional[np.ndarray] = None
        self.dedup_keys: Dict[int, Tuple[str, int]] = {}
        self.dedup_alias: Dict[int, int] = {}
        self.ask_keys: Optional[List[Any]] = None


# ------------------------------------------------------------------- server
class GatewayServer:
    """The front door: admission -> SLO clock -> backend ask, over TCP
    (the evloop transport) and/or in-proc frames (`handle_frame`).
    `system` is the reference's ActorSystem slot (tests pass None); the
    port reads only its optional `tracer` attribute."""

    def __init__(self, system, backend, admission: AdmissionController,
                 slo: SloTracker, host: str = "127.0.0.1", port: int = 0,
                 max_frame: int = DEFAULT_MAX_FRAME, registry=None,
                 tracer=None, aggregate: bool = False,
                 max_window: int = 64, window_wait_s: float = 150e-6,
                 pipeline_depth: int = 4, replica_cache=None,
                 transport: str = "stream", accept_shards: int = 1,
                 dedup=None, idle_timeout_s: float = 0.0):
        if transport not in ("stream", "evloop"):
            raise ValueError(f"unknown transport {transport!r} "
                             "(expected 'stream' or 'evloop')")
        self.system = system
        self.backend = backend
        self.admission = admission
        self.slo = slo
        # replicated hot-key read path: optional
        # ReadReplicaCache — gets for hot entities answered before the
        # ask wave under its bounded-staleness contract, every wave's ok
        # totals published back at the flush boundary
        self.replica_cache = replica_cache
        if replica_cache is not None and slo is not None:
            slo.attach_replica_cache(replica_cache)
        if replica_cache is not None:
            # durable-restore seam: a region restored before
            # the gateway came up replayed the entity journal — overwrite
            # any pre-crash replica entries (local or ddata-fed) with the
            # acked-frontier totals at the NEW step, before first serve
            region = getattr(backend, "region", None)
            replayed = getattr(region, "_durable_replayed_totals", None)
            if replayed is not None:
                replica_cache.republish_restored(replayed)
        # exactly-once effects: optional ReplyCacheTable —
        # duplicate request ids short-circuit with the cached reply
        # instead of re-entering the ask wave. Ok replies rode the
        # entity journal's group commit (`append_wave(replies=)`), so a
        # region restored before the gateway came up replayed the dedup
        # frontier too — rehydrate it before first serve, the replica
        # republish_restored twin above.
        self.dedup = dedup
        self._dedup_lock = threading.Lock()
        self.idle_timeout_s = float(idle_timeout_s)
        if dedup is not None:
            region = getattr(backend, "region", None)
            ej = getattr(region, "_entity_journal", None)
            replayed_replies = getattr(ej, "replies", None)
            if replayed_replies is not None:
                entries = replayed_replies()
                if entries:
                    dedup.load(entries)
            if registry is not None:
                registry.register_collector("gateway_dedup", dedup.stats)
        self.host = host
        self.port = port
        self.max_frame = max_frame
        self._binding = None  # the stream transport's ServerBinding
        self._seq = 0
        self._registry = registry
        self.pipeline_depth = int(pipeline_depth)
        # connection ids of the evloop transport's aggregator tags
        self._conn_ids = itertools.count(1)
        # continuous wave formation: autodetected from the
        # backend's batcher. When on, windows may resolve out of submit
        # order, so replica publishes are filtered per entity by resolve
        # ordinal — a slow wave's stale total must never overwrite a
        # newer wave's published one.
        self.continuous = bool(getattr(
            getattr(backend, "batcher", None), "continuous", False))
        self._pub_lock = threading.Lock()
        self._pub_seq: Dict[str, int] = {}
        # causal tracing (event/tracing.py): explicit tracer wins, else
        # the system-wired one (akka.tracing.* config); None keeps every
        # hook below at one `is not None` predicate
        self._tracer = tracer if tracer is not None \
            else getattr(system, "tracer", None)
        if self._tracer is not None:
            region = getattr(backend, "region", None)
            if region is not None and hasattr(region, "attach_tracer"):
                region.attach_tracer(self._tracer)
        self._h_decode_size = self._h_decode_ns = None
        if registry is not None:
            self._h_decode_size = registry.histogram(
                "gateway_decode_batch_size",
                "binary request records decoded per window")
            self._h_decode_ns = registry.histogram(
                "gateway_decode_ns_per_frame",
                "nanoseconds of wire decode per binary request record")
        # C1M front door: transport picks who owns the
        # sockets — "stream" materializes a per-connection stage graph,
        # "evloop" runs ALL sockets on selector loop threads
        # (evloop.EvLoopIngress). Both funnel frames into the same serve
        # path.
        self.transport = transport
        self.accept_shards = max(1, int(accept_shards))
        self._evloop = None
        # cross-connection ingest windowing: off by default —
        # the per-frame path below stays bit-identical to the seed. The
        # evloop transport has no per-frame stage to fall back on, so it
        # always gets the shared aggregator.
        self.aggregator = None
        if aggregate or transport == "evloop":
            from .aggregator import IngestAggregator
            self.aggregator = IngestAggregator(
                self, max_window=max_window, window_s=window_wait_s,
                registry=registry)
            if slo is not None:
                slo.attach_aggregator(self.aggregator)

    # ------------------------------------------------------------ transport
    def start(self) -> Tuple[str, int]:
        if self.transport == "evloop":
            from .evloop import EvLoopIngress
            self._evloop = EvLoopIngress(
                self, host=self.host, port=self.port,
                n_shards=self.accept_shards, registry=self._registry,
                idle_timeout_s=self.idle_timeout_s)
            self.host, self.port = self._evloop.start()
            return self.host, self.port
        if self.system is None:
            raise ValueError(
                "GatewayServer transport='stream' runs its connections as "
                "streams of an ActorSystem: pass the system, or use "
                "transport='evloop'")
        from ..stream.dsl import Keep, Sink
        from ..stream.framing import Framing
        from ..stream.tcp import Tcp
        tcp = Tcp.get(self.system)

        def handle(conn):
            stage = Framing.simple_framing_protocol_decoder(self.max_frame)
            if self.aggregator is not None:
                # bounded per-connection pipelining: up to pipeline_depth
                # frames of one socket in flight at the shared aggregator;
                # MapAsync's ordered drain preserves per-connection reply
                # order and its in-flight cap keeps the demand chain
                # intact (a slow consumer still throttles its own socket)
                cid = next(self._conn_ids)
                stage = stage.map_async(
                    self.pipeline_depth,
                    lambda body, _c=cid: self.aggregator.submit(body, _c))
            else:
                stage = stage.map(self.handle_frame)
            conn.handle_with(
                stage.via(Framing.simple_framing_protocol_encoder(
                    self.max_frame)),
                self.system)

        # one bind, port 0 included: the bound address comes back with
        # the binding
        fut = tcp.bind(self.host, self.port) \
            .to_mat(Sink.foreach(handle), Keep.left).run(self.system)
        self._binding = fut.result(10.0)
        self.host, self.port = self._binding.local_address[:2]
        return self.host, self.port

    def stop(self) -> None:
        if self._evloop is not None:
            self._evloop.stop()
            self._evloop = None
        if self._binding is not None:
            binding, self._binding = self._binding, None
            binding.unbind().result(10.0)
        if self.aggregator is not None:
            self.aggregator.close()

    # ------------------------------------------------------------- requests
    def handle_frame(self, frame: bytes) -> bytes:
        """One frame in, one reply body out. Binary solos keep the
        zero-copy decode; everything else — including solo JSON — is a
        one-frame window through the SAME columnar serve path a
        cross-connection window rides (the scalar JSON
        admission/SLO/trace block is gone, so check-order parity is
        structural, not mirrored)."""
        if frames.is_binary(frame):
            return self.handle_binary(frame)
        return self._serve_frames([frame])[0]

    def _bad_request_reply(self, e: Exception) -> Dict[str, Any]:
        """Malformed JSON frame: typed error, keep serving."""
        reason = f"bad_request:{type(e).__name__}"
        tr = self._tracer
        trace = tr.start_trace() if tr is not None else 0
        if trace:  # greppable: the reply's trace id is in the spans
            t_now = time.monotonic()
            tr.emit("gw.bad_request", trace, t0=t_now, t1=t_now,
                    reason=reason, proto="json")
        return self._traced(
            {"id": -1, "status": "error", "reason": reason}, trace)

    @staticmethod
    def _traced(rep: Dict[str, Any], trace: int) -> Dict[str, Any]:
        """Mirror the trace id into the reply — EVERY reply of a sampled
        request, so the JSON dict stays the exact twin of a version-2
        binary record's reply_to_dict (trace column on all records)."""
        if trace:
            rep["trace"] = trace
        return rep

    # ------------------------------------------------------ binary requests
    @staticmethod
    def _binary_error(code: str, trace: int = 0) -> bytes:
        """Typed malformed-binary reply (the `bad_request:` twin): one
        error record with id -1, mirroring the JSON path's keep-serving
        discipline. A sampled decode failure carries its trace id (the
        version-2 reply record) so the failure is greppable server-side."""
        return frames.encode_reply_batch(
            np.asarray([-1], np.int64),
            np.asarray([frames.ST_ERROR], np.uint8),
            np.asarray([f"bad_frame:{code}".encode("utf-8")
                        [:frames.REASON_BYTES]]),
            np.zeros(1), np.zeros(1, np.uint32),
            np.asarray([trace], np.uint64) if trace else None)

    def handle_binary(self, body: bytes) -> bytes:
        """One binary window: batch decode -> columnar serve -> one
        vectorized reply encode."""
        t0d = time.monotonic() if self._tracer is not None else 0.0
        rec = self._decode_window([body])
        if isinstance(rec, bytes):  # typed decode error
            return rec
        decode_t = (t0d, time.monotonic()) \
            if self._tracer is not None else None
        cols = self._serve_records(rec, decode_t)
        return frames.encode_reply_batch(*cols)

    def handle_frame_batch(self, bodies: Sequence[bytes]) -> List[bytes]:
        """Window entry point for the ingest aggregator, in-proc
        transports and batched load generators: ALL binary frames in
        `bodies` — contiguous or not — merge into ONE decode pass, JSON
        frames ride the SAME record columns, and the whole window is one
        admission charge + one ask wave + one SLO round.
        Admin and malformed frames stay standalone. Returns one reply
        body per input frame, aligned."""
        return self._serve_frames(bodies)

    def _bad_frame_reply(self, e: frames.FrameFormatError) -> bytes:
        """Typed reply for ONE malformed binary frame (keep serving the
        rest of the window); sampled failures are greppable."""
        tr = self._tracer
        trace = tr.start_trace() if tr is not None else 0
        if trace:  # the bad_frame reply's trace id is in the spans
            t_now = time.monotonic()
            tr.emit("gw.bad_frame", trace, t0=t_now, t1=t_now,
                    reason=f"bad_frame:{e.code}", proto="binary")
        return self._binary_error(e.code, trace)

    def _serve_frames(self, bodies: Sequence[bytes]) -> List[bytes]:
        """ONE ingest window across frames of ANY encoding and ANY
        interleaving: every valid binary body merges
        into a single `np.frombuffer` decode, every JSON request lands
        in the SAME record columns, and the whole window rides one
        `_serve_records` pass — one vectorized admission charge, one ask
        wave, one SLO round. Admin and malformed frames are typed
        standalone (never windowed, never charged). Replies demux back
        1:1 with `bodies`, each in its own encoding; window row order is
        arrival order, so per-entity linearization order is frame order
        (the wave scheduler serves duplicate destinations in row order)."""
        out, windowed, spans, count_of, rec, aux, decode_t = \
            self._window_prep(bodies)
        if not windowed:
            return out  # type: ignore[return-value]
        t_serve0 = time.monotonic() if self._tracer is not None else 0.0
        cols = self._serve_records(rec, decode_t, aux)
        self._window_demux(out, windowed, spans, count_of, cols, aux,
                           t_serve0)
        return out  # type: ignore[return-value]

    def submit_frames(self, bodies: Sequence[bytes]) -> "Future":
        """Continuous-mode async twin of `handle_frame_batch`: decode +
        admission + replica reads + wave STAGING run on the caller's
        thread (arrival order stays the linearization
        order), then this returns a Future of the aligned reply bodies
        immediately — outcome columns, replica publishes, SLO rounds and
        reply encode all run at the wave's resolve boundary on the
        scheduler thread. The caller (IngestAggregator) is then free to
        decode and admission-charge window N+1 while window N's device
        rounds are still in flight."""
        fut: Future = Future()
        try:
            out, windowed, spans, count_of, rec, aux, decode_t = \
                self._window_prep(bodies)
            if not windowed:
                fut.set_result(out)
                return fut
            t_serve0 = time.monotonic() if self._tracer is not None \
                else 0.0
            st = self._serve_stage(rec, decode_t, aux)
            if not len(st.serve):
                cols = self._serve_resolve(st, [], 0.0)
                self._window_demux(out, windowed, spans, count_of, cols,
                                   aux, t_serve0)
                fut.set_result(out)
                return fut
            t0 = time.perf_counter()

            def _done(outcomes: List[Any], seqs: List[int]) -> None:
                try:
                    cols = self._serve_resolve(
                        st, outcomes, time.perf_counter() - t0, seqs)
                    self._window_demux(out, windowed, spans, count_of,
                                       cols, aux, t_serve0)
                    fut.set_result(out)
                except BaseException as e:  # noqa: BLE001 — never hang
                    fut.set_exception(e)

            self.backend.ask_many_async(st.ents, st.vals, st.ctxs, _done,
                                        keys=st.ask_keys)
        except BaseException as e:  # noqa: BLE001 — never hang the caller
            fut.set_exception(e)
        return fut

    def _window_prep(self, bodies: Sequence[bytes]):
        """Frame demux + merged decode + arrival-order row spans + mixed
        columnization — everything in `_serve_frames` upstream of the
        serve pass, shared with the async `submit_frames` path. Returns
        `(out, windowed, spans, count_of, rec, aux, decode_t)`; empty
        `windowed` means every frame was answered standalone and `out`
        is already complete."""
        n_f = len(bodies)
        out: List[Optional[bytes]] = [None] * n_f
        bin_idx: List[int] = []     # frame index per valid binary body
        bin_bodies: List[bytes] = []
        json_reqs: Dict[int, Dict[str, Any]] = {}  # frame idx -> parsed
        for f, body in enumerate(bodies):
            if frames.is_binary(body):
                try:
                    frames.check_request_batch(body, self.max_frame)
                except frames.FrameFormatError as e:
                    out[f] = self._bad_frame_reply(e)
                    continue
                bin_idx.append(f)
                bin_bodies.append(body)
                continue
            try:
                req = json.loads(body)
                tenant = str(req["tenant"])
                str(req["op"])  # the scalar path's parse contract
            except Exception as e:  # malformed: typed, keep serving
                out[f] = encode_body(self._bad_request_reply(e))
                continue
            if tenant == ADMIN_TENANT:
                out[f] = encode_body(self._handle_admin(
                    req.get("id", -1), str(req["op"]), req))
                continue
            json_reqs[f] = req
        if not bin_bodies and not json_reqs:
            return out, [], {}, {}, None, None, None

        # ---- merged decode: ONE frombuffer for the window's binary rows
        tr = self._tracer
        rec_bin = None
        counts: List[int] = []
        decode_t = None
        if bin_bodies:
            t0d = time.monotonic() if tr is not None else 0.0
            t0 = time.perf_counter_ns()
            rec_bin, counts = frames.decode_request_batches(
                bin_bodies, self.max_frame)
            if tr is not None:
                decode_t = (t0d, time.monotonic())
            if self._h_decode_size is not None and len(rec_bin):
                dt = time.perf_counter_ns() - t0
                step = self._registry.step
                self._h_decode_size.observe(float(len(rec_bin)), step=step)
                self._h_decode_ns.observe(dt / len(rec_bin), step=step)

        # ---- arrival-order row spans (rows must NOT sort binary-first:
        # same-entity adds linearize in window row order)
        count_of = dict(zip(bin_idx, counts))
        spans: Dict[int, Tuple[int, int]] = {}
        cursor = 0
        windowed = sorted(set(count_of) | set(json_reqs))
        for f in windowed:
            k = count_of.get(f, 1)
            spans[f] = (cursor, cursor + k)
            cursor += k
        n = cursor

        aux: Optional[_WindowAux] = None
        if not json_reqs:
            rec = rec_bin  # pure binary: zero-copy straight through
        else:
            rec, aux = self._columnize_mixed(rec_bin, bin_idx, spans,
                                             json_reqs, n)
        return out, windowed, spans, count_of, rec, aux, decode_t

    def _window_demux(self, out: List[Optional[bytes]],
                      windowed: List[int],
                      spans: Dict[int, Tuple[int, int]],
                      count_of: Dict[int, int], cols, aux,
                      t_serve0: float) -> None:
        """Reply columns back to per-frame bodies, each in its own
        encoding, plus the window-level join span. Runs on the serving
        thread in the synchronous path and at the wave's resolve
        boundary in the continuous path."""
        ids, status, reason, value, retry, traces, step_lag, dedups = cols
        tr = self._tracer
        if tr is not None and traces is not None and len(windowed) > 1:
            member = [int(t) for t in traces if t]
            if member:  # window-level join span, the ask.wave convention
                tr.emit("gw.ingest_window", member[0], t0=t_serve0,
                        t1=time.monotonic(), n_frames=len(windowed),
                        n_records=spans[windowed[-1]][1],
                        member_traces=member)

        # ---- demux: each frame's reply slice in its own encoding
        for f in windowed:
            lo, hi = spans[f]
            if f in count_of:
                out[f] = frames.encode_reply_batch(
                    ids[lo:hi], status[lo:hi], reason[lo:hi],
                    value[lo:hi], retry[lo:hi],
                    None if traces is None else traces[lo:hi],
                    step_lag[lo:hi],
                    None if dedups is None else dedups[lo:hi])
            else:
                out[f] = encode_body(self._row_reply(
                    lo, ids, status, reason, value, retry, traces, aux,
                    step_lag, dedups))

    @staticmethod
    def _columnize_mixed(rec_bin, bin_idx: List[int],
                         spans: Dict[int, Tuple[int, int]],
                         json_reqs: Dict[int, Dict[str, Any]],
                         n: int) -> Tuple[np.ndarray, _WindowAux]:
        """Lower parsed JSON requests into the binary record schema so a
        mixed window serves as ONE column pass. Tenant/entity columns
        widen to the window's longest JSON string (the wire's fixed
        widths are a floor, not a ceiling); binary records scatter into
        their arrival-order rows with five vectorized field copies."""
        aux = _WindowAux()
        tw, ew = frames.TENANT_BYTES, frames.ENTITY_BYTES
        prep: Dict[int, Tuple[Dict[str, Any], bytes, bytes]] = {}
        for f, req in json_reqs.items():
            r = spans[f][0]
            tb = str(req["tenant"]).encode("utf-8")
            eb = str(req["entity"]).encode("utf-8") \
                if "entity" in req else b""
            tw, ew = max(tw, len(tb)), max(ew, len(eb))
            prep[r] = (req, tb, eb)
        rec = np.zeros((n,), np.dtype(
            [("id", "i8"), ("op", "u1"), ("tenant", f"S{tw}"),
             ("entity", f"S{ew}"), ("value", "f8")]))
        if rec_bin is not None and len(rec_bin):
            rows = np.concatenate([np.arange(*spans[f]) for f in bin_idx])
            for field in ("id", "op", "tenant", "entity", "value"):
                rec[field][rows] = rec_bin[field]
        for r, (req, tb, eb) in prep.items():
            aux.json_rows.add(r)
            rid = req.get("id", -1)
            if type(rid) is int and -(1 << 63) <= rid < (1 << 63):
                rec["id"][r] = rid
            else:  # echo non-wire ids (str/float/null/huge) verbatim
                rec["id"][r] = -1
                aux.raw_ids[r] = rid
            rec["tenant"][r] = tb
            rec["entity"][r] = eb
            op = str(req["op"])
            aux.op_labels[r] = op
            code = frames.OP_CODES.get(op)
            if code is None:
                rec["op"][r] = _OP_JSON_UNKNOWN
                continue
            rec["op"][r] = code
            if code == frames.OP_ADD:
                try:
                    rec["value"][r] = float(req.get("value", 0.0))
                except Exception as e:  # typed, not a connection fault
                    rec["op"][r] = _OP_JSON_BAD_VALUE
                    aux.bad_values[r] = f"bad_request:{type(e).__name__}"
        return rec, aux

    @staticmethod
    def _row_reply(r: int, ids, status, reason, value, retry, traces,
                   aux: Optional[_WindowAux],
                   step_lag=None, dedups=None) -> Dict[str, Any]:
        """One window row back to the exact reply dict the scalar JSON
        path built: per-status key set, raw id echo, untruncated
        reasons, trace id on sampled replies; replica-served reads carry
        `replica`/`step_lag` exactly as a version-3 binary record's
        reply_to_dict does."""
        st = int(status[r])
        rid = aux.raw_ids.get(r, _MISSING) if aux is not None else _MISSING
        rep: Dict[str, Any] = {
            "id": int(ids[r]) if rid is _MISSING else rid}
        if st == frames.ST_OK:
            rep["status"] = "ok"
            rep["value"] = float(value[r])
            if step_lag is not None and int(step_lag[r]) >= 0:
                rep["replica"] = True
                rep["step_lag"] = int(step_lag[r])
        else:
            rep["status"] = "shed" if st == frames.ST_SHED else "error"
            full = aux.reasons_full.get(r) if aux is not None else None
            rep["reason"] = full if full is not None else \
                bytes(reason[r]).rstrip(b"\x00").decode("utf-8", "replace")
            if st == frames.ST_SHED:
                rep["retry_after_ms"] = int(retry[r])
        if dedups is not None and int(dedups[r]):
            rep["dedup"] = True  # the version-4 record flag's JSON twin
        if traces is not None and int(traces[r]):
            rep["trace"] = int(traces[r])
        return rep

    def _decode_window(self, bodies: Sequence[bytes]):
        """Decode one or more binary bodies; returns the record array or
        an encoded typed-error reply (bytes). Decode metrics ride the
        registry step axis like the ask-batch stats."""
        t0 = time.perf_counter_ns()
        try:
            recs = [frames.decode_request_batch(b, self.max_frame)
                    for b in bodies]
            rec = np.concatenate(recs) if len(recs) > 1 else recs[0]
        except frames.FrameFormatError as e:
            return self._bad_frame_reply(e)
        if self._h_decode_size is not None:
            dt = time.perf_counter_ns() - t0
            step = self._registry.step
            self._h_decode_size.observe(float(len(rec)), step=step)
            self._h_decode_ns.observe(dt / len(rec), step=step)
        return rec

    def _serve_records(self, rec: np.ndarray, decode_t=None,
                       aux: Optional[_WindowAux] = None):
        """The whole serving path, one record window at a time:
        admin/malformed checks -> vectorized per-tenant admission charge
        (ONE pressure poll via admit_groups) -> ONE ask wave ->
        vectorized reply columns. This is now the ONLY request path —
        solo JSON is a 1-row window — so check order is a single
        implementation, not a mirrored pair: missing entity is typed
        BEFORE admission and never charges the bucket; unknown op (and a
        JSON "add" whose value fails float()) is typed AFTER admission,
        charged. SLO counters are recorded per tenant with
        `record_many` — counter-identical to N scalar requests.

        Split at the stage/resolve seam: `_serve_stage` does
        everything UP TO the ask wave, `_serve_resolve` everything after
        it; this synchronous composition is the serialized serve path,
        and `submit_frames` recomposes the same
        halves around an async continuous wave.

        `aux` carries the JSON overlays of a mixed window:
        raw reply ids, op-label strings for span attrs and unknown_op
        reasons, and untruncated reasons for JSON replies.

        Tracing: each record gets its own head-sampled trace
        at ingress (one window holds MANY traces); sampled records get a
        root span whose ctx rides next to the request through the ask
        wave, and the reply wave carries the trace-id column (version-2
        records) when any record was sampled. Tracing off ⇒ one
        predicate, identical columns, version-1 bytes."""
        st = self._serve_stage(rec, decode_t, aux)
        outcomes: List[Any] = []
        dt = 0.0
        seqs: Optional[List[int]] = None
        if len(st.serve):
            t0 = time.perf_counter()
            if self.continuous:
                # even the synchronous path needs resolve ordinals when
                # waves overlap: concurrent handle_frame threads resolve
                # out of submit order under the continuous scheduler
                outcomes, seqs = self.backend.ask_many(
                    st.ents, st.vals, st.ctxs, with_seqs=True,
                    keys=st.ask_keys)
            else:
                outcomes = self._backend_ask_many(st.ents, st.vals,
                                                  st.ctxs, st.ask_keys)
            dt = time.perf_counter() - t0
        return self._serve_resolve(st, outcomes, dt, seqs)

    def _serve_stage(self, rec: np.ndarray, decode_t=None,
                     aux: Optional[_WindowAux] = None) -> "_ServeState":
        """Stage phase: reply columns allocated, traces rooted, typed
        admin/missing checks, the vectorized admission charge, unknown-op
        typing, replica reads — ending with the compacted serve rows
        (`st.serve/vals/ents/ctxs`) ready to ride an ask wave."""
        n = len(rec)
        st = _ServeState()
        st.aux = aux
        st.ids = rec["id"].astype(np.int64)
        ops = st.ops = rec["op"]
        tenants = st.tenants = rec["tenant"]
        entities = rec["entity"]
        status = st.status = np.full((n,), frames.ST_ERROR, np.uint8)
        reason = st.reason = np.zeros((n,), f"S{frames.REASON_BYTES}")
        value = st.value = np.zeros((n,), np.float64)
        retry = st.retry = np.zeros((n,), np.uint32)
        # >=0 <=> replica-served
        step_lag = st.step_lag = np.full((n,), -1, np.int32)

        tr = self._tracer
        st.traces = None
        roots = st.roots = {}
        if tr is not None:
            st.traces = np.zeros((n,), np.uint64)
            for i in range(n):
                is_json = aux is not None and i in aux.json_rows
                rid: Any = aux.raw_ids.get(i, _MISSING) if is_json \
                    else _MISSING
                if rid is _MISSING:
                    rid = int(st.ids[i])
                tid = tr.start_trace(
                    tenants[i].decode("utf-8", "replace"), rid)
                if tid:
                    st.traces[i] = tid
                    roots[i] = tr.begin(
                        "gw.request", tid, id=rid,
                        tenant=tenants[i].decode("utf-8", "replace"),
                        op=(aux.op_labels[i] if is_json else int(ops[i])),
                        proto="json" if is_json else "binary")
            if roots and decode_t is not None:
                # the window's decode, retro-emitted under the first
                # sampled root (one decode serves many traces — the
                # wave-span convention)
                first = next(iter(roots.values()))
                tr.emit("gw.decode", first.ctx, t0=decode_t[0],
                        t1=decode_t[1], n_records=n)

        admin = tenants == ADMIN_TENANT.encode("utf-8")
        reason[admin] = b"bad_request:admin_requires_json"
        missing = ~admin & (entities == b"")
        reason[missing] = b"bad_request:missing_entity"
        eligible = ~admin & ~missing

        # ---- vectorized per-tenant admission charge: ONE pressure poll
        # for the whole window, one bucket debit per tenant
        aspan = None
        if roots:  # one admit_batch span joined to the rest by traces
            aspan = tr.begin("gw.admit_batch",
                             next(iter(roots.values())).ctx,
                             member_traces=[s.trace_id
                                            for s in roots.values()])
        admitted = np.zeros((n,), bool)
        groups: Dict[bytes, np.ndarray] = {}
        if eligible.any():
            for t in np.unique(tenants[eligible]):
                groups[t] = np.nonzero(eligible & (tenants == t))[0]
        verdicts = self.admission.admit_groups(
            {t.decode("utf-8"): len(rows) for t, rows in groups.items()})
        for t, rows in groups.items():
            k, rej = verdicts[t.decode("utf-8")]
            admitted[rows[:k]] = True
            if rej is not None:
                shed = rows[k:]
                status[shed] = frames.ST_SHED
                reason[shed] = rej.reason.encode("utf-8") \
                    [:frames.REASON_BYTES]
                retry[shed] = int(rej.retry_after_s * 1e3)
                self._note(st, t, "reject", count=len(shed))
        if aspan is not None:
            aspan.finish(admitted=int(admitted.sum()))

        # unknown-op is typed AFTER admission (the scalar path charged
        # the bucket before it inspected the op); JSON sentinel rows
        # (unmappable op string, bad "add" value) ride the same branch
        known = np.isin(ops, (frames.OP_GET, frames.OP_ADD))
        for i in np.nonzero(admitted & ~known)[0]:
            full = aux.bad_values.get(i) if aux is not None else None
            if full is None:
                lbl = aux.op_labels.get(i) if aux is not None else None
                full = f"unknown_op:{lbl if lbl is not None else int(ops[i])}"
            self._set_reason(st, i, full)
            self._note(st, tenants[i], "error")
        for i in np.nonzero(missing)[0]:
            self._note(st, tenants[i], "error")

        # ---- replicated read path: hot-entity gets answered
        # from the local replica BEFORE the ask wave, strictly after the
        # admission charge (sheds/charging identical to the wave path);
        # stale-beyond-bound and cold entities fall through to the wave
        serve = np.nonzero(admitted & known)[0]
        cache = self.replica_cache
        if cache is not None and len(serve):
            t0r = time.perf_counter()
            replica_rows: List[int] = []
            for i in serve:
                if ops[i] != frames.OP_GET:
                    continue
                hit = cache.try_read(entities[i].decode("utf-8"))
                if hit is None:
                    continue
                status[i] = frames.ST_OK
                value[i], step_lag[i] = hit[0], hit[1]
                replica_rows.append(int(i))
            if replica_rows:
                dtr = time.perf_counter() - t0r
                for i in replica_rows:
                    self._note(st, tenants[i], "ok", dtr, replica=True)
                    sp = roots.get(i)
                    if sp is not None:  # parented under gw.request; the
                        # fall-through rows keep their ask.member spans
                        tr.emit("gw.replica_read", sp.ctx, t0=t0r,
                                t1=t0r + dtr, step_lag=int(step_lag[i]))
                keep = ~np.isin(serve, replica_rows)
                serve = serve[keep]

        # ---- journaled reply-cache dedup: ONE vectorized
        # check per window, strictly AFTER the admission charge (a shed
        # retry is a shed, never a cached hit) — duplicate ids replay
        # the cached reply and never re-enter the ask wave; same-window
        # duplicates alias their source row's reply at resolve; a
        # duplicate of a still-in-flight first attempt is a typed shed.
        dd = self.dedup
        if dd is not None and len(serve):
            keys: List[Optional[Tuple[str, int]]] = []
            for i in serve:
                if aux is not None and int(i) in aux.raw_ids:
                    keys.append(None)  # non-wire JSON ids never dedup
                else:
                    keys.append((tenants[i].decode("utf-8", "replace"),
                                 int(st.ids[i])))
            with self._dedup_lock:
                verdicts = dd.begin(keys)
            dedups = st.dedup = np.zeros((n,), np.uint8)
            keep = np.ones(len(serve), bool)
            for j, v in enumerate(verdicts):
                kind = v[0]
                i = int(serve[j])
                if kind == "hit":
                    status[i] = np.uint8(v[1])
                    value[i] = v[2]
                    if v[3]:
                        reason[i] = v[3]
                    dedups[i] = 1
                    keep[j] = False
                    self._note(st, tenants[i], "ok"
                               if v[1] == frames.ST_OK else "error")
                elif kind == "alias":
                    st.dedup_alias[i] = int(serve[v[1]])
                    dedups[i] = 1
                    keep[j] = False
                elif kind == "inflight":
                    status[i] = frames.ST_SHED
                    reason[i] = DUPLICATE_INFLIGHT.encode("utf-8") \
                        [:frames.REASON_BYTES]
                    retry[i] = 20  # first attempt resolves within a wave
                    dedups[i] = 1
                    keep[j] = False
                    self._note(st, tenants[i], "reject")
                elif kind == "miss":
                    st.dedup_keys[i] = keys[j]
            serve = serve[keep]

        st.serve = serve
        st.vals = np.where(ops[serve] == frames.OP_ADD,
                           rec["value"][serve].astype(np.float64), 0.0)
        st.ents = [entities[i].decode("utf-8") for i in serve]
        if st.dedup_keys:
            # aligned (tenant, id) per ask-wave member: rides the wave
            # into the entity journal's group commit (commit-before-ack
            # covers the reply cache) via ask_many(keys=)
            st.ask_keys = [st.dedup_keys.get(int(i)) for i in serve]
        st.ctxs = None
        if roots:  # each sampled request's ctx rides with its ask
            st.ctxs = [roots[i].ctx if i in roots else None
                       for i in serve]
        return st

    def _serve_resolve(self, st: "_ServeState", outcomes: List[Any],
                       dt: float, seqs: Optional[List[int]] = None):
        """Resolve phase: ask outcomes -> reply columns, replica
        publishes (seq-filtered when waves overlap), SLO rounds, root
        span finish. Runs on the serving thread in the synchronous path
        and on the scheduler thread at the wave's resolve boundary in
        the continuous path."""
        status, reason, value, retry = st.status, st.reason, st.value, \
            st.retry
        cache = self.replica_cache
        dd = self.dedup
        if len(st.serve):
            pool_noted = False
            wave_totals: Dict[str, float] = {}
            wave_seqs: Dict[str, int] = {}
            for j, (i, outc, ent) in enumerate(
                    zip(st.serve, outcomes, st.ents)):
                t = st.tenants[i]
                key = st.dedup_keys.get(int(i))
                if isinstance(outc, AskPoolExhausted):
                    if not pool_noted:
                        self.admission.note_ask_pool_exhausted()
                        pool_noted = True
                    status[i] = frames.ST_SHED
                    reason[i] = b"ask_pool_exhausted"
                    retry[i] = int(self.admission.cooldown_s * 1e3)
                    self._note(st, t, "reject")
                    if key is not None:  # nothing applied: retry fresh
                        with self._dedup_lock:
                            dd.release(key)
                elif isinstance(outc, TimeoutError):
                    reason[i] = b"timeout"
                    self._note(st, t, "timeout", dt)
                    if key is not None:
                        # ambiguous — the apply may have landed without
                        # latching a reply; cache the timeout so the id
                        # stays at-most-once (see dedup module docstring)
                        with self._dedup_lock:
                            dd.record(key, frames.ST_ERROR, 0.0,
                                      b"timeout")
                elif isinstance(outc, BaseException):
                    self._set_reason(st, i, f"fault:{type(outc).__name__}")
                    self._note(st, t, "error", dt)
                    if key is not None:  # typed fault: nothing applied
                        with self._dedup_lock:
                            dd.release(key)
                else:
                    status[i] = frames.ST_OK
                    value[i] = outc
                    self._note(st, t, "ok", dt)
                    if key is not None:
                        # journal already group-committed this reply
                        # (commit-before-ack); now the live table
                        with self._dedup_lock:
                            dd.record(key, frames.ST_OK, float(outc))
                    # last ok outcome per entity wins: rows are in wave
                    # linearization order, so this IS the post-wave total
                    wave_totals[ent] = float(outc)
                    if seqs is not None:
                        wave_seqs[ent] = int(seqs[j])
            if cache is not None and wave_totals:
                # ONE batched publish per ask wave (the coalesced-flush
                # boundary): authoritative totals re-arm the replica —
                # including for reads that just fell through as stale
                if seqs is None:
                    cache.publish_wave(wave_totals)
                else:
                    self._publish_filtered(wave_totals, wave_seqs)

        # same-window duplicates: copy the source row's resolved reply
        # (byte-identical on both encodings) — after the wave resolved
        # the source, before SLO rounds and span finishes
        for i, src in st.dedup_alias.items():
            status[i] = status[src]
            reason[i] = reason[src]
            value[i] = value[src]
            retry[i] = retry[src]
            stt = int(status[i])
            self._note(st, st.tenants[i],
                       "ok" if stt == frames.ST_OK else
                       ("reject" if stt == frames.ST_SHED else "error"))

        for t, outs in st.slo_outcomes.items():
            self.slo.record_many(t.decode("utf-8"), outs, st.slo_lat[t],
                                 st.slo_rep[t])
        if st.roots:
            st_names = {frames.ST_OK: "ok", frames.ST_SHED: "shed",
                        frames.ST_ERROR: "error"}
            aux = st.aux
            for i, sp in st.roots.items():
                full = aux.reasons_full.get(i) if aux is not None else None
                rsn = full if full is not None else \
                    bytes(reason[i]).rstrip(b"\x00") \
                    .decode("utf-8", "replace")
                sp.finish(status=st_names.get(int(status[i]), "error"),
                          **({"reason": rsn} if rsn else {}))
        return st.ids, status, reason, value, retry, st.traces, \
            st.step_lag, st.dedup

    def _publish_filtered(self, totals: Dict[str, float],
                          wave_seqs: Dict[str, int]) -> None:
        """Per-entity monotone replica publish for overlapping waves
       : a wave that resolves LATE must not overwrite an
        entity total a younger wave already published — each entity's
        publish is gated on its members' global resolve ordinal. The
        lock also serializes `publish_wave`'s step stamping, so the
        cache's own step-monotonic feed contract holds too."""
        with self._pub_lock:
            fresh: Dict[str, float] = {}
            for e, tot in totals.items():
                s = wave_seqs.get(e, 0)
                if s > self._pub_seq.get(e, -1):
                    self._pub_seq[e] = s
                    fresh[e] = tot
            if fresh:
                self.replica_cache.publish_wave(fresh)

    @staticmethod
    def _note(st: "_ServeState", t: bytes, outcome: str,
              lat: Optional[float] = None, count: int = 1,
              replica: bool = False) -> None:
        st.slo_outcomes.setdefault(t, []).extend([outcome] * count)
        st.slo_lat.setdefault(t, []).extend([lat] * count)
        st.slo_rep.setdefault(t, []).extend([replica] * count)

    @staticmethod
    def _set_reason(st: "_ServeState", i, full: str) -> None:
        # wire truncation on the column; JSON replies keep the full
        # string through the aux overlay (the scalar path never
        # truncated, so neither does its windowed twin)
        b = full.encode("utf-8")
        st.reason[i] = b[:frames.REASON_BYTES]
        if (st.aux is not None and len(b) > frames.REASON_BYTES
                and i in st.aux.json_rows):
            st.aux.reasons_full[int(i)] = full

    def _backend_ask_many(self, entity_ids: List[str],
                          values: np.ndarray,
                          ctxs: Optional[List[Any]] = None,
                          keys: Optional[List[Any]] = None) -> List[Any]:
        asker = getattr(self.backend, "ask_many", None)
        if asker is not None:
            # ctxs exist only when tracing is on; backends that batch
            # (RegionBackend) accept them, and the fallback loop below
            # pins each member's ctx as the ambient one per ask; keys
            # ride only when dedup staged some — backends
            # without the kwarg never see it
            if keys is not None:
                return asker(entity_ids, values, ctxs, keys=keys)
            return asker(entity_ids, values) if ctxs is None \
                else asker(entity_ids, values, ctxs)
        out: List[Any] = []
        for j, (e, v) in enumerate(zip(entity_ids, values)):
            tok = set_ctx(ctxs[j]) \
                if ctxs is not None and ctxs[j] is not None else None
            try:
                out.append(self.backend.ask(e, float(v)))
            except Exception as exc:  # noqa: BLE001 — per-ask outcome
                out.append(exc)
            finally:
                if tok is not None:
                    reset_ctx(tok)
        return out

    # ---------------------------------------------------------------- admin
    def _handle_admin(self, rid, op: str, req: Dict[str, Any]) \
            -> Dict[str, Any]:
        """Operator channel (not admission-gated): chaos legs and probes
        ride the same wire as traffic."""
        try:
            if op == "sum":
                return {"id": rid, "status": "ok",
                        "value": self.backend.sum_all()}
            if op == "artifact":
                return {"id": rid, "status": "ok",
                        "data": self.slo.artifact()}
            if op == "stats":
                data = {"admission": self.admission.stats(),
                        "region": self.backend.region.stats(),
                        "ask_pool": self.backend.region.ask_pool_stats()}
                batcher = getattr(self.backend, "batcher", None)
                if batcher is not None:
                    data["ask_batch"] = batcher.stats()
                if self.dedup is not None:
                    with self._dedup_lock:
                        data["dedup"] = self.dedup.stats()
                return {"id": rid, "status": "ok", "data": data}
            if op == "checkpoint":
                return {"id": rid, "status": "ok",
                        "data": {"path": self.backend.region.checkpoint()}}
            if op == "rebalance":
                shard = int(req.get("value", 0))
                blk = self.backend.region.rebalance(shard)
                return {"id": rid, "status": "ok", "value": float(blk)}
            if op == "failover":
                n = int(req.get("value", 1))
                region = self.backend.region
                # the survivors: the first n shard slots of the mesh
                step = region.failover(list(region.system.mesh.slots[:n]))
                replayed = getattr(region, "_durable_replayed_totals",
                                   None)
                if self.replica_cache is not None and replayed is not None:
                    # failover truncated device state to the acked
                    # frontier — stale replica entries must not outlive it
                    self.replica_cache.republish_restored(replayed)
                return {"id": rid, "status": "ok", "value": float(step)}
            if op == "durable":
                region = self.backend.region
                ej = getattr(region, "_entity_journal", None)
                data: Dict[str, Any] = {"attached": ej is not None}
                if ej is not None:
                    data["journal"] = ej.stats()
                    data["replayed_entities"] = len(
                        region._durable_replayed_totals or {})
                store = getattr(region.spec, "remember_store", None)
                if store is not None:
                    data["remembered"] = sum(
                        len(store.remembered(region.type_name, str(s)))
                        for s in range(region.spec.n_shards))
                return {"id": rid, "status": "ok", "data": data}
            return {"id": rid, "status": "error",
                    "reason": f"unknown_admin_op:{op}"}
        except Exception as e:  # noqa: BLE001 — admin faults must reply
            return {"id": rid, "status": "error",
                    "reason": f"admin_fault:{type(e).__name__}:{e}"}


# ------------------------------------------------------------------- client
class GatewayClient:
    """Blocking raw-socket client (tests / load generators / example).
    One request in flight per connection; `request` returns the decoded
    reply dict. `request_retry` reconnects through server restarts — the
    chaos legs' client behavior.

    Idempotent sessions: every request id is
    `(session << 24) | seq` — a random per-client session tag over a
    monotone sequence — so ids are unique ACROSS clients and reconnects,
    and `request_retry` resends the SAME id on every attempt. Against a
    dedup-enabled gateway that makes a retried effect exactly-once: the
    server replays the cached reply instead of re-applying. The id is
    masked positive-int64 (the wire's `>i8`), leaving an effective
    39-bit session tag over a 24-bit sequence."""

    def __init__(self, host: str, port: int, timeout: float = 15.0,
                 max_frame: int = DEFAULT_MAX_FRAME,
                 session: Optional[int] = None):
        self.host = host
        self.port = port
        self.timeout = timeout
        self.max_frame = max_frame
        self._sock: Optional[socket.socket] = None
        self._reader = FrameReader(max_frame)
        self.session = random.getrandbits(64) if session is None \
            else int(session)
        self._seq = 0

    def _next_id(self) -> int:
        """Mint the next idempotent request id for this session."""
        self._seq += 1
        return ((self.session << 24) | (self._seq & 0xFFFFFF)) \
            & 0x7FFFFFFFFFFFFFFF

    def connect(self) -> None:
        self.close()
        s = socket.create_connection((self.host, self.port),
                                     timeout=self.timeout)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = s
        self._reader = FrameReader(self.max_frame)

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def request(self, tenant: str, entity: str, op: str,
                value: float = 0.0) -> Dict[str, Any]:
        req = {"id": self._next_id(), "tenant": tenant, "entity": entity,
               "op": op, "value": value}
        return self._request_raw(req)

    def _request_raw(self, req: Dict[str, Any]) -> Dict[str, Any]:
        """Send a prebuilt request dict — `request_retry` resends the
        SAME dict (same id) across reconnects, the idempotent half of
        the exactly-once contract."""
        if self._sock is None:
            self.connect()
        self._sock.sendall(encode_frame(req))
        while True:
            data = self._sock.recv(65536)
            if not data:
                raise ConnectionError("gateway closed the connection")
            for reply in self._reader.feed(data):
                return reply

    def request_many(self, requests: Sequence[Tuple[str, str, str, float]]
                     ) -> List[Dict[str, Any]]:
        """Binary window ask: `requests` is a sequence of
        `(tenant, entity, op, value)`; the whole window rides ONE binary
        frame (one batch decode + one ask wave server-side) and the
        reply wave decodes to JSON-twin dicts, aligned with the input.
        One window in flight per connection, like `request`."""
        if self._sock is None:
            self.connect()
        ids, tenants, entities, ops, values = [], [], [], [], []
        for tenant, entity, op, val in requests:
            ids.append(self._next_id())
            tenants.append(tenant)
            entities.append(entity)
            ops.append(op)
            values.append(float(val))
        body = frames.encode_request_batch(ids, tenants, entities, ops,
                                           values)
        self._sock.sendall(frames.frame(body))
        while True:
            data = self._sock.recv(65536)
            if not data:
                raise ConnectionError("gateway closed the connection")
            for reply in self._reader.feed_raw(data):
                return frames.decode_replies(reply, self.max_frame)

    def request_binary(self, tenant: str, entity: str, op: str,
                       value: float = 0.0) -> Dict[str, Any]:
        """Solo binary ask — the JSON `request`'s bit-identical twin."""
        return self.request_many([(tenant, entity, op, value)])[0]

    def request_many_pipelined(
            self, windows: Sequence[Sequence[Tuple[str, str, str, float]]],
            depth: int = 4) -> List[List[Dict[str, Any]]]:
        """Depth-k pipelined binary windows: up to `depth`
        window frames outstanding on the connection before the first
        reply is read — the client-side load shape that actually fills
        the server's cross-connection ingest windows. Replies come back
        in order (the server's per-connection FIFO contract) and each is
        matched to its window by the first record's sequence id; a
        mismatch raises. Returns one reply list per input window,
        aligned."""
        if self._sock is None:
            self.connect()
        depth = max(1, int(depth))
        encoded: List[bytes] = []
        first_ids: List[int] = []
        for win in windows:
            if not win:
                raise ValueError("empty window in pipelined request")
            ids, tenants, entities, ops, values = [], [], [], [], []
            for tenant, entity, op, val in win:
                ids.append(self._next_id())
                tenants.append(tenant)
                entities.append(entity)
                ops.append(op)
                values.append(float(val))
            encoded.append(frames.frame(frames.encode_request_batch(
                ids, tenants, entities, ops, values)))
            first_ids.append(ids[0])
        out: List[List[Dict[str, Any]]] = []
        sent = 0
        while len(out) < len(encoded):
            while sent < len(encoded) and sent - len(out) < depth:
                self._sock.sendall(encoded[sent])
                sent += 1
            data = self._sock.recv(65536)
            if not data:
                raise ConnectionError("gateway closed the connection")
            for body in self._reader.feed_raw(data):
                reps = frames.decode_replies(body, self.max_frame)
                want = first_ids[len(out)]
                got = reps[0]["id"]
                if got != want:
                    raise ValueError(
                        f"pipelined reply out of order: got first id "
                        f"{got}, want {want}")
                out.append(reps)
        return out

    def request_retry(self, tenant: str, entity: str, op: str,
                      value: float = 0.0, deadline_s: float = 60.0,
                      pause_s: float = 0.2, max_backoff_s: float = 2.0,
                      jitter: float = 0.25,
                      retry_sheds: bool = False) -> Dict[str, Any]:
        """Retry through connection failures (server crash/restart) until
        `deadline_s`, resending the SAME request id on every attempt
        (idempotent session — a dedup-enabled gateway replays the cached
        reply instead of re-applying). Attempts pace with exponential
        backoff + jitter (`pattern/backoff.py`): `pause_s` is the floor,
        `max_backoff_s` the cap. Shed replies are returned to the caller
        (backoff on rejects is a POLICY, reconnection is plumbing) —
        except `duplicate_inflight`, which only this client's own retry
        can provoke, and sheds in general when `retry_sheds` is set.
        The returned reply carries `attempts` and, when any attempt
        failed, `last_error`."""
        deadline = time.monotonic() + deadline_s
        last: Optional[BaseException] = None
        attempts = 0
        req = {"id": self._next_id(), "tenant": tenant, "entity": entity,
               "op": op, "value": value}
        while time.monotonic() < deadline:
            attempts += 1
            delay = backoff_delay(attempts - 1, pause_s, max_backoff_s,
                                  jitter)
            try:
                rep = self._request_raw(req)
            except (OSError, ConnectionError, socket.timeout) as e:
                last = e
                self.close()
                time.sleep(delay)
                continue
            if rep.get("status") == "shed" and \
                    (retry_sheds or
                     rep.get("reason") == DUPLICATE_INFLIGHT):
                last = None
                time.sleep(max(delay,
                               rep.get("retry_after_ms", 0) / 1e3))
                continue
            rep["attempts"] = attempts
            if last is not None:
                rep["last_error"] = repr(last)
            return rep
        raise TimeoutError(f"gateway unreachable for {deadline_s}s: {last!r}")

    def admin(self, op: str, value: float = 0.0) -> Dict[str, Any]:
        return self.request(ADMIN_TENANT, "", op, value)
