"""Cross-connection ingest windowing.

A copy of `akka_tpu/gateway/aggregator.py` (host code).

The batched ingress made one SOCKET's frames decode in one pass;
this module makes windows out of CONCURRENCY: frames from MANY
connections land in one shared queue tagged (conn_id, seq), a window
closes on `max_window` request RECORDS or a microsecond deadline — the
AskBatcher's adaptive-close shape (sharding/ask_batch.py), reused
verbatim via `wait_adaptive_close` — and the whole window runs the
gateway's columnar serve path ONCE (`GatewayServer._serve_frames`): one
merged `np.frombuffer` decode for every binary body, JSON bodies lowered
into the SAME record columns, one vectorized admission charge
(`admit_groups`: one pressure poll), one ask wave, one SLO round. Reply
bodies then demux back to each connection's Future in FIFO order.

Ordering: windows are served sequentially by ONE dispatcher thread and
frames enter the queue in per-connection arrival order (the TCP stage
calls `submit` synchronously per frame), so per-connection FIFO is
structural — and the stream layer's ordered MapAsync drain re-asserts it
at the reply writer regardless of completion order.

Backpressure: each connection holds at most `pipeline_depth` frames in
flight (the MapAsync in-flight cap), so the shared queue is bounded by
depth x connections and the TCP demand chain stays intact — a slow
consumer still throttles its own socket, never the window.

Observability: `gateway_ingest_window_size` (records per window) and
`gateway_ingest_window_wait_us` (per-frame wait for window close), both
step-stamped on the shared ATT_STEP axis; `stats()` is the stable
`ingest_window` summary the SLO artifact carries next to `ask_batch`
(docs/OBSERVABILITY.md, docs/SERVING_GATEWAY.md).
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional

from ..serialization import frames
from ..sharding.ask_batch import (IDLE_WAIT_MAX, IDLE_WAIT_MIN,
                                  wait_adaptive_close)

__all__ = ["IngestAggregator"]


class _PendingFrame:
    __slots__ = ("body", "future", "records", "conn_id", "seq", "t_submit")


class IngestAggregator:
    """Shared decode/admission/ask windows across connections.

    `submit(body, conn_id)` returns a Future of the reply body; the
    dispatcher closes windows on `max_window` records or `window_s`
    seconds, whichever first (a lone frame under light load waits at
    most the deadline — latency is bounded, batching is opportunistic).
    `close()` drains: every pending frame is SERVED before the
    dispatcher exits, never stranded."""

    def __init__(self, server, max_window: int = 64,
                 window_s: float = 150e-6, registry=None):
        self.server = server
        self.max_window = max(1, int(max_window))
        self.window_s = float(window_s)
        self._lock = threading.Lock()
        self._work = threading.Event()
        # continuous wave formation: when the server's
        # backend runs the continuous scheduler, windows are submitted
        # asynchronously (`submit_frames`) — the dispatcher stages
        # window N and immediately starts decoding/admitting window N+1
        # while N's device rounds are in flight. The semaphore bounds
        # dispatcher windows in flight to the server's pipeline depth.
        self._continuous = bool(getattr(server, "continuous", False)) \
            and hasattr(server, "submit_frames")
        self._inflight = 0
        self._idle_wakeups = 0
        self._depth_sem = threading.BoundedSemaphore(
            max(1, int(getattr(server, "pipeline_depth", 4))))
        self._pending: List[_PendingFrame] = []
        self._pending_records = 0
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self._seq = 0
        self._windows = 0
        self._frames = 0
        self._records = 0
        self._multi = 0
        self._max_seen = 0
        self._registry = registry
        self._h_size = self._h_wait = None
        if registry is not None:
            self._h_size = registry.histogram(
                "gateway_ingest_window_size",
                "request records aggregated per cross-connection "
                "ingest window")
            self._h_wait = registry.histogram(
                "gateway_ingest_window_wait_us",
                "microseconds a frame waited for its ingest window "
                "to close")
            registry.register_collector("ingest_window", self.stats)

    # ------------------------------------------------------------- submit
    @staticmethod
    def _peek_records(body: bytes) -> int:
        """Window-close unit: a binary body's record count straight from
        its header (count field, bytes 4..8 big-endian — no decode), 1
        for JSON and for anything malformed (the serve path types those
        per frame)."""
        if len(body) >= 8 and body[0] == frames.MAGIC:
            return max(1, int.from_bytes(body[4:8], "big"))
        return 1

    def submit(self, body: bytes, conn_id: int = 0) -> "Future[bytes]":
        """Queue one frame body for the next window; returns a Future of
        its reply body. Frames are tagged (conn_id, seq) on arrival —
        seq is the shared queue's total order, which is also each
        connection's FIFO order because the TCP stage submits
        synchronously per frame."""
        f = _PendingFrame()
        f.body = body
        f.future = Future()
        f.records = self._peek_records(body)
        f.conn_id = int(conn_id)
        f.t_submit = time.perf_counter()
        with self._lock:
            if self._closed:
                raise RuntimeError("IngestAggregator is closed")
            self._seq += 1
            f.seq = self._seq
            self._pending.append(f)
            self._pending_records += f.records
            if self._thread is None:
                t = threading.Thread(target=self._loop, daemon=True,
                                     name="akka-tpu-ingest-aggregator")
                self._thread = t
                t.start()
        self._work.set()
        return f.future

    # --------------------------------------------------------- dispatcher
    def _full(self) -> bool:
        with self._lock:
            return self._pending_records >= self.max_window

    def _idle(self) -> bool:
        """Window fast-close predicate: exactly ONE
        frame is pending, no window of ours is in flight, and the
        backend's ask pipeline is idle — a lone frame under light load
        closes its window immediately instead of eating the full
        adaptive deadline. Two or more pending frames ARE concurrency
        (and downstream idleness flickers true between waves), so the
        adaptive wait behaves exactly as before under load."""
        with self._lock:
            if self._inflight or len(self._pending) > 1:
                return False
        batcher = getattr(getattr(self.server, "backend", None),
                          "batcher", None)
        return batcher is None or batcher.idle()

    def _loop(self) -> None:
        # exponential idle backoff, same policy as the ask-batch loops
        # (1 ms after work, doubling to 250 ms idle);
        # submit's Event.set() re-arms tight polling instantly
        idle_wait = IDLE_WAIT_MIN
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
                with self._lock:
                    if not self._pending:
                        break
                    closing = self._closed
                if not closing:
                    # the AskBatcher's adaptive close: re-check fullness
                    # on every submit wakeup until the deadline, closing
                    # immediately when the whole pipeline is idle
                    wait_adaptive_close(self._work, self.window_s,
                                        self._full, idle=self._idle)
                with self._lock:
                    window: List[_PendingFrame] = []
                    taken = 0
                    # whole frames only: a frame's records never split
                    # across windows (its reply is one encode slice)
                    while self._pending and (
                            not window
                            or taken + self._pending[0].records
                            <= self.max_window):
                        f = self._pending.pop(0)
                        window.append(f)
                        taken += f.records
                    self._pending_records -= taken
                if window:
                    self._run_window(window, taken)
            with self._lock:
                if self._closed:
                    return

    def _run_window(self, window: List[_PendingFrame],
                    n_records: int) -> None:
        t_close = time.perf_counter()
        if self._continuous:
            self._run_window_async(window, n_records, t_close)
            return
        try:
            replies = self.server._serve_frames([f.body for f in window])
        except BaseException as e:  # noqa: BLE001 — fail the window's
            for f in window:        # futures, never kill the dispatcher
                if not f.future.done():
                    f.future.set_exception(e)
            return
        self._account(window, n_records, t_close)
        for f, body in zip(window, replies):
            f.future.set_result(body)

    def _run_window_async(self, window: List[_PendingFrame],
                          n_records: int, t_close: float) -> None:
        """Continuous path: stage the window's wave
        via `submit_frames` (on THIS dispatcher thread — submit order is
        the staging order, so per-connection FIFO stays structural) and
        return to window formation immediately; frame futures complete
        at the wave's resolve boundary. The depth semaphore blocks
        window N+depth's staging until an older wave resolves, bounding
        promise-pool pressure."""
        self._depth_sem.acquire()
        with self._lock:
            self._inflight += 1

        def _settle_err(e: BaseException) -> None:
            for f in window:
                if not f.future.done():
                    f.future.set_exception(e)

        try:
            sfut = self.server.submit_frames([f.body for f in window])
        except BaseException as e:  # noqa: BLE001 — never strand futures
            with self._lock:
                self._inflight -= 1
            self._depth_sem.release()
            _settle_err(e)
            return

        def _finish(sf) -> None:
            try:
                try:
                    replies = sf.result()
                except BaseException as e:  # noqa: BLE001
                    _settle_err(e)
                    return
                self._account(window, n_records, t_close)
                for f, body in zip(window, replies):
                    f.future.set_result(body)
            finally:
                with self._lock:
                    self._inflight -= 1
                self._depth_sem.release()
                self._work.set()  # idle may have transitioned: fast-close

        sfut.add_done_callback(_finish)

    def _account(self, window: List[_PendingFrame], n_records: int,
                 t_close: float) -> None:
        with self._lock:
            self._windows += 1
            self._frames += len(window)
            self._records += n_records
            self._max_seen = max(self._max_seen, n_records)
            if len(window) > 1:
                self._multi += 1
        if self._h_size is not None:
            step = self._registry.step
            self._h_size.observe(float(n_records), step=step)
            self._h_wait.observe_many(
                [(t_close - f.t_submit) * 1e6 for f in window], step=step)

    # ------------------------------------------------------------ shutdown
    def close(self, timeout: float = 10.0) -> None:
        """Shutdown flush: pending frames are SERVED (the dispatcher
        drains without the adaptive wait) before the thread exits —
        close() is a drain, not a drop. Idempotent; submit() after
        close() raises."""
        with self._lock:
            self._closed = True
            t = self._thread
        self._work.set()
        if t is not None:
            t.join(timeout)
        # continuous windows still in flight resolve on the scheduler
        # thread — wait for them so close() stays a drain, not a drop
        deadline = time.perf_counter() + timeout
        while True:
            with self._lock:
                if not self._inflight:
                    break
            if time.perf_counter() >= deadline:
                break
            time.sleep(1e-3)
        # dispatcher never ran (or died): nothing may stay unresolved
        with self._lock:
            leftover, self._pending = self._pending, []
            self._pending_records = 0
        for f in leftover:
            if not f.future.done():
                f.future.set_exception(
                    RuntimeError("IngestAggregator is closed"))

    # --------------------------------------------------------------- stats
    def stats(self) -> Dict[str, Any]:
        """The `ingest_window` summary: how much cross-connection
        coalescing the traffic actually got (mean_window_size > 1 means
        frames shared decode/admission/ask rounds)."""
        with self._lock:
            w, fr, rec = self._windows, self._frames, self._records
            return {
                "windows": float(w),
                "frames": float(fr),
                "records": float(rec),
                "mean_window_size": (rec / w) if w else 0.0,
                "mean_frames_per_window": (fr / w) if w else 0.0,
                "max_window_size": float(self._max_seen),
                "multi_frame_windows": float(self._multi),
                "pending": float(len(self._pending)),
                "idle_wakeups": float(self._idle_wakeups),
            }
