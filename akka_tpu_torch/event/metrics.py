"""MetricsRegistry: the host half of the telemetry plane.

Port of `akka_tpu/event/metrics.py` at commit ee03956 (numpy only). The
series, the registry, its sinks and `from_config` are the reference's;
`DeviceHistogram` and `expose` read `N_BUCKETS` and `bucket_upper_bounds`
from the port's `batched/metrics_slab.py`, and `close()` joins every
thread the registry started (the HTTP server's as well as the JSONL
emitter's).

The reference ships metrics as a first-class layer next to the flight
recorder (cluster metrics + JFR emitters, SURVEY §2.10). This module
unifies counters, gauges, and log-bucket histograms with nearest-rank
percentile snapshots, plus ingestion of the device metric slab
(batched/metrics_slab.py) drained through the systems' `drain_metrics()`.

Correlation contract: every sample is stamped with the device step counter
current at its last update (`set_step` / the `step` argument of
`ingest_device_slab`), so registry samples, flight-recorder events (which
carry step fields), and `trace_span` profiler brackets line up on ONE axis.

Sinks:
- `expose()` — Prometheus text exposition (device histograms carry
  power-of-two `le` buckets from metrics_slab.bucket_upper_bounds; host
  histograms carry `quantile` summary lines).
- an opt-in tiny HTTP endpoint (`serve_http`, behind
  `akka.metrics.http-port`; 0 = off, the default).
- a periodic JSONL emitter (`start_jsonl`) sharing the flight recorder's
  file conventions: makedirs, line-buffered append, `"event"`/`"ts"` keys.

Everything is thread-safe and noop-cheap: a registry that nobody feeds
holds a dict and does nothing.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

# host-histogram bucketing mirrors the device slab's power-of-two rule
# (metrics_slab.bucket_of) but with enough range for microsecond latencies:
# bucket(v) = #{k : v >= 2^k}, v <= 0 -> 0
_HOST_BUCKETS = 64


def _host_bucket(v: float) -> int:
    if v < 1.0:
        return 0
    return min(int(v).bit_length(), _HOST_BUCKETS - 1)


class Counter:
    """Monotonic int64 counter."""

    __slots__ = ("name", "help", "_value", "step")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0
        self.step: Optional[int] = None

    def inc(self, n: int = 1, step: Optional[int] = None) -> None:
        self._value += int(n)
        if step is not None:
            self.step = int(step)

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("name", "help", "_value", "step")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0
        self.step: Optional[int] = None

    def set(self, v: float, step: Optional[int] = None) -> None:
        self._value = float(v)
        if step is not None:
            self.step = int(step)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Host-side log-bucket histogram (power-of-two buckets, like the
    device slab but 64 wide) with nearest-rank percentile snapshots.

    Percentile estimation returns the UPPER bound of the bucket holding
    the nearest-rank sample (rank = ceil(q*n), 1-based — the corrected
    rule, see pipeline_stats' pct fix), i.e. a conservative estimate that
    never under-reports; exact to within one power of two."""

    __slots__ = ("name", "help", "_buckets", "_count", "_sum", "step")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._buckets = np.zeros((_HOST_BUCKETS,), np.int64)
        self._count = 0
        self._sum = 0.0
        self.step: Optional[int] = None

    def observe(self, v: float, step: Optional[int] = None) -> None:
        self._buckets[_host_bucket(v)] += 1
        self._count += 1
        self._sum += float(v)
        if step is not None:
            self.step = int(step)

    def observe_many(self, vs, step: Optional[int] = None) -> None:
        """Vectorized observe for a whole wave of samples (the binary
        ingress path records per-window): one bincount instead of N
        scalar bucket updates. Bucket math matches _host_bucket exactly
        (bit_length of the integer part, clamped)."""
        arr = np.asarray(vs, np.float64).reshape(-1)
        if arr.size == 0:
            return
        idx = np.where(
            arr < 1.0, 0,
            np.minimum(
                np.frexp(np.maximum(arr, 1.0).astype(np.int64)
                         .astype(np.float64))[1],
                _HOST_BUCKETS - 1))
        self._buckets += np.bincount(idx.astype(np.int64),
                                     minlength=_HOST_BUCKETS)
        self._count += int(arr.size)
        self._sum += float(arr.sum())
        if step is not None:
            self.step = int(step)

    def percentile(self, q: float) -> float:
        if self._count == 0:
            return 0.0
        rank = max(1, math.ceil(q * self._count))  # 1-based nearest rank
        cum = np.cumsum(self._buckets)
        b = int(np.searchsorted(cum, rank))
        return float((1 << b) - 1) if b > 0 else 0.0

    def snapshot(self) -> Dict[str, Any]:
        return {"count": self._count, "sum": self._sum,
                "p50": self.percentile(0.50), "p95": self.percentile(0.95),
                "p99": self.percentile(0.99), "step": self.step}


class DeviceHistogram:
    """One drained device-slab lane: CUMULATIVE fixed-bucket counts (the
    slab accumulates monotonically between restores), stamped with the
    device step of the last drain."""

    __slots__ = ("name", "buckets", "step")

    def __init__(self, name: str):
        self.name = name
        from ..batched.metrics_slab import N_BUCKETS
        self.buckets = np.zeros((N_BUCKETS,), np.int64)
        self.step: Optional[int] = None

    @property
    def count(self) -> int:
        return int(self.buckets.sum())

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile over the bucket counts; returns the
        bucket's inclusive upper bound (+inf for the saturating bucket)."""
        from ..batched.metrics_slab import bucket_upper_bounds
        n = self.count
        if n == 0:
            return 0.0
        rank = max(1, math.ceil(q * n))
        cum = np.cumsum(self.buckets)
        return float(bucket_upper_bounds()[int(np.searchsorted(cum, rank))])


class MetricsRegistry:
    """Process-wide metric registry. Series are created on first touch and
    live for the registry's lifetime; collectors are pull-time callables
    whose numeric fields surface as gauges under their prefix."""

    def __init__(self, namespace: str = "akka"):
        self.namespace = namespace
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._device: Dict[str, DeviceHistogram] = {}
        self._collectors: Dict[str, Callable[[], Dict[str, Any]]] = {}
        self._step = 0  # newest device step seen by any stamp
        self._http_server = None
        self._http_thread = None
        self._jsonl_fh = None
        self._jsonl_thread = None
        self._jsonl_stop = threading.Event()

    # ------------------------------------------------------------- series
    def counter(self, name: str, help: str = "") -> Counter:
        with self._lock:
            return self._counters.setdefault(name, Counter(name, help))

    def gauge(self, name: str, help: str = "") -> Gauge:
        with self._lock:
            return self._gauges.setdefault(name, Gauge(name, help))

    def histogram(self, name: str, help: str = "") -> Histogram:
        with self._lock:
            return self._histograms.setdefault(name, Histogram(name, help))

    def register_collector(self, prefix: str,
                           fn: Callable[[], Dict[str, Any]]) -> None:
        """Absorb an existing `*_stats()`-style dict source: at pull time
        (expose / JSONL emit) its numeric fields become gauges named
        `<prefix>_<field>`; non-numeric fields are skipped."""
        with self._lock:
            self._collectors[prefix] = fn

    def set_step(self, step: int) -> None:
        """Advance the correlation axis: the device step counter current
        for subsequently stamped samples."""
        self._step = max(self._step, int(step))

    @property
    def step(self) -> int:
        return self._step

    # ------------------------------------------------------- device slab
    def ingest_device_slab(self, lanes: Dict[str, np.ndarray],
                           step: int) -> None:
        """One drain of the device metric slab (metrics_slab.slab_dict
        output): cumulative bucket counts replace the previous drain's,
        every lane stamped with the draining step."""
        self.set_step(step)
        with self._lock:
            for name, buckets in lanes.items():
                key = f"device_{name}"
                h = self._device.get(key)
                if h is None:
                    h = self._device[key] = DeviceHistogram(key)
                h.buckets = np.asarray(buckets, np.int64)
                h.step = int(step)

    def device_histogram(self, lane: str) -> Optional[DeviceHistogram]:
        return self._device.get(f"device_{lane}")

    # ------------------------------------------------------------- pulls
    def _pull_collectors(self) -> List[Tuple[str, float]]:
        out: List[Tuple[str, float]] = []
        with self._lock:
            items = list(self._collectors.items())
        for prefix, fn in items:
            try:
                d = fn()
            except Exception:  # noqa: BLE001 — a sick collector never breaks expose
                continue
            for k, v in d.items():
                if isinstance(v, bool) or not isinstance(
                        v, (int, float, np.integer, np.floating)):
                    continue
                out.append((f"{prefix}_{k}", float(v)))
        return out

    def expose(self) -> str:
        """Prometheus-style text exposition of every series."""
        from ..batched.metrics_slab import bucket_upper_bounds
        ns = self.namespace
        lines: List[str] = []
        with self._lock:
            counters = list(self._counters.values())
            gauges = list(self._gauges.values())
            hists = list(self._histograms.values())
            device = list(self._device.values())
        for c in counters:
            lines.append(f"# TYPE {ns}_{c.name} counter")
            lines.append(f"{ns}_{c.name} {c.value}")
        for g in gauges:
            lines.append(f"# TYPE {ns}_{g.name} gauge")
            lines.append(f"{ns}_{g.name} {g.value:g}")
        for name, v in self._pull_collectors():
            lines.append(f"# TYPE {ns}_{name} gauge")
            lines.append(f"{ns}_{name} {v:g}")
        for h in hists:
            s = h.snapshot()
            lines.append(f"# TYPE {ns}_{h.name} summary")
            for q in (0.50, 0.95, 0.99):
                lines.append(f'{ns}_{h.name}{{quantile="{q}"}} '
                             f"{h.percentile(q):g}")
            lines.append(f"{ns}_{h.name}_count {s['count']}")
            lines.append(f"{ns}_{h.name}_sum {s['sum']:g}")
        ubs = bucket_upper_bounds()
        for d in device:
            lines.append(f"# TYPE {ns}_{d.name} histogram")
            cum = 0
            for i, n in enumerate(d.buckets.tolist()):
                cum += int(n)
                le = "+Inf" if math.isinf(ubs[i]) else str(int(ubs[i]))
                lines.append(f'{ns}_{d.name}_bucket{{le="{le}"}} {cum}')
            lines.append(f"{ns}_{d.name}_count {cum}")
            # the step stamp rides as a companion gauge: the device step
            # of the drain that produced these counts (correlation axis)
            lines.append(f"{ns}_{d.name}_step "
                         f"{d.step if d.step is not None else 0}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, Any]:
        """One JSON-able frame of every series (the JSONL emitter's row
        body; also handy for tests)."""
        with self._lock:
            frame: Dict[str, Any] = {
                "step": self._step,
                "counters": {c.name: c.value
                             for c in self._counters.values()},
                "gauges": {g.name: g.value for g in self._gauges.values()},
                "histograms": {h.name: h.snapshot()
                               for h in self._histograms.values()},
                "device": {d.name: {"buckets": d.buckets.tolist(),
                                    "count": d.count,
                                    "p50": d.percentile(0.50),
                                    "p95": d.percentile(0.95),
                                    "p99": d.percentile(0.99),
                                    "step": d.step}
                           for d in self._device.values()},
            }
        frame["collected"] = dict(self._pull_collectors())
        return frame

    # ---------------------------------------------------------- HTTP sink
    def serve_http(self, port: int, host: str = "127.0.0.1") -> int:
        """Start the opt-in exposition endpoint (GET /metrics). Returns
        the bound port (pass 0 to let the OS pick — tests do). Daemon
        thread; close() tears it down."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        registry = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server API
                body = registry.expose().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # silence per-request stderr
                pass

        srv = ThreadingHTTPServer((host, int(port)), Handler)
        srv.daemon_threads = True
        t = threading.Thread(target=srv.serve_forever,
                             name="akka-tpu-torch-metrics-http", daemon=True)
        with self._lock:
            self._http_server, self._http_thread = srv, t
        t.start()
        return int(srv.server_address[1])

    # --------------------------------------------------------- JSONL sink
    def start_jsonl(self, path: str, interval_s: float = 1.0) -> None:
        """Periodic JSONL emitter, flight-recorder file conventions
        (JsonlFlightRecorder): makedirs, line-buffered append, one
        `{"event": "metrics", "ts": ..., ...}` object per line."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        fh = open(path, "a", buffering=1)
        with self._lock:
            self._jsonl_fh = fh
        self._jsonl_stop.clear()

        def loop():
            while not self._jsonl_stop.wait(interval_s):
                self.emit_jsonl_once()

        t = threading.Thread(target=loop, name="akka-tpu-torch-metrics-jsonl",
                             daemon=True)
        with self._lock:
            self._jsonl_thread = t
        t.start()

    def emit_jsonl_once(self) -> None:
        fh = self._jsonl_fh
        if fh is None:
            return
        row = {"event": "metrics", "ts": time.time(), **self.snapshot()}
        try:
            fh.write(json.dumps(row) + "\n")
        except ValueError:  # closed mid-shutdown
            pass

    def close(self) -> None:
        """Final JSONL frame, then tear down both sinks and join the
        threads that ran them."""
        self._jsonl_stop.set()
        t = self._jsonl_thread
        if t is not None:
            t.join(timeout=2.0)
            self._jsonl_thread = None
        if self._jsonl_fh is not None:
            self.emit_jsonl_once()
            try:
                self._jsonl_fh.close()
            except Exception:  # noqa: BLE001
                pass
            self._jsonl_fh = None
        srv, t = self._http_server, self._http_thread
        if srv is not None:
            try:
                srv.shutdown()
                srv.server_close()
            except Exception:  # noqa: BLE001
                pass
            self._http_server = None
        if t is not None:
            t.join(timeout=2.0)
            self._http_thread = None


def from_config(config) -> Optional[MetricsRegistry]:
    """`akka.metrics.enabled` gates the whole plane (default off). With it
    on: `http-port` > 0 starts the exposition endpoint, `jsonl-path`
    starts the periodic emitter at `jsonl-interval` seconds."""
    if config is None or not config.get_bool("akka.metrics.enabled", False):
        return None
    reg = MetricsRegistry(config.get_string("akka.metrics.namespace",
                                            "akka"))
    port = config.get_int("akka.metrics.http-port", 0)
    if port > 0:
        reg.serve_http(port)
    path = config.get_string("akka.metrics.jsonl-path", "")
    if path:
        reg.start_jsonl(path,
                        config.get_duration("akka.metrics.jsonl-interval",
                                            "1s"))
    return reg
