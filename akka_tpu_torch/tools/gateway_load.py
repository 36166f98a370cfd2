"""Client load for the served path: threaded gateway clients sending
pipelined binary add windows, with each window's reply latency.

Used by `chip_smoke.py` (the gateway_serve phases) and
`tools/profile_step.py` (the gateway_serve cells):

    backend, srv = serve_stack(region, continuous=True)
    traces = client_traces(seed=1, clients=16, entities=64, adds=512)
    result = drive(srv.host, srv.port, traces)

Each client owns its entities, so every ok reply must equal that client's
running total for its entity. A record shed by admission is retried after
`retry_after_ms`, once the client's pipelined pass is done (so the server
applies it after the records sent before it; `replies` is in that order).

As a program it is a load process of its own, so the clients' Python does
not share the server's interpreter lock:

    python -m akka_tpu_torch.tools.gateway_load --port PORT [--clients 16]

reads one `SEED ADDS` line per run from stdin, drives `--clients` clients
with `ADDS` adds each, and prints one JSON line per run (requests,
seconds, reply p50/p99 in ms, sheds, errors); it exits at end of input.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..gateway import (AdmissionController, GatewayClient, GatewayServer,
                       RegionBackend, SloTracker)
from ..serialization import frames

Record = Tuple[str, str, str, float]  # (tenant, entity, op, value)


class TimedClient(GatewayClient):
    """A GatewayClient whose pipelined windows record their latency: the
    time from a window's send to its reply."""

    def timed_pipelined(self, windows: Sequence[Sequence[Record]],
                        depth: int = 4):
        """`request_many_pipelined` with the latency of every window, in
        seconds. Returns (replies per window, latencies)."""
        if self._sock is None:
            self.connect()
        encoded, first_ids = [], []
        for win in windows:
            ids = [self._next_id() for _ in win]
            tenants, ents, ops, vals = zip(*win)
            encoded.append(frames.frame(frames.encode_request_batch(
                ids, list(tenants), list(ents), list(ops),
                [float(v) for v in vals])))
            first_ids.append(ids[0])
        out: List[List[dict]] = []
        sent_at: List[float] = []
        lat: List[float] = []
        while len(out) < len(encoded):
            while len(sent_at) < len(encoded) and \
                    len(sent_at) - len(out) < depth:
                sent_at.append(time.perf_counter())
                self._sock.sendall(encoded[len(sent_at) - 1])
            data = self._sock.recv(1 << 16)
            if not data:
                raise ConnectionError("gateway closed the connection")
            for body in self._reader.feed_raw(data):
                reps = frames.decode_replies(body, self.max_frame)
                k = len(out)
                if reps[0]["id"] != first_ids[k]:
                    raise ValueError(f"pipelined reply out of order: got "
                                     f"{reps[0]['id']}, want {first_ids[k]}")
                lat.append(time.perf_counter() - sent_at[k])
                out.append(reps)
        return out, lat


def client_traces(seed: int, clients: int, entities: int, adds: int,
                  window: int = 8) -> List[List[List[Record]]]:
    """Per client: `adds` integer-valued adds (1..9) over its own
    `entities` entities (named after the seed too, so each seed's run
    starts from fresh entities), cut into windows of `window` records."""
    rng = np.random.default_rng(seed)
    out = []
    for c in range(clients):
        ents = rng.integers(0, entities, adds)
        vals = rng.integers(1, 10, adds)
        recs = [(f"tenant-{c}", f"s{seed}-c{c}-e{int(e)}", "add", float(v))
                for e, v in zip(ents, vals)]
        out.append([recs[i:i + window] for i in range(0, adds, window)])
    return out


def serve_stack(region, continuous: bool = True, pipeline_depth: int = 4,
                host: str = "127.0.0.1"):
    """RegionBackend + GatewayServer (evloop transport, ingest windows)
    over `region`, admission wide open but for the ask-pool pressure
    signal; started. Returns (backend, server)."""
    backend = RegionBackend(region, continuous=continuous,
                            pipeline_depth=pipeline_depth)
    adm = AdmissionController(
        rate=1e9, burst=1e9, pressure_signals=backend.pressure_signals(),
        thresholds={"ask_pool_occupancy": 0.9})
    srv = GatewayServer(None, backend, adm, SloTracker(), host=host,
                        transport="evloop", aggregate=True)
    srv.start()
    return backend, srv


@dataclass
class LoadResult:
    """What the clients saw: per client, (entity, value, reply) in the
    order the server applied the adds; window latencies; sheds; errors."""
    replies: List[List[Tuple[str, float, float]]]
    latencies: List[float]
    sheds: int
    errors: List[str] = field(default_factory=list)
    seconds: float = 0.0

    @property
    def acked(self) -> float:
        return float(sum(v for rs in self.replies for _, v, _ in rs))

    @property
    def requests(self) -> int:
        return sum(len(rs) for rs in self.replies)


def drive(host: str, port: int, traces, depth: int = 4,
          timeout: float = 120.0) -> LoadResult:
    """One thread and one TimedClient per trace; returns the LoadResult
    (wall seconds from the clients' start to the last reply)."""
    n = len(traces)
    replies: List[List[Tuple[str, float, float]]] = [[] for _ in range(n)]
    lats: List[List[float]] = [[] for _ in range(n)]
    sheds = [0] * n
    errors: List[str] = []

    def client(c: int) -> None:
        cl = TimedClient(host, port, timeout=timeout)
        try:
            reps, lat = cl.timed_pipelined(traces[c], depth)
            lats[c] = lat
            retry = []
            for win, got in zip(traces[c], reps):
                for (tenant, ent, op, val), rep in zip(win, got):
                    if rep["status"] == "shed":
                        retry.append((tenant, ent, val, rep))
                    elif rep["status"] == "ok":
                        replies[c].append((ent, val, rep["value"]))
                    else:
                        errors.append(f"client {c}: {rep}")
            for tenant, ent, val, rep in retry:
                while rep["status"] == "shed":
                    sheds[c] += 1
                    time.sleep(rep.get("retry_after_ms", 10) / 1e3)
                    rep = cl.request_binary(tenant, ent, "add", val)
                if rep["status"] == "ok":
                    replies[c].append((ent, val, rep["value"]))
                else:
                    errors.append(f"client {c}: {rep}")
        except BaseException as e:  # noqa: BLE001 — reported to the caller
            errors.append(f"client {c}: {e!r}")
        finally:
            cl.close()

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(n)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    seconds = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        errors.append("a client thread did not finish")
    return LoadResult(replies, [x for ls in lats for x in ls], sum(sheds),
                      errors, seconds)


def running_totals_hold(result: LoadResult) -> bool:
    """Every ok reply equals its client's running total for its entity
    (each run's entities start at 0)."""
    for rs in result.replies:
        tot: Dict[str, float] = {}
        for ent, val, rep in rs:
            tot[ent] = tot.get(ent, 0.0) + val
            if rep != tot[ent]:
                return False
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="gateway client load")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--entities", type=int, default=64)
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--depth", type=int, default=4)
    args = ap.parse_args(argv)
    for line in sys.stdin:
        seed, adds = (int(x) for x in line.split())
        res = drive(args.host, args.port, client_traces(
            seed, args.clients, args.entities, adds, args.window),
            args.depth)
        lat = np.asarray(res.latencies) * 1e3
        print(json.dumps({
            "requests": res.requests, "seconds": res.seconds,
            "reply_ms_p50": float(np.percentile(lat, 50)) if lat.size
            else None,
            "reply_ms_p99": float(np.percentile(lat, 99)) if lat.size
            else None,
            "sheds": res.sheds, "errors": len(res.errors),
            "running_totals_hold": running_totals_hold(res)}), flush=True)
    return 0


__all__ = ["TimedClient", "client_traces", "serve_stack", "drive",
           "LoadResult", "running_totals_hold"]

if __name__ == "__main__":
    sys.exit(main())
