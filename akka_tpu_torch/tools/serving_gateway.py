#!/usr/bin/env python3
"""Serving gateway on the port: external traffic in, counter entities on
the card, SLOs out.

After the reference's `examples/serving_gateway.py`, on akka_tpu_torch.
Three subcommands compose into a small multi-process serving stack:

  serve  -- one gateway process: the evloop TCP front door, admission
            control, SLO tracker, and a continuous-wave RegionBackend
            over a DeviceShardRegion of counter entities with the tell
            WAL and checkpoint directory armed (`--dir`). Runs on the
            card by default; `--device cpu` runs it on the CPU. Without
            `--restore` it takes a baseline checkpoint; with it, it
            recovers from the directory and prints "RESTORED step=N"
            (and, with `--durable`, "DURABLE respawned=N sum=X").
            `--durable` arms the entity journal and a record-log
            remember-entities store. On the card the region's step graph
            is captured first (warmup), before the restore's replay and
            the front end's threads. Prints "READY <port>" once bound.
  load   -- one load-generator process: paced client traffic through
            the front door, reconnecting through server restarts.
            Prints a JSON result line (sent/acked sums, outcome counts).
  demo   -- the orchestrator: spawns a durable serve child and two load
            children, then over the wire: rebalances a shard, SIGKILLs
            the server and restarts it with `--restore` on the same port
            and directory, fails the region over from 2 shard slots to 1
            (the `failover` admin op), and checks the conserved-value
            invariant

                acked_sum <= final_total <= sent_sum

Run it:   python -m akka_tpu_torch.tools.serving_gateway demo
          python -m akka_tpu_torch.tools.serving_gateway demo --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Optional

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MODULE = "akka_tpu_torch.tools.serving_gateway"


# ------------------------------------------------------------------ serve
def cmd_serve(args: argparse.Namespace) -> int:
    from akka_tpu_torch.gateway import (AdmissionController, GatewayServer,
                                        RegionBackend, ReplyCacheTable,
                                        SloTracker, counter_behavior)
    from akka_tpu_torch.sharding import DeviceEntity, DeviceShardRegion

    if args.device == "cpu":
        import torch
        torch.set_num_threads(1)
    spec = DeviceEntity(
        "counter", counter_behavior(4), n_shards=args.shards,
        entities_per_shard=args.eps, n_devices=args.devices,
        payload_width=4, spare_blocks=2)
    if args.durable:
        # remembered ids in a record-log store; per-entity events
        # group-committed at the ask-wave boundary into the entity journal
        from akka_tpu_torch.sharding.remember import \
            JournalRememberEntitiesStore
        spec.remember_store = JournalRememberEntitiesStore(
            os.path.join(args.dir, "remember_entities.journal"))
    region = DeviceShardRegion(spec, device=args.device)
    # capture the step's CUDA graph now, before the restore's replay and
    # the front end's threads (a no-op on the CPU)
    region.system.warmup()
    region.attach_journal(args.dir, fsync_every_n=args.fsync_every_n)
    if args.durable:
        region.attach_entity_journal(args.dir,
                                     fsync_every_n=args.fsync_every_n)
    if args.restore:
        from akka_tpu_torch.ops import cuda_mailbox
        cuda_mailbox.reset_launches()  # the replay's kernel launches
        step = region.restore()
        launches = json.dumps(dict(cuda_mailbox.LAUNCHES),
                              separators=(",", ":"))
        print(f"RESTORED step={step} " + " ".join(
            f"{k}={v}" for k, v in region.restore_timings.items()) +
            f" launches={launches}", flush=True)
        if args.durable:
            replayed = region._durable_replayed_totals or {}
            print(f"DURABLE respawned={len(replayed)} "
                  f"sum={sum(replayed.values()):.1f}", flush=True)
    else:
        region.checkpoint()  # the baseline snapshot recovery starts from
    backend = RegionBackend(region, continuous=True, pipeline_depth=4)
    admission = AdmissionController(
        rate=args.rate, burst=args.burst,
        pressure_signals=backend.pressure_signals(),
        thresholds={"ask_pool_occupancy": 0.9,
                    "mailbox_overflow": 0.0,     # any NEW device mail loss
                    "exchange_dropped": 0.0})
    slo = SloTracker(target_p50_ms=args.target_p50_ms,
                     target_p99_ms=args.target_p99_ms)
    dedup = ReplyCacheTable(window=args.dedup_window) if args.dedup \
        else None
    server = GatewayServer(None, backend, admission, slo, port=args.port,
                           transport="evloop", aggregate=True, dedup=dedup)
    host, port = server.start()
    print(f"READY {port}", flush=True)

    stop = {"flag": False}

    def _term(signum, frame):
        stop["flag"] = True

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    try:
        while not stop["flag"]:
            time.sleep(0.1)
    finally:
        server.stop()
        backend.close()
        print("SLO " + json.dumps(slo.artifact()), flush=True)
    return 0


# ------------------------------------------------------------------- load
def cmd_load(args: argparse.Namespace) -> int:
    from akka_tpu_torch.gateway import GatewayClient

    client = GatewayClient("127.0.0.1", args.port, timeout=10.0)
    deadline = time.monotonic() + args.seconds
    sent_sum = acked_sum = 0.0
    counts = {"ok": 0, "shed": 0, "error": 0, "conn_error": 0}
    i = 0
    while time.monotonic() < deadline:
        i += 1
        entity = f"{args.tenant}-acct-{i % args.entities}"
        value = float(i % 5 + 1)
        # one attempt == one wire send: sent_sum counts every send
        sent_sum += value
        try:
            reply = client.request(args.tenant, entity, "add", value)
        except (OSError, ConnectionError, socket.timeout):
            counts["conn_error"] += 1
            client.close()
            time.sleep(args.pause)
            continue
        status = reply.get("status")
        if status == "ok":
            acked_sum += value
            counts["ok"] += 1
        elif status == "shed":
            counts["shed"] += 1
            time.sleep(min(1.0, reply.get("retry_after_ms", 100) / 1e3))
        else:
            counts["error"] += 1
        if args.pace > 0:
            time.sleep(args.pace)
    client.close()
    print(json.dumps({"tenant": args.tenant, "sent_sum": sent_sum,
                      "acked_sum": acked_sum, **counts}), flush=True)
    return 0


# ------------------------------------------------------------------- demo
def _child(argv) -> subprocess.Popen:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    return subprocess.Popen([sys.executable, "-m", MODULE, *argv], cwd=ROOT,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _wait_ready(proc: subprocess.Popen, secs: float = 120.0,
                seen: Optional[list] = None) -> int:
    """Echo the serve child's lines (and append them to `seen`) until
    "READY <port>"; returns the port. Raises if the child exits first or
    `secs` pass. The lines are read on a thread of their own, so the wait
    stays bounded even when the child prints nothing; the thread ends at
    READY or end of output."""
    lines: "queue.Queue" = queue.Queue()

    def pump() -> None:
        for line in iter(proc.stdout.readline, ""):
            lines.put(line)
            if line.startswith("READY "):
                return
        lines.put(None)

    threading.Thread(target=pump, daemon=True).start()
    deadline = time.monotonic() + secs
    while True:
        try:
            line = lines.get(timeout=max(0.0, deadline - time.monotonic()))
        except queue.Empty:
            raise TimeoutError("serve child never printed READY") from None
        if line is None:
            raise RuntimeError(
                f"serve child exited rc={proc.poll()} before READY")
        sys.stdout.write(f"  [serve] {line}")
        if seen is not None:
            seen.append(line)
        if line.startswith("READY "):
            return int(line.split()[1])


def _wait_sum_above(admin, floor: float, secs: float = 60.0) -> float:
    """Poll the admin `sum` until it exceeds `floor` (traffic is landing);
    returns it. Raises after `secs`."""
    deadline = time.monotonic() + secs
    while time.monotonic() < deadline:
        rep = admin.request_retry("__admin", "", "sum", deadline_s=secs)
        if rep.get("status") == "ok" and float(rep["value"]) > floor:
            return float(rep["value"])
        time.sleep(0.1)
    raise TimeoutError(f"the sum stayed at or below {floor} for {secs} s")


def serve_argv(device: str, directory: str, port: int = 0,
               restore: bool = False, extra=()) -> list:
    """The argv of a durable, deduplicating `serve` child."""
    argv = ["serve", "--device", device, "--dir", directory,
            "--port", str(port), "--durable", "--dedup", *extra]
    return argv + ["--restore"] if restore else argv


def kill9_restart(serve: subprocess.Popen, argv, secs: float = 120.0,
                  seen: Optional[list] = None) -> tuple:
    """SIGKILL the serve child (no goodbye), restart it with `argv` (which
    carries --restore), and wait for READY (its lines go to `seen`).
    Returns (the new child, the seconds from the SIGKILL to READY)."""
    t0 = time.monotonic()
    serve.send_signal(signal.SIGKILL)
    serve.wait(timeout=60)
    serve.stdout.close()
    fresh = _child(argv)
    _wait_ready(fresh, secs, seen)
    return fresh, time.monotonic() - t0


def restored_fields(lines) -> dict:
    """The `key=value` fields of a restarted serve child's RESTORED and
    DURABLE lines (values parsed as JSON where they are)."""
    out = {}
    for line in lines:
        if line.startswith(("RESTORED ", "DURABLE ")):
            for tok in line.split()[1:]:
                k, _, v = tok.partition("=")
                try:
                    out[k] = json.loads(v)
                except ValueError:
                    out[k] = v
    return out


def cmd_demo(args: argparse.Namespace) -> int:
    import shutil
    import tempfile

    from akka_tpu_torch.gateway import GatewayClient

    directory = args.dir or tempfile.mkdtemp(prefix="gateway_demo_")
    extra = ["--shards", "4", "--eps", "16", "--devices", "2", "--rate",
             "400", "--burst", "200"]
    serve = _child(serve_argv(args.device, directory, extra=extra))
    loads = []
    admin = None
    try:
        port = _wait_ready(serve)
        print(f"[demo] gateway up on :{port} ({args.device}, checkpoint dir "
              f"{directory}); starting 2 load processes")
        loads = [_child(["load", "--port", str(port), "--tenant",
                         f"tenant{i}", "--seconds", str(args.seconds),
                         "--pace", "0.01"]) for i in (0, 1)]
        admin = GatewayClient("127.0.0.1", port, timeout=30.0)

        time.sleep(args.seconds * 0.25)
        before = _wait_sum_above(admin, 0.0)
        print("[demo] chaos leg 1: shard rebalance (admin op over the wire)")
        rep = admin.request_retry("__admin", "", "rebalance", 0.0,
                                  deadline_s=60.0)
        print("  ->", rep)
        if rep.get("status") != "ok":
            raise RuntimeError(f"rebalance failed: {rep}")

        time.sleep(args.seconds * 0.2)
        _wait_sum_above(admin, before)  # acked writes since the rebalance
        print("[demo] chaos leg 2: kill -9 the gateway, restart it with "
              "--restore on the same port and directory")
        admin.close()
        serve, secs = kill9_restart(serve, serve_argv(
            args.device, directory, port, restore=True, extra=extra))
        print(f"[demo] SIGKILL to READY {secs:.2f} s")
        rep = admin.request_retry("__admin", "", "durable", deadline_s=60.0)
        print("  -> durable:", rep)
        print("[demo] chaos leg 3: device failover (2 -> 1 shard slot)")
        rep = admin.request_retry("__admin", "", "failover", 1.0,
                                  deadline_s=60.0)
        print("  ->", rep)
        if rep.get("status") != "ok":
            raise RuntimeError(f"failover failed: {rep}")
        print(f"[demo] FAILOVER ok step={int(rep['value'])}")

        results = []
        for p in loads:
            out = p.communicate(timeout=args.seconds + 120)[0]
            for line in out.splitlines():
                try:
                    results.append(json.loads(line))
                except ValueError:
                    sys.stdout.write(f"  [load] {line}\n")
        if len(results) != len(loads):
            raise RuntimeError("a load child printed no result")
        sent = sum(r["sent_sum"] for r in results)
        acked = sum(r["acked_sum"] for r in results)
        final = admin.request_retry("__admin", "", "sum", deadline_s=60.0)
        artifact = admin.request_retry("__admin", "", "artifact",
                                       deadline_s=60.0)["data"]
    finally:
        if admin is not None:
            admin.close()
        for p in loads:
            if p.poll() is None:
                p.kill()
                p.wait()
        serve.send_signal(signal.SIGTERM)
        try:
            out = serve.communicate(timeout=30)[0]
            for line in out.splitlines():
                sys.stdout.write(f"  [serve] {line}\n")
        except subprocess.TimeoutExpired:
            serve.kill()
            serve.wait()
        if args.dir is None:
            shutil.rmtree(directory, ignore_errors=True)

    total = float(final["value"])
    ok = acked <= total + 1e-6 and total <= sent + 1e-6
    print(json.dumps({"sent_sum": sent, "acked_sum": acked,
                      "final_total": total, "invariant_held": ok,
                      "p50_ms": artifact["p50_ms"],
                      "p99_ms": artifact["p99_ms"],
                      "reject_rate": artifact["reject_rate"],
                      "requests": artifact["requests"]}, indent=2))
    if not ok:
        print("[demo] CONSERVED-VALUE INVARIANT VIOLATED", file=sys.stderr)
        return 1
    print("[demo] invariant held: acked <= final <= sent")
    return 0


# ------------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("serve", help="run one gateway process")
    s.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    s.add_argument("--port", type=int, default=0)
    s.add_argument("--shards", type=int, default=4)
    s.add_argument("--eps", type=int, default=16)
    s.add_argument("--devices", type=int, default=None,
                   help="shards of the region's axis (one card)")
    s.add_argument("--rate", type=float, default=200.0)
    s.add_argument("--burst", type=float, default=100.0)
    s.add_argument("--dir", required=True,
                   help="checkpoint + WAL directory")
    s.add_argument("--restore", action="store_true",
                   help="recover from --dir instead of starting fresh")
    s.add_argument("--durable", action="store_true",
                   help="entity journal + remember-entities store")
    s.add_argument("--fsync-every-n", type=int, default=1,
                   help="group commit of both journals: fsync every n "
                        "appends (tells) / waves (entity events)")
    s.add_argument("--dedup", action="store_true",
                   help="reply-cache dedup (exactly-once retry effects; "
                        "with --durable the replies ride the entity "
                        "journal and survive kill -9)")
    s.add_argument("--dedup-window", type=int, default=4096,
                   help="remembered request ids per tenant")
    s.add_argument("--target-p50-ms", type=float, default=50.0)
    s.add_argument("--target-p99-ms", type=float, default=500.0)

    ld = sub.add_parser("load", help="run one load-generator process")
    ld.add_argument("--port", type=int, required=True)
    ld.add_argument("--tenant", default="tenant0")
    ld.add_argument("--entities", type=int, default=8)
    ld.add_argument("--seconds", type=float, default=10.0)
    ld.add_argument("--pace", type=float, default=0.01)
    ld.add_argument("--pause", type=float, default=0.2)

    d = sub.add_parser("demo", help="3-process demo with a rebalance and "
                                    "a kill -9 + restore leg")
    d.add_argument("--device", default="cuda",
                   help="the serve child's device: cuda (default) or cpu")
    d.add_argument("--seconds", type=float, default=20.0)
    d.add_argument("--dir", default=None,
                   help="checkpoint dir (default: a temporary one, "
                        "removed at the end)")

    args = ap.parse_args(argv)
    return {"serve": cmd_serve, "load": cmd_load,
            "demo": cmd_demo}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
