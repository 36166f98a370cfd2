#!/usr/bin/env python3
"""Serving gateway on the port: external traffic in, counter entities on
the card, SLOs out.

After the reference's `examples/serving_gateway.py`, on akka_tpu_torch.
Three subcommands compose into a small multi-process serving stack:

  serve  -- one gateway process: the evloop TCP front door, admission
            control, SLO tracker, and a continuous-wave RegionBackend
            over a DeviceShardRegion of counter entities. Runs on the
            card by default; `--device cpu` runs it on the CPU. Prints
            "READY <port>" once bound.
  load   -- one load-generator process: paced client traffic through
            the front door. Prints a JSON result line (sent/acked sums,
            outcome counts).
  demo   -- the orchestrator: spawns a serve child and two load
            children, rebalances a shard over the wire mid-run, and
            checks the conserved-value invariant

                acked_sum <= final_total <= sent_sum

            The reference's kill -9 + restore leg and its device
            failover leg are not run: the region's checkpoint/restore is
            ROADMAP A8 and failover A10. The demo sends both admin ops
            and checks that each answers with its typed `admin_fault:`
            error.

Run it:   python -m akka_tpu_torch.tools.serving_gateway demo
          python -m akka_tpu_torch.tools.serving_gateway demo --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import time

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
    region = DeviceShardRegion(DeviceEntity(
        "counter", counter_behavior(4), n_shards=args.shards,
        entities_per_shard=args.eps, n_devices=args.devices,
        payload_width=4, spare_blocks=2), device=args.device)
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


def _wait_ready(proc: subprocess.Popen, secs: float = 120.0) -> int:
    deadline = time.monotonic() + secs
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            raise RuntimeError(
                f"serve child exited rc={proc.poll()} before READY")
        sys.stdout.write(f"  [serve] {line}")
        if line.startswith("READY "):
            return int(line.split()[1])
    raise TimeoutError("serve child never printed READY")


def _expect_typed_fault(admin, op: str, item: str) -> None:
    """The admin op must answer with its typed error naming `item`."""
    rep = admin.request_retry("__admin", "", op, 1.0, deadline_s=60.0)
    print(f"  -> {op}: {rep}")
    reason = str(rep.get("reason", ""))
    if rep.get("status") != "error" or \
            not reason.startswith("admin_fault:NotImplementedError") or \
            item not in reason:
        raise RuntimeError(f"{op}: expected a typed admin_fault naming "
                           f"{item}, got {rep}")


def cmd_demo(args: argparse.Namespace) -> int:
    from akka_tpu_torch.gateway import GatewayClient

    serve = _child(["serve", "--device", args.device, "--shards", "4",
                    "--eps", "16", "--rate", "400", "--burst", "200"])
    loads = []
    admin = None
    try:
        port = _wait_ready(serve)
        print(f"[demo] gateway up on :{port} ({args.device}); starting 2 "
              "load processes")
        loads = [_child(["load", "--port", str(port), "--tenant",
                         f"tenant{i}", "--seconds", str(args.seconds),
                         "--pace", "0.01"]) for i in (0, 1)]
        admin = GatewayClient("127.0.0.1", port, timeout=30.0)

        time.sleep(args.seconds * 0.25)
        print("[demo] chaos leg 1: shard rebalance (admin op over the wire)")
        rep = admin.request_retry("__admin", "", "rebalance", 0.0,
                                  deadline_s=60.0)
        print("  ->", rep)
        if rep.get("status") != "ok":
            raise RuntimeError(f"rebalance failed: {rep}")
        print("[demo] chaos leg 2 (kill -9 + restore) waits for ROADMAP "
              "A8: checkpoint/restore are not ported")
        _expect_typed_fault(admin, "checkpoint", "ROADMAP A8")
        print("[demo] chaos leg 3 (device failover) waits for ROADMAP A10: "
              "failover is not ported")
        _expect_typed_fault(admin, "failover", "ROADMAP A10")

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
    s.add_argument("--dedup", action="store_true",
                   help="reply-cache dedup (exactly-once retry effects; "
                        "in memory, the journal is ROADMAP A8)")
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

    d = sub.add_parser("demo", help="3-process demo with a rebalance leg")
    d.add_argument("--device", default="cuda",
                   help="the serve child's device: cuda (default) or cpu")
    d.add_argument("--seconds", type=float, default=20.0)

    args = ap.parse_args(argv)
    return {"serve": cmd_serve, "load": cmd_load,
            "demo": cmd_demo}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
