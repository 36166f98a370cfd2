#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (akka_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi) and builds the
   ring-mailbox kernels from akka_tpu_torch/csrc (nvcc, sm_90a).
2. Holds each kernel against its plain PyTorch version on the card, at a
   small ragged shape and at the main path's shape (m = 2^20 + 8 rows,
   n = 2^20 actors, P = 4, S = 2) under three traffic patterns (random,
   ring, 1000-collector fan-in; akka_tpu_torch/tools/bench_mailbox.py):
   integer outputs bit-equal, sums within rtol 1e-4 / atol 1e-3 (float
   atomics add in a run-dependent order). For each pattern it times the C
   entry on the card's clock (CUDA events around 200 launches on outputs
   allocated once, zeroing included: `ms`), the Python wrapper
   (`wrapper_ms`), the plain version and, for K1, one `index_add_` call,
   and computes the memory-bytes bound at 3.35 TB/s.
3. Drives the main path through BatchedSystem on the card at 1M actors:
   the ring in reduce mode, the 1M -> 1k fan-in, the ring with 2-slot
   bounded mailboxes (and its twin on the ranked kernels, which must agree
   bit for bit), and a few tells followed by step(). Each result is held to
   its closed form, and each path must have launched its kernel (launch
   counts are zeroed just before the path and read just after).

Any failure raises and the exit code is non-zero. The last two lines are
the kernel report (JSON; `ms` and the other top-level numbers are the
random pattern's, `patterns` holds all three) and {"ok": true, "device":
{...}}.
"""

from __future__ import annotations

import json
import sys
import time

import torch

from akka_tpu_torch.models.baseline_benches import (PAYLOAD_W, build_fan_in,
                                                    build_ring,
                                                    build_ring_slots,
                                                    seed_ring_full)
from akka_tpu_torch.ops import cuda_mailbox as cm
from akka_tpu_torch.tools import bench_mailbox as bm

RTOL, ATOL = bm.RTOL, bm.ATOL
N = 1 << 20                 # actors on the main path
M = N + bm.HOST_ROWS        # inbox rows: n * K emissions + host_inbox
SLOTS = bm.SLOTS
KERNEL_ITERS = 200          # C-entry launches per device timing


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def kernel_phase():
    """K1 and K2 against their plain versions at a small ragged shape and,
    at the main path's shape, at each traffic pattern; returns the timed
    report rows by pattern and kernel (without launches)."""
    dst, mtype, payload, valid = bm.make_pattern("random", 37, 11, 3, 37)
    err = bm.compare("K1 m=37", cm.ring_reduce(dst, payload, valid, 11),
                     cm.ring_reduce_plain(dst, payload, valid, 11))
    err = max(err, bm.compare(
        "K2 m=37", cm.ring_slots(dst, mtype, payload, valid, 11, SLOTS),
        cm.ring_slots_plain(dst, mtype, payload, valid, 11, SLOTS)))
    torch.cuda.synchronize()
    print(f"kernel_check m=37 n=11 p=3 S={SLOTS}: max_abs_err={err}")

    lib = cm.build()
    b1, b2 = bm.bound_bytes(M, N, PAYLOAD_W, SLOTS)
    rows = {}
    for seed, pattern in enumerate(bm.PATTERNS):
        inputs = bm.make_pattern(pattern, M, N, PAYLOAD_W, seed)
        dst, mtype, payload, valid = inputs
        err1 = bm.compare(f"K1 {pattern}",
                          cm.ring_reduce(dst, payload, valid, N),
                          cm.ring_reduce_plain(dst, payload, valid, N))
        err2 = bm.compare(f"K2 {pattern}",
                          cm.ring_slots(*inputs, N, SLOTS),
                          cm.ring_slots_plain(*inputs, N, SLOTS))
        torch.cuda.synchronize()
        e1, e2, _ = bm.package_entries(lib, inputs, N, SLOTS)
        ok = valid & (dst >= 0) & (dst < N)
        key = torch.where(ok, dst, N).long()
        src = torch.cat([torch.where(ok[:, None], payload, 0),
                         ok[:, None].float()], dim=1)
        rows[pattern] = {
            "K1": {"ms": bm.cuda_ms(e1, KERNEL_ITERS, 5),
                   "wrapper_ms": bm.cuda_ms(
                       lambda: cm.ring_reduce(dst, payload, valid, N)),
                   "plain_ms": bm.cuda_ms(
                       lambda: cm.ring_reduce_plain(dst, payload, valid, N)),
                   "library_ms": bm.cuda_ms(
                       lambda: torch.zeros((N + 1, PAYLOAD_W + 1),
                                           device="cuda")
                       .index_add_(0, key, src)),
                   "bound_ms": bm.bound_ms(b1), "max_abs_err": err1},
            "K2": {"ms": bm.cuda_ms(e2, KERNEL_ITERS, 5),
                   "wrapper_ms": bm.cuda_ms(
                       lambda: cm.ring_slots(*inputs, N, SLOTS)),
                   "plain_ms": bm.cuda_ms(
                       lambda: cm.ring_slots_plain(*inputs, N, SLOTS)),
                   "library_ms": None,
                   "bound_ms": bm.bound_ms(b2), "max_abs_err": err2},
        }
        for k, row in rows[pattern].items():
            print(f"{pattern} {k} " + " ".join(f"{f} {v}"
                                               for f, v in row.items()))
        del inputs, dst, mtype, payload, valid, ok, key, src, e1, e2
    return rows


def timed_run(sys_, steps: int, msgs_per_step: int, label: str) -> None:
    """Warm run(steps), then a timed run(steps) between CUDA events."""
    sys_.run(steps)
    ms = bm.cuda_ms(lambda: sys_.run(steps), iters=1, warmup=0) / steps
    print(f"{label} ms_per_step {ms}")
    print(f"{label} msgs_per_s {msgs_per_step / (ms * 1e-3)}")


def path(label: str, kernel: str, launches: dict, fn):
    """Drive one main-path phase with the launch counts zeroed just
    before and read just after; the phase must launch `kernel`."""
    cm.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    counts = dict(cm.LAUNCHES)
    print(f"{label} launches {counts}")
    check(counts[kernel] > 0, f"{label} launched {kernel}")
    for k, v in counts.items():
        launches[k] += v
    return out


def main_path(launches: dict) -> None:
    steps = 20

    def ring():
        s = build_ring(N, device="cuda")
        seed_ring_full(s)
        timed_run(s, steps, N, "ring_reduce")
        recv = s.read_state("received")
        check((recv == 2 * steps).all(), "ring: every actor received "
              "2 * steps tokens")
        return s

    s = path("ring_reduce", "ring_reduce", launches, ring)

    def tells():
        before = s.read_state("received")
        told = [0, 5, 7]
        s.tell(told, [1.0, 0.0, 0.0, 0.0])
        s.step()
        after = s.read_state("received")
        want = before + 1
        want[told] += 1
        check((after == want).all(), "tell + step: told rows got 2 "
              "messages, others 1")

    path("tell_step", "ring_reduce", launches, tells)

    def fan_in():
        f = build_fan_in(N, 1000, device="cuda")
        timed_run(f, steps, N, "fan_in")
        msgs = f.read_state("msgs")[:1000]
        total = f.read_state("total")[:1000]
        want = (2 * steps - 1) * N   # deliveries lag the first send a step
        check(int(msgs.sum()) == want, f"fan-in: {int(msgs.sum())} == {want}")
        check(float(total.astype("float64").sum()) == float(want),
              "fan-in: totals == msgs")

    path("fan_in", "ring_reduce", launches, fan_in)

    def slots_system(backend):
        r = build_ring_slots(N, SLOTS, device="cuda",
                             delivery_backend=backend)
        seed_ring_full(r)
        return r

    def slots():
        r = slots_system(None)
        timed_run(r, steps, N, "ring_slots")
        check((r.read_state("received") == 2 * steps).all(),
              "slots ring: every actor received 2 * steps tokens")
        return r

    r = path("ring_slots", "ring_slots", launches, slots)
    twin = slots_system("ranked")
    twin.run(2 * steps)
    for field in ("inbox_dst", "inbox_type", "inbox_valid", "alive",
                  "behavior_id", "step_count", "mail_dropped"):
        check(torch.equal(getattr(r, field), getattr(twin, field)),
              f"slots ring vs ranked twin: {field} bit-equal")
    check(torch.equal(r.state["received"], twin.state["received"]),
          "slots ring vs ranked twin: received bit-equal")
    check(torch.allclose(r.inbox_payload, twin.inbox_payload, rtol=RTOL,
                         atol=ATOL), "slots ring vs ranked twin: payload")
    check(bool(torch.isfinite(r.inbox_payload).all()), "finite payloads")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    smi = bm.card_line()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    cm.build(verbose=True)
    print(f"build_s {time.perf_counter() - t0}")

    rows = kernel_phase()
    launches = {k: 0 for k in cm.LAUNCHES}
    main_path(launches)

    entry = {"K1": ("ring_reduce", "_run(with_slots=False)"),
             "K2": ("ring_slots", "_run(with_slots=True)")}
    kernels = []
    for k, (cname, mode) in entry.items():
        by_pattern = {pat: rows[pat][k] for pat in bm.PATTERNS}
        kernels.append({
            "name": f"{k} {cname}", "route": "cuda",
            "source": "akka_tpu_torch/csrc/ring_mailbox.cu",
            "replaces": f"akka_tpu/ops/pallas_mailbox.py:137 {mode}",
            "launches": launches[cname], "bound_by": "bytes",
            **rows["random"][k],
            "max_abs_err": max(r["max_abs_err"]
                               for r in by_pattern.values()),
            "patterns": by_pattern})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
