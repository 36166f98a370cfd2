#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (akka_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi) and builds the
   ring-mailbox kernels from akka_tpu_torch/csrc (nvcc, sm_90a).
2. Holds each kernel against its plain PyTorch version on the card, at the
   main path's shape (m = 2^20 + 8 rows, n = 2^20 actors, P = 4, S = 2) and
   at a small ragged shape: integer outputs bit-equal, sums within rtol 1e-4
   / atol 1e-3 (float atomics add in a run-dependent order). Times the
   kernel, the plain version and, for K1, one `index_add_` call, and
   computes the memory-bytes bound at 3.35 TB/s.
3. Drives the main path through BatchedSystem on the card at 1M actors:
   the ring in reduce mode, the 1M -> 1k fan-in, the ring with 2-slot
   bounded mailboxes (and its twin on the ranked kernels, which must agree
   bit for bit), and a few tells followed by step(). Each result is held to
   its closed form, and each path must have launched its kernel (launch
   counts are zeroed just before the path and read just after).

Any failure raises and the exit code is non-zero. The last two lines are
the kernel report (JSON) and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from akka_tpu_torch.models.baseline_benches import (PAYLOAD_W, build_fan_in,
                                                    build_ring,
                                                    build_ring_slots,
                                                    seed_ring_full)
from akka_tpu_torch.ops import cuda_mailbox as cm

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)
RTOL, ATOL = 1e-4, 1e-3     # sums: float atomics add in no fixed order
N = 1 << 20                 # actors on the main path
M = N + 8                   # inbox rows: n * K emissions + host_inbox
SLOTS = 2


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of fn on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def make_inputs(m: int, n: int, p: int, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dst = torch.randint(-1, n + 1, (m,), generator=g, device="cuda",
                        dtype=torch.int32)              # -1 and n: dropped
    mtype = torch.randint(1, 5, (m,), generator=g, device="cuda",
                          dtype=torch.int32)
    payload = torch.randn((m, p), generator=g, device="cuda")
    valid = torch.rand((m,), generator=g, device="cuda") > 0.1
    return dst, mtype, payload, valid


def compare(name: str, got, want) -> float:
    """Integer fields bit-equal, float fields allclose; returns the max
    absolute float error."""
    err = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if a.is_floating_point():
            check(torch.allclose(a, b, rtol=RTOL, atol=ATOL),
                  f"{name} field {i} within rtol {RTOL} / atol {ATOL}")
            err = max(err, float((a - b).abs().max()))
        else:
            check(torch.equal(a, b), f"{name} field {i} bit-equal")
    return err


def kernel_phase():
    """K1 and K2 against their plain versions; returns the report rows
    (without launches) for the main-path shape."""
    rows = {}
    for m, n, p in ((37, 11, 3), (M, N, PAYLOAD_W)):
        dst, mtype, payload, valid = make_inputs(m, n, p, seed=m)
        k1 = cm.ring_reduce(dst, payload, valid, n)
        err1 = compare(f"K1 m={m}", k1, cm.ring_reduce_plain(dst, payload,
                                                             valid, n))
        k2 = cm.ring_slots(dst, mtype, payload, valid, n, SLOTS)
        err2 = compare(f"K2 m={m}", k2, cm.ring_slots_plain(
            dst, mtype, payload, valid, n, SLOTS))
        torch.cuda.synchronize()
        print(f"kernel_check m={m} n={n} p={p} S={SLOTS}: "
              f"K1 max_abs_err={err1} K2 max_abs_err={err2}")
        if m != M:
            continue
        ok = valid & (dst >= 0) & (dst < n)
        key = torch.where(ok, dst, n).long()
        src = torch.cat([torch.where(ok[:, None], payload, 0),
                         ok[:, None].float()], dim=1)
        k1_bytes = m * (4 + 1 + 4 * p) + n * (4 + 4 * p)
        k2_bytes = k1_bytes + m * 4 + n * SLOTS * (4 + 4 * p + 1) + 4
        timings = {
            "K1": (cuda_ms(lambda: cm.ring_reduce(dst, payload, valid, n)),
                   cuda_ms(lambda: cm.ring_reduce_plain(dst, payload, valid,
                                                        n)),
                   cuda_ms(lambda: torch.zeros((n + 1, p + 1),
                                               device="cuda")
                           .index_add_(0, key, src)),
                   k1_bytes, err1),
            "K2": (cuda_ms(lambda: cm.ring_slots(dst, mtype, payload, valid,
                                                 n, SLOTS)),
                   cuda_ms(lambda: cm.ring_slots_plain(dst, mtype, payload,
                                                       valid, n, SLOTS)),
                   None, k2_bytes, err2),
        }
        for k, (ms, plain_ms, lib_ms, nbytes, err) in timings.items():
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            print(f"{k} kernel_ms {ms}")
            print(f"{k} plain_ms {plain_ms}")
            print(f"{k} library_ms {lib_ms}")
            print(f"{k} bound_us {bound_ms * 1e3} ({nbytes} bytes)")
            rows[k] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": "bytes", "library_ms": lib_ms,
                       "max_abs_err": err}
    return rows


def timed_run(sys_, steps: int, msgs_per_step: int, label: str) -> None:
    """Warm run(steps), then a timed run(steps) between CUDA events."""
    sys_.run(steps)
    ms = cuda_ms(lambda: sys_.run(steps), iters=1, warmup=0) / steps
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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
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
        kernels.append({
            "name": f"{k} {cname}", "route": "cuda",
            "source": "akka_tpu_torch/csrc/ring_mailbox.cu",
            "replaces": f"akka_tpu/ops/pallas_mailbox.py:137 {mode}",
            "launches": launches[cname], **rows[k]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
