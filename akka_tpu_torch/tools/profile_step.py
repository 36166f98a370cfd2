"""Where a BatchedSystem step's time goes on the card.

    python3 -m akka_tpu_torch.tools.profile_step [--n 1048576] [--steps 10]

For each main-path cell (ring in reduce mode, 1M -> 1k fan-in, ring over
2-slot bounded mailboxes) it prints, per step:
- ms/step with tracing off (CUDA events around run(steps), after a warm run),
  and the host's time to enqueue those steps (run() never waits for the
  card, so an enqueue time near the step time means the host bounds it);
- ms/step under torch.profiler, and the device-busy ms/step: the summed
  time of the kernels and copies the profiler saw on the card;
- the busy share against each step time (1 - busy share is the device's
  idle share; the eager step is launched from the host, so tracing, which
  slows the host, lowers the traced share);
- the kernels with the most device time.
The card's name and power limit come first (nvidia-smi).
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..models.baseline_benches import (build_fan_in, build_ring,
                                       build_ring_slots, seed_ring_full)


def device_us(event) -> float:
    """Self device time of a profiler event, in µs, across torch versions."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


def profile_cell(label: str, sys_, steps: int, top: int) -> None:
    sys_.run(steps)                              # warm: allocator, build
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    t0 = time.perf_counter()
    sys_.run(steps)
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    end.record()
    torch.cuda.synchronize()
    untraced_ms = start.elapsed_time(end) / steps
    print(f"{label} ms_per_step_untraced {untraced_ms}")
    print(f"{label} host_enqueue_ms_per_step {host_ms}")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sys_.run(steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side kernels and copies only: host ops carry the device time
    # of the kernels they launched, and the step's record_function span
    # ("akka.device.*") has a device-side range over the whole run; either
    # would count the same time twice
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("akka.")]
    busy_ms = sum(device_us(e) for e in kernels) / 1e3 / steps
    traced_ms = wall_ms / steps
    print(f"{label} ms_per_step_traced {traced_ms}")
    print(f"{label} device_busy_ms_per_step {busy_ms}")
    print(f"{label} device_busy_share_untraced {busy_ms / untraced_ms}")
    print(f"{label} device_busy_share_traced {busy_ms / traced_ms}")
    print(f"{label} kernel_launches_per_step "
          f"{sum(e.count for e in kernels) / steps}")
    ranked = sorted(kernels, key=device_us, reverse=True)[:top]
    for e in ranked:
        print(f"{label}   {device_us(e) / 1e3 / steps:.4f} ms/step  "
              f"{e.count / steps:.0f}x/step  {e.key[:90]}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    ring = build_ring(args.n)
    seed_ring_full(ring)
    profile_cell("ring_reduce", ring, args.steps, args.top)
    del ring
    profile_cell("fan_in", build_fan_in(args.n, 1000), args.steps, args.top)
    slots = build_ring_slots(args.n, 2)
    seed_ring_full(slots)
    profile_cell("ring_slots", slots, args.steps, args.top)


if __name__ == "__main__":
    main()
