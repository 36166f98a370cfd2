"""Where a step's time goes on the card.

    python3 -m akka_tpu_torch.tools.profile_step [--n 1048576] [--steps 10]
        [--cells ring_reduce,fan_in,...]

For each main-path cell (BatchedSystem: ring in reduce mode, 1M -> 1k
fan-in, ring over 2-slot bounded mailboxes; ShardedBatchedSystem: the
cross-shard bench, 256 shards x 4096 entities, on one shard of the axis
and on eight; region_serve: waves of 256 asks to a full-width counter
region, per wave instead of per step, with the host's time by op) it
prints, per step:
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
from typing import Callable

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..gateway import counter_behavior
from ..models.baseline_benches import (build_cross_shard, build_fan_in,
                                       build_ring, build_ring_slots,
                                       seed_ring_full)
from ..sharding import DeviceEntity, DeviceShardRegion


def device_us(event) -> float:
    """Self device time of a profiler event, in µs, across torch versions."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return float(getattr(event, attr))
    return 0.0


def profile_cell(label: str, work: Callable[[], None], units: int,
                 top: int, unit: str = "step") -> None:
    """Profile `work()`, which runs `units` units (steps, or ask waves)."""
    work()                                       # warm: allocator, build
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    t0 = time.perf_counter()
    work()
    host_ms = (time.perf_counter() - t0) * 1e3 / units
    end.record()
    torch.cuda.synchronize()
    untraced_ms = start.elapsed_time(end) / units
    print(f"{label} ms_per_{unit}_untraced {untraced_ms}")
    print(f"{label} host_enqueue_ms_per_{unit} {host_ms}")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        work()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # device-side kernels and copies only: host ops carry the device time
    # of the kernels they launched, and the step's record_function span
    # ("akka.device.*") has a device-side range over the whole run; either
    # would count the same time twice
    kernels = [e for e in events
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("akka.")]
    busy_ms = sum(device_us(e) for e in kernels) / 1e3 / units
    traced_ms = wall_ms / units
    print(f"{label} ms_per_{unit}_traced {traced_ms}")
    print(f"{label} device_busy_ms_per_{unit} {busy_ms}")
    print(f"{label} device_busy_share_untraced {busy_ms / untraced_ms}")
    print(f"{label} device_busy_share_traced {busy_ms / traced_ms}")
    print(f"{label} kernel_launches_per_{unit} "
          f"{sum(e.count for e in kernels) / units}")
    ranked = sorted(kernels, key=device_us, reverse=True)[:top]
    for e in ranked:
        print(f"{label}   {device_us(e) / 1e3 / units:.4f} ms/{unit}  "
              f"{e.count / units:.0f}x/{unit}  {e.key[:90]}")
    if unit != "step":
        # host side: the steps' enqueue span and the host ops (the reads
        # that wait for the card among them), by CPU time per unit
        host = [e for e in events if e.device_type == DeviceType.CPU]
        for e in sorted(host, key=lambda e: e.cpu_time_total,
                        reverse=True)[:top]:
            print(f"{label}   host {e.cpu_time_total / 1e3 / units:.4f} "
                  f"ms/{unit} total, {e.self_cpu_time_total / 1e3 / units:.4f}"
                  f" self  {e.count / units:.1f}x/{unit}  {e.key[:70]}")


def steps_of(sys_, seed: bool = True):
    if seed:
        seed_ring_full(sys_)
    return lambda steps: ((lambda: sys_.run(steps)), steps, "step")


def region_waves(n: int):
    """The region_serve cell of chip_smoke.py: a full-width counter
    region, waves of 256 adds with 1/8 repeats (`units` waves a run)."""
    eps = n // 256
    region = DeviceShardRegion(DeviceEntity(
        "counter", counter_behavior(4), n_shards=256,
        entities_per_shard=eps, n_devices=1, spare_blocks=2))
    rng = np.random.default_rng(0)
    pool = [region.entity_ref(f"entity-{i}")
            for i in range(min(4096, n // 16))]

    def wave():
        picks = list(rng.choice(len(pool), 224, replace=False))
        picks += list(rng.choice(picks, 32))
        region.ask_many([(pool[i].shard, pool[i].index, [1.0])
                         for i in rng.permutation(picks)])

    def make(units):
        def work():
            for _ in range(units):
                wave()
        return work, units, "wave"
    return make


# cell name -> builder at n actors of: steps -> (work, units, unit)
CELLS = {
    "ring_reduce": lambda n: steps_of(build_ring(n)),
    "fan_in": lambda n: steps_of(build_fan_in(n, 1000), seed=False),
    "ring_slots": lambda n: steps_of(build_ring_slots(n, 2)),
    "sharded_ring_d1": lambda n: steps_of(build_cross_shard(256, n // 256)),
    "cross_shard_d8": lambda n: steps_of(build_cross_shard(
        256, n // 256, n_devices=8)),
    "region_serve": region_waves,
}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--steps", type=int, default=10,
                    help="steps (ask waves for region_serve) per run")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--cells", default=",".join(CELLS),
                    help="comma-separated cells, of: " + ", ".join(CELLS))
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    for cell in args.cells.split(","):
        work, units, unit = CELLS[cell](args.n)(args.steps)
        profile_cell(cell, work, units, args.top, unit)


if __name__ == "__main__":
    main()
