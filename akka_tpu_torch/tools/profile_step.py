"""Where a step's time goes on the card.

    python3 -m akka_tpu_torch.tools.profile_step [--n 1048576] [--steps 10]
        [--cells ring_reduce,fan_in,...] [--modes graph,eager]

For each main-path cell (BatchedSystem: ring in reduce mode, 1M -> 1k
fan-in, ring over 2-slot bounded mailboxes, and the ring and fan-in on
compiled routing, ring_static and fan_in_static; ShardedBatchedSystem: the
cross-shard bench, 256 shards x 4096 entities, on one shard of the axis
and on eight; region_serve: waves of 256 asks to a full-width counter
region, per wave instead of per step, with the host's time by op, and
region_serve_spill, the same over 2 slots and the default spill region;
gateway_serve: the served path of chip_smoke.py, 16 clients sending
pipelined binary adds through the evloop gateway to a continuous
RegionBackend, per 256 requests, with the client threads in this process;
gateway_serve_remote: the same with the clients in a load process of
their own, so only the server's Python shares its interpreter lock) it
profiles each mode of `--modes` in turn on the same system: `graph`, the
step's CUDA graph replayed (what the system does on a card), and `eager`,
the eager step loop (the system's private `_eager` twin switch), and
prints, per step (or unit):
- ms/step with tracing off (CUDA events around run(steps), after a warm run),
  and the host's time to enqueue those steps (run() never waits for the
  card, so an enqueue time near the step time means the host bounds it);
- ms/step under torch.profiler, and the device-busy ms/step: the summed
  time of the kernels and copies the profiler saw on the card;
- the busy share against each step time (1 - busy share is the device's
  idle share; the eager step is launched from the host, so tracing, which
  slows the host, lowers the traced share);
- the host's CUDA launch calls (kernel and graph launches, async copies
  and memsets, on every thread): one graph launch a step under replay,
  plus the flush's copies when tells are staged;
- the kernels with the most device time;
- with --sweep-traces R, R more graph-mode traces of one run, each with
  the kernels it saw and its ring kernels' `ring_sweep` records (a trace
  that loses records shows fewer; every trace has --trace-margin-ms of
  idle host time on each side, default 10, against such losses);
- for the per-wave and per-request cells, the host's time inside CUDA
  synchronize and copy calls (the runtime calls in which the host can
  wait for the card; the profiler sees them on every thread) and the
  host ops with the most CPU time (on the profiling thread only: the
  served path's steps run on its scheduler thread, so gateway_serve
  times its steps' `run` calls itself, one `host_split` line per run).
The card's name and power limit come first (nvidia-smi).
"""

from __future__ import annotations

import argparse
import atexit
import itertools
import json
import subprocess
import sys
import time
from contextlib import contextmanager
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
from .gateway_load import client_traces, drive, serve_stack

# CUDA runtime calls in which the host waits for the card (a D2H copy to
# pageable memory synchronises too)
SYNC_CALLS = ("cudaEventSynchronize", "cudaStreamSynchronize",
              "cudaDeviceSynchronize", "cudaMemcpy", "cudaMemcpyAsync")
# the host's CUDA calls that put work on the card (`cuda*` runtime and
# `cu*` low-level entries)
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch",
                "cudaMemcpyAsync", "cudaMemsetAsync", "cudaMemcpy")
MODES = ("graph", "eager")


def device_events(events):
    """Device-side kernels and copies only: host ops carry the device time
    of the kernels they launched, and the step's record_function span
    ("akka.device.*") has a device-side range over the whole run; either
    would count the same time twice."""
    return [e for e in events
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("akka.")]


def host_launch_calls(events) -> int:
    """The host's CUDA launch calls among profiler events (every thread's:
    the profiler traces the runtime calls of the whole process)."""
    return sum(e.count for e in events
               if e.device_type == DeviceType.CPU and e.key in LAUNCH_CALLS)


# Host time traced before and after the work. On an H100 a trace without
# it now and then lost the card's records of whole steps: the lost
# trace's device times sat early against the host's, and the tail of the
# work fell outside the traced window (PERF.md section 7; measured by
# `--sweep-traces` with `--trace-margin-ms 0`).
TRACE_MARGIN_S = 0.010


@contextmanager
def traced():
    """torch.profiler over the host and the card, with TRACE_MARGIN_S of
    idle host time on each side of the body; the card is drained before
    the trace starts and before it ends."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_MARGIN_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(TRACE_MARGIN_S)


def launch_profile(work: Callable[[], None]):
    """Run `work()` under torch.profiler; returns (host launch calls,
    {kernel name: launches on the card}, device-busy ms)."""
    with traced() as prof:
        work()
    events = prof.key_averages()
    kernels = device_events(events)
    return (host_launch_calls(events), {e.key: e.count for e in kernels},
            sum(device_us(e) for e in kernels) / 1e3)


def sweep_trace(label: str, work: Callable[[], None], units: int,
                unit: str) -> None:
    """One graph-mode trace of `work()`: the card's kernels and copies it
    recorded, its `ring_sweep` records, and the first device record's
    time after the first graph launch (µs on the profiler's clock; a
    negative value puts the card's records before the work began)."""
    with traced() as prof:
        work()
    events = prof.events()
    dev = device_events(events)
    sweeps = sum(1 for e in dev if "ring_sweep" in e.name)
    launches = [e.time_range.start for e in events
                if e.device_type == DeviceType.CPU
                and e.name in ("cudaGraphLaunch", "cuGraphLaunch")]
    lead = (min(e.time_range.start for e in dev) - min(launches)
            if dev and launches else None)
    print(f"{label} kernels {len(dev)} ring_sweep {sweeps} over {units} "
          f"{unit}s first_device_us {lead}")


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

    with traced() as prof:
        t0 = time.perf_counter()
        work()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = device_events(events)
    busy_ms = sum(device_us(e) for e in kernels) / 1e3 / units
    traced_ms = wall_ms / units
    print(f"{label} ms_per_{unit}_traced {traced_ms}")
    print(f"{label} device_busy_ms_per_{unit} {busy_ms}")
    print(f"{label} device_busy_share_untraced {busy_ms / untraced_ms}")
    print(f"{label} device_busy_share_traced {busy_ms / traced_ms}")
    print(f"{label} kernel_launches_per_{unit} "
          f"{sum(e.count for e in kernels) / units}")
    print(f"{label} host_launch_calls_per_{unit} "
          f"{host_launch_calls(events) / units}")
    ranked = sorted(kernels, key=device_us, reverse=True)[:top]
    for e in ranked:
        print(f"{label}   {device_us(e) / 1e3 / units:.4f} ms/{unit}  "
              f"{e.count / units:.0f}x/{unit}  {e.key[:90]}")
    if unit != "step":
        # host side: the steps' enqueue span and the host ops (the reads
        # that wait for the card among them), by CPU time per unit
        host = [e for e in events if e.device_type == DeviceType.CPU]
        wait_ms = sum(e.cpu_time_total for e in host
                      if e.key in SYNC_CALLS) / 1e3 / units
        print(f"{label} host_sync_and_copy_calls_ms_per_{unit} {wait_ms}")
        for e in sorted(host, key=lambda e: e.cpu_time_total,
                        reverse=True)[:top]:
            print(f"{label}   host {e.cpu_time_total / 1e3 / units:.4f} "
                  f"ms/{unit} total, {e.self_cpu_time_total / 1e3 / units:.4f}"
                  f" self  {e.count / units:.1f}x/{unit}  {e.key[:70]}")


def steps_of(sys_, seed: bool = True):
    if seed:
        seed_ring_full(sys_)
    return lambda steps: ((lambda: sys_.run(steps)), steps, "step", sys_)


def region_waves(n: int, mailbox_slots: int = 0):
    """The region_serve cell of chip_smoke.py: a full-width counter
    region, waves of 256 adds with 1/8 repeats (`units` waves a run).
    With mailbox_slots, the region keeps its default spill region
    (region_serve_spill: the ranked kernels)."""
    eps = n // 256
    region = DeviceShardRegion(DeviceEntity(
        "counter", counter_behavior(4), n_shards=256,
        entities_per_shard=eps, n_devices=1, spare_blocks=2,
        mailbox_slots=mailbox_slots))
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
        return work, units, "wave", region.system
    return make


def gateway_region(n: int):
    """A full-width counter region whose steps' `run` calls are timed;
    returns (region, a reader of the seconds spent in them since the
    last read)."""
    region = DeviceShardRegion(DeviceEntity(
        "counter", counter_behavior(4), n_shards=256,
        entities_per_shard=n // 256, n_devices=1, spare_blocks=2))
    sys_ = region.system
    run = sys_.run
    in_run = [0.0]

    def timed_run(n_steps=1):
        t0 = time.perf_counter()
        run(n_steps)
        in_run[0] += time.perf_counter() - t0

    def read_run():
        s, in_run[0] = in_run[0], 0.0
        return s

    sys_.run = timed_run
    return region, read_run


def host_split(label, run_no, units, wall, in_run, steps, extra="") -> None:
    print(f"{label} host_split run {run_no}: wall_ms_per_req256 "
          f"{wall * 1e3 / units} run_calls_ms_per_req256 "
          f"{in_run * 1e3 / units} steps_per_req256 {steps / units}{extra}")


def gateway_requests(n: int):
    """The gateway_serve phase of chip_smoke.py: a full-width counter
    region behind a continuous RegionBackend and the evloop gateway; one
    unit is 256 requests (16 clients x 16 adds, two pipelined binary
    windows of 8 each). work() returns when every reply is in, and prints
    the run's host split per 256 requests: wall time, the time inside the
    steps' `run` calls on the scheduler thread (Python and launch calls
    enqueueing the steps) and the steps run."""
    region, read_run = gateway_region(n)
    region.system.warmup()  # capture before the front end's threads start
    _, srv = serve_stack(region, continuous=True)
    seeds = itertools.count()

    def make(units):
        def work():
            seed = next(seeds)
            read_run()
            step0 = region.system._host_step
            t0 = time.perf_counter()
            res = drive(srv.host, srv.port,
                        client_traces(seed, 16, 64, 16 * units))
            wall = time.perf_counter() - t0
            if res.errors or res.sheds:
                raise RuntimeError(f"gateway load: {res.errors[:3]}, "
                                   f"{res.sheds} sheds")
            host_split("gateway_serve", seed, units, wall, read_run(),
                       region.system._host_step - step0)
        return work, units, "req256", region.system
    return make


def gateway_requests_remote(n: int):
    """gateway_serve with the 16 clients in a load process of their own
    (`python -m akka_tpu_torch.tools.gateway_load`, started once and
    stopped at exit); work() returns when that process reports every
    reply in."""
    region, read_run = gateway_region(n)
    region.system.warmup()
    _, srv = serve_stack(region, continuous=True)
    load = subprocess.Popen(
        [sys.executable, "-m", "akka_tpu_torch.tools.gateway_load",
         "--host", srv.host, "--port", str(srv.port)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)

    def stop():
        load.stdin.close()
        load.wait(60)

    atexit.register(stop)
    seeds = itertools.count()

    def make(units):
        def work():
            seed = next(seeds)
            read_run()
            step0 = region.system._host_step
            t0 = time.perf_counter()
            load.stdin.write(f"{seed} {16 * units}\n")
            load.stdin.flush()
            res = json.loads(load.stdout.readline())
            wall = time.perf_counter() - t0
            if res["errors"] or res["sheds"] or \
                    not res["running_totals_hold"]:
                raise RuntimeError(f"gateway load: {res}")
            host_split("gateway_serve_remote", seed, units, wall,
                       read_run(), region.system._host_step - step0,
                       f" client_seconds {res['seconds']} reply_ms_p50 "
                       f"{res['reply_ms_p50']} reply_ms_p99 "
                       f"{res['reply_ms_p99']}")
        return work, units, "req256", region.system
    return make


# cell name -> builder at n actors of: steps -> (work, units, unit)
CELLS = {
    "ring_reduce": lambda n: steps_of(build_ring(n, static=False)),
    "fan_in": lambda n: steps_of(build_fan_in(n, 1000, static=False),
                                 seed=False),
    "ring_slots": lambda n: steps_of(build_ring_slots(n, 2)),
    "ring_static": lambda n: steps_of(build_ring(n)),
    "fan_in_static": lambda n: steps_of(build_fan_in(n, 1000), seed=False),
    "sharded_ring_d1": lambda n: steps_of(build_cross_shard(256, n // 256)),
    "cross_shard_d8": lambda n: steps_of(build_cross_shard(
        256, n // 256, n_devices=8)),
    "region_serve": region_waves,
    "region_serve_spill": lambda n: region_waves(n, mailbox_slots=2),
    "gateway_serve": gateway_requests,
    "gateway_serve_remote": gateway_requests_remote,
}


def main() -> None:
    global TRACE_MARGIN_S
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--steps", type=int, default=10,
                    help="steps (ask waves for region_serve, blocks of "
                         "256 requests for gateway_serve) per run")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--cells", default=",".join(CELLS),
                    help="comma-separated cells, of: " + ", ".join(CELLS))
    ap.add_argument("--modes", default=",".join(MODES),
                    help="comma-separated step modes, of: graph (replays "
                         "of the step's CUDA graph), eager (the eager twin)")
    ap.add_argument("--sweep-traces", type=int, default=0,
                    help="after each cell, this many more graph-mode "
                         "traces of one run, each printing the kernels "
                         "the profiler saw and its ring_sweep records "
                         "(how often a trace loses records)")
    ap.add_argument("--trace-margin-ms", type=float,
                    default=TRACE_MARGIN_S * 1e3,
                    help="idle host time traced before and after the "
                         "work (0: none)")
    args = ap.parse_args()
    TRACE_MARGIN_S = args.trace_margin_ms / 1e3
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    for cell in args.cells.split(","):
        work, units, unit, system = CELLS[cell](args.n)(args.steps)
        for mode in args.modes.split(","):
            if mode not in MODES:
                raise ValueError(f"unknown mode {mode!r}")
            system._eager = mode == "eager"
            profile_cell(f"{cell}/{mode}", work, units, args.top, unit)
        system._eager = False
        for i in range(args.sweep_traces):
            sweep_trace(f"{cell} trace {i}", work, units, unit)
        print(f"{cell} graphs {system._graphs.stats()} memory_reserved "
              f"{torch.cuda.memory_reserved()}")


if __name__ == "__main__":
    main()
