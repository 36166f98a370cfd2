"""Runs one cell of BENCHMARK.json and builds its result line.

A cell (an entry of `workloads`) names a configuration and a traffic mix.
Everything is found by name, so a new configuration, mix or metric is new
files and entries, never an edit:

- `configs/<config>.json` holds the configuration as it is run; its
  `system` names the module `systems/<system>.py` that builds the program
  under test from the configuration, the mix and the seed, and drives its
  timed window;
- `traffic/<traffic>.json` holds the mix's parameters, which that system's
  generator reads;
- `reference/<config>.py` is the configuration's plain reference: it
  compares what the timed path produced and gives each number compared
  with its limit;
- `metrics/<metric>.py` reads one per-layer metric from the traced slice
  and the counters a run keeps, or returns None where it finds nothing.

A run: set-up (built, warmed, every shape of the cell captured), the
window of `--seconds`, the wait for what the window left in flight, the
device's peak memory, the program's outputs copied to the host and its
state freed, then the reference's comparison on the host. With `--trace 1`
the last second of the window is traced (yardstick/trace.py) and the
result carries the per-layer metrics; with `--trace 0`, the end-to-end
ones.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional, Tuple

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
# seconds traced at the end of a `--trace 1` window (at most half of it)
TRACE_SECONDS = 1.0
# seconds the run waits, after the window, for what it left in flight
DRAIN_S = 60.0


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def _reports(metric: Dict[str, Any], workload: str) -> bool:
    return workload in metric.get("workloads", [workload])


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell `workload` of `root`/BENCHMARK.json, with its
    configuration, mix and metrics."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads(
        (root / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
    if traffic["system"] != config["system"]:
        raise ValueError(f"traffic {w['traffic']!r} drives a "
                         f"{traffic['system']!r} system, configuration "
                         f"{config['name']!r} a {config['system']!r} one")
    return Cell(name=workload, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, workload)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, workload)])


def load_module(kind: str, name: str) -> ModuleType:
    """`portbench/<kind>/<name>.py`, loaded by path (names may hold `.`
    and `-`)."""
    path = PKG / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name}".replace("-", "_").replace(".", "_"), path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def process_start() -> float:
    """The process's start on the `time.perf_counter()` clock, from its
    age in /proc (the clock's own reading where /proc is missing)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        age = 0.0
    return now - max(age, 0.0)


def shape_facts(system) -> Dict[str, int]:
    """A batched system's delivery shapes, which a kernel's reader turns
    into bytes: inbox rows, recipients, payload columns, bytes a payload
    column, mailbox slots a recipient (0: one reduced mailbox)."""
    return {"inbox_rows": int(system.inbox_dst.numel()),
            "recipients": int(system.capacity),
            "payload_width": int(system.payload_width),
            "payload_bytes": int(system.inbox_payload.element_size()),
            "mailbox_slots": int(system.mailbox_slots)}


class GcWatch:
    """Records the garbage collector's passes while it is on (`gc.callbacks`):
    their number and seconds by generation, and the longest. A pass on a
    profiled thread also shows as a host span `portbench.gc<generation>`,
    so an idle gap that a collection caused is labelled by it."""

    def __init__(self):
        self.count = [0, 0, 0]
        self.seconds = [0.0, 0.0, 0.0]
        self.longest = 0.0
        self._t0 = 0.0
        self._span = None

    def _callback(self, phase: str, info: Dict[str, int]) -> None:
        gen = int(info["generation"])
        if phase == "start":
            from torch.profiler import record_function
            self._span = record_function(f"portbench.gc{gen}")
            self._span.__enter__()
            self._t0 = time.perf_counter()
            return
        took = time.perf_counter() - self._t0
        if self._span is not None:
            self._span.__exit__(None, None, None)
            self._span = None
        self.count[gen] += 1
        self.seconds[gen] += took
        self.longest = max(self.longest, took)

    def __enter__(self) -> "GcWatch":
        gc.callbacks.append(self._callback)
        return self

    def __exit__(self, *exc) -> None:
        gc.callbacks.remove(self._callback)

    def counters(self) -> Dict[str, float]:
        out: Dict[str, float] = {"gc_longest_s": self.longest}
        for gen in range(3):
            out[f"gc{gen}_passes"] = self.count[gen]
            out[f"gc{gen}_s"] = self.seconds[gen]
        return out


@dataclass
class RunOutcome:
    correct: bool
    attempted: int
    failed: int
    setup_s: float
    end_to_end: Dict[str, float]
    per_layer: Dict[str, float]
    checks: Dict[str, Tuple[float, float]]
    device: Dict[str, Any]
    trace: Any
    counters: Dict[str, float]
    control: Optional[Dict[str, Dict[str, Tuple[float, float]]]] = None


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda",
             control: bool = False) -> RunOutcome:
    """Set-up, window, drain, outputs, comparison. `t_start` is the
    process's start on the perf_counter clock. With `control`, the
    reference also stands in for the program once for each of its
    `CONTROLS` (a lower precision, a guarantee broken), each compared like
    the program (the calibration's controls; never in a benchmark run)."""
    import torch

    system = load_module("systems", cell.config["system"])
    reference = load_module("reference", cell.config["name"])
    on_card = device != "cpu"
    session = system.Session(cell.config, cell.traffic, seed, device)
    session.setup()
    setup_s = time.perf_counter() - t_start

    tracer = None
    if trace and on_card:
        from .yardstick.trace import DeviceTrace
        tracer = DeviceTrace()
        tracer.prepare()
    with GcWatch() as gc_watch:
        session.window(float(seconds), tracer,
                       min(TRACE_SECONDS, float(seconds) / 2))
    session.drain(DRAIN_S)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    outputs = session.outputs()
    counters = dict(session.counters(), **gc_watch.counters())
    e2e = session.end_to_end()
    attempted, failed = session.attempted, session.failed
    session.close()
    del session
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    checks = reference.compare(outputs)
    correct = all(v <= limit for v, limit in checks.values())
    control_checks = None
    if control:
        control_checks = {name: reference.compare(
            reference.simulate(outputs, name)) for name in reference.CONTROLS}

    summary = tracer.summary() if tracer is not None else None
    card = torch.cuda.get_device_name(0) if on_card else "cpu"
    per_layer: Dict[str, float] = {}
    if trace:
        ctx = MetricContext(summary, counters, card)
        for m in cell.per_layer:
            value = load_module("metrics", m["name"]).read(ctx)
            if value is not None:
                per_layer[m["name"]] = value
    dev: Dict[str, Any] = {"platform": "gpu" if on_card else "cpu",
                           "kind": card, "count": cell.chips,
                           "memory_peak_bytes": int(peak)}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
    return RunOutcome(correct=correct, attempted=int(attempted),
                      failed=int(failed), setup_s=setup_s, end_to_end=e2e,
                      per_layer=per_layer, checks=checks, device=dev,
                      trace=summary, counters=counters,
                      control=control_checks)


@dataclass
class MetricContext:
    """What a per-layer reader reads: the traced slice (None when nothing
    was traced): its busy and window seconds and its device and host
    events, clipped to it (yardstick/trace.py `TraceSummary`); the run's
    counters: the system's before-and-after counts over the window, its
    delivery shapes (`shape_facts`) and the collector's passes; the
    card's name."""
    trace: Any
    counters: Dict[str, float]
    card: str


def result_line(cell: Cell, out: RunOutcome, trace: bool) -> Dict[str, Any]:
    metrics: Dict[str, Dict[str, Any]] = {}
    if trace:
        for m in cell.per_layer:
            if m["name"] in out.per_layer:
                metrics[m["name"]] = {"value": out.per_layer[m["name"]],
                                      "unit": m["unit"]}
    else:
        values = dict(out.end_to_end, setup_s=out.setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    line: Dict[str, Any] = {"correct": out.correct,
                            "attempted": out.attempted,
                            "failed": out.failed, "metrics": metrics,
                            "device": out.device}
    if trace and out.trace is not None:
        line["breakdown"] = {
            "device_ops": [[n, s] for n, s in out.trace.device_ops],
            "idle_gaps": [[n, s] for n, s in out.trace.idle_gaps]}
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in out.checks.items()}
    return line


def parse_args(argv: List[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv: List[str], t_start: float) -> int:
    args = parse_args(argv)
    cell = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("portbench: no CUDA device; no result", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present; no result",
              file=sys.stderr)
        return 3
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), t_start)
    from .yardstick.jaxcheck import forbidden_modules
    found = forbidden_modules()
    if found:
        print(f"portbench: JAX modules loaded in this process: {found}; "
              "no result", file=sys.stderr)
        return 4
    line = result_line(cell, out, bool(args.trace))
    if args.trace:
        # the traced run's own end-to-end readings, for the tracing's cost
        print(f"traced run end_to_end {json.dumps(out.end_to_end)}",
              file=sys.stderr)
    print("gc " + json.dumps({k: v for k, v in out.counters.items()
                              if k.startswith("gc")}), file=sys.stderr)
    for name, (value, limit) in out.checks.items():
        print(f"check {name} {value} limit {limit}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    sys.stdout.flush()
    return 0
