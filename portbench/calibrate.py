"""Readings that set the benchmark's limits and loads; never part of a
benchmark run.

    python3 portbench/calibrate.py control --workload W --seed N --seconds S
        one run of the cell, as run.py makes it, that also puts the plain
        reference in the program's place once for each of its controls (a
        lower precision, a guarantee broken) and compares it like the
        program: prints every set of readings.
    python3 portbench/calibrate.py setup --workload W --seed N
        --set KEY=VALUE ...
        the cell's set-up alone, with configuration keys overridden (a
        larger scale, say): prints its seconds.
    python3 portbench/calibrate.py sweep --workload W --callers 8,16,32
        --seconds S --seed N
        the cell's closed loop at each number of callers, one set-up
        each, in one process: asks/s and ask p95 ms, to find where the
        rate stops rising.

Each prints one JSON line per run on standard output.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)

from portbench import harness  # noqa: E402


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("control", "sweep", "setup"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--callers", default="")
    ap.add_argument("--set", action="append", default=[])
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    if args.what == "setup":
        over = dict(kv.split("=", 1) for kv in args.set)
        config = dict(cell.config, **{k: int(v) for k, v in over.items()})
        system = harness.load_module("systems", config["system"])
        t0 = time.perf_counter()
        session = system.Session(config, cell.traffic, args.seed, "cuda")
        session.setup()
        print(json.dumps({"workload": cell.name, "set": over,
                          "build_and_warm_s": time.perf_counter() - t0,
                          "since_start_s": time.perf_counter()
                          - harness.process_start()}), flush=True)
        session.close()
        return 0
    if args.what == "control":
        out = harness.run_cell(cell, args.seed, args.seconds, False,
                               harness.process_start(), control=True)
        print(json.dumps({"workload": cell.name, "seed": args.seed,
                          "correct": out.correct, "program": out.checks,
                          "control": out.control,
                          "end_to_end": out.end_to_end,
                          "setup_s": out.setup_s,
                          "gc": {k: v for k, v in out.counters.items()
                                 if k.startswith("gc")}}), flush=True)
        return 0
    for n in (int(x) for x in args.callers.split(",")):
        cell.traffic = dict(cell.traffic, callers=n)
        out = harness.run_cell(cell, args.seed, args.seconds, False,
                               time.perf_counter())
        print(json.dumps({"workload": cell.name, "callers": n,
                          "correct": out.correct,
                          "end_to_end": out.end_to_end}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
