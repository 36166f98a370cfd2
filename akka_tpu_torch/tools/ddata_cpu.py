"""Where the host's CPU goes in chip_smoke.py's ddata_paths phase.

    python3 -m akka_tpu_torch.tools.ddata_cpu      (from the repo's root)

Runs the phase once on the card, with every check of
`python3 chip_smoke.py --ddata-phase 1`, and prints one line, `CPU`
followed by a JSON object: the process's CPU seconds and the phase's
wall seconds; the CPU seconds of each group of threads (read from
/proc/self/task every 0.25 s, a thread's last reading kept; a group is
the threads whose names differ only in their numbers or addresses); and,
for each actor class and message class, the CPU seconds its handling
took (`time.thread_time` around `Actor.around_receive`) and the count.
The three nodes of the phase share one interpreter lock, so CPU seconds
rank the host's work better than wall seconds inside a handler, which
include waits for the lock. The instrumentation adds its own cost to
the phase's seconds.
"""

from __future__ import annotations

import collections
import json
import os
import re
import sys
import threading
import time

from ..actor import actor as actor_mod


def _thread_cpu() -> dict:
    """tid -> CPU seconds of each thread of this process."""
    tick = os.sysconf("SC_CLK_TCK")
    out = {}
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue  # the thread ended
        out[tid] = (int(fields[11]) + int(fields[12])) / tick
    return out


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    handlers = collections.defaultdict(float)
    counts: collections.Counter = collections.Counter()
    lock = threading.Lock()
    around = actor_mod.Actor.around_receive

    def timed(self, receive, msg):
        t0 = time.thread_time()
        try:
            return around(self, receive, msg)
        finally:
            key = f"{type(self).__name__}/{type(msg).__name__}"
            dt = time.thread_time() - t0
            with lock:
                handlers[key] += dt
                counts[key] += 1

    actor_mod.Actor.around_receive = timed
    names: dict = {}
    last: dict = {}
    stop = threading.Event()

    def poll() -> None:
        while not stop.is_set():
            by_id = {t.native_id: t.name for t in threading.enumerate()}
            for tid, cpu in _thread_cpu().items():
                names[tid] = by_id.get(int(tid), names.get(tid, "?"))
                last[tid] = cpu
            time.sleep(0.25)

    cs.cm.build()
    base = _thread_cpu()
    poller = threading.Thread(target=poll, name="cpu-poll", daemon=True)
    poller.start()
    c0, w0 = time.process_time(), time.perf_counter()
    try:
        cs.ddata_paths({})
    finally:
        stop.set()
        poller.join()
        actor_mod.Actor.around_receive = around
    groups: dict = collections.defaultdict(float)
    for tid, cpu in last.items():
        name = re.sub(r"\d+\.\d+\.\d+\.\d+:\d+", "ADDR", names[tid])
        groups[re.sub(r"[-_]?\d+$", "", name)] += cpu - base.get(tid, 0.0)
    print("CPU", json.dumps({
        "cpu_s": time.process_time() - c0,
        "wall_s": time.perf_counter() - w0,
        "threads": sorted(((round(v, 3), k) for k, v in groups.items()),
                          reverse=True),
        "handlers": sorted(((round(v, 3), k, counts[k])
                            for k, v in handlers.items()), reverse=True)}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
