"""Device time of the ring-mailbox kernels at three traffic patterns.

    python3 -m akka_tpu_torch.tools.bench_mailbox [--n 1048576] [--iters 200]
        [--baseline OLD.cu] [--variant NAME=OTHER.cu ...] [--out FILE]

Patterns, at n actors, m = n + 8 message rows, P = 4 payload columns and
S = 2 ring slots (`make_pattern`):
- random: recipients uniform over [-1, n] (-1 and n are dropped), 10% of
  the rows invalid;
- ring: dst = (i + 1) % n, the last 8 rows invalid (the host-inbox rows);
- fan_in: dst = i % 1000, the last 8 rows invalid (1000 hot collectors).

Libraries: the package's `ring_mailbox.cu`; each `--variant`, another
source with the same C interface; and `--baseline`, a source with the
three-pass design's interface, in which the caller zeroes counts, sums and
dropped and fills the claim array `first` [S, n] with INT_MAX before each
call. Each is built with nvcc (all at once) and held against the plain
versions on every pattern (integers bit-equal, sums within rtol 1e-4 /
atol 1e-3). Then each C entry is timed with CUDA events around `iters`
launches on outputs allocated once, with the zeroing inside the timed
window: the C entry's own memsets, or the baseline's fills. Libraries take
turns (baseline, package, variants, then the same in reverse), and every
reading is printed, with the byte bound at 3.35 TB/s and the card's name
and power limit. With `--profile`, each C entry also runs 20 times under
torch.profiler, and its device time per call is printed by kernel and
memset.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..models.baseline_benches import PAYLOAD_W
from ..ops import cuda_mailbox as cm
from .profile_step import device_us

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)
RTOL, ATOL = 1e-4, 1e-3     # sums: float atomics add in no fixed order
PATTERNS = ("random", "ring", "fan_in")
FAN_IN_COLLECTORS = 1000
HOST_ROWS = 8               # the inbox rows after the n emissions
SLOTS = 2                   # ring slots of the main path's bounded mailboxes
INT_MAX = 2 ** 31 - 1


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


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


def make_pattern(name: str, m: int, n: int, p: int, seed: int,
                 device="cuda"):
    """(dst, mtype, payload, valid) of one traffic pattern (see above)."""
    g = torch.Generator(device=device).manual_seed(seed)
    mtype = torch.randint(1, 5, (m,), generator=g, device=device,
                          dtype=torch.int32)
    payload = torch.randn((m, p), generator=g, device=device)
    i = torch.arange(m, device=device, dtype=torch.int32)
    if name == "random":
        dst = torch.randint(-1, n + 1, (m,), generator=g, device=device,
                            dtype=torch.int32)
        valid = torch.rand((m,), generator=g, device=device) > 0.1
    elif name == "ring":
        dst, valid = (i + 1) % n, i < m - HOST_ROWS
    elif name == "fan_in":
        dst, valid = i % min(n, FAN_IN_COLLECTORS), i < m - HOST_ROWS
    else:
        raise ValueError(f"unknown pattern {name!r}")
    return dst, mtype, payload, valid


def bound_bytes(m: int, n: int, p: int, slots: int):
    """Bytes K1 and K2 must move: each input read once (dst, valid,
    payload; K2 also mtype), each output written once (counts, sums; K2
    also the ring cells and dropped)."""
    k1 = m * (4 + 1 + 4 * p) + n * (4 + 4 * p)
    return k1, k1 + m * 4 + n * slots * (4 + 4 * p + 1) + 4


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def compare(name: str, got, want) -> float:
    """Integer fields bit-equal, float fields allclose (raises otherwise);
    returns the max absolute float error."""
    err = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if a.is_floating_point():
            if not torch.allclose(a, b, rtol=RTOL, atol=ATOL):
                raise RuntimeError(f"{name} field {i} outside rtol {RTOL} / "
                                   f"atol {ATOL}")
            err = max(err, float((a - b).abs().max()))
        elif not torch.equal(a, b):
            raise RuntimeError(f"{name} field {i} not bit-equal")
    return err


def device_breakdown(fn, calls: int = 20):
    """{kernel or memset name: device ms per call} of fn under
    torch.profiler."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: device_us(e) / 1e3 / calls
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and device_us(e) > 0}


def package_entries(lib, inputs, n: int, slots: int):
    """(k1, k2, results) for a library with the package's C interface:
    k1 and k2 call the C entries on outputs allocated here, once; results()
    returns their outputs in the plain versions' layout."""
    dst, mtype, payload, valid = inputs
    p = payload.shape[1]
    counts, sums = cm.reduce_outputs(n, p, dst.device)
    scratch, sums2, buf_t, buf_p, buf_v = cm.slots_outputs(n, p, slots,
                                                           dst.device)

    def k1():
        cm.launch_reduce(lib, dst, payload, valid, n, counts, sums)

    def k2():
        cm.launch_slots(lib, dst, mtype, payload, valid, n, slots, scratch,
                        sums2, buf_t, buf_p, buf_v)

    def results():
        return ((counts, sums),
                (buf_t, buf_p, buf_v, scratch[:n], sums2, scratch[-1]))
    return k1, k2, results


def baseline_entries(lib, inputs, n: int, slots: int):
    """The same for the three-pass design's interface: the caller fills
    the outputs before each call, and the fills are part of k1 and k2."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.ring_reduce.argtypes = [vp, vp, vp, ci, ci, ci, vp, vp, vp]
    lib.ring_reduce.restype = ci
    lib.ring_slots.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci] + [vp] * 8
    lib.ring_slots.restype = ci
    dst, mtype, payload, valid = inputs
    m, p = payload.shape
    dev = dst.device
    i32 = dict(dtype=torch.int32, device=dev)
    counts, counts2 = torch.empty((n,), **i32), torch.empty((n,), **i32)
    sums = torch.empty((n, p), dtype=torch.float32, device=dev)
    sums2 = torch.empty_like(sums)
    first = torch.empty((slots, n), **i32)
    dropped = torch.empty((1,), **i32)
    buf_t = torch.empty((n, slots), **i32)
    buf_p = torch.empty((n, slots, p), dtype=torch.float32, device=dev)
    buf_v = torch.empty((n, slots), dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [t.data_ptr() for t in (dst, mtype, payload, valid)]

    def k1():
        counts.zero_()
        sums.zero_()
        cm._raise_on(lib.ring_reduce(ptrs[0], ptrs[2], ptrs[3], m, n, p,
                                     counts.data_ptr(), sums.data_ptr(),
                                     stream), "baseline ring_reduce")

    def k2():
        counts2.zero_()
        sums2.zero_()
        first.fill_(INT_MAX)
        dropped.zero_()
        cm._raise_on(lib.ring_slots(
            *ptrs, m, n, p, slots, counts2.data_ptr(), sums2.data_ptr(),
            first.data_ptr(), buf_t.data_ptr(), buf_p.data_ptr(),
            buf_v.data_ptr(), dropped.data_ptr(), stream),
            "baseline ring_slots")

    def results():
        return ((counts, sums),
                (buf_t, buf_p, buf_v, counts2, sums2, dropped[0]))
    return k1, k2, results


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--baseline", type=Path, default=None)
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=PATH")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_mailbox: no CUDA device is available")
    card = card_line()
    print(card)
    n, p, slots = args.n, PAYLOAD_W, SLOTS
    m = n + HOST_ROWS

    sources = {"package": cm.SOURCE}
    for spec in args.variant:
        name, _, path = spec.partition("=")
        sources[name] = Path(path)
    if args.baseline is not None:
        sources["baseline"] = args.baseline
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(zip(sources, pool.map(cm.compile_library,
                                          sources.values())))
    cm.bind(libs["package"])
    for name in sources:
        if name not in ("package", "baseline"):
            cm.bind(libs[name])
    turns = list(sources)
    if "baseline" in turns:
        turns.remove("baseline")
        turns.insert(0, "baseline")
    turns += turns[::-1]

    report = {"card": card, "n": n, "m": m, "p": p, "slots": slots,
              "iters": args.iters, "patterns": {}}
    b1, b2 = bound_bytes(m, n, p, slots)
    for pattern in PATTERNS:
        inputs = make_pattern(pattern, m, n, p, seed=PATTERNS.index(pattern))
        want1 = cm.ring_reduce_plain(inputs[0], inputs[2], inputs[3], n)
        want2 = cm.ring_slots_plain(*inputs, n, slots)
        entries = {}
        for name, lib in libs.items():
            make = baseline_entries if name == "baseline" else package_entries
            k1, k2, results = make(lib, inputs, n, slots)
            k1()
            k2()
            got1, got2 = results()
            torch.cuda.synchronize()
            compare(f"{name} K1 {pattern}", got1, want1)
            compare(f"{name} K2 {pattern}", got2, want2)
            entries[name] = (k1, k2)
        readings = {name: {"K1": [], "K2": []} for name in libs}
        for name in turns:
            k1, k2 = entries[name]
            readings[name]["K1"].append(cuda_ms(k1, args.iters, 5))
            readings[name]["K2"].append(cuda_ms(k2, args.iters, 5))
        for name, r in readings.items():
            print(f"{pattern} {name} K1_ms {r['K1']} K2_ms {r['K2']}")
            if args.profile:
                for k, fn in zip(("K1", "K2"), entries[name]):
                    r[f"{k}_by_kernel"] = device_breakdown(fn)
                    print(f"{pattern} {name} {k}_by_kernel "
                          f"{r[f'{k}_by_kernel']}")
        print(f"{pattern} bound_ms K1 {bound_ms(b1)} K2 {bound_ms(b2)}")
        report["patterns"][pattern] = {
            "readings": readings, "bound_ms": {"K1": bound_ms(b1),
                                               "K2": bound_ms(b2)}}
        del inputs, entries
    line = json.dumps(report)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
