"""Device time of the ring-mailbox kernels at three traffic patterns.

    python3 -m akka_tpu_torch.tools.bench_mailbox [--n 1048576] [--iters 200]
        [--dtype float32|int32|bf16] [--baseline OLD.cu]
        [--variant NAME=OTHER.cu ...] [--out FILE]

Patterns, at n actors, m = n + 8 message rows, P = 4 payload columns of
`--dtype` (default float32) and S = 2 ring slots (`make_pattern`):
- random: recipients uniform over [-1, n] (-1 and n are dropped), 10% of
  the rows invalid;
- ring: dst = (i + 1) % n, the last 8 rows invalid (the host-inbox rows);
- fan_in: dst = i % 1000, the last 8 rows invalid (1000 hot collectors).

Libraries: the package's `ring_mailbox.cu`; each `--variant`, another
source with the same C interface; and `--baseline`, a source with the
three-pass design's interface (float32 only), in which the caller zeroes
counts, sums and dropped and fills the claim array `first` [S, n] with
INT_MAX before each call. Each is built with nvcc (all at once) and held
against the plain versions on every pattern (`compare`: integers, int32
sums included, bit-equal; float32 sums within rtol 1e-4 / atol 1e-3; bf16
sums within one bf16 ulp plus the float32 reordering allowance), and so
is K1's yardstick, one `index_add_` (`library_reduce`). Then each C entry
is timed with CUDA events around `iters` launches on outputs allocated
once, with the zeroing inside the timed window: the C entry's own
memsets, or the baseline's fills; libraries with the package's interface
share one set of outputs. Libraries take turns (baseline,
package, variants, then the same in reverse), and every reading is
printed, with the yardstick's time and the byte bound at 3.35 TB/s
(accepted rows only, at the payload's element size) and the card's name
and power limit. With `--profile`, each C entry of each library also
runs 20 times under torch.profiler, and its device time per call is
printed by kernel and memset (K2: the memsets, the claiming sweep and
`ring_fill`, which for bf16 also rounds the sums), one line per library,
the package's beside each variant's.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..models.baseline_benches import PAYLOAD_W
from ..ops import cuda_mailbox as cm
from ..ops.segment import _DUMP_ROWS, _spread_dead
from .profile_step import device_us

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)
RTOL, ATOL = 1e-4, 1e-3     # sums: float atomics add in no fixed order
PATTERNS = ("random", "ring", "fan_in")
DTYPES = {"float32": torch.float32, "int32": torch.int32,
          "bf16": torch.bfloat16}
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
                 device="cuda", dtype: torch.dtype = torch.float32):
    """(dst, mtype, payload, valid) of one traffic pattern (see above).
    The payload is standard normal in float32 and rounded to bf16, or
    integers in [-1000, 1000) in int32 (drawn last: the other columns are
    the float32 pattern's)."""
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
    if dtype == torch.int32:
        payload = torch.randint(-1000, 1000, (m, p), generator=g,
                                device=device, dtype=torch.int32)
    else:
        payload = payload.to(dtype)
    return dst, mtype, payload, valid


def bound_bytes(m: int, n: int, p: int, slots: int,
                live: Optional[int] = None, elem: int = 4):
    """Bytes K1 and K2 must move: each input read once (dst and valid of
    every row; payload, and for K2 mtype, of the `live` rows the kernels
    accept, default all m), each output written once (counts, sums; K2
    also the ring cells and dropped). Payload, sums and ring payload
    count `elem` bytes an element, the payload's own size in both
    kernels; scratch (K2's claim levels, bf16's float32 accumulator) is
    not an output and counts nothing."""
    live = m if live is None else live
    k1 = m * (4 + 1) + live * elem * p + n * (4 + elem * p)
    return k1, k1 + live * 4 + n * slots * (4 + elem * p + 1) + 4


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    a = x.float().abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def sum_slack(dst, payload, valid, n: int) -> torch.Tensor:
    """[n, P] float32 allowance between two float32 sums of the same rows
    added in different orders: 2 * k * 2^-24 * sum|x| over each
    recipient's k accepted rows."""
    ok = valid & (dst >= 0) & (dst < n)
    key = torch.where(ok, dst, n).long()
    k = torch.zeros((n + 1,), device=dst.device).index_add_(0, key, ok.float())
    mag = torch.zeros((n + 1, payload.shape[1]), device=dst.device) \
        .index_add_(0, key, torch.where(ok[:, None], payload.float().abs(), 0))
    return (2 * k[:, None] * 2.0 ** -24 * mag)[:n]


def compare(name: str, got, want, slack=None) -> float:
    """Integer fields (int32 sums included) bit-equal; float32 fields
    allclose; bf16 fields within one bf16 ulp of the larger of the two,
    plus `slack` where it has the field's shape (the sums: both sides add
    in float32 in no fixed order, then round once). Raises otherwise;
    returns the max absolute float error."""
    err = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if a.dtype == torch.bfloat16:
            diff = (a.float() - b.float()).abs()
            tol = bf16_ulp(torch.maximum(a.float().abs(), b.float().abs()))
            if slack is not None and slack.shape == a.shape:
                tol = tol + slack
            if not bool((diff <= tol).all()):
                raise RuntimeError(f"{name} field {i} outside one bf16 ulp")
            err = max(err, float(diff.max()))
        elif a.is_floating_point():
            if not torch.allclose(a, b, rtol=RTOL, atol=ATOL):
                raise RuntimeError(f"{name} field {i} outside rtol {RTOL} / "
                                   f"atol {ATOL}")
            err = max(err, float((a - b).abs().max()))
        elif not torch.equal(a, b):
            raise RuntimeError(f"{name} field {i} not bit-equal")
    return err


def shifted(t: torch.Tensor, elems: int = 1) -> torch.Tensor:
    """A contiguous copy of t that starts `elems` elements past the start
    of its allocation: off every alignment above its element size, so
    the kernels take their column branch for it."""
    out = torch.empty(t.numel() + elems, dtype=t.dtype,
                      device=t.device)[elems:].view(t.shape)
    out.copy_(t)
    return out


def shifted_slots(lib, inputs, n: int, slots: int, shift: str):
    """K2 through `lib`'s C entry with one operand `shifted` off its
    4-element word: "payload", or the output "buf_p", "sums" or "acc"
    (bf16's accumulator). Returns the outputs in the plain version's
    layout."""
    dst, mtype, payload, valid = inputs
    if shift == "payload":
        payload = shifted(payload)
    out = dict(zip(("scratch", "sums", "acc", "buf_t", "buf_p", "buf_v"),
                   cm.slots_outputs(n, payload.shape[1], slots, dst.device,
                                    payload.dtype)))
    if shift != "payload":
        out[shift] = shifted(out[shift])
    moved = payload if shift == "payload" else out[shift]
    if moved.data_ptr() % (4 * moved.element_size()) == 0:
        raise RuntimeError(f"shifted {shift} still lies on a 4-element word")
    cm.launch_slots(lib, dst, mtype, payload, valid, n, slots, **out)
    return (out["buf_t"], out["buf_p"], out["buf_v"], out["scratch"][:n],
            out["sums"], out["scratch"][-1])


def library_reduce(dst, payload, valid, n: int, native: bool = False):
    """K1's function as one PyTorch `index_add_`: the yardstick of K1's
    time, which the port never calls. The accepted rows, with a count
    column of ones, are prepared here (outside any timing); the returned
    call adds them into zeroed [n + 1024, P + 1] rows, the other rows
    spread over the 1024 past n as the plain version spreads them (one
    drop row would serialise their atomics), and returns (counts [n]
    int32, sums [n, P] in the payload's dtype). The accumulator takes the
    payload's dtype for float32 and int32, and float32 for bf16, whose
    sums are then rounded once, as K1's are. With `native`, bf16 adds in
    bf16: the yardstick timed before, whose adds each round to bf16 on
    the card (kept to show that it is not K1's function)."""
    ok = valid & (dst >= 0) & (dst < n)
    key = _spread_dead(torch.where(ok, dst, -1), n)
    acc = torch.float32 if payload.dtype == torch.bfloat16 and not native \
        else payload.dtype
    src = torch.cat([torch.where(ok[:, None], payload, 0).to(acc),
                     ok[:, None].to(acc)], dim=1)
    p = payload.shape[1]

    def call():
        out = torch.zeros((n + _DUMP_ROWS, p + 1), dtype=acc,
                          device=dst.device).index_add_(0, key, src)
        return out[:n, p].to(torch.int32), out[:n, :p].to(payload.dtype)
    return call


def kernel_name(key: str) -> str:
    """A profiler key without its namespace, return type and arguments:
    `ring_fill<true, int>`, `Memset`."""
    key = key.removeprefix("void ").replace("(anonymous namespace)::", "")
    return key.split("(")[0].strip()


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
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and device_us(e) > 0:
            name = kernel_name(e.key)
            out[name] = out.get(name, 0.0) + device_us(e) / 1e3 / calls
    return out


def entry_outputs(inputs, n: int, slots: int):
    """The outputs of both C entries (`reduce_outputs`, `slots_outputs`)
    for `inputs`, allocated once."""
    dst, _, payload, _ = inputs
    p = payload.shape[1]
    return (cm.reduce_outputs(n, p, dst.device, payload.dtype),
            cm.slots_outputs(n, p, slots, dst.device, payload.dtype))


def package_entries(lib, inputs, n: int, slots: int, outputs=None):
    """(k1, k2, results) for a library with the package's C interface:
    k1 and k2 call the C entries on `outputs` (`entry_outputs`; allocated
    here when None); results() returns their outputs in the plain
    versions' layout. Libraries timed against each other share one set of
    outputs: on fan-in, where a thousand hot sum rows take every atomic,
    the time of one and the same kernel moved with where its outputs lay
    (PERF.md section 6)."""
    dst, mtype, payload, valid = inputs
    if outputs is None:
        outputs = entry_outputs(inputs, n, slots)
    (counts, sums, acc), (scratch, sums2, acc2, buf_t, buf_p, buf_v) = \
        outputs

    def k1():
        cm.launch_reduce(lib, dst, payload, valid, n, counts, sums, acc)

    def k2():
        cm.launch_slots(lib, dst, mtype, payload, valid, n, slots, scratch,
                        sums2, acc2, buf_t, buf_p, buf_v)

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
    ap.add_argument("--dtype", choices=tuple(DTYPES), default="float32")
    ap.add_argument("--baseline", type=Path, default=None)
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=PATH")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_mailbox: no CUDA device is available")
    dtype = DTYPES[args.dtype]
    if args.baseline is not None and dtype != torch.float32:
        raise SystemExit("bench_mailbox: --baseline takes float32 only")
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
              "dtype": args.dtype, "iters": args.iters, "patterns": {}}
    for pattern in PATTERNS:
        inputs = make_pattern(pattern, m, n, p, seed=PATTERNS.index(pattern),
                              dtype=dtype)
        dst, _, payload, valid = inputs
        live = int((valid & (dst >= 0) & (dst < n)).sum())
        b1, b2 = bound_bytes(m, n, p, slots, live, payload.element_size())
        slack = sum_slack(dst, payload, valid, n) \
            if dtype == torch.bfloat16 else None
        want1 = cm.ring_reduce_plain(dst, payload, valid, n)
        want2 = cm.ring_slots_plain(*inputs, n, slots)
        library = library_reduce(dst, payload, valid, n)
        compare(f"library K1 {pattern}", library(), want1, slack)
        entries = {}
        shared = entry_outputs(inputs, n, slots)
        for name, lib in libs.items():
            if name == "baseline":
                k1, k2, results = baseline_entries(lib, inputs, n, slots)
            else:
                k1, k2, results = package_entries(lib, inputs, n, slots,
                                                  shared)
            k1()
            k2()
            got1, got2 = results()
            torch.cuda.synchronize()
            compare(f"{name} K1 {pattern}", got1, want1, slack)
            compare(f"{name} K2 {pattern}", got2, want2, slack)
            entries[name] = (k1, k2)
        readings = {name: {"K1": [], "K2": []} for name in libs}
        library_ms = []
        for name in turns:
            k1, k2 = entries[name]
            readings[name]["K1"].append(cuda_ms(k1, args.iters, 5))
            readings[name]["K2"].append(cuda_ms(k2, args.iters, 5))
            if name == "package":
                library_ms.append(cuda_ms(library, args.iters, 5))
        print(f"{pattern} {args.dtype} library K1_ms {library_ms}")
        for name, r in readings.items():
            print(f"{pattern} {args.dtype} {name} K1_ms {r['K1']} "
                  f"K2_ms {r['K2']}")
        if args.profile:
            for i, k in enumerate(("K1", "K2")):
                for name, r in readings.items():
                    r[f"{k}_by_kernel"] = device_breakdown(entries[name][i])
                    print(f"{pattern} {args.dtype} {name} {k}_by_kernel "
                          f"{r[f'{k}_by_kernel']}")
        print(f"{pattern} bound_ms K1 {bound_ms(b1)} K2 {bound_ms(b2)}")
        report["patterns"][pattern] = {
            "readings": readings, "library_ms": {"K1": library_ms},
            "bound_ms": {"K1": bound_ms(b1), "K2": bound_ms(b2)}}
        del inputs, entries, library, shared
    line = json.dumps(report)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
