"""The ring mailbox on Hopper: bindings of `csrc/ring_mailbox.cu`.

Port of `akka_tpu/ops/pallas_mailbox.py`, the reference's one Pallas
kernel. Its two modes are two kernels in practice, and both sit behind the
`backend` seam of `ops/segment.py`:

- `deliver_reduce` (K1): per-recipient count and payload sum over rows with
  `valid & 0 <= dst < n`. C entry `ring_reduce`.
- `deliver_slots_ring` (K2): K1, plus each recipient's first `slots` rows in
  arrival order in its ring (types, payload, valid), and `dropped` = valid
  rows past `slots`. C entry `ring_slots`.

Each C entry zeroes its own outputs (`cudaMemsetAsync`) and launches one
kernel (K1) or two (K2); `launch_reduce`/`launch_slots` call it on outputs
the caller allocated, so a benchmark can time the C entry alone.

On a CUDA tensor each wrapper launches its kernel through ctypes or raises;
on a CPU tensor it runs the plain PyTorch version beside it
(`ring_reduce_plain`, `ring_slots_plain`), which the CPU tests hold against
the reference's Pallas kernel. `LAUNCHES` counts kernel launches per C
entry; the plain versions never touch it.

The library is built at first use: `nvcc -gencode
arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC` into
`akka_tpu_torch/_build/`, named by a hash of the source, and loaded with
ctypes (`compile_library` builds any source with this interface, for
side-by-side timing). Every launch goes to `torch.cuda.current_stream()`;
the C entry returns `cudaGetLastError()` and the wrapper raises on anything
but 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import torch

from .segment import Delivery, SlotDelivery, _segment_max

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "ring_mailbox.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# kernel launches per C entry (incremented only where a kernel launches)
LAUNCHES = {"ring_reduce": 0, "ring_slots": 0}

_INT_MAX = 2 ** 31 - 1
_VP, _CI = ctypes.c_void_p, ctypes.c_int
_lib: Optional[ctypes.CDLL] = None
_build_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def unsupported_reason(n_actors: int, p: int, slots: int = 1,
                       spill_cap: int = 0, slots_kind=None, suspended=None,
                       dtype: torch.dtype = torch.float32) -> Optional[str]:
    """Why a call lies outside the ring kernel's support matrix, or None.

    Spill generations and the per-recipient kind/suspension masks are
    redelivery machinery the ring kernel does not model; payloads are
    float32 (bf16 is queued).

    There is NO cap on accumulator state. The reference caps it at 8 MiB
    (`pallas_mailbox.py:59`), a TPU VMEM budget: rings, cursors and sums
    had to live on-chip, which at P=4 stops near 190k actors. On Hopper
    the counters, sums and rings live in device memory (behind the 50 MB
    L2) and are reached by atomics, so the kernel runs at any size that
    fits in memory. With the cap the 1M-actor path would never launch the
    kernel it ports."""
    if spill_cap > 0:
        return f"spill_cap={spill_cap} > 0"
    if slots_kind is not None:
        return "slots_kind"
    if suspended is not None:
        return "suspended"
    if n_actors < 1 or slots < 1 or p < 1:
        return f"shape n_actors={n_actors} slots={slots} p={p}"
    if dtype != torch.float32:
        return f"payload dtype {dtype}"
    if n_actors * slots >= _INT_MAX:
        return f"{n_actors} x {slots} ring cells exceed the int32 cell index"
    return None


def supported(n_actors: int, p: int, slots: int = 1, spill_cap: int = 0,
              slots_kind=None, suspended=None,
              dtype: torch.dtype = torch.float32) -> bool:
    """Static support matrix of the ring kernel (see unsupported_reason)."""
    return unsupported_reason(n_actors, p, slots, spill_cap, slots_kind,
                              suspended, dtype) is None


# ------------------------------------------------------------------ build

def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def compile_library(source: Path = SOURCE,
                    verbose: bool = False) -> ctypes.CDLL:
    """Compile a CUDA source (once per source hash) into `BUILD_DIR` and
    load it, without binding argument types. With `verbose`, nvcc runs with
    `-Xptxas -v` and its output is printed."""
    src = Path(source).read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()) \
        .hexdigest()[:16]
    so = BUILD_DIR / f"lib{Path(source).stem}_{tag}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose
                                       else []),
               "-o", str(tmp), str(source)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if verbose or res.returncode != 0:
            print(res.stdout + res.stderr, flush=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}): "
                               f"{' '.join(cmd)}")
        os.replace(tmp, so)
    return ctypes.CDLL(str(so))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of `ring_reduce` and `ring_slots`."""
    lib.ring_reduce.argtypes = [_VP, _VP, _VP, _CI, _CI, _CI, _VP, _VP, _VP]
    lib.ring_reduce.restype = _CI
    lib.ring_slots.argtypes = [_VP, _VP, _VP, _VP, _CI, _CI, _CI, _CI, _VP,
                               _VP, _VP, _VP, _VP, _VP]
    lib.ring_slots.restype = _CI
    return lib


def build(verbose: bool = False) -> ctypes.CDLL:
    """The package's library: `ring_mailbox.cu`, compiled and bound once."""
    global _lib
    with _build_lock:
        if _lib is None:
            _lib = bind(compile_library(SOURCE, verbose))
        return _lib


# ------------------------------------------------------------ validation

def _check(dst, payload, valid, mtype=None) -> Tuple[int, int]:
    """Device, dtype, shape and contiguity checks for a kernel launch."""
    if payload.dim() != 2:
        raise ValueError(f"payload must be [M, P], got {tuple(payload.shape)}")
    m, p = payload.shape
    named = [("dst", dst, torch.int32, (m,)),
             ("payload", payload, torch.float32, (m, p)),
             ("valid", valid, torch.bool, (m,))]
    if mtype is not None:
        named.append(("mtype", mtype, torch.int32, (m,)))
    for name, t, dtype, shape in named:
        if t.device != dst.device:
            raise ValueError(f"{name} is on {t.device}, dst on {dst.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if m >= _INT_MAX:
        raise ValueError(f"{m} message rows exceed the int32 row index")
    return m, p


def _raise_on(err: int, entry: str) -> None:
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err} at launch")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# --------------------------------------------------------- plain versions

def ring_reduce_plain(dst, payload, valid,
                      n_actors: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 in plain PyTorch: (counts [n] int32, sums [n, P]) over rows with
    valid & 0 <= dst < n, accumulated in row (arrival) order."""
    ok = valid & (dst >= 0) & (dst < n_actors)
    key = torch.where(ok, dst, n_actors).long()
    counts = torch.zeros((n_actors + 1,), dtype=torch.int32,
                         device=dst.device).index_add_(
        0, key, ok.to(torch.int32))
    sums = payload.new_zeros((n_actors + 1, payload.shape[1])).index_add_(
        0, key, torch.where(ok[:, None], payload, 0).to(payload.dtype))
    return counts[:n_actors], sums[:n_actors]


def ring_slots_plain(dst, mtype, payload, valid, n_actors: int, slots: int):
    """K2 in plain PyTorch: (types [n, S] int32, payload [n, S, P], valid
    [n, S] bool, counts, sums, dropped [] int32). A stable sort of the
    recipient key orders rows by (recipient, arrival); a row's rank is its
    sorted position minus its segment's start, and the first `slots` ranks
    of each recipient land in its ring. Empty slots are 0."""
    m, p = payload.shape
    dev = dst.device
    counts, sums = ring_reduce_plain(dst, payload, valid, n_actors)
    ok = valid & (dst >= 0) & (dst < n_actors)
    key = torch.where(ok, dst, n_actors).to(torch.int32)
    skey, order = torch.sort(key, stable=True)
    start = torch.searchsorted(
        skey, torch.arange(n_actors + 1, dtype=torch.int32, device=dev))
    rank = torch.arange(m, device=dev) - start[skey.long()]
    take = (skey < n_actors) & (rank < slots)
    cells = n_actors * slots
    # rows outside the rings all go to one scratch cell, sliced off below
    flat = torch.where(take, skey.long() * slots + rank, cells)
    buf_t = torch.zeros((cells + 1,), dtype=torch.int32, device=dev)
    buf_t.index_copy_(0, flat, mtype[order])
    buf_p = payload.new_zeros((cells + 1, p))
    buf_p.index_copy_(0, flat, payload[order])
    buf_v = torch.zeros((cells + 1,), dtype=torch.bool, device=dev)
    buf_v.index_copy_(0, flat, take)
    dropped = (counts - slots).clamp(min=0).sum().to(torch.int32)
    return (buf_t[:cells].reshape(n_actors, slots),
            buf_p[:cells].reshape(n_actors, slots, p),
            buf_v[:cells].reshape(n_actors, slots), counts, sums, dropped)


# ------------------------------------------------------------ the kernels

def reduce_outputs(n_actors: int, p: int, device) -> Tuple[torch.Tensor,
                                                           torch.Tensor]:
    """Uninitialised (counts [n] int32, sums [n, P] float32) for
    `launch_reduce`, which zeroes them."""
    return (torch.empty((n_actors,), dtype=torch.int32, device=device),
            torch.empty((n_actors, p), dtype=torch.float32, device=device))


def slots_outputs(n_actors: int, p: int, slots: int, device):
    """Uninitialised (scratch, sums, buf_t, buf_p, buf_v) for
    `launch_slots`, which zeroes scratch and sums and writes every ring
    cell. scratch is int32 [n + n * slots + 1]: counts, the claim levels
    [n, slots], dropped."""
    return (torch.empty((n_actors * (1 + slots) + 1,), dtype=torch.int32,
                        device=device),
            torch.empty((n_actors, p), dtype=torch.float32, device=device),
            torch.empty((n_actors, slots), dtype=torch.int32, device=device),
            torch.empty((n_actors, slots, p), dtype=torch.float32,
                        device=device),
            torch.empty((n_actors, slots), dtype=torch.bool, device=device))


def launch_reduce(lib, dst, payload, valid, n_actors: int, counts,
                  sums) -> None:
    """Call the C entry `ring_reduce` of `lib` on checked inputs and the
    outputs of `reduce_outputs`; raises on a launch error."""
    m, p = payload.shape
    with torch.cuda.device(dst.device):
        err = lib.ring_reduce(
            dst.data_ptr(), payload.data_ptr(), valid.data_ptr(), m,
            n_actors, p, counts.data_ptr(), sums.data_ptr(), _stream(dst))
    _raise_on(err, "ring_reduce")


def launch_slots(lib, dst, mtype, payload, valid, n_actors: int, slots: int,
                 scratch, sums, buf_t, buf_p, buf_v) -> None:
    """Call the C entry `ring_slots` of `lib` on checked inputs and the
    outputs of `slots_outputs`; raises on a launch error."""
    m, p = payload.shape
    with torch.cuda.device(dst.device):
        err = lib.ring_slots(
            dst.data_ptr(), mtype.data_ptr(), payload.data_ptr(),
            valid.data_ptr(), m, n_actors, p, slots, scratch.data_ptr(),
            sums.data_ptr(), buf_t.data_ptr(), buf_p.data_ptr(),
            buf_v.data_ptr(), _stream(dst))
    _raise_on(err, "ring_slots")


def ring_reduce(dst, payload, valid, n_actors: int):
    """K1: (counts [n] int32, sums [n, P] float32). Launches
    `ring_sweep` on a CUDA tensor, runs `ring_reduce_plain` on a CPU
    one. Sums accumulate by float atomics, in no fixed order."""
    if not dst.is_cuda:
        return ring_reduce_plain(dst, payload, valid, n_actors)
    _, p = _check(dst, payload, valid)
    counts, sums = reduce_outputs(n_actors, p, dst.device)
    launch_reduce(build(), dst, payload, valid, n_actors, counts, sums)
    LAUNCHES["ring_reduce"] += 1
    return counts, sums


def ring_slots(dst, mtype, payload, valid, n_actors: int, slots: int):
    """K2: the tuple of `ring_slots_plain`. Launches the claiming
    `ring_sweep` and `ring_fill` on a CUDA tensor; runs `ring_slots_plain`
    on a CPU one."""
    if not dst.is_cuda:
        return ring_slots_plain(dst, mtype, payload, valid, n_actors, slots)
    _, p = _check(dst, payload, valid, mtype)
    if n_actors * slots >= _INT_MAX:
        raise ValueError(f"{n_actors} x {slots} ring cells exceed the int32 "
                         f"cell index")
    scratch, sums, buf_t, buf_p, buf_v = slots_outputs(n_actors, p, slots,
                                                       dst.device)
    launch_slots(build(), dst, mtype, payload, valid, n_actors, slots,
                 scratch, sums, buf_t, buf_p, buf_v)
    LAUNCHES["ring_slots"] += 1
    return buf_t, buf_p, buf_v, scratch[:n_actors], sums, scratch[-1]


# ------------------------------------------------------- segment entries

def _merge_style_max(dst, payload, valid, n_actors: int, need_max: bool):
    """The reference's max convention around its kernel (plain torch, as in
    the reference): invalid rows contribute -inf, recipients with no rows
    read back 0."""
    p = payload.shape[1]
    if not need_max:
        return payload.new_zeros((n_actors, p))
    ok = valid & (dst >= 0) & (dst < n_actors)
    key = torch.where(ok, dst, n_actors).long()
    maxs = _segment_max(torch.where(ok[:, None], payload, float("-inf"))
                        .to(payload.dtype), key, n_actors + 1)[:n_actors]
    return torch.where(maxs <= float("-inf"), 0, maxs).to(payload.dtype)


def deliver_reduce(dst, payload, valid, n_actors: int,
                   need_max: bool) -> Delivery:
    """`deliver` semantics via the ring mailbox (K1): no sort, no rank
    pass."""
    counts, sums = ring_reduce(dst, payload, valid, n_actors)
    return Delivery(sum=sums,
                    max=_merge_style_max(dst, payload, valid, n_actors,
                                         need_max),
                    count=counts)


def deliver_slots_ring(dst, mtype, payload, valid, n_actors: int,
                       slots: int, need_max: bool) -> SlotDelivery:
    """Bounded-mailbox `deliver_slots` semantics (spill_cap == 0) via the
    ring mailbox (K2): each recipient's first `slots` messages land in
    arrival order, the rest count as dropped, and the aggregation consumes
    every valid row. The spill region is empty (no fill launches)."""
    p = payload.shape[1]
    buf_t, buf_p, buf_v, counts, sums, dropped = ring_slots(
        dst, mtype, payload, valid, n_actors, slots)
    dev = dst.device
    return SlotDelivery(
        types=buf_t, payload=buf_p, valid=buf_v, count=counts, sum=sums,
        max=_merge_style_max(dst, payload, valid, n_actors, need_max),
        dropped=dropped,
        spill_dst=torch.empty((0,), dtype=torch.int32, device=dev),
        spill_type=torch.empty((0,), dtype=torch.int32, device=dev),
        spill_payload=payload.new_empty((0, p)),
        spill_valid=torch.empty((0,), dtype=torch.bool, device=dev),
    )
