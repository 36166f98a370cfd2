"""Build + ctypes bindings for the port's native runtime library.

Port of `akka_tpu/native/lib.py` (commit 001ef4f), with a build that is
safe when several processes (test workers) reach it at once:

- it runs at first use (`get()`), never at import;
- the library lands in `akka_tpu_torch/_build/native/`, named by the
  digest of `src/akka_native.cpp`, so an edited source builds anew;
- the build holds an exclusive `fcntl.flock` on a lock file there, and
  looks for the library again once it holds the lock (another process
  may have built it meanwhile);
- g++ writes to a temp name unique to the process and thread, which
  `os.replace` then moves into place, so no reader sees a partial file.

Nothing falls back silently: without g++ (or when the build fails) `get()`
raises `RuntimeError`, and every consumer raises with it. `available()`
is a query: it builds if needed and says whether that worked.

The library is bound twice. `get()` is a `ctypes.CDLL`, whose calls
release the interpreter lock (the reference binds only this way); its
`held` attribute is a `ctypes.PyDLL` of the same library, whose calls
keep it, for the short calls on a tell's path (a stage, the queue's
enqueue and dequeue, the counts). Releasing and retaking the lock around
a few-microsecond call costs a thread switch whenever another thread
(the bridge's pump) wants the lock. A stage that meets a drain waits
holding the lock, which is safe: the drain runs in C through the CDLL,
without the lock.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "src", "akka_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build", "native")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def so_path() -> str:
    """Where the library for the current source lives."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libakka_native-{digest}.so")


def _build() -> str:
    """The library's path, compiled first if it is not there. Raises
    RuntimeError when g++ is missing or fails."""
    so = so_path()
    if os.path.exists(so):
        return so
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(
            "akka_tpu_torch.native: g++ was not found on PATH, so the "
            "native library (native/src/akka_native.cpp) cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(so):  # built by another process meanwhile
                return so
            tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
            cmd = [cxx, "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
                   "-o", tmp, _SRC]
            try:
                res = subprocess.run(cmd, capture_output=True, text=True,
                                     timeout=300)
                if res.returncode != 0:
                    raise RuntimeError(
                        "akka_tpu_torch.native: g++ failed to build "
                        f"{_SRC}:\n{res.stderr[-4000:]}")
                os.replace(tmp, so)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return so


def _bind(lib: ctypes.CDLL) -> None:
    u64, i64, i32p, u64p, u8p, voidp = (
        ctypes.c_uint64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_void_p)
    lib.aq_mpsc_create.restype = voidp
    lib.aq_mpsc_enqueue.argtypes = [voidp, u64]
    lib.aq_mpsc_dequeue.argtypes = [voidp, u64p]
    lib.aq_mpsc_dequeue.restype = ctypes.c_int
    lib.aq_mpsc_count.argtypes = [voidp]
    lib.aq_mpsc_count.restype = i64
    lib.aq_mpsc_drain.argtypes = [voidp, u64p, i64]
    lib.aq_mpsc_drain.restype = i64
    lib.aq_mpsc_close.argtypes = [voidp]
    lib.aq_mpsc_destroy.argtypes = [voidp]

    lib.aq_timer_create.argtypes = [u64, u64]
    lib.aq_timer_create.restype = voidp
    lib.aq_timer_schedule.argtypes = [voidp, u64, u64, u64]
    lib.aq_timer_cancel.argtypes = [voidp, u64]
    lib.aq_timer_poll.argtypes = [voidp, u64p, i64, i64]
    lib.aq_timer_poll.restype = i64
    lib.aq_timer_destroy.argtypes = [voidp]

    lib.aq_stager_create.argtypes = [i64, i64]
    lib.aq_stager_create.restype = voidp
    lib.aq_stager_stage.argtypes = [voidp, i64, i32p, u8p]
    lib.aq_stager_stage.restype = i64
    lib.aq_stager_count.argtypes = [voidp]
    lib.aq_stager_count.restype = i64
    lib.aq_stager_dropped.argtypes = [voidp]
    lib.aq_stager_dropped.restype = i64
    lib.aq_stager_drain.argtypes = [voidp, i32p, u8p]
    lib.aq_stager_drain.restype = i64
    lib.aq_stager_destroy.argtypes = [voidp]


def _bind_held(held: ctypes.PyDLL) -> None:
    """The calls that keep the interpreter lock; buffers go by address."""
    i64, voidp = ctypes.c_int64, ctypes.c_void_p
    held.aq_mpsc_enqueue.argtypes = [voidp, ctypes.c_uint64]
    held.aq_mpsc_dequeue.argtypes = [voidp, ctypes.POINTER(ctypes.c_uint64)]
    held.aq_mpsc_dequeue.restype = ctypes.c_int
    held.aq_mpsc_count.argtypes = [voidp]
    held.aq_mpsc_count.restype = i64
    held.aq_stager_stage.argtypes = [voidp, i64, voidp, voidp]
    held.aq_stager_stage.restype = i64
    held.aq_stager_count.argtypes = [voidp]
    held.aq_stager_count.restype = i64
    held.aq_stager_dropped.argtypes = [voidp]
    held.aq_stager_dropped.restype = i64


def get() -> ctypes.CDLL:
    """The loaded library, built at the first call. Raises RuntimeError
    when it cannot be built (the first failure is remembered)."""
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise RuntimeError(_error)
        try:
            so = _build()
            lib = ctypes.CDLL(so)
            lib.held = ctypes.PyDLL(so)
        except (RuntimeError, OSError, subprocess.TimeoutExpired) as e:
            _error = str(e)
            raise RuntimeError(_error) from e
        _bind(lib)
        _bind_held(lib.held)
        _lib = lib
        return lib


def available() -> bool:
    """Whether the library is built, or can be built now."""
    try:
        get()
    except RuntimeError:
        return False
    return True
