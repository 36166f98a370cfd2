"""Python wrappers over the native substrate: MPSC mailbox queue, wheel
timer, and the message stager.

A copy of `akka_tpu/native/queues.py` (commit 001ef4f) over the port's
own library (native/lib.py): a constructor raises RuntimeError when the
library cannot be built, as `lib.get()` does. The stager also frees its
buffers when it is collected. The short calls on a tell's path (enqueue,
dequeue, stage, the counts) keep the interpreter lock (`lib.held`, see
native/lib.py), and a stage passes its buffers by address. Parity notes
are in src/akka_native.cpp. The token registry trick:
the C queue carries uint64 tokens; the Python side keeps token -> object in
a dict (dict mutation is atomic under the GIL), so arbitrary messages ride
the lock-free queue without the C side touching refcounts.
"""

from __future__ import annotations

import ctypes
import itertools
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from . import lib as _libmod


class NativeMpscQueue:
    """Lock-free MPSC queue of Python objects (AbstractNodeQueue parity)."""

    def __init__(self):
        self._lib = _libmod.get()
        self._held = self._lib.held
        self._h = self._lib.aq_mpsc_create()
        self._closed = False            # consumer side shut (full close)
        self._closed_producers = False  # producer side shut (phase 1)
        self._tokens = itertools.count(1)
        self._registry: Dict[int, Any] = {}
        self._out = (ctypes.c_uint64 * 1)()

    def enqueue(self, obj: Any) -> bool:
        """Returns False when the queue is closed (actor stopped) and the
        message was NOT accepted — the caller routes it to dead letters
        (becomeClosed parity: late sends are redirected, never lost)."""
        if self._closed_producers:
            return False
        tok = next(self._tokens)
        self._registry[tok] = obj
        # safe vs concurrent close(): close only sets the closed flag (no
        # free, no drain — a drain would be a second consumer); memory is
        # freed in __del__, which cannot run while this frame holds a ref
        self._held.aq_mpsc_enqueue(self._h, tok)
        if self._closed_producers:
            # close raced us. If our token is still registered, pull it back
            # and report rejection (caller dead-letters it). If it is gone,
            # either the consumer delivered it or the close-time registry
            # sweep (drain_registry) dead-lettered it — accepted either way.
            return self._registry.pop(tok, None) is None
        return True

    def dequeue(self) -> Optional[Any]:
        if self._closed:
            return None
        if self._held.aq_mpsc_dequeue(self._h, self._out):
            obj = self._registry.pop(int(self._out[0]), None)
            if obj is not None:
                return obj
        return None

    def __len__(self) -> int:
        if self._closed:
            return 0
        return int(self._held.aq_mpsc_count(self._h))

    def close_producers(self) -> None:
        """Phase 1 of shutdown: reject new enqueues; the consumer can still
        drain. Nothing is freed (producers may be mid-enqueue — ADVICE r1)."""
        if not self._closed_producers:
            self._closed_producers = True
            self._lib.aq_mpsc_close(self._h)

    def drain_registry(self) -> list:
        """Swap out the token registry and return the orphaned messages —
        tokens enqueued by racing producers that the consumer never drained.
        Call after close_producers + a full dequeue drain; the caller routes
        these to dead letters (exactly-once: a producer whose token survives
        here sees pop miss and reports 'accepted')."""
        old, self._registry = self._registry, {}
        return list(old.values())

    def close(self) -> None:
        """Full close: producers rejected, consumer reads nothing further.
        No free, no drain, and no registry clear here (clearing would race a
        producer's post-enqueue pop-back check into reporting 'accepted' for
        a message nobody swept); in-flight racers pop their own tokens, and
        whatever remains is reclaimed with the object in __del__."""
        self.close_producers()
        self._closed = True

    def __del__(self):  # true reclamation: no refs => no in-flight producers
        try:
            if self._h:
                self._lib.aq_mpsc_destroy(self._h)
                self._h = None
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


class NativeWheelTimer:
    """Hashed-wheel timer driven by a native tick thread; callbacks run on a
    single Python poller thread (LightArrayRevolverScheduler parity)."""

    def __init__(self, tick_duration: float = 0.001, wheel_size: int = 512):
        self._lib = _libmod.get()
        self._h = self._lib.aq_timer_create(int(tick_duration * 1e9),
                                            wheel_size)
        self._ids = itertools.count(1)
        self._callbacks: Dict[int, Tuple[Callable[[], None], bool]] = {}
        self._lock = threading.Lock()
        self._stopped = threading.Event()
        self._poller = threading.Thread(target=self._run,
                                        name="akka-tpu-torch-native-timer",
                                        daemon=True)
        self._poller.start()

    def schedule_once(self, delay: float, fn: Callable[[], None]) -> int:
        tid = next(self._ids)
        with self._lock:
            self._callbacks[tid] = (fn, False)
        self._lib.aq_timer_schedule(self._h, tid, int(max(delay, 0) * 1e9), 0)
        return tid

    def schedule_periodically(self, initial: float, interval: float,
                              fn: Callable[[], None]) -> int:
        tid = next(self._ids)
        with self._lock:
            self._callbacks[tid] = (fn, True)
        self._lib.aq_timer_schedule(self._h, tid, int(max(initial, 0) * 1e9),
                                    int(max(interval, 1e-4) * 1e9))
        return tid

    def cancel(self, tid: int) -> None:
        with self._lock:
            self._callbacks.pop(tid, None)
        self._lib.aq_timer_cancel(self._h, tid)

    def _run(self) -> None:
        buf = (ctypes.c_uint64 * 256)()
        while not self._stopped.is_set():
            n = self._lib.aq_timer_poll(self._h, buf, 256, 200)
            for i in range(n):
                with self._lock:
                    entry = self._callbacks.get(int(buf[i]))
                    if entry is not None and not entry[1]:
                        del self._callbacks[int(buf[i])]
                if entry is not None:
                    try:
                        entry[0]()
                    except Exception:  # noqa: BLE001 — timer cbs must not die
                        pass

    def shutdown(self) -> None:
        self._stopped.set()
        self._poller.join(timeout=2.0)
        if self._poller.is_alive():
            # a callback is blocking the poller: leak the native handle
            # instead of freeing memory it will touch (no use-after-free)
            return
        self._lib.aq_timer_destroy(self._h)


class NativeStager:
    """Preallocated staging buffer for batched-runtime tells: producers on
    any thread memcpy fixed-width rows in, the step loop drains one
    contiguous block (EnvelopeBufferPool parity)."""

    def __init__(self, capacity: int, payload_width: int, dtype=np.float32):
        self._lib = _libmod.get()
        self._held = self._lib.held
        self.capacity = capacity
        self.payload_width = payload_width
        self.dtype = np.dtype(dtype)
        self.row_bytes = payload_width * self.dtype.itemsize
        self._h = self._lib.aq_stager_create(capacity, self.row_bytes)
        # reusable drain buffers (zero allocation per drain)
        self._dst_out = np.empty(capacity, np.int32)
        self._payload_out = np.empty((capacity, payload_width), self.dtype)

    def stage(self, dsts: np.ndarray, payloads: np.ndarray) -> int:
        dsts = np.ascontiguousarray(dsts, np.int32)
        payloads = np.ascontiguousarray(payloads, self.dtype)
        if payloads.shape != (dsts.shape[0], self.payload_width):
            raise ValueError(f"payloads of shape {payloads.shape} for "
                             f"{dsts.shape[0]} rows of {self.payload_width}")
        return int(self._held.aq_stager_stage(
            self._h, dsts.shape[0], dsts.ctypes.data, payloads.ctypes.data))

    def __len__(self) -> int:
        return int(self._held.aq_stager_count(self._h))

    @property
    def dropped(self) -> int:
        return int(self._held.aq_stager_dropped(self._h))

    def drain(self) -> Tuple[np.ndarray, np.ndarray]:
        n = int(self._lib.aq_stager_drain(
            self._h,
            self._dst_out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self._payload_out.ctypes.data_as(
                ctypes.POINTER(ctypes.c_uint8))))
        return self._dst_out[:n], self._payload_out[:n]

    def close(self) -> None:
        """Free the buffers; no producer or drain may use the stager
        after."""
        if self._h:
            self._lib.aq_stager_destroy(self._h)
            self._h = None

    def __del__(self):  # no refs => no producer can hold the handle
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
