"""Where a BatchedSystem's host tells wait for the next flush: the native
stager or a Python list, behind one interface.

Both take batches of (dst int32 [k], type int32 [k], payload [k, P]) and
hand back at most `capacity` rows at a drain, in staging order. Each keeps
the drop rule of its path in the reference (`akka_tpu/batched/core.py`,
commit 001ef4f):

- NativeStaging: a batch that does not fit whole is dropped whole at the
  stage (the stager's all-or-nothing reserve); the count is the stager's.
- ListStaging: every batch is kept; the drain takes the first `capacity`
  rows and drops the rest.

Either reports what it drops through `on_drop(n)`. A stage returns the
rows it took.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional, Tuple

import numpy as np

Rows = Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]


class ListStaging:
    """Host tells in a Python list, guarded by its own lock."""

    native = False

    def __init__(self, capacity: int, payload_width: int, dtype,
                 on_drop: Callable[[int], None]):
        self.capacity = capacity
        self._empty = (np.zeros((0,), np.int32), np.zeros((0,), np.int32),
                       np.zeros((0, payload_width), dtype))
        self._on_drop = on_drop
        self._lock = threading.Lock()
        self._batches = []  # (dst, type, payload), copies of the tell's
        self._n = 0
        self._dropped = 0

    def stage(self, dst: np.ndarray, mtype: np.ndarray,
              payload: np.ndarray) -> int:
        batch = (np.array(dst, np.int32), np.array(mtype, np.int32),
                 np.array(payload))
        with self._lock:
            self._batches.append(batch)
            self._n += batch[0].shape[0]
        return batch[0].shape[0]

    def __len__(self) -> int:
        return self._n

    @property
    def dropped(self) -> int:
        return self._dropped

    def _take(self) -> Rows:
        with self._lock:
            batches, self._batches, self._n = self._batches, [], 0
        if not batches:
            return self._empty
        return tuple(np.concatenate(col) for col in zip(*batches))

    def drain(self) -> Rows:
        dst, mtype, payload = self._take()
        n_drop = dst.shape[0] - self.capacity
        if n_drop > 0:
            with self._lock:
                self._dropped += n_drop
            self._on_drop(n_drop)
            k = self.capacity
            dst, mtype, payload = dst[:k], mtype[:k], payload[:k]
        return dst, mtype, payload

    def rewrite(self, fn: Callable[..., Rows]) -> None:
        """Replace what is staged by fn(dst, type, payload), under the
        lock: no tell staged meanwhile is reordered or lost."""
        with self._lock:
            if not self._batches:
                return
            rows = tuple(np.concatenate(c) for c in zip(*self._batches))
            dst, mtype, payload = fn(*rows)
            self._batches = [(dst, mtype, payload)] if len(dst) else []
            self._n = len(dst)

    def clear(self) -> None:
        self._take()

    def close(self) -> None:
        pass


class NativeStaging:
    """Host tells in the native stager (native/queues.py NativeStager).
    In slots mode a row is [type | payload]: the leading column carries
    the type tag bitcast into the staging dtype, so the caller takes this
    path there only for a 4-byte dtype. Reduce mode stages bare payloads
    and a drain returns no type column (delivery ignores it)."""

    native = True

    def __init__(self, capacity: int, payload_width: int, dtype,
                 slots: bool, on_drop: Callable[[int], None]):
        from ..native.queues import NativeStager
        self.capacity = capacity
        self._slots = slots
        self._dtype = np.dtype(dtype)
        self._on_drop = on_drop
        self._stager = NativeStager(capacity, payload_width + int(slots),
                                    self._dtype)

    def stage(self, dst: np.ndarray, mtype: np.ndarray,
              payload: np.ndarray) -> int:
        if self._slots:
            rows = np.empty((dst.shape[0], payload.shape[1] + 1),
                            self._dtype)
            rows[:, 0] = np.asarray(mtype, np.int32).view(self._dtype)
            rows[:, 1:] = payload
        else:
            rows = payload
        staged = self._stager.stage(dst, rows)
        if staged < dst.shape[0]:
            self._on_drop(dst.shape[0] - staged)
        return staged

    def __len__(self) -> int:
        return len(self._stager)

    @property
    def dropped(self) -> int:
        return self._stager.dropped

    def drain(self) -> Rows:
        """Views of the stager's reusable drain buffers: valid until the
        next drain."""
        dst, rows = self._stager.drain()
        if self._slots:
            return dst, rows[:, 0].view(np.int32), rows[:, 1:]
        return dst, None, rows

    def rewrite(self, fn: Callable[..., Rows]) -> None:
        """Drain, apply fn(dst, type, payload) and re-stage (a producer
        staging meanwhile lands ahead of the re-staged, older tells; a
        short re-stage is a real drop and is reported)."""
        dst, mtype, payload = self.drain()
        if dst.shape[0] == 0:
            return
        if mtype is None:
            mtype = np.zeros(dst.shape, np.int32)
        dst, mtype, payload = fn(dst.copy(), mtype.copy(), payload.copy())
        if len(dst):
            self.stage(dst, mtype, payload)

    def clear(self) -> None:
        self._stager.drain()

    def close(self) -> None:
        self._stager.close()
