"""Phi-accrual + deadline failure detectors and the per-resource registry.

A copy of `akka_tpu/remote/failure_detector.py` at commit 5d9b7cd (host
code, no jax; the port keeps its own copy of every module it needs).

Reference parity: akka-remote/src/main/scala/akka/remote/
PhiAccrualFailureDetector.scala:57 (normal-distribution estimate of heartbeat
arrival intervals; phi = -log10(P(arrival later than now))),
DeadlineFailureDetector.scala, DefaultFailureDetectorRegistry.scala.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Callable, Dict, Generic, Hashable, Optional, TypeVar

T = TypeVar("T", bound=Hashable)


class FailureDetector:
    def heartbeat(self) -> None:
        raise NotImplementedError

    @property
    def is_available(self) -> bool:
        raise NotImplementedError

    @property
    def is_monitoring(self) -> bool:
        raise NotImplementedError


class HeartbeatHistory:
    """Bounded sample window with streaming mean/variance
    (reference: PhiAccrualFailureDetector.HeartbeatHistory)."""

    __slots__ = ("max_sample_size", "_intervals", "_sum", "_sq_sum")

    def __init__(self, max_sample_size: int):
        self.max_sample_size = max_sample_size
        self._intervals: deque = deque()
        self._sum = 0.0
        self._sq_sum = 0.0

    def add(self, interval: float) -> None:
        if len(self._intervals) >= self.max_sample_size:
            old = self._intervals.popleft()
            self._sum -= old
            self._sq_sum -= old * old
        self._intervals.append(interval)
        self._sum += interval
        self._sq_sum += interval * interval

    def __len__(self) -> int:
        return len(self._intervals)

    @property
    def mean(self) -> float:
        n = len(self._intervals)
        return self._sum / n if n else 0.0

    @property
    def variance(self) -> float:
        n = len(self._intervals)
        if not n:
            return 0.0
        m = self.mean
        return max(self._sq_sum / n - m * m, 0.0)

    @property
    def std_deviation(self) -> float:
        return math.sqrt(self.variance)


class PhiAccrualFailureDetector(FailureDetector):
    def __init__(self, threshold: float = 8.0, max_sample_size: int = 1000,
                 min_std_deviation: float = 0.1,
                 acceptable_heartbeat_pause: float = 3.0,
                 first_heartbeat_estimate: float = 1.0,
                 clock: Callable[[], float] = time.monotonic):
        self.threshold = threshold
        self.min_std_deviation = min_std_deviation
        self.acceptable_heartbeat_pause = acceptable_heartbeat_pause
        self.clock = clock
        self._history = HeartbeatHistory(max_sample_size)
        # bootstrap sample (reference: firstHeartbeatEstimate with std-dev/4)
        mean = first_heartbeat_estimate
        std = mean / 4.0
        self._history.add(mean - std)
        self._history.add(mean + std)
        self._last_timestamp: Optional[float] = None
        self._lock = threading.Lock()

    def heartbeat(self) -> None:
        with self._lock:
            now = self.clock()
            if self._last_timestamp is not None:
                interval = now - self._last_timestamp
                if self.is_available_at(now):
                    # winsorize the admitted sample: a scheduling stall that
                    # slips under a generous acceptable-pause would otherwise
                    # enter the history at full size, inflate the std
                    # deviation, admit even LARGER stalls, and run away
                    # until phi can never cross the threshold (observed on a
                    # loaded single-core host: 180s of real silence went
                    # undetected). Capping at mean+pause keeps the estimator
                    # adaptive without the unbounded ratchet.
                    cap = self._history.mean + self.acceptable_heartbeat_pause
                    self._history.add(min(interval, cap))
            self._last_timestamp = now

    def phi(self, at: Optional[float] = None) -> float:
        with self._lock:
            return self._phi(at if at is not None else self.clock())

    def _phi(self, now: float) -> float:
        if self._last_timestamp is None:
            return 0.0
        elapsed = now - self._last_timestamp
        mean = self._history.mean + self.acceptable_heartbeat_pause
        std = max(self._history.std_deviation, self.min_std_deviation)
        y = (elapsed - mean) / std
        # logistic approximation of the normal CDF (reference :230-238).
        # The reference computes this in IEEE doubles, where a hugely
        # NEGATIVE y (a fresh heartbeat against a wide acceptable-pause
        # window, e.g. load-dilated test configs) overflows e to +inf and
        # phi comes out 0; python's math.exp RAISES instead, which used to
        # crash the cluster daemon's reap tick on every loaded run — clamp
        # explicitly (exp(709) is the float64 edge)
        exp_arg = -y * (1.5976 + 0.070566 * y * y)
        if exp_arg > 709.0:
            return 0.0  # arrival later is virtually certain: phi ~ 0
        e = math.exp(exp_arg)
        if elapsed > mean:
            return -math.log10(e / (1.0 + e)) if e != 0 else 35.0
        return -math.log10(1.0 - 1.0 / (1.0 + e))

    @property
    def is_available(self) -> bool:
        return self.is_available_at(self.clock())

    def is_available_at(self, at: float) -> bool:
        return self._phi(at) < self.threshold

    @property
    def is_monitoring(self) -> bool:
        return self._last_timestamp is not None


class DeadlineFailureDetector(FailureDetector):
    """(reference: DeadlineFailureDetector.scala)"""

    def __init__(self, acceptable_heartbeat_pause: float = 4.0,
                 heartbeat_interval: float = 1.0,
                 clock: Callable[[], float] = time.monotonic):
        self.deadline = acceptable_heartbeat_pause + heartbeat_interval
        self.clock = clock
        self._last = None

    def heartbeat(self) -> None:
        self._last = self.clock()

    @property
    def is_available(self) -> bool:
        return self._last is None or (self.clock() - self._last) <= self.deadline

    @property
    def is_monitoring(self) -> bool:
        return self._last is not None


class FailureDetectorRegistry(Generic[T]):
    """Per-resource (address) detector instances
    (reference: DefaultFailureDetectorRegistry.scala)."""

    def __init__(self, factory: Callable[[], FailureDetector]):
        self.factory = factory
        self._detectors: Dict[T, FailureDetector] = {}
        self._lock = threading.Lock()

    def heartbeat(self, resource: T) -> None:
        with self._lock:
            fd = self._detectors.get(resource)
            if fd is None:
                fd = self.factory()
                self._detectors[resource] = fd
        fd.heartbeat()

    def is_available(self, resource: T) -> bool:
        fd = self._detectors.get(resource)
        return fd.is_available if fd is not None else True

    def is_monitoring(self, resource: T) -> bool:
        fd = self._detectors.get(resource)
        return fd.is_monitoring if fd is not None else False

    def phi(self, resource: T) -> float:
        """Current suspicion level of a monitored resource: the detector's
        phi for accrual detectors, 0.0 for boolean detectors or resources
        never heartbeated. The sentinel records this in device_suspected
        events so a post-mortem shows HOW suspicious the shard looked."""
        fd = self._detectors.get(resource)
        if fd is None:
            return 0.0
        return float(fd.phi()) if hasattr(fd, "phi") else 0.0

    def remove(self, resource: T) -> None:
        with self._lock:
            self._detectors.pop(resource, None)

    def reset(self) -> None:
        with self._lock:
            self._detectors.clear()
