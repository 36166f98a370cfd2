"""Circuit breaker: closed -> open -> half-open state machine.

A copy of `akka_tpu/pattern/circuit_breaker.py` at commit 5d9b7cd (host
code, no jax; the port keeps its own copy of every module it needs).

Reference parity: akka-actor/src/main/scala/akka/pattern/CircuitBreaker.scala
(:136 state machine, :416 transitions) — maxFailures within callTimeout trips
open; after resetTimeout one probe call (half-open) decides close vs re-open;
exponential backoff on repeated open.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, List, Optional


class CircuitBreakerOpenException(Exception):
    def __init__(self, remaining: float):
        super().__init__(f"circuit breaker is open; retry after {remaining:.2f}s")
        self.remaining = remaining


class CircuitBreaker:
    def __init__(self, scheduler, max_failures: int, call_timeout: float,
                 reset_timeout: float, exponential_backoff_factor: float = 1.0,
                 max_reset_timeout: float = float("inf")):
        self.scheduler = scheduler
        self.max_failures = max_failures
        self.call_timeout = call_timeout
        self.reset_timeout = reset_timeout
        self.backoff_factor = max(exponential_backoff_factor, 1.0)
        self.max_reset_timeout = max_reset_timeout
        self._state = "closed"
        self._failures = 0
        self._opened_at = 0.0
        self._current_reset = reset_timeout
        # half-open admits exactly ONE probe (reference :416 attemptReset —
        # the transition swaps in a single-permit gate): the first caller
        # claims this flag under the lock; every other caller fails fast
        # with CircuitBreakerOpenException until the probe reports. A probe
        # that raises re-opens atomically in fail(), which also restarts
        # the reset timer (_trip_open re-stamps _opened_at).
        self._probe_in_flight = False
        self._lock = threading.RLock()
        self._on_open: List[Callable[[], None]] = []
        self._on_close: List[Callable[[], None]] = []
        self._on_half_open: List[Callable[[], None]] = []

    # -- listeners -----------------------------------------------------------
    def on_open(self, cb): self._on_open.append(cb); return self
    def on_close(self, cb): self._on_close.append(cb); return self
    def on_half_open(self, cb): self._on_half_open.append(cb); return self

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    @property
    def current_failure_count(self) -> int:
        return self._failures

    def _maybe_half_open(self) -> None:
        if self._state == "open" and time.monotonic() - self._opened_at >= self._current_reset:
            self._state = "half-open"
            for cb in self._on_half_open:
                cb()

    def _trip_open(self) -> None:
        self._state = "open"
        self._opened_at = time.monotonic()
        self._probe_in_flight = False
        for cb in self._on_open:
            cb()

    def _close(self) -> None:
        self._state = "closed"
        self._failures = 0
        self._current_reset = self.reset_timeout
        self._probe_in_flight = False
        for cb in self._on_close:
            cb()

    def _admit(self) -> None:
        """Gate one call attempt (caller holds the lock): open -> fail
        fast; half-open -> admit only the single probe, racing callers
        fail fast until it reports via succeed()/fail()."""
        self._maybe_half_open()
        if self._state == "open" or (self._state == "half-open"
                                     and self._probe_in_flight):
            remaining = self._current_reset - (time.monotonic() - self._opened_at)
            raise CircuitBreakerOpenException(max(remaining, 0.0))
        if self._state == "half-open":
            self._probe_in_flight = True

    # -- call protection -----------------------------------------------------
    def with_sync_circuit_breaker(self, body: Callable[[], Any]) -> Any:
        with self._lock:
            self._admit()
        start = time.monotonic()
        try:
            result = body()
        except Exception:
            self.fail()
            raise
        if time.monotonic() - start > self.call_timeout:
            self.fail()
        else:
            self.succeed()
        return result

    call = with_sync_circuit_breaker

    def with_circuit_breaker(self, body: Callable[[], Future]) -> Future:
        out: Future = Future()
        with self._lock:
            try:
                self._admit()
            except CircuitBreakerOpenException as e:
                out.set_exception(e)
                return out
        start = time.monotonic()
        try:
            fut = body()
        except Exception as e:  # noqa: BLE001
            self.fail()
            out.set_exception(e)
            return out

        def _done(f: Future):
            exc = f.exception()
            if exc is not None or time.monotonic() - start > self.call_timeout:
                self.fail()
            else:
                self.succeed()
            if exc is not None:
                out.set_exception(exc)
            else:
                out.set_result(f.result())

        fut.add_done_callback(_done)
        return out

    # -- manual outcome reporting (reference: succeed()/fail() on CB) --------
    def succeed(self) -> None:
        with self._lock:
            if self._state == "half-open":
                self._close()
            else:
                self._failures = 0

    def fail(self) -> None:
        with self._lock:
            if self._state == "half-open":
                # atomic re-open: backoff the reset and restart its timer
                # (_trip_open re-stamps _opened_at) in the same critical
                # section that releases the probe permit
                self._current_reset = min(self._current_reset * self.backoff_factor,
                                          self.max_reset_timeout)
                self._trip_open()
                return
            self._failures += 1
            if self._failures >= self.max_failures and self._state == "closed":
                self._trip_open()
