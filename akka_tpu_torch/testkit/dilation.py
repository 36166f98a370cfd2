"""Adaptive test-time dilation.

A copy of `akka_tpu/testkit/dilation.py` at commit 5834bbc (host
code, no jax; the port keeps its own copy of every module it needs).

Reference parity: akka-testkit TestKit.scala:244-319 — every timeout is
`dilated` by `akka.test.timefactor` so timing-coupled assertions survive
slow machines. TestProbe already honors the per-system config factor;
this module adds the PROCESS-level factor used by the multi-process and
lease suites, whose deadlines (lease TTLs, heartbeat pauses, SBR
stable-after) race the wall clock of the whole machine:

- `AKKA_TPU_TEST_TIMEFACTOR` env var: explicit override (CI knob),
  inherited by spawned worker nodes.
- Otherwise AUTO: the 1-minute load average beyond half the cores widens
  the factor proportionally (capped) — a quiet machine runs at 1.0, a
  machine also compiling XLA in 8 other processes gets its heartbeat
  pauses and TTLs stretched instead of flaking.
"""

from __future__ import annotations

import os
import time

_slip_cache = {"at": 0.0, "value": 1.0}


def _sleep_slip() -> float:
    """How late short sleeps wake up RIGHT NOW (scheduler pressure).

    The 1-minute load average lags a just-started load burst by tens of
    seconds — exactly the window in which a timing test sets up its
    deadlines. A 20ms sleep's overshoot responds within one call. Cached
    for 2s so hot await-loops don't pay 20ms per check."""
    now = time.monotonic()
    if now - _slip_cache["at"] < 2.0:
        return _slip_cache["value"]
    t0 = time.perf_counter()
    time.sleep(0.02)
    slip = (time.perf_counter() - t0) / 0.02
    _slip_cache["at"] = now
    _slip_cache["value"] = slip
    return slip


def time_factor() -> float:
    env = os.environ.get("AKKA_TPU_TEST_TIMEFACTOR")
    if env:
        try:
            return max(float(env), 0.1)
        except ValueError:
            pass
    try:
        load = os.getloadavg()[0]
        ncpu = os.cpu_count() or 1
    except (OSError, AttributeError):
        return 1.0
    excess = max(0.0, load - 0.5 * ncpu) / ncpu
    from_load = 1.0 + 3.0 * excess
    from_slip = _sleep_slip()
    return min(max(1.0, from_load, from_slip), 8.0)


def dilated(seconds: float) -> float:
    """Widen a deadline by the current machine-load factor."""
    return seconds * time_factor()


def dilated_s(seconds: float) -> str:
    """Config-string form ("1.5s") for HOCON-style duration keys."""
    return f"{dilated(seconds):.2f}s"
