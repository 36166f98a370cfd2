"""Exponential backoff pacing.

Port of `backoff_delay` from `akka_tpu/pattern/backoff.py`. The reference
module also holds the host-actor `BackoffSupervisor`, which needs the
actor layer the port does not have; only the delay function is here (the
gateway client's retry pacing).
"""

from __future__ import annotations

import random

__all__ = ["backoff_delay"]


def backoff_delay(restart_count: int, min_backoff: float, max_backoff: float,
                  random_factor: float = 0.0) -> float:
    """Exponential backoff delay (BackoffSupervisor.scala calculateDelay):
    min_backoff * 2^restart_count capped at max_backoff, plus optional
    random jitter."""
    delay = min(min_backoff * (2 ** restart_count), max_backoff)
    if random_factor:
        delay *= 1.0 + random.random() * random_factor
    return delay
