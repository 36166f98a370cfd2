"""Gloo ranks as threads of the test's process, for the port's ranked
meshes (tests/test_torch_ranks.py, tests/test_torch_region_ranks.py).

`run_ranks(world, fn, test_id)` builds one `dist.HashStore` (10 s
timeout) and, in each of `world` threads, its own
`dist.ProcessGroupGloo(PrefixStore(test_id, store), rank, world,
timedelta(seconds=10))`, then calls `fn(rank, group)` there. It returns
each rank's result in rank order and re-raises the first rank's error.
It joins every thread (waits of at most 10 s, then a last one of 5 s)
and asserts that none it started is still alive. Nothing here touches the
global default group: `dist.init_process_group` is never called.

Gloo's TCP transport opens loopback connections on ephemeral ports; that
is the only socket a test of ranks opens. Gloo rank threads start only
through this module (ROADMAP's thread rule).
"""

from __future__ import annotations

import datetime
import threading
from typing import Any, Callable, List

import torch.distributed as dist

TIMEOUT_S = 10.0   # the store's and every group's timeout
JOIN_S = 5.0       # each thread's last join
WAITS = 3          # joins of TIMEOUT_S each before a thread is given up


def run_ranks(world: int, fn: Callable[[int, Any], Any],
              test_id: str) -> List[Any]:
    """fn(rank, group) on `world` gloo thread ranks; each rank's result,
    in rank order. Each rank builds what it needs inside its own thread
    and shares no tensor with another."""
    store = dist.HashStore()
    store.set_timeout(datetime.timedelta(seconds=TIMEOUT_S))
    results: List[Any] = [None] * world
    errors: List[BaseException] = [None] * world

    def body(rank: int) -> None:
        try:
            group = dist.ProcessGroupGloo(
                dist.PrefixStore(test_id, store), rank, world,
                datetime.timedelta(seconds=TIMEOUT_S))
            results[rank] = fn(rank, group)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors[rank] = e

    threads = [threading.Thread(target=body, args=(r,), daemon=True,
                                name=f"gloo-rank-{test_id}-{r}")
               for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:  # each wait bounded; a hung collective times out
        for _ in range(WAITS):
            t.join(TIMEOUT_S)
            if not t.is_alive():
                break
    for t in threads:
        t.join(JOIN_S)
    alive = [t.name for t in threads if t.is_alive()]
    assert not alive, f"gloo rank threads still alive: {alive}"
    for e in errors:
        if e is not None:
            raise e
    return results
