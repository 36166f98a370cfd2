"""The least time a kernel could take on the card, from its calls' shapes.

A copy of the byte count the port's kernel bench uses for its bound
(`bound_bytes` in akka_tpu_torch/tools/bench_mailbox.py): K1, the
reduce-mode ring-mailbox entry, reads each input byte once (dst and valid
of all m inbox rows, the payload of the `live` rows it accepts) and writes
each output byte once (counts and sums of all n recipients). Kept here so
that a later kernel cannot change its own yardstick. K1 does no arithmetic
worth a bound of its own (one add a payload element), so bytes bound it.
"""

from __future__ import annotations

import re
from typing import Optional

from portbench.yardstick.trace import device_calls

_TEMPLATE = re.compile(r"ring_sweep<([^>]*)>")

# device memory rate by card name (NVIDIA data sheets, bytes/s)
HBM_BYTES_PER_S = {
    "H100 80GB HBM3": 3.35e12,    # SXM5
    "H100 PCIe": 2.0e12,
    "H100 NVL": 3.9e12,
}


def peak_bytes_per_s(card: str) -> float:
    for key, rate in HBM_BYTES_PER_S.items():
        if key in card:
            return rate
    raise KeyError(f"no memory rate for card {card!r}")


def k1_bytes(m: int, n: int, p: int, live: int, elem: int = 4) -> int:
    """Bytes one K1 call must move: dst (4) and valid (1) of m rows, the
    payload of `live` accepted rows, counts (4) and sums of n rows."""
    return m * (4 + 1) + live * elem * p + n * (4 + elem * p)


def k1_bound_s(calls: int, m: int, n: int, p: int, live_total: int,
               card: str, elem: int = 4) -> float:
    """The least time of `calls` K1 calls of one shape whose accepted rows
    add up to `live_total`."""
    nbytes = calls * k1_bytes(m, n, p, 0, elem) + live_total * elem * p
    return nbytes / peak_bytes_per_s(card)


def is_k1_sweep(name: str) -> bool:
    """A K1 sweep: `ring_sweep<ROWS, VEC, CLAIM=false, T>` or the int32
    `ring_sweep_elems`; K2's sweeps claim slots (CLAIM=true, or the
    `_claim_elems` kernel)."""
    if "ring_sweep_elems" in name:
        return True
    m = _TEMPLATE.search(name)
    if m is None:
        return False
    args = [a.strip() for a in m.group(1).split(",")]
    return len(args) >= 3 and args[2] == "false"


def is_memset(name: str) -> bool:
    # "Memset (Device)" from a stream; "memset32" and the like from a
    # memset node of a CUDA graph
    return name.lower().startswith("memset")


def k1_share(trace, counters, card: str) -> Optional[float]:
    """K1's share of its roofline in the traced slice, in %: the least
    time of the K1 calls the trace holds over their device time. A call
    is the C entry's whole device time: its sweep, the memsets right
    before it that zero its outputs and, for bf16, the rounding kernel
    right after. The calls' delivered rows are `delivered_per_step` each
    where the system delivers as many every step (one K1 call a step),
    else `delivered_in_slice` in all. None when the slice holds no K1
    record or the system reports no delivery."""
    if trace is None:
        return None
    calls, seconds = device_calls(trace, is_k1_sweep, is_memset,
                                  lambda name: "round_sums" in name)
    if calls == 0 or seconds <= 0:
        return None
    if "delivered_per_step" in counters:
        live = calls * int(counters["delivered_per_step"])
    elif "delivered_in_slice" in counters:
        live = int(counters["delivered_in_slice"])
    else:
        return None
    bound = k1_bound_s(calls, int(counters["inbox_rows"]),
                       int(counters["recipients"]),
                       int(counters["payload_width"]), live, card,
                       int(counters["payload_bytes"]))
    return 100.0 * bound / seconds
