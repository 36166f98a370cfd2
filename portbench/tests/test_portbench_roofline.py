"""K1's byte count against the bounds PERF.md's kernel table lists (from
the port's kernel bench), and the share a reader reports."""

import pytest

from portbench.yardstick import roofline
from portbench.yardstick.trace import Event, TraceSummary

CARD = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("m, n, live, bound_ms", [
    (2 ** 20 + 8, 2 ** 20, 2 ** 20, 0.01283),      # ring / fan_in
    (1057024, 1056768, 0, 0.00789),               # gateway region
    (8388672, 2 ** 20, 2 ** 20, 0.02379),          # sharded_d8
])
def test_k1_bound_matches_the_kernel_table(m, n, live, bound_ms):
    got = roofline.k1_bound_s(1, m, n, 4, live, CARD) * 1e3
    assert got == pytest.approx(bound_ms, abs=5e-6)


def k1_trace(calls, us):
    """A slice of `calls` K1 entries, each two memsets and a sweep that
    take `us` µs together, and some other kernel between them."""
    events, t = [], 0.0
    for _ in range(calls):
        events += [Event("Memset (Device)", t, t + 1, 7),
                   Event("memset32", t + 1, t + 2, 7),
                   Event("void ring_sweep<4, true, false, float>(int)",
                         t + 2, t + us, 7),
                   Event("elementwise", t + us, t + us + 5, 7)]
        t += us + 10
    return TraceSummary(window_s=1.0, busy_s=0.9, device_events=events)


def test_share_uses_the_traced_calls():
    trace = k1_trace(100, 40.0)
    counters = {"inbox_rows": 2 ** 20 + 8, "recipients": 2 ** 20,
                "payload_width": 4, "payload_bytes": 4, "mailbox_slots": 0,
                "delivered_per_step": 2 ** 20}
    share = roofline.k1_share(trace, counters, CARD)
    assert share == pytest.approx(100 * 12.833e-6 / 40e-6, rel=1e-3)
    in_slice = dict(counters, delivered_in_slice=100 * 2 ** 20)
    del in_slice["delivered_per_step"]
    assert roofline.k1_share(trace, in_slice, CARD) == pytest.approx(share)


def test_k1_kernel_names():
    assert roofline.is_k1_sweep("void ring_sweep<4, true, false, float>(.)")
    assert roofline.is_k1_sweep("void ring_sweep_elems<8>(int const*)")
    assert not roofline.is_k1_sweep("void ring_sweep<4, true, true, float>()")
    assert not roofline.is_k1_sweep("void ring_sweep_claim_elems<8>(int*)")
    assert not roofline.is_k1_sweep("void ring_fill<4, float>(int const*)")


def test_no_record_no_share():
    empty = TraceSummary(window_s=1.0, busy_s=0.5)
    assert roofline.k1_share(empty, {}, CARD) is None
    assert roofline.k1_share(None, {}, CARD) is None
    # K1 records but no delivery reported: nothing to read
    assert roofline.k1_share(k1_trace(3, 40.0), {}, CARD) is None
    with pytest.raises(KeyError):
        roofline.peak_bytes_per_s("cpu")
