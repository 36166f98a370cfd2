"""The trace reduction (yardstick/trace.py) on events made by hand, and the
readers that reduce its events themselves."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench import harness
from portbench.yardstick import roofline, trace


def ev(name, start, end, device=DeviceType.CUDA, stream=7):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end),
                           device_resource_id=stream,
                           is_user_annotation=False)


def test_busy_idle_events_and_readers():
    cpu = DeviceType.CPU
    events = [
        ev(trace.WINDOW_SPAN, 100, 1100, cpu),
        ev("cudaGraphLaunch", 110, 120, cpu),
        ev("cudaGraphLaunch", 500, 510, cpu),
        ev("cudaStreamSynchronize", 600, 1000, cpu),
        ev("cudaGraphLaunch", 50, 60, cpu),            # before the slice
        ev("Memset (Device)", 150, 160),
        ev("Memset (Device)", 160, 170),
        ev("void ring_sweep<4, true, false, float>(int const*)", 170, 230),
        ev("void ring_sweep<4, true, true, float>(int const*)", 240, 260),
        ev("elementwise", 200, 300),                  # overlaps the sweep
        ev("memset32", 400, 405),                     # graph memset nodes
        ev("memset32", 405, 410),
        ev("void ring_sweep<4, true, false, float>(int const*)", 410, 420),
        ev("late", 1050, 1200),                       # clipped at 1100
    ]
    s = trace.summarize(events)
    assert s.window_s == pytest.approx(1000e-6)
    assert s.busy_s == pytest.approx((300 - 150 + 20 + 1100 - 1050) * 1e-6)
    # the readers' own reductions of the slice's events
    launches = harness.load_module("metrics", "launches_per_step.ring")
    ctx = harness.MetricContext(s, {"trace_steps": 2}, "H100 80GB HBM3")
    assert launches.read(ctx) == 1.0
    assert trace.count_host(s, ["cudaStreamSynchronize"]) == 1
    calls, secs = trace.device_calls(s, roofline.is_k1_sweep,
                                     roofline.is_memset)
    assert calls == 2
    assert secs == pytest.approx((10 + 10 + 60 + 5 + 5 + 10) * 1e-6)
    # device events are clipped to the slice; host ones start in it
    assert max(e.end for e in s.device_events) == 1100
    assert all(100 <= e.start <= 1100 for e in s.host_events)
    # the longest gap, 420..1050, is labelled by the sync over its middle
    label, gap = s.idle_gaps[0]
    assert gap == pytest.approx(630e-6)
    assert "cudaStreamSynchronize" in label
    assert s.device_ops[0][0] == "late" or s.device_ops[0][1] >= 50e-6


def test_no_span_is_an_error():
    with pytest.raises(RuntimeError):
        trace.summarize([ev("x", 0, 1)])
