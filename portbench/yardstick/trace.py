"""One traced slice of a run, reduced to the numbers the readers take.

`DeviceTrace` runs `torch.profiler` over the host and the card around a
slice of a run's window: `begin()` drains the card and starts recording,
`end()` drains the card and stops it, and `summary()` reduces the events
once the window has closed (the reduction takes tens of seconds of
Python, which must not stall the window). 10 ms of idle host time sit on
each side of the slice (a trace without it now and then lost the card's
records of whole steps on an H100). The slice is the range of the
harness's own `portbench.traced` span, so its base is the traced time
itself, never an untraced one.

From the trace, for the result's `device` and `breakdown`:
- busy seconds: the union of the card's kernel, copy and memset intervals,
  clipped to the slice (what ran, not the sum of what overlapped);
- idle gaps: the slice's complement of that union, the longest labelled
  by the innermost host op (any thread) that covers the gap's middle;
- device ops: time by name.
And, for the per-layer readers, which each make their own reduction: the
slice's device events and host events as plain records (`Event`), each
clipped to the slice. `count_host` and `device_calls` are reductions that
readers share.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np

WINDOW_SPAN = "portbench.traced"
MARGIN_S = 0.010
TOP = 10


class Event(NamedTuple):
    """One traced operation, its times in µs on the trace's clock: a device
    event clipped to the slice, a host event that starts in it with its
    end clipped. `lane` is the device stream of a device event and the
    thread of a host event."""
    name: str
    start: float
    end: float
    lane: int


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)
    device_events: List[Event] = field(default_factory=list)
    host_events: List[Event] = field(default_factory=list)


def count_host(summary: TraceSummary, names: Iterable[str]) -> int:
    """Host operations that start in the slice, on any thread, whose name
    is one of `names`."""
    want = set(names)
    return sum(1 for e in summary.host_events if e.name in want)


def device_calls(summary: TraceSummary, is_main: Callable[[str], bool],
                 before: Callable[[str], bool] = lambda name: False,
                 after: Callable[[str], bool] = lambda name: False,
                 reach: int = 2) -> Tuple[int, float]:
    """Calls of one kernel in the slice and their device seconds: each
    event `is_main` accepts, with up to `reach` events right before it on
    its stream that `before` accepts and the one right after that `after`
    accepts (the parts of one C entry: memsets that zero its outputs, a
    kernel that rounds them)."""
    lanes: Dict[int, List[Event]] = {}
    for e in summary.device_events:
        lanes.setdefault(e.lane, []).append(e)
    calls, total = 0, 0.0
    for evs in lanes.values():
        evs.sort(key=lambda e: e.start)
        for i, e in enumerate(evs):
            if not is_main(e.name):
                continue
            calls += 1
            total += e.end - e.start
            j = i - 1
            while j >= 0 and i - j <= reach and before(evs[j].name):
                total += evs[j].end - evs[j].start
                j -= 1
            if i + 1 < len(evs) and after(evs[i + 1].name):
                total += evs[i + 1].end - evs[i + 1].start
    return calls, total / 1e6


class DeviceTrace:
    """`prepare()` before the window, `begin()` and `end()` around the
    traced slice on one thread, `summary()` after the window.

    `prepare()` loads the card's tracing library and starts its activity
    buffers (which takes tenths of a second, and would stall the window
    if `begin()` paid it); from then on the card's activity is collected
    and dropped until `begin()`. So the whole of a traced run's window
    runs under the same tracing."""

    def __init__(self):
        self._prof = None
        self._span = None
        self._summary: Optional[TraceSummary] = None
        self.t_begin = self.t_end = None   # host clock of the slice

    @property
    def active(self) -> bool:
        return self._span is not None

    def prepare(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.prepare_trace()

    def begin(self) -> None:
        import torch
        from torch.profiler import record_function
        torch.cuda.synchronize()
        self._prof.start_trace()
        time.sleep(MARGIN_S)
        self._span = record_function(WINDOW_SPAN)
        self._span.__enter__()
        self.t_begin = time.perf_counter()

    def end(self) -> None:
        import torch
        try:
            torch.cuda.synchronize()
            self.t_end = time.perf_counter()
        finally:
            self._span.__exit__(None, None, None)
            self._span = None
            time.sleep(MARGIN_S)
            self._prof.stop_trace()

    def summary(self) -> TraceSummary:
        if self._summary is None:
            self._summary = summarize(self._prof.events())
            self._prof = None
        return self._summary


def _union(iv: np.ndarray) -> np.ndarray:
    """Merge [start, end] rows (sorted by start) into disjoint intervals."""
    if len(iv) == 0:
        return iv.reshape(0, 2)
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return np.asarray(out, np.float64)


def summarize(events) -> TraceSummary:
    """Reduce profiler events (`prof.events()`) to a TraceSummary."""
    from torch.autograd import DeviceType
    window = [e for e in events if e.name == WINDOW_SPAN
              and e.device_type == DeviceType.CPU]
    if not window:
        raise RuntimeError(f"no {WINDOW_SPAN} span in the trace")
    w0 = float(window[0].time_range.start)
    w1 = float(window[0].time_range.end)
    dev, cpu = [], []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or \
                    e.name.startswith(("akka.", "portbench.")):
                continue
            dev.append(e)
        elif e.name != WINDOW_SPAN:
            cpu.append(e)
    iv = np.asarray([(max(float(e.time_range.start), w0),
                      min(float(e.time_range.end), w1)) for e in dev],
                    np.float64).reshape(-1, 2)
    keep = iv[:, 1] > iv[:, 0]
    iv = iv[keep]
    kept = [e for e, k in zip(dev, keep) if k]
    busy = _union(iv[np.argsort(iv[:, 0], kind="stable")])
    busy_us = float((busy[:, 1] - busy[:, 0]).sum())

    by_name: Dict[str, float] = {}
    for e, (s, t) in zip(kept, iv):
        by_name[e.name[:160]] = by_name.get(e.name[:160], 0.0) + (t - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]

    # idle gaps inside the slice, labelled by the innermost host op over
    # each gap's middle
    edges = np.concatenate([[w0], busy.reshape(-1), [w1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    longest = gaps[np.argsort(gaps[:, 0] - gaps[:, 1], kind="stable")][:TOP]
    c_start = np.asarray([float(e.time_range.start) for e in cpu])
    c_end = np.asarray([float(e.time_range.end) for e in cpu])
    labelled = []
    for s, t in longest:
        mid = (s + t) / 2
        cover = np.nonzero((c_start <= mid) & (c_end >= mid))[0]
        if len(cover):
            inner = cover[np.argmin(c_end[cover] - c_start[cover])]
            label = f"host: {cpu[inner].name[:120]}"
        else:
            label = "host: no traced op (Python)"
        labelled.append((label, (t - s) / 1e6))

    device_events = [Event(e.name, float(a), float(b),
                           int(getattr(e, "device_resource_id", 0)))
                     for e, (a, b) in zip(kept, iv)]
    host_events = [Event(e.name, float(e.time_range.start),
                         min(float(e.time_range.end), w1),
                         int(getattr(e, "thread", 0))) for e in cpu
                   if w0 <= float(e.time_range.start) <= w1]
    return TraceSummary(
        window_s=(w1 - w0) / 1e6, busy_s=busy_us / 1e6,
        device_ops=[(n, us / 1e6) for n, us in ops], idle_gaps=labelled,
        device_events=device_events, host_events=host_events)
