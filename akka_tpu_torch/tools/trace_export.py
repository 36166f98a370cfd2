#!/usr/bin/env python3
"""Merge tracing spans + flight-recorder events into Perfetto JSON.

A copy of the repo's `tools/trace_export.py` at commit ee03956 (stdlib
only), which the port's tests and `chip_smoke.py` use: `to_perfetto`
merges the tracer's spans (event/tracing.py) with the flight recorder's
events (event/flight_recorder.py) on the monotonic clock, and
`validate_trace` checks the document.

Exporter (b) of the tracing layer: exporter (a) is the span JSONL
itself (keyed by trace id — `jq 'select(.trace==N)' spans.jsonl` is the
request-journey query); THIS tool folds those spans together with
flight-recorder events (JSONL file or an InMemoryFlightRecorder's list)
into one Chrome trace-event JSON that opens in Perfetto
(https://ui.perfetto.dev) or chrome://tracing — a whole gateway run on
one timeline: request roots, ask waves, step rounds, promise readbacks,
reshard pauses, checkpoints, evictions.

Timeline mechanics: trace-event `ts` is microseconds on ONE clock. Spans
carry monotonic t0/t1 natively; FR rows carry `ts_mono`. Rows from OLDER
recordings (wall `ts` only) are aligned by the median
wall-minus-monotonic offset observed across rows that carry both clocks
— no guessing, and a file of only-old rows degrades to the wall clock
for everything.

Track layout:

- pid 1 "gateway requests": one tid per trace id — each sampled
  request's tree (gw.request / gw.admit / gw.ask / ask.member) nests on
  its own row.
- pid 1 tid 0 "ask waves": wave-scoped spans (ask.wave, wave.*) — waves
  are serialized by the region's ask lock, so one row nests cleanly.
- pid 2 "device runtime": flight-recorder events, one tid per event
  type. Pause-like events (mesh_expanded/narrowed `pause_s`,
  device_checkpoint `elapsed_s`, failover_completed `mttr_s`) become
  DURATION events ending at their timestamp; the rest are instants.

Usage:
    python -m akka_tpu_torch.tools.trace_export --spans spans.jsonl \
        --flight flight.jsonl --out trace.json
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from typing import Any, Dict, List, Optional, Sequence

# FR event -> the field holding the event's duration in seconds; the
# event's timestamp marks the END of that window (all three are emitted
# after the measured phase completes)
_DURATION_FIELDS = {
    "mesh_expanded": "pause_s",
    "mesh_narrowed": "pause_s",
    "device_checkpoint": "elapsed_s",
    "failover_completed": "mttr_s",
}

_WAVE_NAMES = ("ask.wave", "wave.latch_reset", "wave.flush",
               "wave.step_round", "wave.readback", "wave.stage",
               "wave.inflight_wait", "wave.resolve", "wave.journal")

PID_GATEWAY = 1
PID_RUNTIME = 2
TID_WAVES = 0


def load_jsonl(path: str) -> List[Dict[str, Any]]:
    rows: List[Dict[str, Any]] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                continue  # torn tail line of a live file
    return rows


def split_rows(rows: Sequence[Dict[str, Any]]):
    """One mixed JSONL (or concatenated lists) -> (spans, fr_events)."""
    spans = [r for r in rows if r.get("kind") == "span"]
    events = [r for r in rows if "event" in r and r.get("kind") != "span"]
    return spans, events


def wall_mono_offset(spans: Sequence[Dict[str, Any]],
                     events: Sequence[Dict[str, Any]]) -> Optional[float]:
    """Median wall-minus-monotonic offset over every row carrying both
    clocks — the alignment key for old wall-only FR rows."""
    deltas = [s["ts"] - s["t0"] for s in spans
              if "ts" in s and "t0" in s]
    deltas += [e["ts"] - e["ts_mono"] for e in events
               if "ts" in e and "ts_mono" in e]
    return statistics.median(deltas) if deltas else None


def _wave_lanes(spans: Sequence[Dict[str, Any]]) -> Dict[int, int]:
    """wave_id -> track lane for wave-scoped spans. Serialized waves
    never overlap (the ask lock), so every wave lands on lane 0 — the
    historical single "ask waves" row. Continuous waves
    overlap in wall time; interval-greedy lane assignment keeps each
    overlapping wave on its own row so complete events still stack-nest
    per track."""
    iv: Dict[int, List[float]] = {}
    for s in spans:
        if s.get("name") not in _WAVE_NAMES:
            continue
        wid = s.get("wave_id")
        if not isinstance(wid, int):
            continue
        t0, t1 = float(s.get("t0", 0.0)), float(s.get("t1", 0.0))
        cur = iv.get(wid)
        if cur is None:
            iv[wid] = [t0, t1]
        else:
            cur[0] = min(cur[0], t0)
            cur[1] = max(cur[1], t1)
    lanes: Dict[int, int] = {}
    lane_end: List[float] = []
    for wid, (t0, t1) in sorted(iv.items(), key=lambda kv: kv[1][0]):
        for k, end in enumerate(lane_end):
            if t0 >= end - 1e-9:
                lanes[wid] = k
                lane_end[k] = t1
                break
        else:
            lanes[wid] = len(lane_end)
            lane_end.append(t1)
    return lanes


def _span_events(spans: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = []
    tids: Dict[int, int] = {}
    lanes = _wave_lanes(spans)
    for s in spans:
        trace = int(s.get("trace", 0))
        if s.get("name") in _WAVE_NAMES:
            # lane 0 is TID_WAVES; overlapping continuous waves spill to
            # negative tids so they can never collide with request rows
            lane = lanes.get(s.get("wave_id"), 0)
            tid = TID_WAVES if lane == 0 else -lane
        else:
            tid = tids.setdefault(trace, len(tids) + 1)
        args = {k: v for k, v in s.items()
                if k not in ("kind", "name", "t0", "t1", "ts")}
        out.append({
            "name": str(s.get("name", "span")),
            "ph": "X",
            "pid": PID_GATEWAY,
            "tid": tid,
            "ts": float(s["t0"]) * 1e6,
            "dur": max(0.0, (float(s["t1"]) - float(s["t0"])) * 1e6),
            "args": args,
        })
    return out


def _fr_events(events: Sequence[Dict[str, Any]],
               offset: Optional[float]) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = []
    tids: Dict[str, int] = {}
    for e in events:
        name = str(e.get("event", "event"))
        if "ts_mono" in e:
            t = float(e["ts_mono"])
        elif offset is not None:
            t = float(e.get("ts", 0.0)) - offset
        else:
            t = float(e.get("ts", 0.0))  # wall-only file: one clock anyway
        tid = tids.setdefault(name, len(tids) + 1)
        args = {k: v for k, v in e.items()
                if k not in ("event", "ts", "ts_mono")}
        dur_field = _DURATION_FIELDS.get(name)
        dur_s = float(e.get(dur_field, 0.0)) if dur_field else 0.0
        if dur_field and dur_s > 0.0:
            # the event stamps the END of its measured window: a
            # scale_to pause of pause_s seconds is the [ts-pause_s, ts]
            # duration block on the runtime track
            out.append({"name": name, "ph": "X", "pid": PID_RUNTIME,
                        "tid": tid, "ts": (t - dur_s) * 1e6,
                        "dur": dur_s * 1e6, "args": args})
        else:
            out.append({"name": name, "ph": "i", "s": "g",
                        "pid": PID_RUNTIME, "tid": tid, "ts": t * 1e6,
                        "args": args})
    return out


def _metadata(span_events, fr_events) -> List[Dict[str, Any]]:
    meta = [
        {"name": "process_name", "ph": "M", "pid": PID_GATEWAY, "tid": 0,
         "args": {"name": "gateway requests"}},
        {"name": "process_name", "ph": "M", "pid": PID_RUNTIME, "tid": 0,
         "args": {"name": "device runtime"}},
        {"name": "thread_name", "ph": "M", "pid": PID_GATEWAY,
         "tid": TID_WAVES, "args": {"name": "ask waves"}},
    ]
    named = set()
    for ev in span_events:
        tid = ev["tid"]
        if tid < 0 and tid not in named:  # overflow wave lanes
            named.add(tid)
            meta.append({"name": "thread_name", "ph": "M",
                         "pid": PID_GATEWAY, "tid": tid,
                         "args": {"name": f"ask waves +{-tid}"}})
            continue
        if tid != TID_WAVES and tid not in named:
            named.add(tid)
            trace = ev["args"].get("trace", "?")
            meta.append({"name": "thread_name", "ph": "M",
                         "pid": PID_GATEWAY, "tid": tid,
                         "args": {"name": f"trace {trace:#x}"
                                  if isinstance(trace, int)
                                  else f"trace {trace}"}})
    seen = set()
    for ev in fr_events:
        if ev["tid"] not in seen:
            seen.add(ev["tid"])
            meta.append({"name": "thread_name", "ph": "M",
                         "pid": PID_RUNTIME, "tid": ev["tid"],
                         "args": {"name": ev["name"]}})
    return meta


def to_perfetto(spans: Sequence[Dict[str, Any]],
                events: Sequence[Dict[str, Any]] = ()) -> Dict[str, Any]:
    """Spans + FR events -> one Chrome trace-event document. The ts base
    is arbitrary (monotonic seconds * 1e6, shifted so the earliest event
    sits at 0 — Perfetto displays relative time anyway)."""
    offset = wall_mono_offset(spans, events)
    span_evs = _span_events(spans)
    fr_evs = _fr_events(events, offset)
    meta = _metadata(span_evs, fr_evs)
    evs = span_evs + fr_evs
    if evs:
        base = min(e["ts"] for e in evs)
        for e in evs:
            e["ts"] -= base
    return {"traceEvents": meta + evs, "displayTimeUnit": "ms"}


def validate_trace(doc: Dict[str, Any]) -> List[str]:
    """Schema check for the trace-event JSON (what the tier-1 test runs
    instead of a browser): structural field/type constraints plus the
    per-track nesting discipline complete ("X") events rely on. Returns
    a list of problems — empty means the file will load."""
    errs: List[str] = []
    if not isinstance(doc, dict):
        return ["document is not an object"]
    evs = doc.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents is not a list"]
    tracks: Dict[Any, List[Dict[str, Any]]] = {}
    for i, e in enumerate(evs):
        if not isinstance(e, dict):
            errs.append(f"event {i}: not an object")
            continue
        ph = e.get("ph")
        if ph not in ("X", "i", "I", "M"):
            errs.append(f"event {i}: bad ph {ph!r}")
            continue
        if not isinstance(e.get("name"), str) or not e["name"]:
            errs.append(f"event {i}: missing name")
        if not isinstance(e.get("pid"), int) \
                or not isinstance(e.get("tid"), int):
            errs.append(f"event {i}: pid/tid must be ints")
        if ph == "M":
            if not isinstance(e.get("args"), dict) \
                    or "name" not in e.get("args", {}):
                errs.append(f"event {i}: metadata without args.name")
            continue
        ts = e.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errs.append(f"event {i}: bad ts {ts!r}")
            continue
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errs.append(f"event {i}: X event with bad dur {dur!r}")
                continue
            tracks.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    # nesting: within one (pid, tid) row, complete events must form a
    # stack — overlap without containment renders as garbage. Tolerance
    # is float-aware, not zero: ts comes from monotonic*1e6 minus a
    # base, so adjacent spans that tile exactly in seconds can disagree
    # by ~ulp(monotonic*1e6) ≈ 1e-4 us after days of uptime; real
    # overlap bugs are >> half a microsecond.
    eps = 0.5
    for key, track in tracks.items():
        track.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack: List[Dict[str, Any]] = []
        for e in track:
            while stack and e["ts"] >= stack[-1]["ts"] + stack[-1]["dur"] \
                    - eps:
                stack.pop()
            if stack and e["ts"] + e["dur"] > stack[-1]["ts"] \
                    + stack[-1]["dur"] + eps:
                errs.append(f"track {key}: {e['name']} overlaps "
                            f"{stack[-1]['name']} without nesting")
            stack.append(e)
    return errs


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--spans", help="span JSONL (akka.tracing.jsonl-path)")
    p.add_argument("--flight", help="flight-recorder JSONL "
                                    "(akka.flight-recorder.path)")
    p.add_argument("--out", default="trace.json",
                   help="output trace-event JSON (default trace.json)")
    p.add_argument("--validate", action="store_true",
                   help="schema-check the result and exit nonzero on "
                        "problems")
    args = p.parse_args(argv)
    if not args.spans and not args.flight:
        p.error("need --spans and/or --flight")
    spans: List[Dict[str, Any]] = []
    events: List[Dict[str, Any]] = []
    if args.spans:
        s, e = split_rows(load_jsonl(args.spans))
        spans += s
        events += e
    if args.flight:
        s, e = split_rows(load_jsonl(args.flight))
        spans += s
        events += e
    doc = to_perfetto(spans, events)
    with open(args.out, "w") as fh:
        json.dump(doc, fh)
    n_spans, n_events = len(spans), len(events)
    print(f"wrote {args.out}: {n_spans} spans + {n_events} flight "
          f"events -> {len(doc['traceEvents'])} trace events")
    if args.validate:
        errs = validate_trace(doc)
        for err in errs:
            print(f"INVALID: {err}", file=sys.stderr)
        return 1 if errs else 0
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
