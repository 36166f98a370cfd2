"""Flight recorder: structured runtime tracing behind a noop-by-default SPI.

Port of `akka_tpu/event/flight_recorder.py` at commit ee03956. The SPI
(`FlightRecorder`, every hook with its signature), `NoOpFlightRecorder`,
`spi_hook_fields`, `InMemoryFlightRecorder` (wall `ts` and monotonic
`ts_mono` on every row), `JsonlFlightRecorder` and `from_config` are the
reference's, line for line. The profiler side is PyTorch's:
`trace_span` wraps `torch.profiler.record_function`, so a bracket such as
`akka.device.step` shows up as a range in a `torch.profiler` trace beside
the kernels it launched; `start_trace(log_dir)`/`stop_trace()` run one
`torch.profiler.profile` (the CPU, and the card's CUDA activity when a
card is present) and write its Chrome trace into `log_dir` on stop.

Reference parity: the JDK Flight Recorder emitters selected at runtime —
typed actor events (akka-actor-typed/src/main/scala-jdk-9/akka/actor/typed/
internal/jfr/JFRActorFlightRecorder.scala, noop fallback
typed/internal/ActorFlightRecorder.scala) and remoting events
(akka-remote/src/main/scala-jdk-9/akka/remote/artery/jfr/Events.scala), with
hook points through ArteryTransport.start (ArteryTransport.scala:344,436-466).

Selection mirrors the reference's runtime pick: config
`akka.flight-recorder.implementation = noop|memory|jsonl` read at system
bootstrap; `noop` costs one no-inlined method call per hook, nothing else.
"""

from __future__ import annotations

import inspect
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import torch


class FlightRecorder:
    """SPI. Every hook is fire-and-forget and must never raise into the
    caller; implementations are thread-safe. Callers building non-trivial
    hook arguments (path strings, reprs) should gate on `enabled` so the
    noop configuration pays one attribute read, nothing else."""

    enabled = True

    # -- actor lifecycle (JFRActorFlightRecorder parity) ---------------------
    def actor_spawned(self, path: str) -> None: ...
    def actor_stopped(self, path: str) -> None: ...
    def actor_failed(self, path: str, cause: str) -> None: ...
    def actor_restarted(self, path: str, cause: str) -> None: ...

    # -- remoting (artery/jfr/Events.scala parity) ---------------------------
    def transport_started(self, address: str) -> None: ...
    def association_opened(self, peer: str) -> None: ...
    def association_quarantined(self, peer: str, reason: str) -> None: ...
    def remote_message_sent(self, peer: str, size: int) -> None: ...
    def remote_message_received(self, peer: str, size: int) -> None: ...

    # -- device runtime (no reference analogue; the TPU data plane) ----------
    def device_step(self, system: str, n_steps: int, elapsed_s: float) -> None: ...
    def device_flush(self, system: str, staged: int) -> None: ...
    def device_compile(self, system: str, elapsed_s: float) -> None: ...
    def dropped(self, system: str, count: int) -> None: ...

    # in-graph supervision counter DELTA since the previous report
    # (batched/supervision.py COUNTER_NAMES): one event per step window,
    # emitted only when something happened — the watchdog's artifact shows
    # directive traffic without per-step device syncs
    def device_supervision(self, system: str, steps: int, failed: int,
                           resumed: int, restarted: int, stopped: int,
                           escalated: int, dead_letters: int) -> None: ...

    # depth-k dispatch pipeline counter DELTA since the previous report
    # (batched/bridge.py): programs enqueued/drained in the window and how
    # many drains paid the wide promise readback (wide_resolves) vs
    # host-only deadline checks — emitted at the pump's busy->idle edge
    # and at handle shutdown
    def device_pipeline(self, system: str, depth: int, steps: int,
                        drains: int, wide_resolves: int,
                        host_checks: int) -> None: ...

    # checkpoint/recovery (batched runtime + persistence/tell_journal):
    # one device_checkpoint per snapshot taken; checkpoint_failed when
    # snapshot IO degrades (the step loop keeps running); journal_truncated
    # when a torn record-log tail is repaired on open
    def device_checkpoint(self, system: str, step: int, elapsed_s: float,
                          size_bytes: int, path: str) -> None: ...

    def checkpoint_failed(self, system: str, error: str,
                          consecutive: int) -> None: ...

    def journal_truncated(self, path: str, dropped_bytes: int) -> None: ...

    # failure detection / degraded-mesh failover (batched/sentinel.py):
    # device_suspected when a shard's heartbeat lane trips its detector
    # (phi-accrual on frozen progress, or the wall-clock drain deadline);
    # device_evicted once the sentinel quarantines it; failover_completed
    # after the surviving-mesh rebuild resumes stepping (mttr_s measures
    # suspicion -> first post-failover step); failover_halted is TERMINAL —
    # the failover breaker tripped and the runtime stopped instead of
    # flapping; shard_overflow localizes mailbox/exchange overflow to one
    # shard (the "slow, not dead" warning)
    def device_suspected(self, system: str, shard: int, phi: float,
                         detector: str) -> None: ...

    def device_evicted(self, system: str, shard: int, step: int) -> None: ...

    def failover_completed(self, system: str, lost_shards, survivors: int,
                           step: int, mttr_s: float) -> None: ...

    def failover_halted(self, system: str, failovers: int,
                        reason: str) -> None: ...

    def shard_overflow(self, system: str, shard: int, mailbox_overflow: int,
                       dropped: int) -> None: ...

    # elastic mesh (batched/sentinel.scale_to + batched/autoscale.py):
    # device_rejoined per device added back on a grow; mesh_expanded /
    # mesh_narrowed after the bounded-pause live re-shard resumes
    # (pause_s = drain -> first dispatch on the new mesh is ready);
    # autoscale_decision records WHY the policy acted (trigger signal +
    # its observed value) with the measured pause — the operator-facing
    # audit trail of every mesh-size change
    def device_rejoined(self, system: str, shard: int, step: int) -> None: ...

    def mesh_expanded(self, system: str, from_shards: int, to_shards: int,
                      step: int, pause_s: float, trigger: str) -> None: ...

    def mesh_narrowed(self, system: str, from_shards: int, to_shards: int,
                      step: int, pause_s: float, trigger: str) -> None: ...

    def autoscale_decision(self, system: str, direction: str, signal: str,
                           value: float, from_shards: int, to_shards: int,
                           pause_ms: float) -> None: ...

    # -- generic escape hatch ------------------------------------------------
    def event(self, name: str, **fields: Any) -> None: ...

    def events(self) -> List[Dict[str, Any]]:
        return []

    def close(self) -> None: ...


class NoOpFlightRecorder(FlightRecorder):
    """Default: every hook is a pass (ActorFlightRecorder noop parity)."""

    enabled = False


def _structured(method_name):
    def hook(self, *args, **kwargs):
        self._record(method_name, args, kwargs)
    return hook


# Recorder plumbing on the SPI that is NOT a structured hook: the **fields
# escape hatch and the buffer/lifecycle accessors.
_NON_HOOKS = frozenset({"event", "events", "close"})


def spi_hook_fields() -> Dict[str, Tuple[str, ...]]:
    """hook name -> positional field names, derived from the FlightRecorder
    SPI signatures themselves. Adding a hook to the SPI (or a field to an
    existing hook) updates every structured recorder automatically — the
    hand-maintained copy of this table used to drift one hook behind."""
    fields: Dict[str, Tuple[str, ...]] = {}
    for name, fn in vars(FlightRecorder).items():
        if name.startswith("_") or name in _NON_HOOKS or not callable(fn):
            continue
        params = tuple(inspect.signature(fn).parameters)
        fields[name] = params[1:]  # drop self
    return fields


class InMemoryFlightRecorder(FlightRecorder):
    """Bounded ring of structured events; the testkit/debug recorder."""

    _FIELDS = spi_hook_fields()

    def __init__(self, capacity: int = 4096):
        self._buf: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()

    def _record(self, name: str, args, kwargs=None) -> None:
        # dual timestamps: wall `ts` for humans,
        # monotonic `ts_mono` so tools/trace_export.py can align FR rows
        # with tracing spans without guessing a clock offset. Rows written
        # before this change carry `ts` only and still parse everywhere.
        ev = {"event": name, "ts": time.time(), "ts_mono": time.monotonic()}
        for field, value in zip(self._FIELDS.get(name, ()), args):
            ev[field] = value
        if kwargs:
            ev.update(kwargs)
        self._append(ev)

    def _append(self, ev: Dict[str, Any]) -> None:
        with self._lock:
            self._buf.append(ev)

    def event(self, name: str, **fields: Any) -> None:
        self._append({"event": name, "ts": time.time(),
                      "ts_mono": time.monotonic(), **fields})

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._buf)

    def of_type(self, name: str) -> List[Dict[str, Any]]:
        return [e for e in self.events() if e["event"] == name]


for _m in InMemoryFlightRecorder._FIELDS:
    setattr(InMemoryFlightRecorder, _m, _structured(_m))


class JsonlFlightRecorder(InMemoryFlightRecorder):
    """Appends every event as one JSON line (the post-mortem recorder —
    a human can `jq` the flight after a crash, like opening a .jfr)."""

    def __init__(self, path: str, capacity: int = 4096):
        super().__init__(capacity)
        self._path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._fh = open(path, "a", buffering=1)
        self._flock = threading.Lock()

    def _append(self, ev: Dict[str, Any]) -> None:
        super()._append(ev)
        with self._flock:
            try:
                self._fh.write(json.dumps(ev) + "\n")
            except ValueError:  # closed file mid-shutdown
                pass

    def close(self) -> None:
        with self._flock:
            try:
                self._fh.close()
            except Exception:  # noqa: BLE001
                pass


def from_config(config) -> FlightRecorder:
    """`akka.flight-recorder.implementation`: noop (default) | memory | jsonl
    (+ `akka.flight-recorder.path` for jsonl)."""
    impl = "noop"
    path = "flight.jsonl"
    capacity = 4096
    if config is not None:
        impl = config.get_string("akka.flight-recorder.implementation", "noop")
        path = config.get_string("akka.flight-recorder.path", path)
        capacity = config.get_int("akka.flight-recorder.capacity", capacity)
    if impl == "memory":
        return InMemoryFlightRecorder(capacity)
    if impl == "jsonl":
        return JsonlFlightRecorder(path, capacity)
    return NoOpFlightRecorder()


# ------------------------------------------------------ torch.profiler side
class trace_span:
    """Context manager: annotate a host-side region so that it shows up in
    a `torch.profiler` trace as a range beside the kernels it launches
    (`torch.profiler.record_function`). Costs a few microseconds and
    records nothing when no profiler is active."""

    __slots__ = ("_name", "_cm")

    def __init__(self, name: str):
        self._name = name
        self._cm = None

    def __enter__(self):
        try:
            self._cm = torch.profiler.record_function(self._name)
            self._cm.__enter__()
        except Exception:  # noqa: BLE001 — tracing must never break the step
            self._cm = None
        return self

    def __exit__(self, *exc):
        if self._cm is not None:
            try:
                self._cm.__exit__(*exc)
            except Exception:  # noqa: BLE001
                pass
        return False


# the profile start_trace() opened and its log directory; None when idle
_TRACE: Optional[Tuple[Any, str]] = None
_TRACE_LOCK = threading.Lock()


def start_trace(log_dir: str) -> bool:
    """Begin one `torch.profiler` trace of the host and, on a card, its
    CUDA activity; `stop_trace()` writes it into `log_dir` as a Chrome
    trace (open it in Perfetto or chrome://tracing). False when a trace
    is already running or the profiler cannot start."""
    global _TRACE
    from torch.profiler import ProfilerActivity, profile
    with _TRACE_LOCK:
        if _TRACE is not None:
            return False
        try:
            os.makedirs(log_dir, exist_ok=True)
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities)
            prof.start()
        except Exception:  # noqa: BLE001
            return False
        _TRACE = (prof, log_dir)
        return True


def stop_trace() -> bool:
    """End the running trace (the card is synchronised first, so the work
    it launched is in it) and write `akka_trace_<pid>_<ms>.json` into its
    log directory. False when no trace runs or the export fails."""
    global _TRACE
    with _TRACE_LOCK:
        got, _TRACE = _TRACE, None
    if got is None:
        return False
    prof, log_dir = got
    try:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"akka_trace_{os.getpid()}_{int(time.time() * 1e3)}"
            ".json"))
        return True
    except Exception:  # noqa: BLE001
        return False
