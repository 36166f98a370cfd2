"""The `tpu-batched` dispatcher type: the device-actor seam.

Port of `akka_tpu/dispatch/batched.py` at commit 5d9b7cd. Reference parity:
the MessageDispatcherConfigurator / Dispatchers extension point
(dispatch/Dispatchers.scala:235-259, registerConfigurator :184-185) gates
the backend, so `akka.actor.default-dispatcher.type = tpu-batched` (or the
dedicated `akka.actor.tpu-dispatcher` id) selects this dispatcher.

Ordinary Python actors attached to this dispatcher still run on a host
thread pool; the dispatcher also owns a BatchedRuntimeHandle
(batched/bridge.py), whose BatchedSystem holds the actors whose Props
carry a DeviceSpec as rows, stepped on the card.

Two port additions, forwarded to the handle: the config key `device`
(default "cuda", which raises without a card; "cpu" runs the same handle
on the CPU, as the tests do) and `spill-capacity` (absent: the system's
default spill region; 0 bounds each slots mailbox at its slots, the mode
the ring kernel K2 delivers).
"""

from __future__ import annotations

import threading
from typing import Optional

from .dispatcher import Dispatcher, DispatcherConfigurator


class TpuBatchedDispatcher(Dispatcher):
    """Host-facing dispatcher + owner of the device runtime handle."""

    def __init__(self, dispatchers, id: str, config):
        super().__init__(dispatchers, id,
                         throughput=config.get_int("throughput", 64),
                         shutdown_timeout=config.get_duration(
                             "shutdown-timeout", "1s"))
        self._config = config
        self._handle = None
        self._runtime_lock = threading.Lock()

    def handle(self, system=None, **overrides):
        """Get (or lazily build) the BatchedRuntimeHandle."""
        with self._runtime_lock:
            if self._handle is None:
                from ..batched.bridge import BatchedRuntimeHandle
                c = self._config
                settings = getattr(system, "settings", None)
                wal_default = settings.config.get_int(
                    "akka.persistence.tell-journal.fsync-every-n", 1) \
                    if settings is not None else 1

                def key(name, conf, get, default):
                    return overrides.get(name, get(conf, default))

                self._handle = BatchedRuntimeHandle(
                    capacity=key("capacity", "capacity", c.get_int, 1 << 20),
                    payload_width=key("payload_width", "payload-width",
                                      c.get_int, 8),
                    out_degree=key("out_degree", "out-degree", c.get_int, 1),
                    host_inbox=key("host_inbox", "host-inbox", c.get_int,
                                   4096),
                    mailbox_slots=key("mailbox_slots", "mailbox-slots",
                                      c.get_int, 0),
                    promise_rows=key("promise_rows", "promise-rows",
                                     c.get_int, 256),
                    auto_step_interval=c.get_duration("auto-step-interval",
                                                      "1ms"),
                    event_stream=getattr(system, "event_stream", None),
                    flight_recorder=getattr(system, "flight_recorder", None),
                    failure_policy=c.get_string("failure-policy", "restart"),
                    pipeline_depth=key("pipeline_depth", "pipeline-depth",
                                       c.get_int, 2),
                    checkpoint_interval_steps=key(
                        "checkpoint_interval_steps",
                        "checkpoint-interval-steps", c.get_int, 0),
                    checkpoint_dir=overrides.get(
                        "checkpoint_dir",
                        c.get_string("checkpoint-dir", "") or None),
                    checkpoint_keep=key("checkpoint_keep", "checkpoint-keep",
                                        c.get_int, 3),
                    # WAL group commit: the system-wide
                    # akka.persistence.tell-journal.fsync-every-n key (or a
                    # per-dispatcher wal-fsync-every-n / override)
                    wal_fsync_every_n=key("wal_fsync_every_n",
                                          "wal-fsync-every-n", c.get_int,
                                          wal_default or 1),
                    sentinel_threshold=key("sentinel_threshold",
                                           "sentinel-threshold",
                                           c.get_float, 8.0),
                    sentinel_heartbeat_interval=key(
                        "sentinel_heartbeat_interval",
                        "sentinel-heartbeat-interval", c.get_duration,
                        "100ms"),
                    sentinel_acceptable_pause=key(
                        "sentinel_acceptable_pause",
                        "sentinel-acceptable-pause", c.get_duration, "3s"),
                    # sentinel-max-failovers and -depth-recovery-rounds act
                    # only in MeshSentinel, not in a handle: unread
                    # telemetry plane: the system-level akka.metrics.enabled
                    # switch (or an explicit override) compiles the device
                    # metric slab in; the system-owned registry is shared
                    metrics_enabled=overrides.get(
                        "metrics_enabled",
                        c.get_bool("metrics-enabled", False) or
                        getattr(system, "metrics_registry", None)
                        is not None),
                    metrics_registry=overrides.get(
                        "metrics_registry",
                        getattr(system, "metrics_registry", None)),
                    device=key("device", "device", c.get_string, "cuda"),
                    spill_capacity=overrides.get(
                        "spill_capacity",
                        c.get_int("spill-capacity")
                        if c.has_path("spill-capacity") else None),
                    native_staging=overrides.get("native_staging"),
                )
            return self._handle

    def runtime(self, behaviors=None, **overrides):
        """The raw BatchedSystem (builds the handle; registers any passed
        behaviors)."""
        h = self.handle(**overrides)
        for b in behaviors or ():
            h._behavior_index(b)
        return h.runtime

    @property
    def has_runtime(self) -> bool:
        return self._handle is not None and self._handle._runtime is not None

    def shutdown(self) -> None:
        if self._handle is not None:
            self._handle.shutdown()
        super().shutdown()


class TpuBatchedDispatcherConfigurator(DispatcherConfigurator):
    def __init__(self, config, dispatchers, id: str):
        super().__init__(config, dispatchers)
        self.id = id
        self._instance: Optional[TpuBatchedDispatcher] = None
        self._lock = threading.Lock()

    def dispatcher(self) -> TpuBatchedDispatcher:
        with self._lock:
            if self._instance is None:
                self._instance = TpuBatchedDispatcher(self.dispatchers,
                                                      self.id, self.config)
            return self._instance


def register_tpu_dispatcher_type(dispatchers) -> None:
    """Called from ActorSystem bootstrap (actor/system.py)."""
    dispatchers.register_type("tpu-batched", TpuBatchedDispatcherConfigurator)
