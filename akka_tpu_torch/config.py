"""Layered configuration system.

A copy of `akka_tpu/config.py` at commit ee03956 (stdlib only; the port
keeps its own copy of every module it needs). The flight recorder, the
metrics registry and the tracer read it through their `from_config`.

TPU-native equivalent of the reference's Typesafe Config (HOCON) layer: every
module contributes reference defaults which are merged under user-supplied
overrides at system start (reference: akka-actor/src/main/resources/reference.conf,
read via ActorSystem.Settings, akka-actor/src/main/scala/akka/actor/ActorSystem.scala:398).

We use plain nested dicts with dotted-path access instead of HOCON files: config
is consumed from Python, and a dict round-trips through JSON for the cluster
join-config compatibility check (reference: cluster/JoinConfigCompatChecker.scala).
"""

from __future__ import annotations

import copy
import json
import re
from typing import Any, Iterator, Mapping

_DURATION_RE = re.compile(
    r"^\s*([0-9]*\.?[0-9]+)\s*(d|day|days|h|hour|hours|m|min|minute|minutes|"
    r"s|sec|second|seconds|ms|milli|millis|millisecond|milliseconds|"
    r"us|micro|micros|microsecond|microseconds|ns|nano|nanos|nanosecond|nanoseconds)?\s*$"
)

_UNIT_SECONDS = {
    None: 1.0,  # bare numbers are seconds
    "d": 86400.0, "day": 86400.0, "days": 86400.0,
    "h": 3600.0, "hour": 3600.0, "hours": 3600.0,
    "m": 60.0, "min": 60.0, "minute": 60.0, "minutes": 60.0,
    "s": 1.0, "sec": 1.0, "second": 1.0, "seconds": 1.0,
    "ms": 1e-3, "milli": 1e-3, "millis": 1e-3, "millisecond": 1e-3, "milliseconds": 1e-3,
    "us": 1e-6, "micro": 1e-6, "micros": 1e-6, "microsecond": 1e-6, "microseconds": 1e-6,
    "ns": 1e-9, "nano": 1e-9, "nanos": 1e-9, "nanosecond": 1e-9, "nanoseconds": 1e-9,
}


def parse_duration(value: Any) -> float:
    """Parse a duration into float seconds. Accepts numbers (seconds) or strings
    like "100ms", "5s", "1 minute", "off"/"infinite" (-> float('inf'))."""
    if isinstance(value, (int, float)):
        return float(value)
    if isinstance(value, str):
        v = value.strip().lower()
        if v in ("off", "infinite", "inf", "none"):
            return float("inf")
        m = _DURATION_RE.match(v)
        if m:
            return float(m.group(1)) * _UNIT_SECONDS[m.group(2)]
    raise ValueError(f"cannot parse duration: {value!r}")


def _deep_merge(base: dict, overrides: Mapping) -> dict:
    out = dict(base)
    for k, v in overrides.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, Mapping):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v) if isinstance(v, (dict, list)) else v
    return out


class Config:
    """Immutable-ish layered config with dotted-path access.

    ``Config({"akka": {"loglevel": "INFO"}}).get("akka.loglevel")`` -> "INFO".
    """

    __slots__ = ("_data",)

    def __init__(self, data: Mapping | None = None):
        self._data: dict = dict(data or {})

    # -- access ------------------------------------------------------------
    def get(self, path: str, default: Any = None) -> Any:
        node: Any = self._data
        for part in path.split("."):
            if isinstance(node, Mapping) and part in node:
                node = node[part]
            else:
                return default
        return node

    def has_path(self, path: str) -> bool:
        sentinel = object()
        return self.get(path, sentinel) is not sentinel

    def get_config(self, path: str) -> "Config":
        v = self.get(path, {})
        return Config(v if isinstance(v, Mapping) else {})

    def get_int(self, path: str, default: int = 0) -> int:
        v = self.get(path, default)
        return int(v)

    def get_float(self, path: str, default: float = 0.0) -> float:
        return float(self.get(path, default))

    def get_bool(self, path: str, default: bool = False) -> bool:
        v = self.get(path, default)
        if isinstance(v, str):
            return v.strip().lower() in ("on", "true", "yes", "1")
        return bool(v)

    def get_string(self, path: str, default: str = "") -> str:
        v = self.get(path, default)
        return str(v)

    def get_list(self, path: str, default: list | None = None) -> list:
        v = self.get(path, default if default is not None else [])
        return list(v) if isinstance(v, (list, tuple)) else [v]

    def get_duration(self, path: str, default: Any = 0.0) -> float:
        """Duration in float seconds ('off' -> inf)."""
        return parse_duration(self.get(path, default))

    def keys(self, path: str = "") -> Iterator[str]:
        node = self.get(path, {}) if path else self._data
        if isinstance(node, Mapping):
            yield from node.keys()

    # -- combination -------------------------------------------------------
    def with_fallback(self, other: "Config | Mapping") -> "Config":
        other_data = other._data if isinstance(other, Config) else dict(other)
        return Config(_deep_merge(other_data, self._data))

    def with_overrides(self, overrides: Mapping) -> "Config":
        return Config(_deep_merge(self._data, overrides))

    def to_dict(self) -> dict:
        return copy.deepcopy(self._data)

    def to_json(self) -> str:
        return json.dumps(self._data, sort_keys=True, default=str)

    def __repr__(self) -> str:  # pragma: no cover
        return f"Config({self._data!r})"


def reference_config() -> Config:
    """Framework-wide defaults. Mirrors the union of the per-module
    reference.conf files in the reference (akka-actor 1307 lines, akka-remote
    1234, akka-cluster 480 — see SURVEY.md §5 config)."""
    return Config({
        "akka": {
            "loglevel": "INFO",
            "stdout-loglevel": "WARNING",
            "log-dead-letters": 10,
            "actor": {
                "provider": "local",  # local | remote | cluster
                "creation-timeout": "20s",
                "unstarted-push-timeout": "10s",
                "serialize-messages": False,
                "guardian-supervisor-strategy": "default",
                "default-dispatcher": {
                    "type": "Dispatcher",
                    "executor": "thread-pool-executor",
                    "throughput": 64,
                    "thread-pool-executor": {"fixed-pool-size": 0},  # 0 => ncores
                    "shutdown-timeout": "1s",
                },
                "internal-dispatcher": {
                    "type": "Dispatcher",
                    "executor": "thread-pool-executor",
                    "throughput": 64,
                    "thread-pool-executor": {"fixed-pool-size": 2},
                    "shutdown-timeout": "1s",
                },
                "tpu-dispatcher": {
                    # The flagship batched dispatcher (BASELINE north star):
                    # SoA actor slabs stepped on-device; see akka_tpu/dispatch/batched.py
                    "type": "tpu-batched",
                    # where the handle's runtime runs (a port addition):
                    # "cuda" raises without a card; "cpu" on request
                    "device": "cuda",
                    "capacity": 1 << 20,
                    "payload-width": 8,
                    "out-degree": 1,
                    "host-inbox": 4096,
                    "mailbox-slots": 0,     # >0 = per-message ordered mailboxes
                    "promise-rows": 256,    # ask() promise slots
                    "auto-step-interval": "1ms",
                    "pipeline-depth": 2,    # in-flight programs for step(depth=)
                    # preemption tolerance: snapshot every N dispatched steps
                    # into checkpoint-dir, retaining checkpoint-keep newest
                    # (0 / "" disables; see docs/CHECKPOINT_RECOVERY.md)
                    "checkpoint-interval-steps": 0,
                    "checkpoint-dir": "",
                    "checkpoint-keep": 3,
                    # shard-failure sentinel (batched/sentinel.py): phi
                    # threshold + expected heartbeat cadence for the
                    # progress-lane detector, the wall-clock pause before
                    # a silent mesh is declared hung, and how many
                    # automatic failovers may run before the breaker
                    # halts the runtime degraded (docs/FAILOVER.md)
                    "sentinel-threshold": 8.0,
                    "sentinel-heartbeat-interval": "100ms",
                    "sentinel-acceptable-pause": "3s",
                    "sentinel-max-failovers": 3,
                    # degrade-ladder recovery: failover halves the
                    # speculation depth; this many consecutive healthy
                    # pump rounds restore the configured depth (0 = the
                    # halving is permanent, the pre-PR-10 behavior)
                    "sentinel-depth-recovery-rounds": 64,
                    "mesh-axes": {},
                    # per-dispatcher override of akka.metrics.enabled:
                    # compiles the device metric slab into this
                    # dispatcher's step even without the system-wide plane
                    "metrics-enabled": False,
                },
                "default-mailbox": {
                    "mailbox-type": "unbounded",
                    "mailbox-capacity": 1000,
                    "mailbox-push-timeout-time": "10s",
                },
                "mailbox": {"requirements": {}},
                "debug": {"receive": False, "autoreceive": False, "lifecycle": False,
                          "event-stream": False, "unhandled": False},
                "deployment": {},
            },
            "scheduler": {
                "tick-duration": "10ms",
                "ticks-per-wheel": 512,
                "shutdown-timeout": "5s",
            },
            "coordinated-shutdown": {
                "default-phase-timeout": "5s",
                "terminate-actor-system": True,
                "run-by-actor-system-terminate": True,
                "phases": {
                    "before-service-unbind": {"depends-on": []},
                    "service-unbind": {"depends-on": ["before-service-unbind"]},
                    "service-requests-done": {"depends-on": ["service-unbind"]},
                    "service-stop": {"depends-on": ["service-requests-done"]},
                    "before-cluster-shutdown": {"depends-on": ["service-stop"]},
                    "cluster-sharding-shutdown-region": {"depends-on": ["before-cluster-shutdown"]},
                    "cluster-leave": {"depends-on": ["cluster-sharding-shutdown-region"]},
                    "cluster-exiting": {"depends-on": ["cluster-leave"]},
                    "cluster-exiting-done": {"depends-on": ["cluster-exiting"]},
                    "cluster-shutdown": {"depends-on": ["cluster-exiting-done"]},
                    "before-actor-system-terminate": {"depends-on": ["cluster-shutdown"]},
                    "actor-system-terminate": {"depends-on": ["before-actor-system-terminate"]},
                },
            },
            "serialization": {
                "serializers": {},         # name -> FQCN
                "serialization-bindings": {},  # FQCN of message class -> serializer name
            },
            # unified telemetry plane (event/metrics.py + the device metric
            # slab, batched/metrics_slab.py): off by default — enabling it
            # compiles the slab into tpu-batched steps and builds the
            # system-owned MetricsRegistry. http-port > 0 serves
            # Prometheus exposition on 127.0.0.1; jsonl-path arms the
            # periodic emitter (flight-recorder file conventions).
            "metrics": {
                "enabled": False,
                "namespace": "akka",
                "http-port": 0,
                "jsonl-path": "",
                "jsonl-interval": "1s",
            },
            # elastic mesh autoscaler (batched/autoscale.py): off by
            # default — when enabled, autoscaler_from_config attaches a
            # MeshAutoscaler to the MeshSentinel, polled once per pump
            # round. Thresholds are per-poll growth deltas for the
            # counters and levels for the occupancies; hysteresis windows
            # are counted in polls (= pump rounds). max-shards 0 means
            # pool-bounded. docs/ELASTIC_MESH.md has tuning guidance.
            "autoscale": {
                "enabled": False,
                "min-shards": 1,
                "max-shards": 0,
                "widen-after-polls": 3,
                "narrow-after-polls": 16,
                "cooldown-polls": 8,
                "overflow-threshold": 1.0,
                "dropped-threshold": 1.0,
                "ask-occupancy-threshold": 0.9,
                "occupancy-p90-threshold": float("inf"),
            },
            "remote": {
                "canonical": {"hostname": "127.0.0.1", "port": 0},
                "handshake-timeout": "20s",
                "handshake-retry-interval": "1s",
                "quarantine-duration": "5d",
                "system-message-resend-interval": "1s",
                "system-message-buffer-size": 20000,
                "lanes": 4,
                "watch-failure-detector": {
                    "heartbeat-interval": "1s",
                    "threshold": 10.0,
                    "max-sample-size": 200,
                    "min-std-deviation": "100ms",
                    "acceptable-heartbeat-pause": "10s",
                    "expected-first-heartbeat-estimate": "1s",
                },
                "use-unsafe-remote-features-outside-cluster": False,
            },
            "cluster": {
                "seed-nodes": [],
                "seed-node-timeout": "5s",
                "retry-unsuccessful-join-after": "10s",
                "shutdown-after-unsuccessful-join-seed-nodes": "off",
                "periodic-tasks-initial-delay": "1s",
                "gossip-interval": "1s",
                "gossip-time-to-live": "2s",
                "leader-actions-interval": "1s",
                "unreachable-nodes-reaper-interval": "1s",
                "allow-weakly-up-members": True,
                "roles": [],
                "min-nr-of-members": 1,
                "downing-provider-class": "",
                "failure-detector": {
                    "heartbeat-interval": "1s",
                    "threshold": 8.0,
                    "max-sample-size": 1000,
                    "min-std-deviation": "100ms",
                    "acceptable-heartbeat-pause": "3s",
                    "monitored-by-nr-of-members": 5,
                    "expected-first-heartbeat-estimate": "1s",
                },
                "split-brain-resolver": {
                    "active-strategy": "keep-majority",
                    "stable-after": "20s",
                    "down-all-when-unstable": "on",
                    "static-quorum": {"quorum-size": 0, "role": ""},
                    "keep-majority": {"role": ""},
                    "keep-oldest": {"down-if-alone": True, "role": ""},
                    "lease-majority": {"lease-implementation": "", "acquire-lease-delay-for-minority": "2s", "role": ""},
                },
                "sharding": {
                    "number-of-shards": 256,
                    "guardian-name": "sharding",
                    "retry-interval": "2s",
                    "buffer-size": 100000,
                    "handoff-timeout": "60s",
                    "rebalance-interval": "10s",
                    "passivate-idle-entity-after": "120s",
                    "remember-entities": False,
                    "state-store-mode": "ddata",
                    "least-shard-allocation-strategy": {
                        "rebalance-absolute-limit": 0,
                        "rebalance-relative-limit": 0.1,
                    },
                },
                "singleton": {
                    "singleton-name": "singleton",
                    "hand-over-retry-interval": "1s",
                    "min-number-of-hand-over-retries": 15,
                },
                "singleton-proxy": {
                    "buffer-size": 1000,
                    "singleton-identification-interval": "1s",
                },
                "pub-sub": {
                    "gossip-interval": "1s",
                    "removed-time-to-live": "120s",
                },
                "metrics": {
                    "enabled": True,
                    "collect-interval": "3s",
                    "gossip-interval": "3s",
                    "moving-average-half-life": "12s",
                },
                "distributed-data": {
                    "gossip-interval": "2s",
                    "notify-subscribers-interval": "0.5s",
                    "max-delta-elements": 500,
                    "delta-crdt": {"enabled": True, "max-delta-size": 50},
                    "durable": {"keys": [], "store-dir": "ddata"},
                },
            },
            "persistence": {
                "journal": {"plugin": "akka.persistence.journal.inmem",
                            "inmem": {"class": "akka_tpu_torch.persistence.journal.InMemJournal"},
                            "file": {"class": "akka_tpu_torch.persistence.journal.FileJournal", "dir": "journal"}},
                "snapshot-store": {"plugin": "akka.persistence.snapshot-store.local",
                                   "local": {"class": "akka_tpu_torch.persistence.snapshot.LocalSnapshotStore",
                                             "dir": "snapshots"}},
                "max-concurrent-recoveries": 50,
                "at-least-once-delivery": {
                    "redeliver-interval": "5s",
                    "redelivery-burst-limit": 10000,
                    "warn-after-number-of-unconfirmed-attempts": 5,
                    "max-unconfirmed-messages": 100000,
                },
            },
            "stream": {
                "materializer": {
                    "initial-input-buffer-size": 4,
                    "max-input-buffer-size": 16,
                    "dispatcher": "akka.actor.default-dispatcher",
                    "stream-ref": {"buffer-capacity": 32, "demand-redelivery-interval": "1s",
                                   "subscription-timeout": "30s"},
                },
            },
            "test": {
                "timefactor": 1.0,
                "single-expect-default": "3s",
                "default-timeout": "5s",
            },
        },
    })
