"""ActorSystem: bootstrap + lifecycle of the whole runtime.

A copy of `akka_tpu/actor/system.py` at commit 5d9b7cd (host code, no jax;
the port keeps its own copy of every module it needs). Where the
reference falls back silently, the port refuses: the `tpu-batched`
dispatcher type is registered unconditionally. A remote or cluster
provider (`akka.actor.provider = remote | cluster`) builds the port's
`remote.provider.RemoteActorRefProvider`, whose `post_init` binds the
transport once the guardians exist, as the reference does; when it
raises, the port terminates the system before re-raising.
`akka.jax-distributed.enabled` calls the reference's hook at start
(`parallel.mesh.maybe_initialize_distributed_from_config`: this process's
rank of a torch.distributed process group; `akka.jax-distributed.device`,
a port addition, picks the backend), and `terminate()` destroys the group
this system started. The native scheduler
(`akka.scheduler.implementation = native`) and the native mailboxes
(`akka.actor.native-mailboxes`) build the native library (native/) and
raise RuntimeError when it cannot be built; the reference falls back to
the Python scheduler and queues there.

Reference parity: akka-actor/src/main/scala/akka/actor/ActorSystem.scala —
ctor sequence eventStream → scheduler → provider → mailboxes → dispatchers
(:911-956), `_start` runs provider.init (:1013-1031), terminate (:1042),
Settings (:398), extensions loaded at start (:1027), CoordinatedShutdown
phase DAG (actor/CoordinatedShutdown.scala:189,297,366).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

from ..config import Config, reference_config
from ..dispatch.batched import register_tpu_dispatcher_type
from ..dispatch.dispatcher import Dispatchers
from ..dispatch.mailbox import Mailboxes
from ..event.event_stream import EventStream
from ..event.logging import (DEBUG_LEVEL, LogEvent, LoggingAdapter, StdOutLogger,
                             level_for)
from .messages import DeadLetter
from .path import Address
from .props import Props
from .provider import LocalActorRefProvider
from .ref import ActorRef
from .scheduler import Scheduler


class Settings:
    """(reference: ActorSystem.Settings, actor/ActorSystem.scala:398)"""

    def __init__(self, config: Config):
        self.config = config
        self.loglevel = config.get_string("akka.loglevel", "INFO")
        self.stdout_loglevel = config.get_string("akka.stdout-loglevel", "WARNING")
        self.log_dead_letters = config.get_int("akka.log-dead-letters", 10)
        self.debug_receive = config.get_bool("akka.actor.debug.receive")
        self.debug_autoreceive = config.get_bool("akka.actor.debug.autoreceive")
        self.debug_lifecycle = config.get_bool("akka.actor.debug.lifecycle")
        self.debug_event_stream = config.get_bool("akka.actor.debug.event-stream")
        self.debug_unhandled = config.get_bool("akka.actor.debug.unhandled")
        self.serialize_messages = config.get_bool("akka.actor.serialize-messages")
        self.provider_kind = config.get_string("akka.actor.provider", "local")
        self.creation_timeout = config.get_duration("akka.actor.creation-timeout", "20s")


class ExtensionId:
    """Typed singleton plugin per system (reference: actor/Extension.scala)."""

    def create_extension(self, system: "ActorSystem") -> Any:
        raise NotImplementedError

    def apply(self, system: "ActorSystem") -> Any:
        return system.register_extension(self)

    __call__ = apply


class CoordinatedShutdown:
    """Ordered, config-defined phase DAG for graceful shutdown
    (reference: actor/CoordinatedShutdown.scala:189,297,366)."""

    PHASE_BEFORE_SERVICE_UNBIND = "before-service-unbind"
    PHASE_SERVICE_UNBIND = "service-unbind"
    PHASE_SERVICE_REQUESTS_DONE = "service-requests-done"
    PHASE_SERVICE_STOP = "service-stop"
    PHASE_BEFORE_CLUSTER_SHUTDOWN = "before-cluster-shutdown"
    PHASE_CLUSTER_SHARDING_SHUTDOWN_REGION = "cluster-sharding-shutdown-region"
    PHASE_CLUSTER_LEAVE = "cluster-leave"
    PHASE_CLUSTER_EXITING = "cluster-exiting"
    PHASE_CLUSTER_EXITING_DONE = "cluster-exiting-done"
    PHASE_CLUSTER_SHUTDOWN = "cluster-shutdown"
    PHASE_BEFORE_ACTOR_SYSTEM_TERMINATE = "before-actor-system-terminate"
    PHASE_ACTOR_SYSTEM_TERMINATE = "actor-system-terminate"

    def __init__(self, system: "ActorSystem"):
        self.system = system
        cfg = system.settings.config.get_config("akka.coordinated-shutdown")
        self.default_timeout = cfg.get_duration("default-phase-timeout", "5s")
        self._phases: Dict[str, list] = {name: [] for name in cfg.keys("phases")}
        self._order = self._topo_sort(cfg.get("phases", {}))
        self._run_started = threading.Event()
        self._lock = threading.Lock()

    @staticmethod
    def _topo_sort(phases: dict) -> list:
        order, seen = [], set()

        def visit(name: str, stack: tuple):
            if name in seen:
                return
            if name in stack:
                raise ValueError(f"cycle in coordinated-shutdown phases at {name}")
            for dep in phases.get(name, {}).get("depends-on", []):
                visit(dep, stack + (name,))
            seen.add(name)
            order.append(name)

        for name in phases:
            visit(name, ())
        return order

    def add_task(self, phase: str, name: str, task: Callable[[], Any]) -> None:
        with self._lock:
            self._phases.setdefault(phase, []).append((name, task))

    def run(self, reason: str = "unknown") -> None:
        if self._run_started.is_set():
            return
        self._run_started.set()
        for phase in self._order:
            for name, task in list(self._phases.get(phase, [])):
                try:
                    task()
                except Exception as e:  # noqa: BLE001
                    self.system.log.warning(
                        f"coordinated shutdown task [{name}] in phase [{phase}] failed: {e!r}")


class ActorSystem:
    """Create with `ActorSystem.create(name, config_overrides)`."""

    _global_count = 0

    def __init__(self, name: str, config: Optional[Config | dict] = None):
        if isinstance(config, dict):
            config = Config(config)
        self.name = name
        self.settings = Settings((config or Config()).with_fallback(reference_config()))
        cfg = self.settings.config

        self.event_stream = EventStream(debug=self.settings.debug_event_stream)
        self._stdout_logger = StdOutLogger(level_for(self.settings.stdout_loglevel))
        self.event_stream.attach_tap(self._stdout_filtered)

        # flight recorder: runtime-selected tracing SPI, noop by default
        # (JFRActorFlightRecorder selection parity, SURVEY.md §2.10 item 9)
        from ..event.flight_recorder import from_config as _fr_from_config
        self.flight_recorder = _fr_from_config(cfg)

        # metrics registry: the other half of the telemetry plane
        # (event/metrics.py) — None unless akka.metrics.enabled; the
        # tpu-batched dispatcher wires its device slab and stats
        # collectors into it (docs/OBSERVABILITY.md)
        from ..event.metrics import from_config as _metrics_from_config
        self.metrics_registry = _metrics_from_config(cfg)

        # causal tracing: sampled request->wave->step spans (event/
        # tracing.py) — None unless akka.tracing.enabled; the gateway
        # picks it up from the system and threads it through the serving
        # path (docs/OBSERVABILITY.md tracing section)
        from ..event.tracing import from_config as _tracer_from_config
        self.tracer = _tracer_from_config(cfg)
        if self.tracer is not None and self.metrics_registry is not None \
                and self.tracer.step_fn is None:
            # default step source: the registry's shared ATT_STEP axis
            self.tracer.step_fn = lambda: self.metrics_registry.step

        # multi-process data plane: opt-in process group (this process's
        # rank), so meshes built over it span every process
        self._started_group = False
        if cfg.get_bool("akka.jax-distributed.enabled", False):
            from ..parallel.mesh import \
                maybe_initialize_distributed_from_config
            self._started_group = \
                maybe_initialize_distributed_from_config(cfg)

        if cfg.get_string("akka.scheduler.implementation",
                          "default") == "native":
            # the C++ hashed wheel (LightArrayRevolverScheduler parity);
            # raises when the native library cannot be built
            from ..native.integration import NativeScheduler
            self.scheduler = NativeScheduler(
                tick_duration=cfg.get_duration(
                    "akka.scheduler.tick-duration", "10ms"),
                ticks_per_wheel=cfg.get_int(
                    "akka.scheduler.ticks-per-wheel", 512))
        else:
            self.scheduler = Scheduler(
                tick_duration=cfg.get_duration("akka.scheduler.tick-duration", "10ms"),
                ticks_per_wheel=cfg.get_int("akka.scheduler.ticks-per-wheel", 512),
                name=f"akka-tpu-scheduler-{name}")

        self.dispatchers = Dispatchers(self.settings, self)
        # register the flagship device dispatcher type, unconditionally
        # (extension seam; reference: dispatch/Dispatchers.scala:235-259)
        register_tpu_dispatcher_type(self.dispatchers)
        self.mailboxes = Mailboxes(self.settings, self.event_stream)
        if cfg.get_bool("akka.actor.native-mailboxes"):
            # raises when the native library cannot be built
            from ..native.integration import register_native_mailbox
            try:
                register_native_mailbox(self.mailboxes)
            except RuntimeError:
                self.scheduler.shutdown()
                raise
        provider_kind = self.settings.provider_kind
        if provider_kind in ("remote", "cluster"):
            from ..remote.provider import RemoteActorRefProvider
            self.provider = RemoteActorRefProvider(name, self.settings, self.event_stream)
        else:
            self.provider = LocalActorRefProvider(name, self.settings, self.event_stream)

        self.dead_letters = self.provider.dead_letters
        self.log = LoggingAdapter(self.event_stream, f"ActorSystem({name})",
                                  level=level_for(self.settings.loglevel))
        self._extensions: Dict[Any, Any] = {}
        self._ext_lock = threading.RLock()
        self._terminated = threading.Event()
        self._termination_callbacks: list[Callable[[], None]] = []
        self.start_time = time.time()

        self.provider.init(self)
        self.coordinated_shutdown = CoordinatedShutdown(self)
        self.coordinated_shutdown.add_task(
            CoordinatedShutdown.PHASE_ACTOR_SYSTEM_TERMINATE, "terminate-system",
            self._terminate_guardians)
        self._dead_letter_count = 0
        if self.settings.log_dead_letters:
            self.event_stream.subscribe(self._on_dead_letter, DeadLetter)

        if provider_kind in ("remote", "cluster"):
            try:
                self.provider.post_init(self)
            except BaseException:
                # a transport that cannot start (a bad PEM file, a bound
                # port) leaves no thread of this system running
                self.terminate()
                self.await_termination(10.0)
                raise

    # -- factory -------------------------------------------------------------
    @staticmethod
    def create(name: str = "default", config: Optional[Config | dict] = None) -> "ActorSystem":
        return ActorSystem(name, config)

    # -- logging taps ---------------------------------------------------------
    def _stdout_filtered(self, event: Any) -> None:
        if isinstance(event, LogEvent):
            self._stdout_logger(event)

    def _on_dead_letter(self, event: DeadLetter) -> None:
        self._dead_letter_count += 1
        n = self.settings.log_dead_letters
        if self._dead_letter_count <= n:
            suffix = " (further dead letters will not be logged)" if self._dead_letter_count == n else ""
            self.log.info(
                f"Message [{type(event.message).__name__}] to {event.recipient} was not "
                f"delivered. [{self._dead_letter_count}] dead letters encountered{suffix}.")

    # -- actor factory surface (reference: ActorSystem.actorOf :886-887) ------
    def actor_of(self, props: Props, name: Optional[str] = None) -> ActorRef:
        return self.provider.guardian.cell.actor_of(props, name)

    spawn = actor_of

    def system_actor_of(self, props: Props, name: Optional[str] = None) -> ActorRef:
        return self.provider.system_guardian.cell.actor_of(props, name)

    def stop(self, ref: ActorRef) -> None:
        ref.stop()

    def actor_selection(self, path: str) -> ActorRef:
        return self.provider.resolve_actor_ref(path)

    @property
    def address(self) -> Address:
        return self.provider.default_address

    # -- extensions ------------------------------------------------------------
    def register_extension(self, ext_id: ExtensionId) -> Any:
        with self._ext_lock:
            key = type(ext_id) if not isinstance(ext_id, type) else ext_id
            if key not in self._extensions:
                self._extensions[key] = ext_id.create_extension(self)
            return self._extensions[key]

    def has_extension(self, ext_id: Any) -> bool:
        key = type(ext_id) if not isinstance(ext_id, type) else ext_id
        return key in self._extensions

    # -- termination ------------------------------------------------------------
    def terminate(self) -> None:
        threading.Thread(target=self.coordinated_shutdown.run,
                         args=("terminate",), daemon=True,
                         name=f"akka-tpu-shutdown-{self.name}").start()

    def _terminate_guardians(self) -> None:
        self.provider.guardian.stop()
        # root guardian stop cascades via provider.actor_terminated

    def _finish_terminate(self) -> None:
        self.dispatchers.shutdown()
        self.scheduler.shutdown()
        self.flight_recorder.close()
        if self.metrics_registry is not None:
            self.metrics_registry.close()
        if self.tracer is not None:
            self.tracer.close()
        if self._started_group:
            from ..parallel.mesh import shutdown_distributed
            shutdown_distributed()
        self._terminated.set()
        for cb in self._termination_callbacks:
            try:
                cb()
            except Exception:  # noqa: BLE001
                pass

    def register_on_termination(self, cb: Callable[[], None]) -> None:
        if self._terminated.is_set():
            cb()
        else:
            self._termination_callbacks.append(cb)

    def await_termination(self, timeout: Optional[float] = None) -> bool:
        return self._terminated.wait(timeout)

    @property
    def when_terminated(self) -> threading.Event:
        return self._terminated

    @property
    def is_terminated(self) -> bool:
        return self._terminated.is_set()

    def __enter__(self) -> "ActorSystem":
        return self

    def __exit__(self, *exc) -> None:
        self.terminate()
        self.await_termination(10.0)

    def __repr__(self) -> str:
        return f"ActorSystem({self.name})"
