"""Dispatchers: bind actors to executors; the executeMailbox hot path.

A copy of `akka_tpu/dispatch/dispatcher.py` at commit 5d9b7cd (host code, no
jax; the port keeps its own copy of every module it needs).

Reference parity: akka-actor/src/main/scala/akka/dispatch/Dispatcher.scala
(`dispatch` = enqueue + registerForExecution :61-65; the CAS-schedule
:120-143) and AbstractDispatcher.scala (attach/detach/inhabitants :95-327).
PinnedDispatcher (dispatch/PinnedDispatcher.scala) dedicates one thread per
actor. CallingThreadDispatcher (testkit) runs receive on the caller's thread
for deterministic tests (akka-testkit/.../CallingThreadDispatcher.scala).

On TPU the real hot path bypasses all of this — see batched.py — but host
actors (IO, control plane, cluster daemons) run here.
"""

from __future__ import annotations

import os
import threading
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

from .mailbox import (AtomicInt, Envelope, Mailbox, Mailboxes, MailboxType,
                      UnboundedMailbox)
from . import sysmsg


class MessageDispatcher:
    """Base: lifecycle accounting + the dispatch contract
    (reference: dispatch/AbstractDispatcher.scala:95-327)."""

    def __init__(self, dispatchers: "Any", id: str, throughput: int = 64,
                 throughput_deadline: float = 0.0, shutdown_timeout: float = 1.0):
        self.dispatchers = dispatchers
        self.id = id
        self.throughput = throughput
        self.throughput_deadline = throughput_deadline
        self.shutdown_timeout = shutdown_timeout
        self._inhabitants = AtomicInt(0)
        self._shutdown_lock = threading.Lock()

    # -- attach/detach ------------------------------------------------------
    def attach(self, cell) -> None:
        self.register(cell)
        self.register_for_execution(cell.mailbox, False, True)

    def detach(self, cell) -> None:
        try:
            self.unregister(cell)
        finally:
            self.if_sensible_to_do_something_do_it()

    def register(self, cell) -> None:
        self._inhabitants.get_and_add(1)

    def unregister(self, cell) -> None:
        self._inhabitants.get_and_add(-1)
        mailbox = cell.swap_mailbox(None)
        if mailbox is not None:
            mailbox.become_closed()
            mailbox.clean_up()

    def if_sensible_to_do_something_do_it(self) -> None:
        pass

    @property
    def inhabitants(self) -> int:
        return self._inhabitants.get()

    # -- the dispatch contract ----------------------------------------------
    def create_mailbox(self, cell, mailbox_type: MailboxType) -> Mailbox:
        mb = Mailbox(mailbox_type.create(cell.self_ref, cell.system))
        mb.dispatcher = self
        return mb

    def dispatch(self, cell, envelope: Envelope) -> None:
        mbox = cell.mailbox
        mbox.enqueue(cell.self_ref, envelope)
        self.register_for_execution(mbox, True, False)

    def system_dispatch(self, cell, message: sysmsg.SystemMessage) -> None:
        mbox = cell.mailbox
        mbox.system_enqueue(cell.self_ref, message)
        self.register_for_execution(mbox, False, True)

    def register_for_execution(self, mbox: Optional[Mailbox], has_message_hint: bool,
                               has_system_message_hint: bool) -> bool:
        raise NotImplementedError

    def execute(self, fn) -> None:
        """Run an arbitrary task on this dispatcher's executor."""
        raise NotImplementedError

    def shutdown(self) -> None:
        pass


class Dispatcher(MessageDispatcher):
    """Event-based dispatcher over a shared thread pool
    (reference: dispatch/Dispatcher.scala)."""

    def __init__(self, dispatchers, id: str, throughput: int = 64,
                 throughput_deadline: float = 0.0, shutdown_timeout: float = 1.0,
                 pool_size: int = 0, executor: Optional[ThreadPoolExecutor] = None):
        super().__init__(dispatchers, id, throughput, throughput_deadline, shutdown_timeout)
        workers = pool_size or min(32, (os.cpu_count() or 4))
        self._executor = executor or ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix=f"akka-tpu-{id}")
        self._owns_executor = executor is None

    def register_for_execution(self, mbox, has_message_hint, has_system_message_hint) -> bool:
        if mbox is None:
            return False
        if mbox.can_be_scheduled_for_execution(has_message_hint, has_system_message_hint):
            if mbox.set_as_scheduled():
                try:
                    self._executor.submit(mbox.run)
                    return True
                except RuntimeError:
                    mbox.set_as_idle()
                    return False
        return False

    def execute(self, fn) -> None:
        self._executor.submit(fn)

    def shutdown(self) -> None:
        if self._owns_executor:
            self._executor.shutdown(wait=False, cancel_futures=True)


class PinnedDispatcher(Dispatcher):
    """One dedicated thread per actor (reference: dispatch/PinnedDispatcher.scala)."""

    def __init__(self, dispatchers, id: str, throughput: int = 1,
                 shutdown_timeout: float = 1.0):
        super().__init__(dispatchers, id, throughput=throughput,
                         shutdown_timeout=shutdown_timeout,
                         executor=ThreadPoolExecutor(max_workers=1,
                                                     thread_name_prefix=f"akka-tpu-pinned-{id}"))
        self._owns_executor = True


class CallingThreadDispatcher(MessageDispatcher):
    """Processes the mailbox synchronously on the sending thread — the
    deterministic-test dispatcher (reference: akka-testkit
    CallingThreadDispatcher.scala). Reentrant sends are queued and drained
    iteratively to avoid unbounded recursion."""

    def __init__(self, dispatchers=None, id: str = "calling-thread-dispatcher"):
        super().__init__(dispatchers, id, throughput=1)
        self._draining = threading.local()

    def register_for_execution(self, mbox, has_message_hint, has_system_message_hint) -> bool:
        if mbox is None:
            return False
        if getattr(self._draining, "active", False):
            # already draining higher up the stack; outer loop will pick it up
            self._draining.pending.append(mbox)
            return True
        self._draining.active = True
        self._draining.pending = [mbox]
        try:
            while self._draining.pending:
                m = self._draining.pending.pop(0)
                if m.can_be_scheduled_for_execution(True, True) and m.set_as_scheduled():
                    m.run()
        finally:
            self._draining.active = False
        return True

    def execute(self, fn) -> None:
        fn()


class DispatcherConfigurator:
    """Config section -> dispatcher instance
    (reference: MessageDispatcherConfigurator, AbstractDispatcher.scala:338-381)."""

    def __init__(self, config, dispatchers):
        self.config = config
        self.dispatchers = dispatchers

    def dispatcher(self) -> MessageDispatcher:
        raise NotImplementedError


class _StdDispatcherConfigurator(DispatcherConfigurator):
    def __init__(self, config, dispatchers, id: str):
        super().__init__(config, dispatchers)
        self.id = id
        self._instance: Optional[Dispatcher] = None
        self._lock = threading.Lock()

    def dispatcher(self) -> MessageDispatcher:
        with self._lock:
            if self._instance is None:
                c = self.config
                self._instance = Dispatcher(
                    self.dispatchers, self.id,
                    throughput=c.get_int("throughput", 64),
                    throughput_deadline=c.get_duration("throughput-deadline-time", 0.0),
                    shutdown_timeout=c.get_duration("shutdown-timeout", "1s"),
                    pool_size=c.get_int("thread-pool-executor.fixed-pool-size", 0),
                )
            return self._instance


class _PinnedDispatcherConfigurator(DispatcherConfigurator):
    def __init__(self, config, dispatchers, id: str):
        super().__init__(config, dispatchers)
        self.id = id
        self._instances: list[PinnedDispatcher] = []
        self._lock = threading.Lock()

    def dispatcher(self) -> MessageDispatcher:
        # a new pinned dispatcher per lookup (one per actor)
        d = PinnedDispatcher(self.dispatchers, self.id,
                             shutdown_timeout=self.config.get_duration("shutdown-timeout", "1s"))
        with self._lock:
            self._instances.append(d)
        return d

    def shutdown_all(self) -> None:
        with self._lock:
            for d in self._instances:
                d.shutdown()
            self._instances.clear()


class _CallingThreadDispatcherConfigurator(DispatcherConfigurator):
    def __init__(self, config, dispatchers, id: str):
        super().__init__(config, dispatchers)
        self.id = id
        self._instance = CallingThreadDispatcher(dispatchers, id)

    def dispatcher(self) -> MessageDispatcher:
        return self._instance


class Dispatchers:
    """THE extension point: config-driven dispatcher lookup by id, with a
    `type` string selecting the backend and runtime registration of custom
    configurators (reference: dispatch/Dispatchers.scala:121,184-185,235-259).
    The `tpu-batched` type (registered by akka_tpu_torch.dispatch.batched) is the
    flagship backend per BASELINE.json."""

    DEFAULT_DISPATCHER_ID = "akka.actor.default-dispatcher"
    INTERNAL_DISPATCHER_ID = "akka.actor.internal-dispatcher"

    def __init__(self, settings, system: Any = None):
        self.settings = settings
        self.system = weakref.proxy(system) if system is not None else None
        self._configurators: dict[str, DispatcherConfigurator] = {}
        self._type_factories: dict[str, Any] = {}
        self._lock = threading.Lock()
        self.register_type("Dispatcher", _StdDispatcherConfigurator)
        self.register_type("PinnedDispatcher", _PinnedDispatcherConfigurator)
        self.register_type("CallingThreadDispatcher", _CallingThreadDispatcherConfigurator)

    def register_type(self, type_name: str, factory) -> None:
        """factory(config, dispatchers, id) -> DispatcherConfigurator"""
        self._type_factories[type_name] = factory

    def register_configurator(self, id: str, configurator: DispatcherConfigurator) -> bool:
        with self._lock:
            if id in self._configurators:
                return False
            self._configurators[id] = configurator
            return True

    def has_dispatcher(self, id: str) -> bool:
        return id in self._configurators or self.settings.config.has_path(id)

    def lookup(self, id: str) -> MessageDispatcher:
        return self._lookup_configurator(id).dispatcher()

    def _lookup_configurator(self, id: str) -> DispatcherConfigurator:
        with self._lock:
            c = self._configurators.get(id)
            if c is not None:
                return c
            cfg = self.settings.config.get_config(id)
            type_name = cfg.get_string("type", "Dispatcher")
            factory = self._type_factories.get(type_name)
            if factory is None:
                raise KeyError(f"unknown dispatcher type [{type_name}] for id [{id}]; "
                               f"registered: {sorted(self._type_factories)}")
            c = factory(cfg, self, id)
            self._configurators[id] = c
            return c

    @property
    def default_global_dispatcher(self) -> MessageDispatcher:
        return self.lookup(self.DEFAULT_DISPATCHER_ID)

    @property
    def internal_dispatcher(self) -> MessageDispatcher:
        return self.lookup(self.INTERNAL_DISPATCHER_ID)

    def shutdown(self) -> None:
        with self._lock:
            for c in self._configurators.values():
                inst = getattr(c, "_instance", None)
                if inst is not None:
                    inst.shutdown()
                if hasattr(c, "shutdown_all"):
                    c.shutdown_all()
