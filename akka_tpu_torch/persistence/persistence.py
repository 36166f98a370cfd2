"""Persistence extension: plugin registry + recovery permitter.

A copy of `akka_tpu/persistence/persistence.py` at commit 1001e26 (host
code, no jax; the port keeps its own copy of every module it needs).

Reference parity: akka-persistence/src/main/scala/akka/persistence/
Persistence.scala (journalFor/snapshotStoreFor resolve config-path plugin ids
to one actor per plugin, `plugin` default keys) and RecoveryPermitter.scala
(token bucket limiting concurrent recoveries, max-concurrent-recoveries=35).

Plugin ids mirror the reference's config paths:
  akka.persistence.journal.plugin        = "akka.persistence.journal.inmem"
  akka.persistence.snapshot-store.plugin = "akka.persistence.snapshot-store.local"
Custom plugins register a factory under their own id via
`Persistence.register_journal_plugin` (the Dispatchers-registry seam,
reference: Persistence.scala journalFor + dispatch/Dispatchers.scala:184).
"""

from __future__ import annotations

import os
import tempfile
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

from ..actor.actor import Actor
from ..actor.props import Props
from ..actor.ref import ActorRef
from ..actor.system import ActorSystem
from .journal import FileJournal, InMemJournal, JournalActor, JournalPlugin
from .snapshot import (InMemSnapshotStore, LocalSnapshotStore, SnapshotPlugin,
                       SnapshotStoreActor)


# -- recovery permitter (reference: RecoveryPermitter.scala) -----------------

@dataclass(frozen=True)
class RequestRecoveryPermit:
    pass


@dataclass(frozen=True)
class RecoveryPermitGranted:
    pass


@dataclass(frozen=True)
class ReturnRecoveryPermit:
    pass


class RecoveryPermitter(Actor):
    def __init__(self, max_permits: int):
        super().__init__()
        self.max_permits = max_permits
        self.holders: set = set()   # refs that were actually GRANTED
        self.waiting: list = []

    def receive(self, message: Any) -> Any:
        if isinstance(message, RequestRecoveryPermit):
            self.context.watch(self.sender)
            if len(self.holders) < self.max_permits:
                self.holders.add(self.sender)
                self.sender.tell(RecoveryPermitGranted(), self.self_ref)
            else:
                self.waiting.append(self.sender)
        elif isinstance(message, ReturnRecoveryPermit):
            # a Return from an actor still queued (stopped while waiting)
            # must NOT decrement — it never held a permit
            if self.sender in self.holders:
                self._return_permit(self.sender)
            elif self.sender in self.waiting:
                self.waiting.remove(self.sender)
                self.context.unwatch(self.sender)
        else:
            from ..actor.messages import Terminated
            if isinstance(message, Terminated):
                if message.actor in self.waiting:
                    self.waiting.remove(message.actor)
                elif message.actor in self.holders:
                    self._return_permit(message.actor, watched_gone=True)
            else:
                return NotImplemented

    def _return_permit(self, ref: ActorRef, watched_gone: bool = False) -> None:
        if not watched_gone:
            self.context.unwatch(ref)
        self.holders.discard(ref)
        while self.waiting and len(self.holders) < self.max_permits:
            nxt = self.waiting.pop(0)
            self.holders.add(nxt)
            nxt.tell(RecoveryPermitGranted(), self.self_ref)


# -- extension ---------------------------------------------------------------

JOURNAL_INMEM = "akka.persistence.journal.inmem"
JOURNAL_FILE = "akka.persistence.journal.file"
SNAPSHOT_LOCAL = "akka.persistence.snapshot-store.local"
SNAPSHOT_INMEM = "akka.persistence.snapshot-store.inmem"


class Persistence:
    """Obtain via Persistence.get(system)."""

    _instances: Dict[ActorSystem, "Persistence"] = {}
    _lock = threading.Lock()
    # plugin-id -> factory(system, plugin_config) -> plugin object
    _journal_factories: Dict[str, Callable] = {}
    _snapshot_factories: Dict[str, Callable] = {}

    @staticmethod
    def get(system: ActorSystem) -> "Persistence":
        with Persistence._lock:
            inst = Persistence._instances.get(system)
            if inst is None:
                inst = Persistence._instances[system] = Persistence(system)
                system.register_on_termination(
                    lambda: Persistence._instances.pop(system, None))
            return inst

    @staticmethod
    def register_journal_plugin(plugin_id: str, factory: Callable) -> None:
        Persistence._journal_factories[plugin_id] = factory

    @staticmethod
    def register_snapshot_plugin(plugin_id: str, factory: Callable) -> None:
        Persistence._snapshot_factories[plugin_id] = factory

    def __init__(self, system: ActorSystem):
        self.system = system
        cfg = system.settings.config.get_config("akka.persistence")
        self.default_journal_id = cfg.get_string("journal.plugin",
                                                 JOURNAL_INMEM)
        self.default_snapshot_id = cfg.get_string("snapshot-store.plugin",
                                                  SNAPSHOT_INMEM)
        self.max_concurrent_recoveries = cfg.get_int(
            "max-concurrent-recoveries", 35)
        self._journals: Dict[str, ActorRef] = {}
        self._journal_plugins: Dict[str, JournalPlugin] = {}
        self._event_adapters: Dict[str, Any] = {}  # plugin-id -> EventAdapters
        self._snapshots: Dict[str, ActorRef] = {}
        self._snapshot_plugins: Dict[str, SnapshotPlugin] = {}
        self._counter = 0
        self._instance_lock = threading.Lock()
        self.recovery_permitter = system.system_actor_of(
            Props.create(RecoveryPermitter, self.max_concurrent_recoveries),
            "recoveryPermitter")

    def _plugin_config(self, plugin_id: str):
        return self.system.settings.config.get_config(plugin_id)

    def _plugin_dir(self, configured: str) -> str:
        """Relative plugin dirs (reference default `journal`/`snapshots`) are
        rooted per system under the temp directory so concurrent systems
        don't collide and the repo cwd stays clean. The reference roots them
        under /tmp; the port under tempfile.gettempdir(), which honours
        TMPDIR (and is /tmp without it)."""
        if os.path.isabs(configured):
            return configured
        return os.path.join(tempfile.gettempdir(),
                            f"akka-tpu-{self.system.name}", configured)

    def _make_journal_plugin(self, plugin_id: str) -> JournalPlugin:
        factory = Persistence._journal_factories.get(plugin_id)
        if factory is not None:
            return factory(self.system, self._plugin_config(plugin_id))
        if plugin_id == JOURNAL_INMEM:
            return InMemJournal()
        if plugin_id == JOURNAL_FILE:
            d = self._plugin_dir(
                self._plugin_config(plugin_id).get_string("dir", "journal"))
            return FileJournal(d)
        raise ValueError(f"unknown journal plugin id {plugin_id!r}")

    def _make_snapshot_plugin(self, plugin_id: str) -> SnapshotPlugin:
        factory = Persistence._snapshot_factories.get(plugin_id)
        if factory is not None:
            return factory(self.system, self._plugin_config(plugin_id))
        if plugin_id == SNAPSHOT_INMEM:
            return InMemSnapshotStore()
        if plugin_id == SNAPSHOT_LOCAL:
            d = self._plugin_dir(
                self._plugin_config(plugin_id).get_string("dir", "snapshots"))
            return LocalSnapshotStore(d)
        raise ValueError(f"unknown snapshot plugin id {plugin_id!r}")

    def register_event_adapters(self, plugin_id: str, adapters) -> None:
        """Bind an EventAdapters registry to a journal plugin id BEFORE its
        first use (reference: the per-journal event-adapters config block,
        EventAdapters.scala:25). Late registration raises — adapters must
        see every write."""
        pid = plugin_id or self.default_journal_id
        with self._instance_lock:
            if pid in self._journals:
                raise RuntimeError(
                    f"journal '{pid}' already started; register event "
                    f"adapters before the first persistence use")
            self._event_adapters[pid] = adapters

    def journal_for(self, plugin_id: str = "") -> ActorRef:
        pid = plugin_id or self.default_journal_id
        with self._instance_lock:
            ref = self._journals.get(pid)
            if ref is None:
                plugin = self._make_journal_plugin(pid)
                self._journal_plugins[pid] = plugin
                name = f"journal-{len(self._journals)}"
                ref = self._journals[pid] = self.system.system_actor_of(
                    Props.create(JournalActor, plugin,
                                 self._event_adapters.get(pid)), name)
            return ref

    def journal_plugin_for(self, plugin_id: str = "") -> JournalPlugin:
        """The underlying sync plugin (persistence-query reads through it)."""
        pid = plugin_id or self.default_journal_id
        self.journal_for(pid)
        return self._journal_plugins[pid]

    def snapshot_store_for(self, plugin_id: str = "") -> ActorRef:
        pid = plugin_id or self.default_snapshot_id
        with self._instance_lock:
            ref = self._snapshots.get(pid)
            if ref is None:
                plugin = self._make_snapshot_plugin(pid)
                self._snapshot_plugins[pid] = plugin
                name = f"snapshotStore-{len(self._snapshots)}"
                ref = self._snapshots[pid] = self.system.system_actor_of(
                    Props.create(SnapshotStoreActor, plugin), name)
            return ref

    def next_instance_id(self) -> int:
        with self._instance_lock:
            self._counter += 1
            return self._counter
