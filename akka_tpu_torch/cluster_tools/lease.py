"""Coordination lease: pluggable distributed lock API.

A copy of `akka_tpu/cluster_tools/lease.py` at commit c056b95 (host code,
no jax; the port keeps its own copy of every module it needs). Two
changes: each lease's heartbeat is one thread that `release()` and
`_stop_heartbeat()` join (and the provider stops its leases' heartbeats
at the system's termination), and `FileLease.directory` defaults under
`tempfile.gettempdir()`, not `/tmp`.

Reference parity: akka-coordination/src/main/scala/akka/coordination/lease/
scaladsl/LeaseProvider.scala (:35 — config-driven impl lookup) and
Lease.scala (acquire/release/checkLease + granted-callback on lost lease),
LeaseSettings.scala (lease-name, owner-name, heartbeat-timeout/interval).

`InProcLease` is the reference implementation for single-process multi-"node"
tests (the analogue of a Kubernetes-lease backend): a process-global table
keyed by lease name, with TTL expiry so a crashed owner's lease can be taken
over after heartbeat-timeout.
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

from ..actor.system import ActorSystem, ExtensionId


@dataclass(frozen=True)
class TimeoutSettings:
    """(reference: lease/TimeoutSettings.scala)"""
    heartbeat_interval: float = 0.5
    heartbeat_timeout: float = 5.0
    operation_timeout: float = 2.0


@dataclass(frozen=True)
class LeaseSettings:
    """(reference: lease/LeaseSettings.scala)"""
    lease_name: str
    owner_name: str
    timeout: TimeoutSettings = TimeoutSettings()


class Lease:
    """Base lease API (reference: lease/scaladsl/Lease.scala). Implementations
    must be safe to call from any thread."""

    def __init__(self, settings: LeaseSettings):
        self.settings = settings

    def acquire(self, lease_lost_callback:
                Optional[Callable[[Optional[Exception]], None]] = None) -> bool:
        raise NotImplementedError

    def release(self) -> bool:
        raise NotImplementedError

    def check_lease(self) -> bool:
        """True only if this owner holds the lease (and it has not expired)."""
        raise NotImplementedError


class _Heartbeat:
    """A lease's heartbeat: one thread that calls `lease._beat()` every
    heartbeat interval until it returns False or `stop()` is called.
    `start()` restarts it; `stop()` joins the thread (the reference chains
    one `threading.Timer` per beat and joins none)."""

    def __init__(self, lease: "Lease"):
        self.lease = lease
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stopped: Optional[threading.Event] = None

    def start(self) -> None:
        self.stop()
        stopped = threading.Event()
        interval = self.lease.settings.timeout.heartbeat_interval

        def run():
            while not stopped.wait(interval):
                if not self.lease._beat():
                    return

        t = threading.Thread(target=run, daemon=True,
                             name=f"lease-{self.lease.settings.lease_name}")
        with self._lock:
            self._thread, self._stopped = t, stopped
        t.start()

    def stop(self) -> None:
        with self._lock:
            t, stopped = self._thread, self._stopped
            self._thread = self._stopped = None
        if t is None:
            return
        stopped.set()
        if t is not threading.current_thread():
            t.join()


class _LeaseRecord:
    __slots__ = ("owner", "deadline", "lost_cb")

    def __init__(self, owner: str, deadline: float, lost_cb):
        self.owner = owner
        self.deadline = deadline
        self.lost_cb = lost_cb


class InProcLease(Lease):
    """Process-global lease table with TTL; take-over allowed after the
    current owner's TTL expires (expiry triggers its lost-callback)."""

    _table: Dict[str, _LeaseRecord] = {}
    _lock = threading.Lock()

    def __init__(self, settings: LeaseSettings):
        super().__init__(settings)
        self._heartbeat = _Heartbeat(self)

    @classmethod
    def reset_all(cls) -> None:
        with cls._lock:
            cls._table.clear()

    def _ttl(self) -> float:
        return self.settings.timeout.heartbeat_timeout

    def acquire(self, lease_lost_callback=None) -> bool:
        name, owner = self.settings.lease_name, self.settings.owner_name
        now = time.monotonic()
        with InProcLease._lock:
            rec = InProcLease._table.get(name)
            if rec is not None and rec.owner != owner and rec.deadline > now:
                return False
            if rec is not None and rec.owner != owner and rec.deadline <= now:
                if rec.lost_cb:
                    try:
                        rec.lost_cb(None)
                    except Exception:
                        pass
            InProcLease._table[name] = _LeaseRecord(
                owner, now + self._ttl(), lease_lost_callback)
        self._start_heartbeat()
        return True

    def _start_heartbeat(self) -> None:
        self._heartbeat.start()

    def _stop_heartbeat(self) -> None:
        self._heartbeat.stop()

    def _beat(self) -> bool:
        name, owner = self.settings.lease_name, self.settings.owner_name
        with InProcLease._lock:
            rec = InProcLease._table.get(name)
            if rec is None or rec.owner != owner:
                return False  # lost; stop beating
            rec.deadline = time.monotonic() + self._ttl()
        return True

    def release(self) -> bool:
        name, owner = self.settings.lease_name, self.settings.owner_name
        self._stop_heartbeat()
        with InProcLease._lock:
            rec = InProcLease._table.get(name)
            if rec is not None and rec.owner == owner:
                del InProcLease._table[name]
            return True

    def check_lease(self) -> bool:
        name, owner = self.settings.lease_name, self.settings.owner_name
        with InProcLease._lock:
            rec = InProcLease._table.get(name)
            return (rec is not None and rec.owner == owner
                    and rec.deadline > time.monotonic())


class FileLease(Lease):
    """Cross-PROCESS lease backed by an atomically-created lock file with a
    TTL (the single-host analogue of a Kubernetes-lease backend; used by the
    real-process SBR lease-majority tests). Layout: one JSON file per lease
    name under `FileLease.directory` holding {owner, deadline} (wall clock).

    Every read-check-write cycle (acquire, heartbeat, release) runs under
    an exclusive flock on a sibling .lock file, so contention — including
    two processes racing to take over an EXPIRED lease — has exactly one
    winner; the lease file itself is rewritten via tmp+rename (atomic)."""

    directory: str = os.path.join(tempfile.gettempdir(), "akka-tpu-leases")

    def __init__(self, settings: LeaseSettings):
        super().__init__(settings)
        self._heartbeat = _Heartbeat(self)

    def _path(self) -> str:
        import os
        import re
        os.makedirs(FileLease.directory, exist_ok=True)
        safe = re.sub(r"[^\w.-]", "_", self.settings.lease_name)
        return os.path.join(FileLease.directory, safe + ".lease")

    def _ttl(self) -> float:
        return self.settings.timeout.heartbeat_timeout

    class _flocked:
        """Exclusive advisory lock over the lease's critical sections —
        the cross-process mutex that makes read-check-write atomic."""

        def __init__(self, path: str):
            self._path = path + ".lock"
            self._f = None

        def __enter__(self):
            import fcntl
            self._f = open(self._path, "a+")  # noqa: SIM115 — held past scope
            fcntl.flock(self._f, fcntl.LOCK_EX)
            return self

        def __exit__(self, *exc):
            import fcntl
            fcntl.flock(self._f, fcntl.LOCK_UN)
            self._f.close()
            self._f = None
            return False

    def _read(self):
        import json
        try:
            with open(self._path(), "r", encoding="utf-8") as f:
                return json.loads(f.read())
        except (OSError, ValueError):
            return None

    def _write(self) -> None:
        import json
        import os
        tmp = self._path() + f".{os.getpid()}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(json.dumps({"owner": self.settings.owner_name,
                                "deadline": time.time() + self._ttl()}))
        os.replace(tmp, self._path())

    def acquire(self, lease_lost_callback=None) -> bool:
        with self._flocked(self._path()):
            rec = self._read()
            if rec is not None \
                    and rec.get("owner") != self.settings.owner_name \
                    and rec.get("deadline", 0) > time.time():
                return False  # held by a live other owner
            self._write()     # fresh, expired, or our own: (re)claim
        self._start_heartbeat()
        return True

    def _start_heartbeat(self) -> None:
        self._heartbeat.start()

    def _stop_heartbeat(self) -> None:
        self._heartbeat.stop()

    def _beat(self) -> bool:
        with self._flocked(self._path()):
            rec = self._read()
            if rec is None or \
                    rec.get("owner") != self.settings.owner_name:
                return False  # lost; stop beating
            try:
                self._write()
            except OSError:
                return False
        return True

    def release(self) -> bool:
        self._stop_heartbeat()
        with self._flocked(self._path()):
            rec = self._read()
            if rec is not None and \
                    rec.get("owner") == self.settings.owner_name:
                try:
                    os.unlink(self._path())
                except OSError:
                    pass
        return True

    def check_lease(self) -> bool:
        rec = self._read()
        return (rec is not None
                and rec.get("owner") == self.settings.owner_name
                and rec.get("deadline", 0) > time.time())


_LEASE_IMPLS: Dict[str, Callable[[LeaseSettings], Lease]] = {
    "in-proc": InProcLease,
    "file": FileLease,
}


def register_lease_impl(name: str, factory: Callable[[LeaseSettings], Lease]) -> None:
    """Config-style extension seam (reference: LeaseProvider loads the
    `lease-class` FQCN from config; here a registry name)."""
    _LEASE_IMPLS[name] = factory


class LeaseProvider(ExtensionId):
    """(reference: lease/scaladsl/LeaseProvider.scala:35) — per-system cache
    of (impl, lease-name, owner) -> Lease instance."""

    def create_extension(self, system: ActorSystem) -> "_LeaseProviderExt":
        return _LeaseProviderExt(system)

    @staticmethod
    def get(system: ActorSystem) -> "_LeaseProviderExt":
        return system.register_extension(LeaseProvider())


class _LeaseProviderExt:
    def __init__(self, system: ActorSystem):
        self.system = system
        self._leases: Dict[tuple, Lease] = {}
        self._lock = threading.Lock()
        system.coordinated_shutdown.add_task(
            "before-actor-system-terminate", "lease-provider-close",
            self._close_all)

    def _close_all(self) -> None:
        """As the system terminates: join every heartbeat of the leases
        it handed out. Held leases are not released; they expire after
        their TTL, as a crashed node's do."""
        with self._lock:
            leases = list(self._leases.values())
        for lease in leases:
            stop = getattr(lease, "_stop_heartbeat", None)
            if stop is not None:
                stop()

    def get_lease(self, lease_name: str, config_path: str,
                  owner_name: str) -> Lease:
        key = (lease_name, config_path, owner_name)
        with self._lock:
            if key not in self._leases:
                cfg = self.system.settings.config
                impl = cfg.get_string(f"{config_path}.lease-implementation",
                                      "in-proc")
                timeout = TimeoutSettings(
                    heartbeat_interval=cfg.get_duration(
                        f"{config_path}.heartbeat-interval", 0.5),
                    heartbeat_timeout=cfg.get_duration(
                        f"{config_path}.heartbeat-timeout", 5.0))
                settings = LeaseSettings(lease_name, owner_name, timeout)
                self._leases[key] = _LEASE_IMPLS[impl](settings)
            return self._leases[key]
