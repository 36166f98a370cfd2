"""Multi-node testkit: N role-named systems in one process, with barriers and

A copy of `akka_tpu/testkit/multi_node.py` at commit 5834bbc (host
code, no jax; the port keeps its own copy of every module it needs).
link fault injection.

Reference parity: akka-multi-node-testkit — MultiNodeSpec roles + runOn +
enterBarrier (remote/testkit/MultiNodeSpec.scala:258,373,388-401) and the
TestConductor's throttle/blackhole/passThrough/disconnect/shutdown
(remote/testconductor/Conductor.scala:128,148,177,188,230-239). The reference
runs one JVM per role on one machine; we run one ActorSystem per role in one
process over the fault-injectable InProcTransport — the same fidelity point
(real serialization + real transport hops, no real network). TPU-wise this is
the host-control-plane analogue of simulating a multi-chip mesh with
xla_force_host_platform_device_count (see tests/conftest.py).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

from ..actor.system import ActorSystem
from ..remote.transport import InProcTransport


class BarrierTimeout(AssertionError):
    pass


class TestConductor:
    """Link-level fault injection between roles (reference:
    remote/testconductor/Conductor.scala)."""

    def __init__(self, kit: "MultiNodeKit"):
        self._kit = kit
        self._fi = InProcTransport.fault_injector

    def _addr(self, role: str) -> str:
        return self._kit.transport_address(role)

    def blackhole(self, from_role: str, to_role: str, both: bool = True) -> None:
        self._fi.blackhole(self._addr(from_role), self._addr(to_role))
        if both:
            self._fi.blackhole(self._addr(to_role), self._addr(from_role))

    def throttle(self, from_role: str, to_role: str,
                 rate_msgs_per_sec: float) -> None:
        self._fi.throttle(self._addr(from_role), self._addr(to_role),
                          rate_msgs_per_sec)

    def pass_through(self, from_role: str, to_role: str, both: bool = True) -> None:
        self._fi.pass_through(self._addr(from_role), self._addr(to_role))
        if both:
            self._fi.pass_through(self._addr(to_role), self._addr(from_role))

    disconnect = blackhole

    def shutdown(self, role: str) -> None:
        """Hard-kill a node: transport drops first (no graceful goodbye), then
        the system dies (reference: Conductor.shutdown :230-239)."""
        system = self._kit.systems.pop(role, None)
        if system is None:
            return
        system.provider.shutdown_transport()
        system.terminate()
        system.await_termination(10.0)

    def reset(self) -> None:
        self._fi.reset()


class MultiNodeKit:
    """Spin up one remote-enabled ActorSystem per role.

    kit = MultiNodeKit(["first", "second", "third"])
    kit.run({"first": fn_a, "second": fn_b})   # concurrent, with barriers
    kit.conductor.blackhole("first", "second")
    """

    def __init__(self, roles: Sequence[str],
                 config: Optional[dict] = None,
                 config_per_role: Optional[Dict[str, dict]] = None,
                 name_prefix: str = "multi"):
        self.roles = list(roles)
        self.systems: Dict[str, ActorSystem] = {}
        self.conductor = TestConductor(self)
        self._barriers: Dict[str, threading.Barrier] = {}
        self._barrier_lock = threading.Lock()
        self._parties = 0
        base = config or {}
        for role in self.roles:
            overrides = _deep_merge(
                {"akka": {"actor": {"provider": "remote"},
                          "stdout-loglevel": "ERROR", "log-dead-letters": 0,
                          "remote": {"transport": "inproc",
                                     "canonical": {"hostname": "local", "port": 0}}}},
                _deep_merge(base, (config_per_role or {}).get(role, {})))
            self.systems[role] = ActorSystem.create(f"{name_prefix}-{role}", overrides)

    # -- addressing -----------------------------------------------------------
    def system(self, role: str) -> ActorSystem:
        return self.systems[role]

    def address(self, role: str) -> str:
        """akka://name@host:port — for actor_selection across nodes."""
        s = self.systems[role]
        a = s.provider.local_address
        return f"akka://{s.name}@{a.host}:{a.port}"

    def transport_address(self, role: str) -> str:
        a = self.systems[role].provider.local_address
        return f"{a.host}:{a.port}"

    def node(self, role: str, path: str):
        """Resolve /user/... on another role from... any system (first role's)."""
        return self.address(role) + path

    # -- concurrent role code + barriers --------------------------------------
    def run(self, fns_by_role: Dict[str, Callable[["NodeHandle"], Any]],
            timeout: float = 30.0) -> Dict[str, Any]:
        """Run each role's fn concurrently (reference: runOn scoping). Each fn
        receives a NodeHandle exposing enter_barrier. Re-raises the first
        failure."""
        self._parties = len(fns_by_role)
        self._barriers.clear()
        results: Dict[str, Any] = {}
        errors: List[BaseException] = []

        def _runner(role: str, fn):
            try:
                results[role] = fn(NodeHandle(self, role))
            except BaseException as e:  # noqa: BLE001
                errors.append(e)
                self._abort_barriers()

        threads = [threading.Thread(target=_runner, args=(r, f),
                                    name=f"multi-node-{r}", daemon=True)
                   for r, f in fns_by_role.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout)
            if t.is_alive():
                self._abort_barriers()
                raise BarrierTimeout(f"role thread {t.name} did not finish in {timeout}s")
        if errors:
            raise errors[0]
        return results

    def _barrier(self, name: str) -> threading.Barrier:
        with self._barrier_lock:
            if name not in self._barriers:
                self._barriers[name] = threading.Barrier(self._parties)
            return self._barriers[name]

    def _abort_barriers(self) -> None:
        with self._barrier_lock:
            for b in self._barriers.values():
                b.abort()

    def enter_barrier(self, name: str, timeout: float = 20.0) -> None:
        try:
            self._barrier(name).wait(timeout)
        except threading.BrokenBarrierError:
            raise BarrierTimeout(f"barrier [{name}] broken/timed out")

    # -- lifecycle ------------------------------------------------------------
    def shutdown(self) -> None:
        for system in self.systems.values():
            system.terminate()
        for system in self.systems.values():
            system.await_termination(10.0)
        self.systems.clear()
        self.conductor.reset()

    def __enter__(self) -> "MultiNodeKit":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()


class NodeHandle:
    """What a role's fn receives inside MultiNodeKit.run."""

    def __init__(self, kit: MultiNodeKit, role: str):
        self.kit = kit
        self.role = role
        self.system = kit.systems[role]

    def enter_barrier(self, name: str, timeout: float = 20.0) -> None:
        self.kit.enter_barrier(name, timeout)


def _deep_merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out
