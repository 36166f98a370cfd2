"""What the port's remoting and cluster test files share (not a test
module): node configs, the package namespaces the scenarios are written
against, and the bookkeeping behind each file's one fixture.

A scenario is a function `scenario(P, nodes, *args) -> trace`, written
once against a package namespace `P` (`package("akka_tpu")` or
`package("akka_tpu_torch")`). `side_by_side` runs it on the reference,
then on the port, each package on its own wire (its own in-proc
transport, or its own TCP / TLS pairs on 127.0.0.1 port 0), and holds
the port's trace (replies, Terminated and Quarantined events, member
statuses, routee counts, in order) to the reference's. Two live systems
of different packages cannot share a wire: each trusts only its own
package's control classes. Addresses enter a trace through `norm`,
which drops the port number (each package numbers its ports alone).

Every remote or cluster ActorSystem of a test starts through `Nodes`
(the file's fixture), on the in-proc transport or on TCP / TLS bound to
127.0.0.1 port 0 (the bound address is read back from the provider; no
fixed port). `close()` terminates every system and asserts
`await_termination(10.0)` (the reference's systems that hold device
actors are finished by hand, as `torch_actor_fixture.Actors` does; a
reference TCP node's accept thread, which its shutdown closes the socket
under but never wakes, is woken by one loopback connect; a reference
cluster node whose members are all Exiting has no leader to remove it,
ROADMAP section C, and the leaves' 5 s waits are ended once every
remaining node's gossip shows that state), then
asserts that each port transport's threads are joined and that no thread
the test started is still alive (5 s join), and resets the in-proc fault
injectors of both packages.
"""

import importlib
import re
import socket
import time
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import torch

from torch_actor_fixture import Actors

PKI = Path(__file__).resolve().parent / "data" / "torch_pki"
PACKAGES = ("akka_tpu", "akka_tpu_torch")
WAIT = 10.0         # every ask, probe and condition wait of these tests
# the membership settings of the reference's sharding tests
# (tests/test_sharding.py FAST): gossip and leader actions every 0.05 s,
# heartbeats every 0.1 s with a 2 s acceptable pause, no downing
SHARDING_CLUSTER = {"gossip-interval": "0.05s",
                    "leader-actions-interval": "0.05s",
                    "unreachable-nodes-reaper-interval": "0.1s",
                    "failure-detector": {
                        "heartbeat-interval": "0.1s",
                        "acceptable-heartbeat-pause": "2s"}}


def package(name: str) -> SimpleNamespace:
    """The modules of one package a scenario uses, by short names;
    `device_array` makes the package's device array of a numpy array (a
    torch tensor in the port, a jax.Array in the reference)."""
    def m(sub):
        return importlib.import_module(f"{name}.{sub}")

    root = importlib.import_module(name)
    port = name == "akka_tpu_torch"
    return SimpleNamespace(
        name=name, ActorSystem=root.ActorSystem, Actor=root.Actor,
        Props=root.Props, ask_sync=root.ask_sync, PoisonPill=root.PoisonPill,
        Terminated=root.Terminated, Deploy=root.Deploy,
        RemoteScope=root.RemoteScope, DeadLetter=root.DeadLetter,
        provider=m("remote.provider"), transport=m("remote.transport"),
        deploy=m("remote.deploy"), instrument=m("remote.instrument"),
        cluster=m("cluster"), pki=m("pki"),
        router=m("routing.router"), testkit=m("testkit"),
        serialization=m("serialization.serialization"),
        actor_deploy=m("actor.deploy"), path=m("actor.path"),
        config=m("config"),
        device_array=torch.from_numpy if port else jnp.asarray)


def norm(text: str) -> str:
    """`text` with every address's port dropped: akka://s@h:123/x ->
    akka://s@h/x."""
    return re.sub(r"(@[\w.\-]+):\d+", r"\1", str(text))


def config(transport: str = "inproc", provider: str = "remote",
           cluster=None, tls=None, actor=None, remote=None) -> dict:
    """A node's config: `transport` inproc (host "local"), tcp or tls-tcp
    (127.0.0.1), port 0; `tls` the stem of a certificate pair under
    tests/data/torch_pki (node0, node1, rogue)."""
    host = "local" if transport == "inproc" else "127.0.0.1"
    rem = {"transport": transport,
           "canonical": {"hostname": host, "port": 0}}
    if tls is not None:
        rem["tls"] = {"cert-file": str(PKI / f"{tls}.crt"),
                      "key-file": str(PKI / f"{tls}.key"),
                      "ca-file": str(PKI / "ca.crt")}
    rem.update(remote or {})
    akka = {"actor": {"provider": provider, **(actor or {})},
            "stdout-loglevel": "OFF", "log-dead-letters": 0,
            "remote": rem}
    if cluster is not None:
        akka["cluster"] = cluster
    return {"akka": akka}


def addr_of(system) -> str:
    """The system's canonical address, `akka://name@host:port`."""
    return str(system.provider.local_address)


def transport_threads(transport) -> list:
    """The threads a port transport started and still holds."""
    threads = list(getattr(transport, "_threads", ()))
    drain = getattr(transport, "_drain_thread", None)
    return threads + ([drain] if drain is not None else [])


def _wake_accept(system) -> None:
    """Wake a shut-down reference TCP transport's accept loop: it blocks
    in accept() on the socket its shutdown closed, and checks its stop
    flag only when a connection arrives."""
    if getattr(system.provider.transport, "_server_sock", None) is None:
        return
    addr = system.provider.local_address
    try:
        socket.create_connection((addr.host, addr.port), timeout=1.0).close()
    except OSError:
        pass


def _leaderless(state) -> bool:
    """A reference cluster node's view in which every member is Exiting
    and none leads: nobody will remove it."""
    return state.leader is None and bool(state.members) and all(
        m.status.value == "Exiting" for m in state.members)


def _reset_injectors() -> None:
    from akka_tpu.remote.transport import InProcTransport as JInProc

    from akka_tpu_torch.remote.transport import InProcTransport
    InProcTransport.fault_injector.reset()
    JInProc.fault_injector.reset()


class Nodes(Actors):
    """Every node, handle and thread of one test."""

    def __init__(self):
        super().__init__(None)
        self.ref_nodes, self.ref_clusters = [], []
        _reset_injectors()

    def node(self, name: str, transport: str = "inproc", P=None,
             device_rows: bool = False, **kw):
        """An ActorSystem of `config(transport, **kw)`: the port's, or the
        reference's when `P` is the reference's namespace (`device_rows`:
        it will hold device actors, so it is finished by hand)."""
        if P is None or P.name == "akka_tpu_torch":
            return self.port_system(name, config(transport, **kw))
        s = P.ActorSystem.create(name, config(transport, **kw))
        (self.ref_systems if device_rows else self.ref_nodes).append(s)
        if kw.get("provider") == "cluster":
            self.ref_clusters.append((s, P.cluster.Cluster.get(s)))
        return s

    def _end_ref_nodes(self) -> list:
        """Terminate the reference's nodes; the names of those that did
        not finish within WAIT."""
        for s in self.ref_nodes:
            s.terminate()
        deadline = time.monotonic() + WAIT
        while time.monotonic() < deadline:
            left = [c for s, c in self.ref_clusters
                    if not s.await_termination(0.01)]
            if not left:
                break
            if all(_leaderless(c.state) for c in left):
                for c in left:
                    c._removed_event.set()   # end the leaderless leave
        late = [s.name for s in self.ref_nodes
                if not s.await_termination(
                    max(0.0, deadline - time.monotonic()))]
        for s in self.ref_nodes:
            _wake_accept(s)
        return late

    def close(self):
        transports = [s.provider.transport for s in self.port_systems
                      if getattr(s.provider, "transport", None) is not None]
        late = self._end_ref_nodes()
        try:
            super().close()
        finally:
            _reset_injectors()
        assert not late, f"reference systems failed to terminate: {late}"
        alive = [t.name for tr in transports for t in transport_threads(tr)
                 if t.is_alive()]
        assert not alive, f"transport threads not joined: {alive}"


def side_by_side(scenario, nodes: Nodes, *args):
    """Run `scenario` on the reference, then on the port, each on its own
    wire; the two traces must be equal. Returns the port's trace."""
    traces = {}
    for name in PACKAGES:
        _reset_injectors()
        traces[name] = scenario(package(name), nodes, *args)
    assert traces["akka_tpu_torch"] == traces["akka_tpu"], traces
    return traces["akka_tpu_torch"]
