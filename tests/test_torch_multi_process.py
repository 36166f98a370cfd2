"""Real multi-process clusters of the port (tests/test_multi_process.py's
6 cases and tests/test_remote_instrument.py's two-process case, on
akka_tpu_torch): separate OS processes, real TCP, barriers through the
port's conductor (akka_tpu_torch.testkit.multi_process). Slow tier: the
cases start subprocesses, which tier-1 forbids.

Each worker is a fresh python process with the parent's environment and
the repo on its path (the port's `sanitized_env` forces no device); the
cluster forms over actual sockets, gossips to convergence, survives a
blackholed partition through split-brain resolution (keep-majority, and
lease-majority over the file lease), forms over TLS with the committed
test PKI (tests/data/torch_pki) while a node with a self-signed
certificate stays out,
re-homes sharded daemon workers when a process dies, and carries remote
tells and a remote instrument's trace id between processes."""

from pathlib import Path

import pytest

from akka_tpu_torch.testkit.multi_process import spawn_nodes

pytestmark = pytest.mark.slow

PKI = Path(__file__).resolve().parent / "data" / "torch_pki"


_COMMON = r"""
import json, os, sys, time
from akka_tpu_torch import ActorSystem
from akka_tpu_torch.cluster import Cluster
from akka_tpu_torch.testkit.dilation import dilated, dilated_s
from akka_tpu_torch.testkit.multi_process import (node_barrier, node_index,
                                            node_count, node_result)

IDX = node_index()
N = node_count()
BASE_PORT = int(os.environ["AKKA_TPU_TEST_BASE_PORT"])

def make_system(extra=None):
    # starvation windows (heartbeat pause, SBR timing overridden by tests)
    # auto-dilate with machine load (TestKit.scala:244-319 `dilated`
    # discipline): N extra busy processes must widen deadlines, not flake
    cfg = {"akka": {"actor": {"provider": "cluster"},
                    "stdout-loglevel": "OFF", "log-dead-letters": 0,
                    "remote": {"transport": "tcp",
                               "canonical": {"hostname": "127.0.0.1",
                                             "port": BASE_PORT + IDX}},
                    "cluster": {"gossip-interval": "0.1s",
                                "leader-actions-interval": "0.1s",
                                "unreachable-nodes-reaper-interval": "0.2s",
                                "failure-detector": {
                                    "heartbeat-interval": "0.2s",
                                    "acceptable-heartbeat-pause":
                                        dilated_s(2.0)}}}}
    if extra:
        def deep(dst, src):
            for k, v in src.items():
                if isinstance(v, dict):
                    deep(dst.setdefault(k, {}), v)
                else:
                    dst[k] = v
        deep(cfg, extra)
    return ActorSystem(f"mp{IDX}", cfg)

def up_count(system):
    return len([m for m in Cluster.get(system).state.members
                if m.status.value == "Up"])

def await_(cond, secs, what):
    deadline = time.monotonic() + dilated(secs)
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.1)
    raise AssertionError("timeout waiting for " + what)
"""


def test_two_process_cluster_forms_and_converges():
    worker = _COMMON + r"""
system = make_system()
seed = f"akka://mp0@127.0.0.1:{BASE_PORT}"
node_barrier("boot")
Cluster.get(system).join(seed)
await_(lambda: up_count(system) == 2, 30, "2 members Up")
node_barrier("converged")
state = Cluster.get(system).state
node_result({"up": up_count(system),
             "leader": str(state.leader) if state.leader else None})
node_barrier("done")
system.terminate(); system.await_termination(10)
"""
    results, _ = spawn_nodes(worker, 2, timeout=120.0,
                             extra_env={"AKKA_TPU_TEST_BASE_PORT": "24510"})
    assert results[0]["up"] == 2 and results[1]["up"] == 2
    # both sides agree on the leader (gossip convergence)
    assert results[0]["leader"] == results[1]["leader"] is not None


def test_three_process_partition_sbr_downs_minority():
    worker = _COMMON + r"""
system = make_system({"akka": {"cluster": {
    "split-brain-resolver": {"active-strategy": "keep-majority",
                             "stable-after": dilated_s(1.0)},
    "down-removal-margin": dilated_s(0.5)}}})
seed = f"akka://mp0@127.0.0.1:{BASE_PORT}"
node_barrier("boot")
Cluster.get(system).join(seed)
await_(lambda: up_count(system) == 3, 40, "3 members Up")
node_barrier("converged")

# partition: node 2 blackholed from {0, 1} in BOTH directions
tr = system.provider.transport
me = f"127.0.0.1:{BASE_PORT + IDX}"
if IDX == 2:
    for other in (0, 1):
        tr.fault_injector.blackhole(me, f"127.0.0.1:{BASE_PORT + other}")
else:
    tr.fault_injector.blackhole(me, f"127.0.0.1:{BASE_PORT + 2}")
node_barrier("partitioned")

if IDX in (0, 1):
    # majority side: SBR downs the unreachable minority; cluster heals to 2
    await_(lambda: up_count(system) == 2 and len(
        Cluster.get(system).state.members) == 2, 60, "minority removed")
    node_result({"up": up_count(system), "side": "majority"})
else:
    # minority side: downs ITSELF (keep-majority on the losing side)
    c = Cluster.get(system)
    assert c.await_removed(60.0), "minority never downed itself"
    node_result({"side": "minority", "downed": True})
node_barrier("checked")
system.terminate(); system.await_termination(10)
"""
    results, _ = spawn_nodes(worker, 3, timeout=180.0,
                             extra_env={"AKKA_TPU_TEST_BASE_PORT": "24520"})
    assert results[0]["up"] == 2 and results[1]["up"] == 2
    assert results[2]["downed"] is True


def test_three_process_partition_resolved_by_lease(tmp_path):
    """A partitioned 3-process cluster
    resolves via the LEASE (file-backed — a real cross-process lock): the
    side that acquires it survives, the other downs itself."""
    worker = _COMMON + r"""
from akka_tpu_torch.cluster_tools.lease import FileLease
FileLease.directory = os.environ["AKKA_TPU_TEST_LEASE_DIR"]
system = make_system({"akka": {"cluster": {
    "split-brain-resolver": {
        "active-strategy": "lease-majority",
        "stable-after": dilated_s(1.0),
        "lease-majority": {"lease-name": "mp-sbr",
                           "lease-implementation": "file",
                           "heartbeat-interval": "0.3s",
                           "heartbeat-timeout": dilated_s(3.0),
                           "acquire-lease-delay-for-minority":
                               dilated(2.0)}},
    "down-removal-margin": dilated_s(0.5)}}})
seed = f"akka://mp0@127.0.0.1:{BASE_PORT}"
node_barrier("boot")
Cluster.get(system).join(seed)
await_(lambda: up_count(system) == 3, 40, "3 members Up")
node_barrier("converged")

tr = system.provider.transport
me = f"127.0.0.1:{BASE_PORT + IDX}"
if IDX == 2:
    for other in (0, 1):
        tr.fault_injector.blackhole(me, f"127.0.0.1:{BASE_PORT + other}")
else:
    tr.fault_injector.blackhole(me, f"127.0.0.1:{BASE_PORT + 2}")
node_barrier("partitioned")

if IDX in (0, 1):
    # this side's decider (node 0, lowest address) wins the lease race
    # (2-to-1 timing is not what decides it — the LEASE is)
    await_(lambda: up_count(system) == 2 and len(
        Cluster.get(system).state.members) == 2, 60, "minority removed")
    node_result({"up": up_count(system), "side": "lease-winner"})
else:
    c = Cluster.get(system)
    assert c.await_removed(60.0), "lease loser never downed itself"
    node_result({"side": "lease-loser", "downed": True})
node_barrier("checked")
system.terminate(); system.await_termination(10)
"""
    results, _ = spawn_nodes(
        worker, 3, timeout=180.0,
        extra_env={"AKKA_TPU_TEST_BASE_PORT": "24550",
                   "AKKA_TPU_TEST_LEASE_DIR": str(tmp_path)})
    assert results[0]["up"] == 2 and results[1]["up"] == 2
    assert results[2]["downed"] is True


def test_tls_cluster_across_real_processes():
    """A real-process cluster forms over TLS with mutual client
    certificates, and a third process presenting a self-signed
    certificate (the committed test PKI's `rogue`) is rejected at the
    handshake (never admitted)."""
    worker = _COMMON + r"""
CERTS = os.environ["AKKA_TPU_TEST_CERT_DIR"]
STEM = ("node0", "node1", "rogue")[IDX]
system = make_system({"akka": {"remote": {
    "transport": "tls-tcp",
    "tls": {"cert-file": f"{CERTS}/{STEM}.crt",
            "key-file": f"{CERTS}/{STEM}.key",
            "ca-file": f"{CERTS}/ca.crt"}}}})
seed = f"akka://mp0@127.0.0.1:{BASE_PORT}"
node_barrier("boot")
Cluster.get(system).join(seed)
if IDX < 2:
    await_(lambda: up_count(system) == 2, 40, "2 TLS members Up")
    time.sleep(2.0)  # rogue must STAY out
    node_result({"up": up_count(system)})
else:
    time.sleep(6.0)  # rogue: join handshakes fail silently
    node_result({"up": up_count(system)})
node_barrier("done")
system.terminate(); system.await_termination(10)
"""
    results, _ = spawn_nodes(
        worker, 3, timeout=180.0,
        extra_env={"AKKA_TPU_TEST_BASE_PORT": "24540",
                   "AKKA_TPU_TEST_CERT_DIR": str(PKI)})
    assert results[0]["up"] == 2 and results[1]["up"] == 2
    assert results[2]["up"] <= 1  # never admitted


def test_sharded_daemon_process_rehomes_across_real_processes():
    """ShardedDaemonProcess through the REAL multi-process harness: N
    always-alive workers spread over two OS processes; when the second process dies mid-run, the keep-alive
    pinger revives every index on the survivor — singleton-per-index
    throughout (reference: ShardedDaemonProcessImpl keep-alive +
    one-shard-per-instance design)."""
    worker = _COMMON + r"""
from akka_tpu_torch.sharding import (ShardedDaemonProcess,
                               ShardedDaemonProcessSettings)
from akka_tpu_torch.typed import Behaviors
from akka_tpu_torch.testkit import TestProbe

system = make_system({"akka": {"cluster": {
    "split-brain-resolver": {"active-strategy": "keep-majority",
                             "stable-after": dilated_s(1.0)},
    "down-removal-margin": dilated_s(0.5)}}})
seed = f"akka://mp0@127.0.0.1:{BASE_PORT}"
node_barrier("boot")
Cluster.get(system).join(seed)
await_(lambda: up_count(system) == 2, 40, "2 members Up")
node_barrier("converged")

NWORK = 4
def factory(i):
    return Behaviors.setup(lambda ctx: Behaviors.receive(
        lambda c, m: Behaviors.same))

region = ShardedDaemonProcess.get(system).init(
    "mp-daemons", NWORK, factory,
    settings=ShardedDaemonProcessSettings(keep_alive_interval=0.3))
probe = TestProbe(system)
from akka_tpu_torch.testkit import region_entity_ids

def local_ids():
    return region_entity_ids(region, probe)

all_ids = {str(i) for i in range(NWORK)}
# report the value an await_ CONFIRMED, never a fresh one-shot re-query
# (a single GetShardRegionState may legitimately return a partial
# snapshot at the region's own aggregation timeout)
confirmed = {}
if IDX == 0:
    # wait until the workers are spread: node 1 hosts at least one
    def spread():
        mine = local_ids()
        return mine and mine != all_ids
    await_(spread, 40, "workers never spread to the second node")
    node_barrier("spread")
    # no further barriers: node 1 dies abruptly after this point and a
    # barrier would wait for it forever. Every index must rehome here.
    def rehomed():
        mine = local_ids()
        if mine == all_ids:
            confirmed["ids"] = mine
            return True
        return False
    await_(rehomed, 60, "workers did not rehome to the survivor")
    await_(lambda: up_count(system) == 1, 60, "dead node never removed")
    node_result({"side": "survivor", "ids": sorted(confirmed["ids"])})
    system.terminate(); system.await_termination(10)
else:
    def hosted_some():
        mine = local_ids()
        if mine:
            confirmed["hosted"] = mine
            return True
        return False
    await_(hosted_some, 40, "no workers ever landed here")
    node_barrier("spread")
    node_result({"side": "leaver", "hosted": sorted(confirmed["hosted"])})
    # die ABRUPTLY (no graceful leave): the cluster must down us and the
    # daemons must rehome via the keep-alive pinger
    os._exit(0)
"""
    results, _ = spawn_nodes(worker, 2, timeout=240.0,
                             extra_env={"AKKA_TPU_TEST_BASE_PORT": "24560"})
    assert results[0]["side"] == "survivor"
    assert results[0]["ids"] == ["0", "1", "2", "3"]
    assert results[1]["hosted"]  # the leaver really hosted workers first


def test_remote_tell_across_real_processes():
    worker = _COMMON + r"""
from akka_tpu_torch import Actor, Props
from akka_tpu_torch.pattern.ask import ask_sync

system = make_system()

class Echo(Actor):
    def receive(self, msg):
        self.sender.tell(("echo-from", IDX, msg), self.self_ref)

system.actor_of(Props.create(Echo), "echo")
node_barrier("ready")
peer = (IDX + 1) % N
ref = system.actor_selection(
    f"akka://mp{peer}@127.0.0.1:{BASE_PORT + peer}/user/echo")
got = ask_sync(ref, ["hi", IDX], timeout=15.0)
assert got == ("echo-from", peer, ["hi", IDX]), got
node_result({"ok": True})
node_barrier("done")
system.terminate(); system.await_termination(10)
"""
    results, _ = spawn_nodes(worker, 2, timeout=120.0,
                             extra_env={"AKKA_TPU_TEST_BASE_PORT": "24530"})
    assert results[0]["ok"] and results[1]["ok"]


def test_trace_id_propagates_across_real_processes():
    worker = r"""
import json, os, sys, time
from akka_tpu_torch import Actor, ActorSystem, Props, ask_sync
from akka_tpu_torch.remote.instrument import RemoteInstrument
from akka_tpu_torch.testkit.multi_process import (node_barrier, node_index,
                                            node_result)

IDX = node_index()
BASE_PORT = int(os.environ["AKKA_TPU_TEST_BASE_PORT"])

class TraceInstrument(RemoteInstrument):
    identifier = 9
    def __init__(self):
        self.current = None
        self.seen = []
    def remote_write_metadata(self, recipient, message, sender):
        return self.current.encode() if self.current else None
    def remote_read_metadata(self, recipient, message, sender, metadata):
        self.seen.append(metadata.decode())

system = ActorSystem.create(f"ri{IDX}", {
    "akka": {"actor": {"provider": "remote"},
             "stdout-loglevel": "OFF", "log-dead-letters": 0,
             "remote": {"transport": "tcp",
                        "canonical": {"hostname": "127.0.0.1",
                                      "port": BASE_PORT + IDX}}}})
ins = TraceInstrument()
system.provider.remote_instruments.add(ins)

class Echo(Actor):
    def receive(self, message):
        self.sender.tell(("echo", message), self.self_ref)

if IDX == 0:
    system.actor_of(Props.create(Echo), "echo")
    node_barrier("ready")
    node_barrier("asked")
    node_result({"seen": ins.seen})
else:
    node_barrier("ready")
    ref = system.provider.resolve_actor_ref(
        f"akka://ri0@127.0.0.1:{BASE_PORT}/user/echo")
    ins.current = "xproc-trace-7"
    reply = ask_sync(ref, "hello", timeout=20.0, system=system)
    assert reply == ("echo", "hello"), reply
    node_barrier("asked")
    node_result({"sent": ins.current})
node_barrier("done")
system.terminate(); system.await_termination(10)
"""
    results, _ = spawn_nodes(worker, 2, timeout=120.0,
                             extra_env={"AKKA_TPU_TEST_BASE_PORT": "24610"})
    # node 0 (the echo host) read the trace id node 1 stamped on the wire
    assert "xproc-trace-7" in results[0]["seen"]
    assert results[1]["sent"] == "xproc-trace-7"
