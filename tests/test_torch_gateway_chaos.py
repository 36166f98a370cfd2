"""The port's serving-gateway chaos tier (tests/test_gateway_chaos.py's
3 cases on akka_tpu_torch): REAL OS processes, real TCP, mid-run chaos,
through the port's multi-process harness
(akka_tpu_torch.testkit.multi_process) and its serve child
(`python -m akka_tpu_torch.tools.serving_gateway serve`). Slow tier: the
cases start subprocesses, which tier-1 forbids.

Topology: 3 worker processes form a cluster over real sockets (the
conductor for barriers). Node 0 supervises a gateway-server child (a
DeviceShardRegion of counter entities on the card where there is one,
else on the CPU, with an armed WAL and checkpoint dir, behind admission
and SLO tracking) and injects the chaos legs over the wire as the
`__admin` tenant; nodes 1-2 are sustained-load clients reconnecting
through the outages.

1. rebalance, kill -9 with --restore, failover 2 -> 1 under load:
   acked_sum <= final_total <= sent_sum.
2. a durable gateway killed under load respawns every remembered entity
   with its acked state: per entity and in sum.
3. idempotent sessions against a --durable --dedup gateway: final_total
   == intended_sum exactly under chosen losses and two kills; the
   dedup-off control double-applies.
"""

import pytest
import torch

from akka_tpu_torch.testkit.multi_process import spawn_nodes

pytestmark = pytest.mark.slow


def device_env() -> dict:
    """The serve child's device: the card where there is one."""
    return {"AKKA_TPU_TEST_DEVICE":
            "cuda" if torch.cuda.is_available() else "cpu"}


_COMMON = r"""
import json, os, signal, socket, subprocess, sys, tempfile, time
from akka_tpu_torch import ActorSystem
from akka_tpu_torch.cluster import Cluster
from akka_tpu_torch.gateway import GatewayClient
from akka_tpu_torch.testkit.dilation import dilated, dilated_s
from akka_tpu_torch.testkit.multi_process import (node_barrier, node_index,
                                            node_count, node_result)

IDX = node_index()
N = node_count()
BASE_PORT = int(os.environ["AKKA_TPU_TEST_BASE_PORT"])
GW_PORT = BASE_PORT + 37
STOP_FILE = os.path.join(tempfile.gettempdir(),
                         f"gw_chaos_stop_{BASE_PORT}")
DEVICE = os.environ["AKKA_TPU_TEST_DEVICE"]

def make_system(extra=None):
    cfg = {"akka": {"actor": {"provider": "cluster"},
                    "stdout-loglevel": "OFF", "log-dead-letters": 0,
                    "remote": {"transport": "tcp",
                               "canonical": {"hostname": "127.0.0.1",
                                             "port": BASE_PORT + IDX}},
                    "cluster": {"gossip-interval": "0.1s",
                                "leader-actions-interval": "0.1s"}}}
    if extra:
        cfg["akka"].update(extra)
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

def spawn_serve(directory, restore=False, durable=False, dedup=False):
    cmd = [sys.executable, "-m", "akka_tpu_torch.tools.serving_gateway",
           "serve", "--device", DEVICE, "--port", str(GW_PORT),
           "--dir", directory, "--devices", "2", "--shards", "4",
           "--eps", "16", "--rate", "1000", "--burst", "500"]
    if restore:
        cmd.append("--restore")
    if durable:
        cmd.append("--durable")
    if dedup:
        cmd.append("--dedup")
    p = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    deadline = time.monotonic() + dilated(120.0)
    while time.monotonic() < deadline:
        line = p.stdout.readline()
        if not line:
            raise AssertionError(f"serve child died rc={p.poll()}")
        sys.stderr.write(f"[serve:{IDX}] {line}")
        if line.startswith("READY "):
            return p
    raise AssertionError("serve child never printed READY")
"""


def test_gateway_survives_rebalance_crash_and_failover():
    worker = _COMMON + r"""
system = make_system()
seed = f"akka://mp0@127.0.0.1:{BASE_PORT}"
node_barrier("boot", timeout=dilated(120.0))
Cluster.get(system).join(seed)
await_(lambda: up_count(system) == 3, 60, "3 members Up")
node_barrier("converged", timeout=dilated(120.0))

if IDX == 0:
    # ------------------------------------------ gateway supervisor + chaos
    if os.path.exists(STOP_FILE):
        os.remove(STOP_FILE)
    gw_dir = tempfile.mkdtemp(prefix="gw_chaos_")
    serve = spawn_serve(gw_dir)
    node_barrier("gw_up", timeout=dilated(180.0))
    admin = GatewayClient("127.0.0.1", GW_PORT, timeout=30.0)
    legs = {}

    time.sleep(dilated(2.0))  # load flowing against the initial placement
    rep = admin.request_retry("__admin", "", "rebalance", 0.0,
                              deadline_s=dilated(60.0))
    legs["rebalance"] = rep["status"]

    time.sleep(dilated(2.0))
    serve.send_signal(signal.SIGKILL)   # chaos: the process, not the data
    serve.wait()
    admin.close()
    serve = spawn_serve(gw_dir, restore=True)
    legs["crash_restore"] = "ok"

    time.sleep(dilated(2.0))
    rep = admin.request_retry("__admin", "", "failover", 1.0,
                              deadline_s=dilated(90.0))
    legs["failover"] = rep["status"]

    time.sleep(dilated(3.0))  # post-failover traffic on the survivor mesh
    open(STOP_FILE, "w").close()
    node_barrier("load_done", timeout=dilated(240.0))

    # loads are quiesced: the conserved-value probe is stable now
    final = admin.request_retry("__admin", "", "sum",
                                deadline_s=dilated(60.0))
    artifact = admin.request_retry("__admin", "", "artifact",
                                   deadline_s=dilated(60.0))["data"]
    admin.close()
    serve.send_signal(signal.SIGTERM)
    try:
        serve.wait(timeout=dilated(30.0))
    except subprocess.TimeoutExpired:
        serve.kill()
    os.remove(STOP_FILE)
    node_result({"role": "chaos", "legs": legs,
                 "final_total": float(final["value"]),
                 "artifact": {k: v for k, v in artifact.items()
                              if k != "per_tenant"}})
else:
    # ------------------------------------------------- sustained-load client
    node_barrier("gw_up", timeout=dilated(180.0))
    client = GatewayClient("127.0.0.1", GW_PORT, timeout=10.0)
    sent_sum = acked_sum = 0.0
    counts = {"ok": 0, "shed": 0, "error": 0, "conn_error": 0}
    i = 0
    while not os.path.exists(STOP_FILE):
        i += 1
        value = float(i % 5 + 1)
        # one wire send attempt == one sent_sum credit: resends after a
        # connection death count again, keeping final <= sent_sum valid
        sent_sum += value
        try:
            rep = client.request(f"tenant{IDX}",
                                 f"n{IDX}-acct-{i % 4}", "add", value)
        except (OSError, ConnectionError, socket.timeout):
            counts["conn_error"] += 1
            client.close()
            time.sleep(0.2)
            continue
        if rep.get("status") == "ok":
            acked_sum += value
            counts["ok"] += 1
        elif rep.get("status") == "shed":
            counts["shed"] += 1
            time.sleep(min(1.0, rep.get("retry_after_ms", 100) / 1e3))
        else:
            counts["error"] += 1
        time.sleep(0.01)
    client.close()
    node_barrier("load_done", timeout=dilated(240.0))
    node_result({"role": "load", "sent_sum": sent_sum,
                 "acked_sum": acked_sum, **counts})

node_barrier("done", timeout=dilated(120.0))
system.terminate(); system.await_termination(10)
"""
    results, _ = spawn_nodes(worker, 3, timeout=900.0,
                             extra_env={"AKKA_TPU_TEST_BASE_PORT": "24710",
                                        **device_env()})
    chaos = results[0]
    loads = [results[1], results[2]]
    assert chaos["role"] == "chaos"
    # every chaos leg executed through the front door
    assert chaos["legs"] == {"rebalance": "ok", "crash_restore": "ok",
                             "failover": "ok"}, chaos["legs"]

    sent = sum(r["sent_sum"] for r in loads)
    acked = sum(r["acked_sum"] for r in loads)
    final = chaos["final_total"]
    # clients actually exercised the gateway across the outages
    assert all(r["ok"] > 0 for r in loads), loads
    assert acked > 0
    # THE conserved-value invariant: no acknowledged write lost (WAL +
    # snapshot + replay), nothing conjured beyond what was sent
    assert acked - 1e-6 <= final <= sent + 1e-6, \
        f"acked={acked} final={final} sent={sent}"

    # the SLO artifact came out of the run with the stable schema
    art = chaos["artifact"]
    for key in ("p50_ms", "p99_ms", "reject_rate", "requests",
                "error_budget_remaining"):
        assert key in art, art
    assert art["requests"] > 0


def test_gateway_durable_entities_survive_kill9():
    """Kill -9 a DURABLE gateway (entity journal +
    remember-entities store armed) under load, restart with --restore,
    and the restarted region respawns every remembered entity with its
    exact acked state — per-entity AND globally:

        last_acked_reply(e) <= final(e) <= sent(e)
        acked_sum <= final_total <= sent_sum

    The left bound is the new durable guarantee (zero lost acked writes
    at ENTITY granularity — the WAL-only path guaranteed it only for the
    conserved sum); the remember-entities respawn is visible through the
    `durable` admin op before post-restore traffic can recreate ids."""
    worker = _COMMON + r"""
system = make_system()
seed = f"akka://mp0@127.0.0.1:{BASE_PORT}"
node_barrier("boot", timeout=dilated(120.0))
Cluster.get(system).join(seed)
await_(lambda: up_count(system) == 3, 60, "3 members Up")
node_barrier("converged", timeout=dilated(120.0))

if IDX == 0:
    # --------------------------------------- gateway supervisor + kill -9
    if os.path.exists(STOP_FILE):
        os.remove(STOP_FILE)
    gw_dir = tempfile.mkdtemp(prefix="gw_durable_")
    serve = spawn_serve(gw_dir, durable=True)
    node_barrier("gw_up", timeout=dilated(180.0))
    admin = GatewayClient("127.0.0.1", GW_PORT, timeout=30.0)

    time.sleep(dilated(3.0))   # acked traffic group-commits the journal
    serve.send_signal(signal.SIGKILL)
    serve.wait()
    admin.close()
    serve = spawn_serve(gw_dir, restore=True, durable=True)
    # respawn evidence straight after READY: replayed_entities was fixed
    # at restore time, before the port opened, so load racing back in
    # cannot have created it
    dur = admin.request_retry("__admin", "", "durable",
                              deadline_s=dilated(60.0))["data"]

    time.sleep(dilated(3.0))   # post-restore traffic on respawned rows
    open(STOP_FILE, "w").close()
    node_barrier("load_done", timeout=dilated(240.0))

    final = admin.request_retry("__admin", "", "sum",
                                deadline_s=dilated(60.0))
    by_entity = {}
    for n in (1, 2):
        for k in range(4):
            e = f"n{n}-acct-{k}"
            rep = admin.request_retry(f"tenant{n}", e, "get", 0.0,
                                      deadline_s=dilated(60.0))
            if rep.get("status") == "ok":
                by_entity[e] = float(rep["value"])
    admin.close()
    serve.send_signal(signal.SIGTERM)
    try:
        serve.wait(timeout=dilated(30.0))
    except subprocess.TimeoutExpired:
        serve.kill()
    os.remove(STOP_FILE)
    node_result({"role": "chaos", "durable": dur,
                 "final_total": float(final["value"]),
                 "by_entity": by_entity})
else:
    # ------------------------------------------- sustained-load client
    node_barrier("gw_up", timeout=dilated(180.0))
    client = GatewayClient("127.0.0.1", GW_PORT, timeout=10.0)
    sent_sum = acked_sum = 0.0
    sent_by = {}
    last_acked = {}
    counts = {"ok": 0, "shed": 0, "error": 0, "conn_error": 0}
    i = 0
    while not os.path.exists(STOP_FILE):
        i += 1
        value = float(i % 5 + 1)
        entity = f"n{IDX}-acct-{i % 4}"
        sent_sum += value
        sent_by[entity] = sent_by.get(entity, 0.0) + value
        try:
            rep = client.request(f"tenant{IDX}", entity, "add", value)
        except (OSError, ConnectionError, socket.timeout):
            counts["conn_error"] += 1
            client.close()
            time.sleep(0.2)
            continue
        if rep.get("status") == "ok":
            acked_sum += value
            counts["ok"] += 1
            # the ok reply carries the post-add running total: the last
            # one per entity is that entity's acked frontier floor
            last_acked[entity] = float(rep["value"])
        elif rep.get("status") == "shed":
            counts["shed"] += 1
            time.sleep(min(1.0, rep.get("retry_after_ms", 100) / 1e3))
        else:
            counts["error"] += 1
        time.sleep(0.01)
    client.close()
    node_barrier("load_done", timeout=dilated(240.0))
    node_result({"role": "load", "sent_sum": sent_sum,
                 "acked_sum": acked_sum, "sent_by": sent_by,
                 "last_acked": last_acked, **counts})

node_barrier("done", timeout=dilated(120.0))
system.terminate(); system.await_termination(10)
"""
    results, _ = spawn_nodes(worker, 3, timeout=900.0,
                             extra_env={"AKKA_TPU_TEST_BASE_PORT": "24810",
                                        **device_env()})
    chaos = results[0]
    loads = [results[1], results[2]]
    assert chaos["role"] == "chaos"

    # the durable layer was armed and the restart respawned remembered
    # entities from the store + journal, not from traffic
    dur = chaos["durable"]
    assert dur["attached"], dur
    assert dur["remembered"] == 8, dur       # 2 load nodes x 4 accounts
    assert dur["replayed_entities"] >= 1, dur
    assert dur["journal"]["entities"] >= 1, dur

    sent = sum(r["sent_sum"] for r in loads)
    acked = sum(r["acked_sum"] for r in loads)
    final = chaos["final_total"]
    assert all(r["ok"] > 0 for r in loads), loads
    assert acked > 0
    # global conserved-value invariant: ZERO lost acked writes
    assert acked - 1e-6 <= final <= sent + 1e-6, \
        f"acked={acked} final={final} sent={sent}"

    # per-entity durable exactness: every entity's final state holds at
    # least everything its client was acknowledged, and no more than it
    # ever sent (floats are small integer sums here, so 1e-6 is slack)
    by_entity = chaos["by_entity"]
    for r in loads:
        for e, floor in r["last_acked"].items():
            assert e in by_entity, (e, by_entity)
            assert floor - 1e-6 <= by_entity[e] <= r["sent_by"][e] + 1e-6, \
                (e, floor, by_entity[e], r["sent_by"][e])


def test_gateway_exactly_once_retry_effects():
    """With idempotent client sessions (every retry
    resends the SAME request id) against a --durable --dedup gateway,
    the conserved-value INEQUALITY upgrades to exact equality

        final_total == intended_sum

    under murmur3-chosen losses at every point in a request's life —
    pre-send (connection dies before the frame leaves), in-flight (frame
    sent, reply lost), post-ack (ack received but "lost", the client
    resends anyway) — plus two kill -9 + --restore legs that land server
    kills around the journal commit (post-commit-pre-ack included). Each
    intent's value counts into intended_sum exactly ONCE no matter how
    many wire attempts it took; duplicates are replayed from the
    journaled reply cache, never re-applied.

    The dedup-off CONTROL leg then demonstrates the bug the cache
    removes: the same lost-ack resend against a plain --durable gateway
    double-applies (>= 1 duplicate, final == 2x the intended value)."""
    worker = _COMMON + r"""
from akka_tpu_torch.gateway.ingress import encode_frame
from akka_tpu_torch.testkit.chaos import chaos_hit_np

system = make_system()
seed = f"akka://mp0@127.0.0.1:{BASE_PORT}"
node_barrier("boot", timeout=dilated(120.0))
Cluster.get(system).join(seed)
await_(lambda: up_count(system) == 3, 60, "3 members Up")
node_barrier("converged", timeout=dilated(120.0))

if IDX == 0:
    # ------------------------------- gateway supervisor + kill -9 legs
    if os.path.exists(STOP_FILE):
        os.remove(STOP_FILE)
    gw_dir = tempfile.mkdtemp(prefix="gw_exact_")
    serve = spawn_serve(gw_dir, durable=True, dedup=True)
    node_barrier("gw_up", timeout=dilated(180.0))
    admin = GatewayClient("127.0.0.1", GW_PORT, timeout=30.0)

    # two kill legs: SIGKILL lands wherever the serve path happens to
    # be — including between the journal fsync and the ack reaching
    # the wire (post-commit-pre-ack), the loss only the JOURNALED
    # reply cache survives exactly-once
    for leg in range(2):
        time.sleep(dilated(3.0))
        serve.send_signal(signal.SIGKILL)
        serve.wait()
        admin.close()
        serve = spawn_serve(gw_dir, restore=True, durable=True,
                            dedup=True)

    time.sleep(dilated(3.0))   # post-restore traffic through the cache
    open(STOP_FILE, "w").close()
    node_barrier("load_done", timeout=dilated(240.0))

    final = admin.request_retry("__admin", "", "sum",
                                deadline_s=dilated(60.0))
    stats = admin.request_retry("__admin", "", "stats",
                                deadline_s=dilated(60.0))["data"]
    admin.close()
    serve.send_signal(signal.SIGTERM)
    try:
        serve.wait(timeout=dilated(30.0))
    except subprocess.TimeoutExpired:
        serve.kill()

    # ---- dedup-off CONTROL: the duplicate the cache removes. A
    # lost-ack resend of the SAME id double-applies without it.
    ctl_dir = tempfile.mkdtemp(prefix="gw_ctl_")
    ctl = spawn_serve(ctl_dir, durable=True)
    cc = GatewayClient("127.0.0.1", GW_PORT, timeout=30.0)
    creq = {"id": cc._next_id(), "tenant": "ctl", "entity": "ctl-acct",
            "op": "add", "value": 7.0}
    r1 = cc._request_raw(creq)
    cc.close()                 # the ack "was lost": reconnect, resend
    r2 = cc._request_raw(creq)
    rg = cc.request("ctl", "ctl-acct", "get", 0.0)
    cc.close()
    ctl.send_signal(signal.SIGTERM)
    try:
        ctl.wait(timeout=dilated(30.0))
    except subprocess.TimeoutExpired:
        ctl.kill()
    os.remove(STOP_FILE)
    node_result({"role": "chaos", "final_total": float(final["value"]),
                 "dedup": stats.get("dedup", {}),
                 "control": {"first": r1.get("value"),
                             "second": r2.get("value"),
                             "second_dedup": bool(r2.get("dedup")),
                             "total": rg.get("value")}})
else:
    # -------------------- idempotent-session client with chosen losses
    node_barrier("gw_up", timeout=dilated(180.0))
    client = GatewayClient("127.0.0.1", GW_PORT, timeout=10.0)
    SEED = 0xE0E0 + IDX
    intended_sum = 0.0
    counts = {"ok": 0, "shed_waits": 0, "conn_error": 0,
              "pre_send": 0, "mid_flight": 0, "post_ack": 0,
              "dedup_replays": 0, "failed_intents": 0}
    i = 0
    while not os.path.exists(STOP_FILE):
        i += 1
        value = float(i % 5 + 1)
        # one INTENT counts once, however many wire attempts it takes
        intended_sum += value
        req = {"id": client._next_id(), "tenant": f"tenant{IDX}",
               "entity": f"n{IDX}-acct-{i % 4}", "op": "add",
               "value": value}
        # murmur3-chosen loss schedule (testkit.chaos): one lane per
        # loss point in the request's life
        if bool(chaos_hit_np(SEED, i, 0, 0.06)):      # pre-send
            counts["pre_send"] += 1
            client.close()
        if bool(chaos_hit_np(SEED, i, 1, 0.06)):      # in-flight
            counts["mid_flight"] += 1
            try:
                if client._sock is None:
                    client.connect()
                client._sock.sendall(encode_frame(req))
            except (OSError, ConnectionError, socket.timeout):
                pass
            client.close()   # reply lost; the server MAY have applied
        rep = None
        deadline = time.monotonic() + dilated(120.0)
        while time.monotonic() < deadline:
            try:
                rep = client._request_raw(req)   # SAME id, every attempt
            except (OSError, ConnectionError, socket.timeout):
                counts["conn_error"] += 1
                client.close()
                time.sleep(0.2)
                continue
            if rep.get("status") == "shed":
                counts["shed_waits"] += 1
                time.sleep(min(1.0, rep.get("retry_after_ms", 100) / 1e3))
                continue
            break
        if rep is None or rep.get("status") != "ok":
            counts["failed_intents"] += 1
            continue
        counts["ok"] += 1
        if rep.get("dedup"):
            counts["dedup_replays"] += 1
        if bool(chaos_hit_np(SEED, i, 2, 0.06)):      # post-ack lost ack
            counts["post_ack"] += 1
            try:
                rep2 = client._request_raw(req)
                if rep2.get("dedup"):
                    counts["dedup_replays"] += 1
            except (OSError, ConnectionError, socket.timeout):
                client.close()
        time.sleep(0.01)
    client.close()
    node_barrier("load_done", timeout=dilated(240.0))
    node_result({"role": "load", "intended_sum": intended_sum, **counts})

node_barrier("done", timeout=dilated(120.0))
system.terminate(); system.await_termination(10)
"""
    results, _ = spawn_nodes(worker, 3, timeout=900.0,
                             extra_env={"AKKA_TPU_TEST_BASE_PORT": "24910",
                                        **device_env()})
    chaos = results[0]
    loads = [results[1], results[2]]
    assert chaos["role"] == "chaos"

    # every intent resolved to an ok ack and every loss lane fired
    for r in loads:
        assert r["ok"] > 0 and r["failed_intents"] == 0, r
        assert r["pre_send"] > 0 and r["mid_flight"] > 0 \
            and r["post_ack"] > 0, r
    assert sum(r["dedup_replays"] for r in loads) >= 1, loads

    # THE exactly-once invariant: intended == final EXACTLY — no lost
    # acked write (journal) and no double-applied retry (reply cache),
    # across two kill -9 legs and every client-side loss lane
    intended = sum(r["intended_sum"] for r in loads)
    final = chaos["final_total"]
    assert abs(final - intended) <= 1e-6, \
        f"intended={intended} final={final} diff={final - intended}"

    # the server-side cache actually served duplicates
    dd = chaos["dedup"]
    assert dd.get("hits", 0) + dd.get("alias_hits", 0) >= 1, dd

    # dedup-off control: the SAME lost-ack resend double-applies —
    # >= 1 duplicate, demonstrating the bug the tentpole removes
    ctl = chaos["control"]
    assert ctl["first"] == pytest.approx(7.0), ctl
    assert ctl["second"] == pytest.approx(14.0), ctl   # re-applied!
    assert not ctl["second_dedup"], ctl
    assert ctl["total"] == pytest.approx(14.0), ctl
