"""The port's gateway over real sockets, on the CPU: the evloop front door
(akka_tpu_torch.gateway.evloop) in front of a continuous RegionBackend,
the `stream` transport (a framed stage graph per connection) held to the
evloop transport and to the reference's stream transport on the same
frames, and the serving demo
(`python -m akka_tpu_torch.tools.serving_gateway demo --device cpu`).

Deterministic by construction: each client owns its entities, the checks
are counts, running totals and conservation (never timing), and every
join, future, socket and subprocess wait is bounded.
"""

import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)  # tiny tensors: spare the other test workers

from akka_tpu_torch.gateway import (AdmissionController, GatewayClient,
                                    GatewayServer, RegionBackend,
                                    SloTracker, counter_behavior)
from akka_tpu_torch.sharding import DeviceEntity, DeviceShardRegion

ROOT = Path(__file__).resolve().parent.parent
WAIT_S = 60.0
CLIENTS, ENTS, WINDOWS = 8, 3, 12


def _region(name, slots=0):
    return DeviceShardRegion(DeviceEntity(
        name, counter_behavior(4), n_shards=2, entities_per_shard=16,
        n_devices=1, payload_width=4, mailbox_slots=slots,
        spare_blocks=2), device="cpu")


@pytest.mark.parametrize("slots", [0, 2])
def test_evloop_clients_conserved_and_in_order(slots):
    """8 threaded clients, each on its own entities, send pipelined binary
    windows (depth 4) and JSON requests through the evloop front door:
    every ok reply is its entity's running total, every connection's
    replies come back in request order (ids checked), sheds are retried,
    and the region's total equals the sum of the acked adds."""
    region = _region(f"ev-s{slots}", slots)
    backend = RegionBackend(region, continuous=True, pipeline_depth=4)
    srv = GatewayServer(
        None, backend, AdmissionController(
            rate=1e9, burst=1e9, pressure_signals=backend.pressure_signals(),
            thresholds={"ask_pool_occupancy": 0.9}),
        SloTracker(), transport="evloop", aggregate=True)
    results = [None] * CLIENTS
    errors = []

    def client(w):
        c = GatewayClient(*srv_addr, timeout=WAIT_S)
        ents = [f"c{w}-e{k}" for k in range(ENTS)]
        totals = {e: 0.0 for e in ents}
        acked = sheds = 0
        try:
            for r in range(WINDOWS):
                wins = [[(f"t{w}", ents[(r + i + j) % ENTS], "add",
                          float((w + r + i + j) % 5 + 1))
                         for j in range(2)] for i in range(3)]
                seq0 = c._seq
                replies = c.request_many_pipelined(wins, depth=4)
                pending = []
                for i, (win, reps) in enumerate(zip(wins, replies)):
                    for j, (req, rep) in enumerate(zip(win, reps)):
                        want_id = ((c.session << 24)
                                   | (seq0 + 2 * i + j + 1)) \
                            & 0x7FFFFFFFFFFFFFFF
                        assert rep["id"] == want_id
                        pending.append((req, rep))
                # the server applied the ok records in request order;
                # shed ones are retried after them, in order
                retry = []
                for (_, ent, _, val), rep in pending:
                    if rep["status"] == "shed":
                        retry.append((ent, val, rep))
                        continue
                    assert rep["status"] == "ok", rep
                    totals[ent] += val
                    acked += val
                    assert rep["value"] == totals[ent], (rep, totals[ent])
                for ent, val, rep in retry:
                    while rep["status"] == "shed":
                        sheds += 1
                        time.sleep(rep["retry_after_ms"] / 1e3)
                        rep = c.request(f"t{w}", ent, "add", val)
                    assert rep["status"] == "ok", rep
                    totals[ent] += val
                    acked += val
                    assert rep["value"] == totals[ent], (rep, totals[ent])
                rep = c.request(f"t{w}", ents[r % ENTS], "get")
                assert rep["status"] in ("ok", "shed"), rep
                if rep["status"] == "ok":
                    assert rep["value"] == totals[ents[r % ENTS]]
            results[w] = (acked, sheds)
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append((w, repr(e)))
        finally:
            c.close()

    srv_addr = srv.start()
    threads = [threading.Thread(target=client, args=(w,))
               for w in range(CLIENTS)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT_S)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        assert backend.batcher.quiesce(WAIT_S)
        acked = sum(r[0] for r in results)
        assert backend.sum_all() == acked
        assert region.ask_pool_stats()["in_flight"] == 0
        ev = srv._evloop.stats()
        assert ev["accepted"] >= CLIENTS
        assert ev["frames_in"] >= CLIENTS * WINDOWS * 4
        assert srv.admission.stats()["resident_tenants"] == CLIENTS
    finally:
        srv.stop()
        backend.close()


QUIET = {"akka": {"stdout-loglevel": "OFF", "log-dead-letters": 0}}


def _frames():
    """One client's frames, sent one at a time: JSON and binary adds and
    gets over a few entities, a malformed frame and the admin sum."""
    from akka_tpu_torch.serialization import frames as fr
    out = [b'{"id":1,"tenant":"t0","entity":"e0","op":"add","value":2}']
    for r in range(6):
        ids = [10 * r + k for k in range(3)]
        out.append(fr.encode_request_batch(
            ids, ["t0", "t1", "t0"], [f"e{r % 3}", f"e{(r + 1) % 3}", "e9"],
            ["add", "add", "get"], [float(r + 1), float(2 * r + 1), 0.0]))
    out += [b'{"id":90,"tenant":"t1","entity":"e1","op":"get"}',
            b"{not json",
            b'{"id":91,"tenant":"__admin","entity":"","op":"sum"}']
    return out


def _exchange(port, bodies):
    """Send each body as a `[u32 length][body]` frame over one socket and
    read its reply frame before the next; the reply bodies."""
    import socket
    import struct

    def read(sock, n):
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            assert chunk, "server closed the connection"
            buf += chunk
        return buf

    replies = []
    with socket.create_connection(("127.0.0.1", port),
                                  timeout=WAIT_S) as sock:
        for body in bodies:
            sock.sendall(struct.pack(">I", len(body)) + body)
            (n,) = struct.unpack(">I", read(sock, 4))
            replies.append(read(sock, n))
    return replies


def _serve(g, system, region, transport):
    """The package's stack in front of `region`: the replies to
    `_frames()` over one socket, and the region's total."""
    backend = g.RegionBackend(region, continuous=True, pipeline_depth=4)
    srv = g.GatewayServer(
        system, backend, g.AdmissionController(
            rate=1e9, burst=1e9, pressure_signals=backend.pressure_signals(),
            thresholds={"ask_pool_occupancy": 0.9}),
        g.SloTracker(), transport=transport, aggregate=True)
    host, port = srv.start()
    try:
        assert host == "127.0.0.1" and port > 0
        replies = _exchange(port, _frames())
        assert backend.batcher.quiesce(WAIT_S)
        return replies, backend.sum_all()
    finally:
        srv.stop()
        backend.close()


def test_stream_transport_replies_equal_evloop_and_reference():
    """The stream transport (a framed stage graph per connection) serves
    one client's frames with replies byte-equal to the evloop transport's
    on a fresh region, and to the reference's stream transport on the
    same frames; the totals agree."""
    import akka_tpu
    import akka_tpu.gateway as jg
    from akka_tpu.sharding.device import DeviceEntity as JEntity
    from akka_tpu.sharding.device import DeviceShardRegion as JRegion

    import akka_tpu_torch
    import akka_tpu_torch.gateway as tg

    tsys = akka_tpu_torch.ActorSystem.create("gw-stream", QUIET)
    jsys = akka_tpu.ActorSystem.create("gw-stream-ref", QUIET)
    try:
        stream = _serve(tg, tsys, _region("st-stream"), "stream")
        evloop = _serve(tg, None, _region("st-evloop"), "evloop")
        jregion = JRegion(JEntity(
            "st-ref", jg.counter_behavior(4), n_shards=2,
            entities_per_shard=16, n_devices=1, payload_width=4,
            mailbox_slots=0, spare_blocks=2))
        reference = _serve(jg, jsys, jregion, "stream")
    finally:
        tsys.terminate()
        jsys.terminate()
        assert tsys.await_termination(WAIT_S)
        assert jsys.await_termination(WAIT_S)
    assert stream == evloop
    assert stream == reference
    replies, total = stream
    assert len(replies) == len(_frames())
    assert total == 2.0 + sum(r + 1 + 2 * r + 1 for r in range(6))
    with pytest.raises(ValueError, match="unknown transport"):
        GatewayServer(None, None, AdmissionController(), SloTracker(),
                      transport="udp")


def test_stream_transport_stop_leaves_no_listener_or_thread():
    """`stop()` unbinds the stream transport's listener and waits for it:
    a connect right after is refused, and once the system has ended no
    thread of the test is left. A stream transport given no system
    refuses to start, naming the evloop transport."""
    import socket

    from akka_tpu_torch import ActorSystem

    with pytest.raises(ValueError, match="evloop"):
        GatewayServer(None, None, AdmissionController(rate=1e9, burst=1e9),
                      SloTracker(), transport="stream").start()
    before = {t.ident for t in threading.enumerate()}
    system = ActorSystem.create("gw-stop", QUIET)
    region = _region("st-stop")
    backend = RegionBackend(region, continuous=True, pipeline_depth=4)
    srv = GatewayServer(system, backend,
                        AdmissionController(rate=1e9, burst=1e9),
                        SloTracker(), aggregate=True)
    try:
        assert srv.transport == "stream"
        _, port = srv.start()
        assert _exchange(port, _frames()[:2])
        srv.stop()
        assert srv._binding is None
        with pytest.raises(ConnectionRefusedError):
            socket.create_connection(("127.0.0.1", port), timeout=WAIT_S)
    finally:
        srv.stop()
        backend.close()
        system.terminate()
    assert system.await_termination(WAIT_S)
    deadline = time.monotonic() + 5.0
    left = [t for t in threading.enumerate() if t.ident not in before]
    for t in left:
        t.join(max(0.0, deadline - time.monotonic()))
    alive = [t.name for t in left if t.is_alive()]
    assert not alive, alive


def test_serving_gateway_demo_on_cpu():
    """The demo's durable serve child and two load children run on the
    CPU, the rebalance leg goes over the wire, the server is SIGKILLed and
    restarted with --restore on the same port and directory, the failover
    leg rebuilds the region from 2 shard slots onto 1 and answers ok, and
    the conserved-value invariant holds."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    res = subprocess.run(
        [sys.executable, "-m", "akka_tpu_torch.tools.serving_gateway",
         "demo", "--device", "cpu", "--seconds", "3"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    assert "invariant held: acked <= final <= sent" in res.stdout
    assert "RESTORED step=" in res.stdout
    assert "DURABLE respawned=" in res.stdout
    assert "SIGKILL to READY" in res.stdout
    assert "[demo] FAILOVER ok step=" in res.stdout
