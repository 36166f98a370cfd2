"""The port's gateway over real sockets, on the CPU: the evloop front door
(akka_tpu_torch.gateway.evloop) in front of a continuous RegionBackend,
the `stream` transport's typed refusal, and the serving demo
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


def test_stream_transport_raises_naming_its_roadmap_item():
    srv = GatewayServer(None, None, AdmissionController(rate=1e9, burst=1e9),
                        SloTracker())
    assert srv.transport == "stream"
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        srv.start()
    with pytest.raises(ValueError, match="unknown transport"):
        GatewayServer(None, None, AdmissionController(), SloTracker(),
                      transport="udp")


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
