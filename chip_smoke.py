#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (akka_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi) and builds the
   ring-mailbox kernels from akka_tpu_torch/csrc (nvcc, sm_90a).
2. Holds each kernel against its plain PyTorch version on the card, at a
   small ragged shape and at the main path's shape (m = 2^20 + 8 rows,
   n = 2^20 actors, P = 4, S = 2) under three traffic patterns (random,
   ring, 1000-collector fan-in; akka_tpu_torch/tools/bench_mailbox.py):
   integer outputs bit-equal, sums within rtol 1e-4 / atol 1e-3 (float
   atomics add in a run-dependent order). For each pattern it times the C
   entry on the card's clock (CUDA events around 200 launches on outputs
   allocated once, zeroing included: `ms`), the Python wrapper
   (`wrapper_ms`), the plain version and, for K1, one `index_add_` call,
   and computes the memory-bytes bound at 3.35 TB/s.
3. Drives the main path through BatchedSystem on the card at 1M actors:
   the ring in reduce mode, the 1M -> 1k fan-in, the ring with 2-slot
   bounded mailboxes (and its twin on the ranked kernels, which must agree
   bit for bit), and a few tells followed by step(). Each result is held to
   its closed form, and each path must have launched its kernel (launch
   counts are zeroed just before the path and read just after).
4. Drives the sharded system (ShardedBatchedSystem) at bench config 5,
   256 logical shards x 4096 entities = 2^20 actors, seeded with one token
   each, 20 timed steps after 20 warm ones: on one shard
   (sharded_ring_d1), on 8 shards of the card where every message crosses
   a shard (cross_shard_d8), and on 8 shards with 2-slot bounded
   mailboxes (sharded_slots_d8, bit-equal to its twin on the ranked
   kernels). Every actor must have received one token per step, nothing
   may be dropped, and K1 (K2 for slots) must launch once per step.
5. Serves asks through the region (DeviceShardRegion of the gateway's
   counter entity, 256 shards x 4096 entities on one shard of the axis,
   two spare blocks): one warm wave, then 32 timed ask_many waves of 256
   adds (integer-valued floats, so every sum is exact; about an eighth of
   each wave repeats an entity of the same wave), a solo ask, a rebalance
   of one shard and a wave over its entities. Every reply must equal a
   host oracle's running total, the totals must be conserved, no ask may
   be left in flight, and K1 must launch (region_serve). The same trace
   on a region with 2-slot bounded mailboxes (region_serve_slots) must
   give bit-equal replies and launch K2.
6. Serves the gateway on the card (akka_tpu_torch.tools.gateway_load):
   a full-width counter region (256 shards x 4096 entities, one shard of
   the axis, two spare blocks) behind RegionBackend(continuous=True,
   pipeline_depth=4) and GatewayServer(transport="evloop",
   aggregate=True) on 127.0.0.1, admission shedding only on ask-pool
   occupancy > 0.9. 16 client threads, each with its own GatewayClient
   and 64 entities of its own, send 512 integer-valued adds each as
   pipelined binary windows of 8 (depth 4); sheds are retried and
   counted (gateway_serve). Every ok reply must equal its client's
   running total, sum_all the acked sum (plus the warm-up), no reply may
   be an error, no ask may be in flight after quiesce, and K1 must launch
   once per region step. The same trace with continuous=False
   (gateway_serve_serialized) must give the same replies and totals, and
   the first 128 adds of each client on a region with 2-slot bounded
   mailboxes (gateway_serve_slots, K2 once per step) the replies
   gateway_serve gave them. gateway_serve_durable runs gateway_serve's
   trace on a region with the tell WAL and the entity journal attached
   (an fsync per WAL record and per entity-journal wave): the same
   replies, the journal's fold equal to the acked totals, and its fsyncs
   per 256 requests.
7. Durability (akka_tpu_torch.persistence, DeviceShardRegion's
   checkpoint/restore). region_restore: the region_serve region with
   both journals and an uninterrupted twin take 16 ask waves of 256
   adds, a rebalance (which drains the hand-off window and checkpoints
   itself), the timed checkpoint(), 16 more waves and 64 tells to new
   entities staged but not stepped; the journaled region is dropped
   without a goodbye and a fresh one restores from the directory. Every
   entity's total must equal the twin's and the host oracle's, the entity
   journal's fold the acked totals, and the replay must launch K1 once
   per replayed step (counts zeroed just before restore()). It prints
   the snapshot's bytes, checkpoint_ms, and restore_ms split into load,
   H2D and replay. region_restore_slots: the same with 2-slot bounded
   mailboxes, on K2. gateway_kill9: a full-width durable, deduplicating
   `serving_gateway serve` child on the card and two `load` children;
   the server is SIGKILLed mid-load and restarted with --restore on the
   same port and directory; acked_sum <= final_total <= sent_sum must
   hold, the `durable` admin op must report the respawned entities, and
   the restored server's replay must have launched K1 once per step (it
   prints its counts). It prints the wall time from SIGKILL to READY.
8. Holds both kernels against their plain versions once more at the
   shapes these paths gave them: the 8-shard flat inboxes (sharded_d8),
   the region's inbox as a wave's tells land (region) and the gateway
   region's (gateway).

Any failure raises and the exit code is non-zero. The last lines are the
kernel report (JSON; `ms` and the other top-level numbers are the random
pattern's, `patterns` holds every pattern and path shape, and
`launches_by_path` each path's launches), the card's name and power limit,
and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from typing import Dict

import numpy as np
import torch

from akka_tpu_torch.gateway import GatewayClient, counter_behavior
from akka_tpu_torch.models.baseline_benches import (PAYLOAD_W,
                                                    build_cross_shard,
                                                    build_cross_shard_slots,
                                                    build_fan_in,
                                                    build_ring,
                                                    build_ring_slots,
                                                    seed_ring_full)
from akka_tpu_torch.ops import cuda_mailbox as cm
from akka_tpu_torch.sharding import DeviceEntity, DeviceShardRegion
from akka_tpu_torch.tools import bench_mailbox as bm
from akka_tpu_torch.tools import gateway_load as gl
from akka_tpu_torch.tools import serving_gateway as sg

RTOL, ATOL = bm.RTOL, bm.ATOL
N = 1 << 20                 # actors on the main path
M = N + bm.HOST_ROWS        # inbox rows: n * K emissions + host_inbox
SLOTS = bm.SLOTS
KERNEL_ITERS = 200          # C-entry launches per device timing
STEPS = 20                  # timed steps per main-path system
WAVES, WAVE_ASKS = 32, 256  # timed ask waves of the region phases
GW_CLIENTS, GW_ENTS, GW_ADDS = 16, 64, 512  # gateway_serve's trace
GW_SLOTS_ADDS = 128        # adds per client of gateway_serve_slots
GW_WARM = 64               # warm-up adds (one each) before the clients
RESTORE_WAVES = 16         # ask waves before and after the checkpoint
LATE_TELLS = 64            # tells staged, not stepped, at the crash
KILL9_SECONDS = 25.0       # the load children's run in gateway_kill9


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def kernel_rows(label: str, inputs, n: int, lib,
                kernels=("K1", "K2")) -> dict:
    """`kernels` against their plain versions on `inputs` (integers
    bit-equal, sums within the tolerance), then timed: the C entry on the
    card's clock (`ms`), the wrapper, the plain version and, for K1, one
    `index_add_` call; the bound counts the bytes of this input's
    accepted rows."""
    dst, mtype, payload, valid = inputs
    m, n_p = dst.shape[0], payload.shape[1]
    e1, e2, _ = bm.package_entries(lib, inputs, n, SLOTS)
    ok = valid & (dst >= 0) & (dst < n)
    b1, b2 = bm.bound_bytes(m, n, n_p, SLOTS, live=int(ok.sum()))
    rows = {}
    if "K1" in kernels:
        err = bm.compare(f"K1 {label}", cm.ring_reduce(dst, payload, valid, n),
                         cm.ring_reduce_plain(dst, payload, valid, n))
        torch.cuda.synchronize()
        key = torch.where(ok, dst, n).long()
        src = torch.cat([torch.where(ok[:, None], payload, 0),
                         ok[:, None].float()], dim=1)
        rows["K1"] = {
            "ms": bm.cuda_ms(e1, KERNEL_ITERS, 5),
            "wrapper_ms": bm.cuda_ms(
                lambda: cm.ring_reduce(dst, payload, valid, n)),
            "plain_ms": bm.cuda_ms(
                lambda: cm.ring_reduce_plain(dst, payload, valid, n)),
            "library_ms": bm.cuda_ms(
                lambda: torch.zeros((n + 1, n_p + 1), device="cuda")
                .index_add_(0, key, src)),
            "bound_ms": bm.bound_ms(b1), "max_abs_err": err}
    if "K2" in kernels:
        err = bm.compare(f"K2 {label}", cm.ring_slots(*inputs, n, SLOTS),
                         cm.ring_slots_plain(*inputs, n, SLOTS))
        torch.cuda.synchronize()
        rows["K2"] = {
            "ms": bm.cuda_ms(e2, KERNEL_ITERS, 5),
            "wrapper_ms": bm.cuda_ms(
                lambda: cm.ring_slots(*inputs, n, SLOTS)),
            "plain_ms": bm.cuda_ms(
                lambda: cm.ring_slots_plain(*inputs, n, SLOTS)),
            "library_ms": None,
            "bound_ms": bm.bound_ms(b2), "max_abs_err": err}
    for k, row in rows.items():
        print(f"{label} m={m} n={n} {k} " + " ".join(
            f"{f} {v}" for f, v in row.items()))
    return rows


def kernel_phase(lib) -> Dict[str, dict]:
    """K1 and K2 at a small ragged shape and, at the main path's shape,
    at each traffic pattern; returns the report rows by pattern."""
    dst, mtype, payload, valid = bm.make_pattern("random", 37, 11, 3, 37)
    err = bm.compare("K1 m=37", cm.ring_reduce(dst, payload, valid, 11),
                     cm.ring_reduce_plain(dst, payload, valid, 11))
    err = max(err, bm.compare(
        "K2 m=37", cm.ring_slots(dst, mtype, payload, valid, 11, SLOTS),
        cm.ring_slots_plain(dst, mtype, payload, valid, 11, SLOTS)))
    torch.cuda.synchronize()
    print(f"kernel_check m=37 n=11 p=3 S={SLOTS}: max_abs_err={err}")
    return {pattern: kernel_rows(pattern, bm.make_pattern(
                pattern, M, N, PAYLOAD_W, seed), N, lib)
            for seed, pattern in enumerate(bm.PATTERNS)}


def flat_inputs(s):
    """The inputs of a sharded step's one delivery call, as it is about to
    run: the flat inbox, rows addressed outside their shard masked, and
    the recipient count."""
    d, ml = s.n_shards, s.m_local
    dst = s.inbox_dst.view(d, ml)
    own = s.inbox_valid.view(d, ml) & (dst >= s._bases) \
        & (dst < s._bases + s.local_n)
    return (s.inbox_dst.clone(), s.inbox_type.clone(),
            s.inbox_payload.clone(), own.reshape(-1).clone()), s.capacity


def timed_run(sys_, steps: int, msgs_per_step: int, label: str) -> float:
    """Warm run(steps), then a timed run(steps) between CUDA events;
    returns ms per step."""
    sys_.run(steps)
    ms = bm.cuda_ms(lambda: sys_.run(steps), iters=1, warmup=0) / steps
    print(f"{label} ms_per_step {ms}")
    print(f"{label} msgs_per_s {msgs_per_step / (ms * 1e-3)}")
    return ms


def path(label: str, kernel: str, launches: dict, fn, steps=None):
    """Drive one main-path phase with the launch counts zeroed just
    before and read just after; the phase must launch `kernel`, and with
    `steps`, exactly once per step."""
    cm.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    counts = dict(cm.LAUNCHES)
    print(f"{label} phase_s {time.perf_counter() - t0}")
    print(f"{label} launches {counts}")
    check(counts[kernel] > 0, f"{label} launched {kernel}")
    if steps is not None:
        print(f"{label} launches_per_step {counts[kernel] / steps}")
        check(counts[kernel] == steps, f"{label}: {counts[kernel]} "
              f"{kernel} launches, one per step for all shards ({steps})")
    launches[label] = counts
    return out


def check_twins(label: str, a, b, fields) -> None:
    """Integer carry fields bit-equal, the received counts too, the inbox
    payload within the kernel tolerance, and finite."""
    for field in fields:
        check(torch.equal(getattr(a, field), getattr(b, field)),
              f"{label} vs ranked twin: {field} bit-equal")
    check(torch.equal(a.state["received"], b.state["received"]),
          f"{label} vs ranked twin: received bit-equal")
    check(torch.allclose(a.inbox_payload, b.inbox_payload, rtol=RTOL,
                         atol=ATOL), f"{label} vs ranked twin: payload")
    check(bool(torch.isfinite(a.inbox_payload).all()),
          f"{label}: finite payloads")


def single_device_paths(launches: dict, steps: int = STEPS) -> None:
    def ring():
        s = build_ring(N, device="cuda")
        seed_ring_full(s)
        timed_run(s, steps, N, "ring_reduce")
        recv = s.read_state("received")
        check((recv == 2 * steps).all(), "ring: every actor received "
              "2 * steps tokens")
        return s

    s = path("ring_reduce", "ring_reduce", launches, ring)

    def tells():
        before = s.read_state("received")
        told = [0, 5, 7]
        s.tell(told, [1.0, 0.0, 0.0, 0.0])
        s.step()
        after = s.read_state("received")
        want = before + 1
        want[told] += 1
        check((after == want).all(), "tell + step: told rows got 2 "
              "messages, others 1")

    path("tell_step", "ring_reduce", launches, tells)
    del s

    def fan_in():
        f = build_fan_in(N, 1000, device="cuda")
        timed_run(f, steps, N, "fan_in")
        msgs = f.read_state("msgs")[:1000]
        total = f.read_state("total")[:1000]
        want = (2 * steps - 1) * N   # deliveries lag the first send a step
        check(int(msgs.sum()) == want, f"fan-in: {int(msgs.sum())} == {want}")
        check(float(total.astype("float64").sum()) == float(want),
              "fan-in: totals == msgs")

    path("fan_in", "ring_reduce", launches, fan_in)

    def slots_system(backend):
        r = build_ring_slots(N, SLOTS, device="cuda",
                             delivery_backend=backend)
        seed_ring_full(r)
        return r

    def slots():
        r = slots_system(None)
        timed_run(r, steps, N, "ring_slots")
        check((r.read_state("received") == 2 * steps).all(),
              "slots ring: every actor received 2 * steps tokens")
        return r

    r = path("ring_slots", "ring_slots", launches, slots)
    twin = slots_system("ranked")
    twin.run(2 * steps)
    check_twins("slots ring", r, twin,
                ("inbox_dst", "inbox_type", "inbox_valid", "alive",
                 "behavior_id", "step_count", "mail_dropped"))


def sharded_paths(launches: dict, steps: int = STEPS) -> dict:
    """The sharded system's paths; returns the 8-shard paths' delivery
    inputs by kernel."""
    def cross_shard(d):
        def run():
            x = build_cross_shard(256, 4096, n_devices=d, device="cuda")
            seed_ring_full(x)
            label = "sharded_ring_d1" if d == 1 else f"cross_shard_d{d}"
            timed_run(x, steps, x.capacity, label)
            check((x.read_state("received") == 2 * steps).all(),
                  f"{label}: every entity received 2 * steps tokens")
            check(x.total_dropped == 0 and x.mailbox_overflow == 0,
                  f"{label}: total_dropped == 0")
            pc, sc = x.pair_cap, x.spill_cap
            chunks = x.inbox_valid.view(d, x.m_local)[:, sc:sc + d * pc] \
                .view(d, d, pc)
            check(int(chunks.sum()) == x.capacity, f"{label}: every token "
                  "in flight")
            if d > 1:
                check(not bool(chunks.diagonal().any()),
                      f"{label}: every message crossed a shard")
            return x
        return run

    path("sharded_ring_d1", "ring_reduce", launches, cross_shard(1),
         steps=2 * steps)
    x = path("cross_shard_d8", "ring_reduce", launches, cross_shard(8),
             steps=2 * steps)
    flat = {"K1": flat_inputs(x)}
    del x

    def slots_system(backend):
        r = build_cross_shard_slots(256, 4096, n_devices=8, slots=SLOTS,
                                    device="cuda", delivery_backend=backend)
        seed_ring_full(r)
        return r

    def slots_d8():
        r = slots_system(None)
        timed_run(r, steps, r.capacity, "sharded_slots_d8")
        check((r.read_state("received") == 2 * steps).all(),
              "sharded slots: every entity received 2 * steps tokens")
        check(r.total_dropped == 0 and r.mailbox_overflow == 0,
              "sharded slots: nothing dropped")
        return r

    r = path("sharded_slots_d8", "ring_slots", launches, slots_d8,
             steps=2 * steps)
    twin = slots_system("ranked")
    twin.run(2 * steps)
    check_twins("sharded slots d8", r, twin,
                ("inbox_dst", "inbox_type", "inbox_valid", "alive",
                 "behavior_id", "step_count", "mail_dropped", "dropped",
                 "attention"))
    flat["K2"] = flat_inputs(r)
    return flat


def make_trace(seed: int = 0):
    """One warm wave and WAVES timed waves of WAVE_ASKS adds: 7/8 distinct
    entities of a 4096-name pool, the rest repeats of entities already in
    the wave; values are integers 1..9."""
    rng = np.random.default_rng(seed)
    pool = [f"entity-{i}" for i in range(4096)]
    waves = []
    distinct = WAVE_ASKS - WAVE_ASKS // 8
    for _ in range(WAVES + 1):
        names = list(rng.choice(pool, distinct, replace=False))
        names += list(rng.choice(names, WAVE_ASKS - distinct))
        order = rng.permutation(WAVE_ASKS)
        vals = rng.integers(1, 10, WAVE_ASKS).astype(np.float64)
        waves.append([(names[i], float(v)) for i, v in zip(order, vals)])
    return waves


def serve(label: str, slots: int, trace) -> list:
    """The region phase: returns every reply, in order."""
    region = DeviceShardRegion(DeviceEntity(
        "counter", counter_behavior(PAYLOAD_W), n_shards=256,
        entities_per_shard=4096, n_devices=1, spare_blocks=2,
        mailbox_slots=slots, spill_capacity=0 if slots else None),
        device="cuda")
    sys_ = region.system
    refs = {n: region.entity_ref(n) for w in trace for n, _ in w}
    oracle = {n: 0.0 for n in refs}
    sent = 0.0
    replies = []
    rounds = [0]
    run = sys_.run

    def counted_run(n_steps=1):
        rounds[0] += 1
        run(n_steps)

    sys_.run = counted_run

    def wave(asks):
        nonlocal sent
        reqs = [(refs[n].shard, refs[n].index, [v]) for n, v in asks]
        t0 = time.perf_counter()
        out = region.ask_many(reqs)
        dt = time.perf_counter() - t0
        for (n, v), o in zip(asks, out):
            check(not isinstance(o, BaseException), f"{label}: {o!r}")
            oracle[n] += v
            sent += v
            check(float(o[0]) == oracle[n], f"{label}: reply {o[0]} == "
                  f"oracle {oracle[n]} for {n}")
            replies.append(o)
        return dt

    wave(trace[0])  # warm: allocator, first launches
    times, per_wave_rounds, per_wave_steps = [], [], []
    for asks in trace[1:]:
        r0, s0 = rounds[0], sys_._host_step
        times.append(wave(asks))
        per_wave_rounds.append(rounds[0] - r0)
        per_wave_steps.append(sys_._host_step - s0)
    times = np.asarray(times)
    print(f"{label} asks_per_s {WAVES * WAVE_ASKS / times.sum()}")
    print(f"{label} wave_ms_p50 {np.percentile(times, 50) * 1e3}")
    print(f"{label} wave_ms_p99 {np.percentile(times, 99) * 1e3}")
    print(f"{label} rounds_per_wave {np.mean(per_wave_rounds)} "
          f"steps_per_wave {np.mean(per_wave_steps)}")

    name = trace[0][0][0]
    solo = region.ask(refs[name].shard, refs[name].index, [5.0])
    oracle[name] += 5.0
    sent += 5.0
    check(float(solo[0]) == oracle[name], f"{label}: solo ask")
    replies.append(solo)

    moved = refs[name].shard
    old_row = refs[name].row
    region.rebalance(moved)
    check(refs[name].row != old_row, f"{label}: the shard moved")
    wave([(n, 1.0) for n in refs if refs[n].shard == moved])
    rows = np.asarray([r.row for r in refs.values()], np.int64)
    totals = sys_.read_state("total", rows)
    check(all(float(t) == oracle[n] for t, n in zip(totals, refs)),
          f"{label}: totals == oracle after rebalance")
    live = sys_.alive.cpu().numpy()  # the moved block's old copy is dead
    check(float(sys_.read_state("total")[live].astype(np.float64).sum())
          == sent, f"{label}: totals conserved ({sent})")
    check(region.ask_pool_stats()["in_flight"] == 0,
          f"{label}: no ask left in flight")
    print(f"{label} asks {len(replies)} entities {len(refs)} "
          f"steps {sys_._host_step}")
    return replies, sys_


def region_paths(launches: dict) -> dict:
    """region_serve and region_serve_slots on one trace; returns the
    region's delivery inputs as a wave's tells land, by kernel."""
    trace = make_trace()
    flat = {}
    replies = {}
    for label, slots, kernel in (("region_serve", 0, "ring_reduce"),
                                 ("region_serve_slots", SLOTS,
                                  "ring_slots")):
        out, sys_ = path(label, kernel, launches,
                         lambda: serve(label, slots, trace))
        steps = sys_._host_step
        print(f"{label} launches_per_step "
              f"{launches[label][kernel] / steps}")
        replies[label] = out
        # the first step's inbox of a wave: its tells flushed in
        for i in range(WAVE_ASKS):
            sys_.tell(i * 4099 % sys_.capacity,
                      [1.0, 0.0, 0.0, float(sys_.capacity - 1)])
        sys_._flush_staged()
        flat["K2" if slots else "K1"] = flat_inputs(sys_)
        del sys_
    a, b = replies["region_serve"], replies["region_serve_slots"]
    check(len(a) == len(b) and all(np.array_equal(x, y)
                                   for x, y in zip(a, b)),
          "region_serve_slots replies bit-equal to region_serve's")
    return flat


def gateway_region(slots: int) -> DeviceShardRegion:
    """The full-width counter region of the region and gateway phases."""
    return DeviceShardRegion(DeviceEntity(
        "counter", counter_behavior(PAYLOAD_W), n_shards=256,
        entities_per_shard=4096, n_devices=1, spare_blocks=2,
        mailbox_slots=slots, spill_capacity=0 if slots else None),
        device="cuda")


def gateway_serve(label: str, slots: int, continuous: bool, traces,
                  durable: bool = False):
    """One gateway phase on a fresh region: a warm-up wave, then the
    clients' trace over TCP. With `durable`, the region has both journals
    attached with an fsync per record (tell) and per wave (entity
    events). Returns (LoadResult, the region's steps, the region's
    delivery inputs as a window's tells land)."""
    region = gateway_region(slots)
    directory = tempfile.mkdtemp(prefix="chip_smoke_") if durable else None
    if durable:
        region.attach_journal(directory, fsync_every_n=1)
        region.attach_entity_journal(directory, fsync_every_n=1)
    backend, srv = gl.serve_stack(region, continuous=continuous)
    try:
        warm = backend.ask_many([f"warm-{i}" for i in range(GW_WARM)],
                                [1.0] * GW_WARM)
        check(warm == [1.0] * GW_WARM, f"{label}: warm-up replies")
        if durable:
            wal0 = sum(1 for _ in region._journal.records())
            ej0 = region._entity_journal.stats()
        res = gl.drive(srv.host, srv.port, traces)
        check(not res.errors, f"{label}: no error replies "
              f"({res.errors[:3]})")
        want = sum(len(w) for t in traces for w in t)
        check(res.requests == want, f"{label}: {res.requests} acked "
              f"of {want} adds")
        check(gl.running_totals_hold(res), f"{label}: every reply equals "
              "its client's running total")
        check(backend.batcher.quiesce(60.0), f"{label}: quiesce")
        total = backend.sum_all()
        check(total == res.acked + GW_WARM, f"{label}: sum_all {total} == "
              f"acked {res.acked} + warm-up {GW_WARM}")
        check(region.ask_pool_stats()["in_flight"] == 0,
              f"{label}: no ask in flight after quiesce")
        st = backend.batcher.stats()
        agg = srv.aggregator.stats()
        lat = np.asarray(res.latencies) * 1e3
        print(f"{label} requests {res.requests} seconds {res.seconds}")
        print(f"{label} requests_per_s {res.requests / res.seconds}")
        print(f"{label} reply_ms_p50 {np.percentile(lat, 50)} "
              f"reply_ms_p99 {np.percentile(lat, 99)} "
              f"(per window of 8, client side)")
        print(f"{label} waves {st['batches']} mean_wave "
              f"{st['mean_batch_size']} overlap_ratio {st['overlap_ratio']}")
        print(f"{label} ingest_windows {agg['windows']} mean_window "
              f"{agg['mean_window_size']} sheds {res.sheds}")
        steps = region.system._host_step
        print(f"{label} steps {steps}")
        if durable:
            # one fsync per WAL record (every staged tell) and per entity
            # journal wave
            wal = sum(1 for _ in region._journal.records()) - wal0
            ej = region._entity_journal.stats()
            ej_fsyncs = ej["fsyncs"] - ej0["fsyncs"]
            check(region._entity_journal.totals() ==
                  {**{f"warm-{i}": 1.0 for i in range(GW_WARM)},
                   **{e: t for rs in res.replies for e, _, t in rs}},
                  f"{label}: the entity journal's fold == the acked "
                  "totals")
            print(f"{label} wal_fsyncs {wal} entity_journal_fsyncs "
                  f"{ej_fsyncs} entity_journal_waves "
                  f"{ej['waves'] - ej0['waves']}")
            print(f"{label} fsyncs_per_256_requests "
                  f"{(wal + ej_fsyncs) * 256 / res.requests}")
        # a window's tells as they land: the delivery call's inputs
        sys_ = region.system
        for i in range(64):
            sys_.tell(i * 4099 % sys_.capacity,
                      [1.0, 0.0, 0.0, float(sys_.capacity - 1)])
        sys_._flush_staged()
        flat = flat_inputs(sys_)
    finally:
        srv.stop()
        backend.close()
        if directory is not None:
            shutil.rmtree(directory, ignore_errors=True)
    return res, steps, flat


def gateway_paths(launches: dict) -> dict:
    """gateway_serve, its serialized twin and gateway_serve_slots;
    returns the gateway region's delivery inputs by kernel."""
    traces = gl.client_traces(1, GW_CLIENTS, GW_ENTS, GW_ADDS)
    runs, flat = {}, {}
    short = [t[:GW_SLOTS_ADDS // 8] for t in traces]
    for label, slots, continuous, trace, kernel, durable in (
            ("gateway_serve", 0, True, traces, "ring_reduce", False),
            ("gateway_serve_durable", 0, True, traces, "ring_reduce", True),
            ("gateway_serve_serialized", 0, False, traces, "ring_reduce",
             False),
            ("gateway_serve_slots", SLOTS, True, short, "ring_slots",
             False)):
        res, steps, inputs = path(
            label, kernel, launches,
            lambda: gateway_serve(label, slots, continuous, trace, durable))
        n = launches[label][kernel]
        print(f"{label} launches_per_step {n / steps}")
        check(n == steps, f"{label}: {n} {kernel} launches, one per region "
              f"step ({steps})")
        runs[label] = res
        flat["K2" if slots else "K1"] = inputs
    main = runs["gateway_serve"].replies
    check(runs["gateway_serve_serialized"].replies == main,
          "gateway_serve_serialized: the same replies as gateway_serve")
    check(runs["gateway_serve_durable"].replies == main,
          "gateway_serve_durable: the same replies as gateway_serve")
    check(runs["gateway_serve_serialized"].acked ==
          runs["gateway_serve"].acked, "gateway_serve_serialized: totals")
    slots_replies = runs["gateway_serve_slots"].replies
    check(all(s == m[:len(s)] for s, m in zip(slots_replies, main)),
          "gateway_serve_slots: the replies gateway_serve gave the same "
          "requests")
    return flat


def ask_waves(region, trace, oracle: dict, label: str) -> None:
    """Each wave through `ask_many`; every reply must equal the oracle's
    running total (which it advances)."""
    for asks in trace:
        refs = [region.entity_ref(n) for n, _ in asks]
        out = region.ask_many([(r.shard, r.index, [v])
                               for r, (_, v) in zip(refs, asks)])
        for (n, v), o in zip(asks, out):
            check(not isinstance(o, BaseException), f"{label}: {o!r}")
            oracle[n] = oracle.get(n, 0.0) + v
            check(float(o[0]) == oracle[n], f"{label}: reply {o[0]} == "
                  f"oracle {oracle[n]} for {n}")


def restore_phase(label: str, slots: int, kernel: str, trace,
                  launches: dict) -> None:
    """A journaled region (tell WAL + entity journal) and its
    uninterrupted twin take the same traffic: RESTORE_WAVES ask waves, a
    rebalance (which drains the hand-off window and checkpoints, as the
    reference does), the timed checkpoint(), RESTORE_WAVES more waves,
    and LATE_TELLS tells to entities first allocated after the
    checkpoint, staged but not stepped. The journaled region is dropped
    without a goodbye; a fresh region on the same directory restores
    (launch counts zeroed just before restore(), read just after) and
    must equal the twin (after its 2-step flush) and the host oracle,
    entity by entity."""
    directory = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        twin = gateway_region(slots)
        victim = gateway_region(slots)
        victim.attach_journal(directory)
        victim.attach_entity_journal(directory)
        oracles = ({}, {})
        first, second = trace[1:1 + RESTORE_WAVES], \
            trace[1 + RESTORE_WAVES:1 + 2 * RESTORE_WAVES]
        for r, o in zip((twin, victim), oracles):
            ask_waves(r, first, o, label)
            r.rebalance(r.entity_ref(first[0][0][0]).shard)
        t0 = time.perf_counter()
        snap = victim.checkpoint()
        ckpt_ms = (time.perf_counter() - t0) * 1e3
        snap_bytes = os.path.getsize(snap)
        late = [(f"late-{i}", float(i % 7 + 1)) for i in range(LATE_TELLS)]
        for r, o in zip((twin, victim), oracles):
            ask_waves(r, second, o, label)
            for n, v in late:
                r.entity_ref(n).tell([v, 0.0, 0.0, -1.0])
                o[n] = o.get(n, 0.0) + v
        twin.run(2)  # the twin applies the staged tells
        oracle = oracles[0]
        check(oracles[1] == oracle, f"{label}: both regions' replies")
        crash_step = victim.system._host_step
        del victim  # the crash: no close, no sync, no goodbye

        fresh = gateway_region(slots)
        fresh.attach_journal(directory)
        fresh.attach_entity_journal(directory)
        cm.reset_launches()
        t0 = time.perf_counter()
        step = fresh.restore()
        fresh.block_until_ready()
        restore_ms = (time.perf_counter() - t0) * 1e3
        counts = dict(cm.LAUNCHES)
        timing = fresh.restore_timings
        names = sorted(oracle)
        got = fresh.system.read_state(
            "total", np.asarray([fresh.entity_ref(n).row for n in names]))
        want = twin.system.read_state(
            "total", np.asarray([twin.entity_ref(n).row for n in names]))
        check(step == crash_step, f"{label}: restored step {step} == "
              f"crash step {crash_step}")
        check(all(float(g) == oracle[n] for g, n in zip(want, names)),
              f"{label}: the twin's totals == the host oracle's")
        check(np.array_equal(got, want), f"{label}: every restored "
              f"total == the twin's ({len(names)} entities)")
        check(fresh._durable_replayed_totals ==
              {n: t for n, t in oracle.items() if not n.startswith("late-")},
              f"{label}: the entity journal's fold == the acked totals")
        check(bool(torch.isfinite(fresh.system.state["total"]).all()),
              f"{label}: finite totals")
        replayed = int(timing["replayed_steps"])
        print(f"{label} rows {fresh.system.capacity} entities "
              f"{len(names)} snapshot_bytes {snap_bytes} checkpoint_ms "
              f"{ckpt_ms}")
        print(f"{label} restore_ms {restore_ms} load_ms {timing['load_ms']} "
              f"h2d_ms {timing['h2d_ms']} replay_ms {timing['replay_ms']} "
              f"replayed_steps {replayed} step {step}")
        print(f"{label} launches {counts}")
        check(counts[kernel] == replayed > 0, f"{label}: {counts[kernel]} "
              f"{kernel} launches, one per replayed step ({replayed})")
        launches[label] = counts
        del fresh, twin
    finally:
        shutil.rmtree(directory, ignore_errors=True)


def kill9_phase(launches: dict) -> None:
    """gateway_kill9: a durable, deduplicating `serving_gateway serve`
    child (full width) and two `load` children; the server is SIGKILLed
    mid-load and restarted with --restore on the same port and
    directory. acked_sum <= final_total <= sent_sum must hold, the
    restored child's replay must have launched K1, and the `durable`
    admin op must report the respawned entities."""
    directory = tempfile.mkdtemp(prefix="chip_smoke_")
    seconds = KILL9_SECONDS
    extra = ["--shards", "256", "--eps", "4096", "--rate", "400",
             "--burst", "200"]
    serve = sg._child(sg.serve_argv("cuda", directory, extra=extra))
    loads, admin = [], None
    try:
        port = sg._wait_ready(serve, 300.0)
        loads = [sg._child(["load", "--port", str(port), "--tenant",
                            f"k9-{i}", "--seconds", str(seconds),
                            "--pace", "0.005"]) for i in (0, 1)]
        admin = GatewayClient("127.0.0.1", port, timeout=30.0)
        before = sg._wait_sum_above(admin, 0.0, 120.0)
        time.sleep(seconds * 0.3)
        sg._wait_sum_above(admin, before, 120.0)
        admin.close()
        seen = []
        serve, secs = sg.kill9_restart(serve, sg.serve_argv(
            "cuda", directory, port, restore=True, extra=extra), 300.0,
            seen)
        fields = sg.restored_fields(seen)
        print(f"gateway_kill9 sigkill_to_ready_s {secs}")
        print(f"gateway_kill9 restored {fields}")
        durable = admin.request_retry("__admin", "", "durable",
                                      deadline_s=60.0)
        check(durable.get("status") == "ok", f"gateway_kill9: {durable}")
        respawned = durable["data"]["replayed_entities"]
        check(respawned > 0 and respawned == fields["respawned"],
              f"gateway_kill9: durable reports {respawned} respawned")
        results = []
        for p in loads:
            out = p.communicate(timeout=seconds + 300)[0]
            results += [json.loads(line) for line in out.splitlines()
                        if line.startswith("{")]
        check(len(results) == 2, "gateway_kill9: both loads reported")
        sent = sum(r["sent_sum"] for r in results)
        acked = sum(r["acked_sum"] for r in results)
        total = float(admin.request_retry("__admin", "", "sum",
                                          deadline_s=60.0)["value"])
        print(f"gateway_kill9 sent_sum {sent} acked_sum {acked} "
              f"final_total {total} loads {results}")
        check(acked <= total <= sent, "gateway_kill9: acked_sum <= "
              "final_total <= sent_sum")
        counts = fields["launches"]
        check(counts["ring_reduce"] > 0 and
              counts["ring_reduce"] == fields["replayed_steps"],
              f"gateway_kill9: the restored server's replay launched K1 "
              f"once per step ({counts})")
        launches["gateway_kill9_restore"] = counts
    finally:
        if admin is not None:
            admin.close()
        for p in loads:
            if p.poll() is None:
                p.kill()
                p.wait()
        serve.send_signal(signal.SIGTERM)
        try:
            serve.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            serve.kill()
            serve.wait()
        shutil.rmtree(directory, ignore_errors=True)


def durability_paths(launches: dict) -> None:
    """region_restore, region_restore_slots and gateway_kill9."""
    trace = make_trace(1)
    for label, slots, kernel in (("region_restore", 0, "ring_reduce"),
                                 ("region_restore_slots", SLOTS,
                                  "ring_slots")):
        t0 = time.perf_counter()
        restore_phase(label, slots, kernel, trace, launches)
        print(f"{label} phase_s {time.perf_counter() - t0}")
    t0 = time.perf_counter()
    kill9_phase(launches)
    print(f"gateway_kill9 phase_s {time.perf_counter() - t0}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    smi = bm.card_line()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    lib = cm.build(verbose=True)
    print(f"build_s {time.perf_counter() - t0}")

    t0 = time.perf_counter()
    rows = kernel_phase(lib)
    print(f"kernel_phase_s {time.perf_counter() - t0}")
    launches: Dict[str, dict] = {}
    single_device_paths(launches)
    sharded = sharded_paths(launches)
    region = region_paths(launches)
    gateway = gateway_paths(launches)
    durability_paths(launches)
    # both kernels at the shapes the new paths gave them
    t0 = time.perf_counter()
    for label, flat in (("sharded_d8", sharded), ("region", region),
                        ("gateway", gateway)):
        for k, (inputs, n) in flat.items():
            rows.setdefault(label, {})[k] = kernel_rows(
                label, inputs, n, lib, kernels=(k,))[k]
    del sharded, region, gateway
    print(f"path_kernels_s {time.perf_counter() - t0}")

    entry = {"K1": ("ring_reduce", "_run(with_slots=False)"),
             "K2": ("ring_slots", "_run(with_slots=True)")}
    kernels = []
    for k, (cname, mode) in entry.items():
        by_pattern = {pat: r[k] for pat, r in rows.items() if k in r}
        kernels.append({
            "name": f"{k} {cname}", "route": "cuda",
            "source": "akka_tpu_torch/csrc/ring_mailbox.cu",
            "replaces": f"akka_tpu/ops/pallas_mailbox.py:137 {mode}",
            "launches": sum(c[cname] for c in launches.values()),
            "bound_by": "bytes",
            **rows["random"][k],
            "max_abs_err": max(r["max_abs_err"]
                               for r in by_pattern.values()),
            "launches_by_path": {p: c[cname] for p, c in launches.items()},
            "patterns": by_pattern})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
