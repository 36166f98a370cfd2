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
6. Holds both kernels against their plain versions once more at the
   shapes these paths gave them: the 8-shard flat inboxes (sharded_d8)
   and the region's inbox as a wave's tells land (region).

Any failure raises and the exit code is non-zero. The last lines are the
kernel report (JSON; `ms` and the other top-level numbers are the random
pattern's, `patterns` holds every pattern and path shape, and
`launches_by_path` each path's launches), the card's name and power limit,
and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Dict

import numpy as np
import torch

from akka_tpu_torch.gateway import counter_behavior
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

RTOL, ATOL = bm.RTOL, bm.ATOL
N = 1 << 20                 # actors on the main path
M = N + bm.HOST_ROWS        # inbox rows: n * K emissions + host_inbox
SLOTS = bm.SLOTS
KERNEL_ITERS = 200          # C-entry launches per device timing
STEPS = 20                  # timed steps per main-path system
WAVES, WAVE_ASKS = 32, 256  # timed ask waves of the region phases


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
    # both kernels at the shapes the new paths gave them
    t0 = time.perf_counter()
    for label, flat in (("sharded_d8", sharded), ("region", region)):
        for k, (inputs, n) in flat.items():
            rows.setdefault(label, {})[k] = kernel_rows(
                label, inputs, n, lib, kernels=(k,))[k]
    del sharded, region
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
