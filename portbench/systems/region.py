"""The sharded counter: a full-width DeviceShardRegion of counter entities
behind RegionBackend's continuous ask front end, driven by a closed loop.

Set-up builds the region the configuration states, resolves every name of
the key space once through `entity_refs` (so that no ask in the window
allocates a row), makes every row live with `allocate_all`, captures the
step's graph, and warms the ask path with WARM_ROUNDS calls of every
caller at the window's own load.

The window: `callers` logical callers, each with one call of `call_size`
Increments outstanding through `RegionBackend.ask_many_async`; a caller whose
call completes sends its next at once. One submitting thread hands over every
call, so the order in which asks reach the front end is known; the
replies arrive on the scheduler's thread, which stamps each call's
completion. An ask's latency runs from the moment its call was handed to
`ask_many_async` to the moment its `on_done` fired. Every caller draws its
keys from its own stream of the seed, so a seed gives the same calls in
the same order per caller, however the window paces them.
"""

from __future__ import annotations

import queue
import time
from typing import Any, Dict, List, Optional

import numpy as np

from portbench.harness import shape_facts
from portbench.yardstick.keys import KeyLaw, key_space

# calls of every caller that warm the ask path before the window
WARM_ROUNDS = 2


class _Call:
    __slots__ = ("caller", "keys", "adds", "t0", "t_done", "outcomes",
                 "window")

    def __init__(self, caller: int, keys: np.ndarray, adds: np.ndarray,
                 window: bool):
        self.caller = caller
        self.keys = keys
        self.adds = adds
        self.window = window
        self.t0 = 0.0
        self.t_done: Optional[float] = None
        self.outcomes: Optional[List[Any]] = None


class Session:
    def __init__(self, config: Dict[str, Any], traffic: Dict[str, Any],
                 seed: int, device: str):
        self.config, self.traffic = config, traffic
        self.seed, self.device = int(seed), device
        self.calls: List[_Call] = []
        self._done: "queue.SimpleQueue[_Call]" = queue.SimpleQueue()
        self._outstanding = 0
        self.attempted = self.failed = 0

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from akka_tpu_torch.gateway.ingress import (RegionBackend,
                                                    counter_behavior)
        from akka_tpu_torch.sharding.device import (DeviceEntity,
                                                    DeviceShardRegion)
        c, t = self.config, self.traffic
        self.n_shards = int(c["number_of_shards"])
        self.eps = int(c["entities_per_shard"])
        if self.n_shards * self.eps != int(c["recordcount"]):
            raise ValueError("recordcount is not number_of_shards x "
                             "entities_per_shard")
        self.region = DeviceShardRegion(DeviceEntity(
            c["entity_type"], counter_behavior(int(c["payload_width"])),
            n_shards=self.n_shards, entities_per_shard=self.eps,
            n_devices=int(c["n_devices"]),
            spare_blocks=int(c["spare_blocks"]),
            mailbox_slots=int(c["mailbox_slots"]),
            host_inbox_per_shard=int(c["host_inbox_per_shard"])),
            device=self.device)
        self.names = key_space(self.n_shards, self.eps, c["name_prefix"])
        refs = self.region.entity_refs(self.names)
        shard = np.fromiter((r.shard for r in refs), np.int64, len(refs))
        index = np.fromiter((r.index for r in refs), np.int64, len(refs))
        del refs
        want = np.arange(len(self.names), dtype=np.int64)
        if not (np.array_equal(shard, want // self.eps)
                and np.array_equal(index, want % self.eps)):
            raise RuntimeError("the region placed the key space elsewhere "
                               "than its shard hash says")
        self.region.allocate_all()
        self.region.system.warmup()
        self.backend = RegionBackend(
            self.region, steps=int(c["ask_steps"]),
            max_extra_steps=int(c["ask_max_extra_steps"]),
            max_batch=int(c["max_batch"]), continuous=True,
            pipeline_depth=int(c["pipeline_depth"]))

        self.law = KeyLaw(len(self.names), t["keys"],
                          float(t.get("theta", 0.99)))
        self.n_callers = int(t["callers"])
        self.call_size = int(t["call_size"])
        self.increment = float(c["increment"])
        self.rngs = [np.random.default_rng([self.seed, i])
                     for i in range(self.n_callers)]
        # the warm-up: every caller's first WARM_ROUNDS calls
        left = [WARM_ROUNDS] * self.n_callers
        for i in range(self.n_callers):
            self._submit(i, window=False)
            left[i] -= 1
        while self._outstanding:
            call = self._done.get(timeout=60.0)
            self._outstanding -= 1
            if left[call.caller] > 0:
                left[call.caller] -= 1
                self._submit(call.caller, window=False)
        self.region.block_until_ready()

    def _submit(self, caller: int, window: bool) -> None:
        rng = self.rngs[caller]
        keys = self.law.draw(rng, self.call_size)
        adds = np.full(self.call_size, self.increment, np.float32)
        call = _Call(caller, keys, adds, window)
        ids = [self.names[k] for k in keys.tolist()]
        done = self._done

        def on_done(outcomes, _seqs, call=call):
            call.t_done = time.perf_counter()
            call.outcomes = outcomes
            done.put(call)

        self.calls.append(call)
        self._outstanding += 1
        call.t0 = time.perf_counter()
        self.backend.ask_many_async(ids, adds.tolist(), None, on_done)

    # ------------------------------------------------------------ window
    def _snapshot(self) -> Dict[str, float]:
        st = self.backend.batcher.stats()
        return {"waves": st["batches"], "asks": st["asks"],
                "overlap_s": st["waves_overlap_s"],
                "busy_s": st["waves_busy_s"],
                "steps": float(int(self.region.system.step_count))}

    def window(self, seconds: float, tracer, trace_s: float) -> None:
        from torch.profiler import record_function
        self._before = self._snapshot()
        self.t_start = time.perf_counter()
        self.t_end = self.t_start + seconds
        t_trace = self.t_end - trace_s if tracer is not None else None
        with record_function("portbench.calls"):
            for i in range(self.n_callers):
                self._submit(i, window=True)
        while True:
            now = time.perf_counter()
            if t_trace is not None and now >= t_trace \
                    and tracer.t_begin is None:
                tracer.begin()
            if now >= self.t_end:
                break
            try:
                call = self._done.get(timeout=min(self.t_end - now, 0.05))
            except queue.Empty:
                continue
            self._outstanding -= 1
            if time.perf_counter() < self.t_end:
                with record_function("portbench.call"):
                    self._submit(call.caller, window=True)
        if tracer is not None and tracer.active:
            tracer.end()
        self._after = self._snapshot()
        self.tracer = tracer

    def drain(self, limit_s: float) -> None:
        """Wait for every call still in flight (at most `limit_s`)."""
        deadline = time.perf_counter() + limit_s
        while self._outstanding and time.perf_counter() < deadline:
            try:
                self._done.get(timeout=deadline - time.perf_counter())
            except queue.Empty:
                break
            else:
                self._outstanding -= 1
        self.backend.batcher.quiesce(max(deadline - time.perf_counter(),
                                         0.0))
        self.region.block_until_ready()

    # ----------------------------------------------------------- results
    def _replies(self) -> np.ndarray:
        """Per ask, in submission order: its reply, or NaN where it got
        none (an exception, or no `on_done`)."""
        out = np.full(len(self.calls) * self.call_size, np.nan, np.float32)
        for j, call in enumerate(self.calls):
            if call.outcomes is None:
                continue
            for i, o in enumerate(call.outcomes):
                if isinstance(o, float):
                    out[j * self.call_size + i] = o
        return out

    def outputs(self) -> Dict[str, Any]:
        system = self.region.system
        base = np.asarray([self.region.row_of(s, 0)
                           for s in range(self.n_shards)], np.int64)
        k = np.arange(len(self.names), dtype=np.int64)
        rows = base[k // self.eps] + k % self.eps
        final = system.read_state("total")[rows]
        replies = self._replies()
        window = np.repeat([c.window for c in self.calls], self.call_size)
        self.attempted = int(window.sum())
        self.failed = int(np.isnan(replies[window]).sum())
        return {
            "n_entities": len(self.names),
            "keys": np.concatenate([c.keys for c in self.calls]),
            "adds": np.concatenate([c.adds for c in self.calls]),
            "caller": np.repeat([c.caller for c in self.calls],
                                self.call_size).astype(np.int32),
            "replies": replies,
            "final": np.asarray(final, np.float32),
            "max_batch": int(self.config["max_batch"])}

    def _answered(self, t0: float, t1: float) -> List[_Call]:
        return [c for c in self.calls if c.window and c.t_done is not None
                and t0 <= c.t_done <= t1
                and all(isinstance(o, float) for o in c.outcomes)]

    def end_to_end(self) -> Dict[str, float]:
        calls = self._answered(self.t_start, self.t_end)
        lat = np.repeat([(c.t_done - c.t0) * 1e3 for c in calls],
                        self.call_size)
        return {"asks_per_s": len(lat) / (self.t_end - self.t_start),
                "ask_p95_ms": float(np.percentile(lat, 95))
                if len(lat) else float("nan")}

    def counters(self) -> Dict[str, float]:
        d = {k: self._after[k] - self._before[k] for k in self._before}
        d.update(shape_facts(self.region.system))
        tr = self.tracer
        if tr is not None and tr.t_begin is not None:
            # each ask is two messages delivered over its life: its tell
            # to the entity and the entity's reply to its promise row
            answered = self._answered(tr.t_begin, tr.t_end)
            d["delivered_in_slice"] = 2 * self.call_size * len(answered)
        return d

    def close(self) -> None:
        self.backend.close()
        del self.backend, self.region
