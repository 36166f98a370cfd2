"""The thread ring: `build_ring(n, static=False)`, every actor forwarding
what it received to its successor each step, delivered dynamically (K1 on
a card), driven by `BatchedSystem.run`.

Set-up builds the ring, seeds its `tokens` tokens into the inbox on the
device, on distinct actors drawn from the seed, each with a payload of
`payload_width` floats drawn from the seed by a generator on the device,
captures the step's graph and runs WARM_RUNS runs.

The window dispatches `run(run_steps)` back to back until the host clock
passes its end and synchronizes once. The host runs at most
RUNS_IN_FLIGHT runs ahead of the card (it waits on the CUDA event of the
run that many back), so the window ends within a few milliseconds of its
length. CUDA events bracket the window's runs, or, in a traced run, the
runs before the traced slice.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict

from portbench.harness import shape_facts

# runs after the capture that warm the step before the window
WARM_RUNS = 2
# runs the host may dispatch ahead of the card in the window
RUNS_IN_FLIGHT = 16


class Session:
    def __init__(self, config: Dict[str, Any], traffic: Dict[str, Any],
                 seed: int, device: str):
        self.config, self.traffic = config, traffic
        self.seed, self.device = int(seed), device
        self.attempted = self.failed = 0

    def setup(self) -> None:
        import torch
        from akka_tpu_torch.models.baseline_benches import build_ring
        c, t = self.config, self.traffic
        self.n = n = int(c["actors"])
        self.p = int(c["payload_width"])
        self.sys = build_ring(n, static=False, device=self.device)
        if self.sys.payload_width != self.p:
            raise RuntimeError(f"the ring's payload width is "
                               f"{self.sys.payload_width}, not {self.p}")
        dev = self.sys.device
        g = torch.Generator(device=dev)
        g.manual_seed(self.seed)
        self.k = int(t["tokens"])
        dst0 = torch.randperm(n, generator=g, device=dev)[:self.k]
        payload0 = torch.rand((self.k, self.p), generator=g, device=dev,
                              dtype=torch.float32)
        self.sys.seed_inbox(dst0.to(torch.int32), payload0)
        self.dst0 = dst0.cpu().numpy()
        self.payload0 = payload0.cpu().numpy()
        self.run_steps = int(t["run_steps"])
        self.sys.warmup()
        self.steps = 0
        for _ in range(WARM_RUNS):
            self.sys.run(self.run_steps)
            self.steps += self.run_steps
        self.sys.block_until_ready()

    def window(self, seconds: float, tracer, trace_s: float) -> None:
        import torch
        from torch.profiler import record_function
        on_card = self.sys.device.type == "cuda"
        ev = (lambda: torch.cuda.Event(enable_timing=True)) if on_card \
            else None
        pending: deque = deque()
        steps0 = self.steps
        self.t_start = time.perf_counter()
        t_end = self.t_start + seconds
        t_trace = t_end - trace_s if tracer is not None else float("inf")
        if on_card:
            self._ev_a = ev()
            self._ev_a.record()
        self._ev_b = None
        self.trace_steps = 0
        while True:
            now = time.perf_counter()
            if now >= t_trace and tracer.t_begin is None:
                if on_card:
                    self._ev_b = ev()
                    self._ev_b.record()
                self._timed_steps = self.steps - steps0
                tracer.begin()
                trace0 = self.steps
            if now >= t_end:
                break
            with record_function("portbench.run"):
                self.sys.run(self.run_steps)
            self.steps += self.run_steps
            if on_card:
                e = ev()
                e.record()
                pending.append(e)
                if len(pending) > RUNS_IN_FLIGHT:
                    pending.popleft().synchronize()
        if tracer is not None and tracer.active:
            tracer.end()        # drains the card, then stops the profiler
            self.trace_steps = self.steps - trace0
            self.t_close = tracer.t_end
        else:
            if on_card:
                self._ev_b = ev()
                self._ev_b.record()
                self._timed_steps = self.steps - steps0
            self.sys.block_until_ready()
            self.t_close = time.perf_counter()
        self.window_steps = self.steps - steps0
        self.attempted = self.window_steps * self.k

    def drain(self, limit_s: float) -> None:
        """Nothing is left in flight: the window ended on a sync."""

    def outputs(self) -> Dict[str, Any]:
        s = self.sys
        return {"n": self.n, "steps": self.steps, "dst0": self.dst0,
                "payload0": self.payload0,
                "received": s.read_state("received"),
                "pend_dst": s.inbox_dst.cpu().numpy(),
                "pend_valid": s.inbox_valid.cpu().numpy(),
                "pend_payload": s.inbox_payload.cpu().numpy()}

    def end_to_end(self) -> Dict[str, float]:
        return {"msgs_per_s": self.window_steps * self.k
                / (self.t_close - self.t_start)}

    def counters(self) -> Dict[str, float]:
        d = {"steps": self.window_steps, "trace_steps": self.trace_steps,
             # every step delivers one message a token
             "delivered_per_step": self.k, **shape_facts(self.sys)}
        if self._ev_b is not None and self._timed_steps:
            d["timed_steps"] = self._timed_steps
            d["timed_device_ms"] = self._ev_a.elapsed_time(self._ev_b)
        return d

    def close(self) -> None:
        del self.sys
