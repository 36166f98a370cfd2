"""What the port's actor-system test files share (not a test module): the
bookkeeping behind each file's one fixture, which starts every
ActorSystem, handle and thread of a test and, at its end, terminates the
port's systems (asserting that termination finished), shuts the handles
down and asserts that no thread the test started is still alive (5 s
join).

A reference (akka_tpu) system that holds device actors never finishes
terminating: its device refs never notify their parent, so the user
guardian waits for them forever (a reference fault; the port's refs
notify theirs). `close()` finishes such a system by hand, through its own
`_finish_terminate`, which shuts its dispatchers and handles down.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

import akka_tpu
from akka_tpu.batched import bridge as jbridge

import akka_tpu_torch
from akka_tpu_torch.batched import bridge as tbridge
from akka_tpu_torch.persistence.slab_snapshot import host_array

JAX_DTYPE = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32,
             torch.int32: jnp.int32}


class Actors:
    """Every system, handle and thread of one test."""

    def __init__(self, config):
        self.config = config
        self.before = {t.ident for t in threading.enumerate()}
        self.port_systems, self.ref_systems = [], []
        self.handles, self.threads = [], []

    def port_system(self, name, config=None):
        t = akka_tpu_torch.ActorSystem.create(
            name, self.config if config is None else config)
        self.port_systems.append(t)
        return t

    def systems(self, name, config=None):
        """A port and a reference ActorSystem of one config (the reference
        ignores the dispatcher's `device` key)."""
        config = self.config if config is None else config
        t = self.port_system(name, config)
        j = akka_tpu.ActorSystem.create(name, config)
        self.ref_systems.append(j)
        return t, j

    def port_handle(self, **kw):
        h = tbridge.BatchedRuntimeHandle(device="cpu", **kw)
        self.handles.append(h)
        return h

    def ref_handle(self, **kw):
        if "payload_dtype" in kw:
            kw["payload_dtype"] = JAX_DTYPE[kw["payload_dtype"]]
        h = jbridge.BatchedRuntimeHandle(**kw)
        self.handles.append(h)
        return h

    def handles_pair(self, **kw):
        """A port and a reference BatchedRuntimeHandle of one config."""
        return self.port_handle(**kw), self.ref_handle(**kw)

    def thread(self, target):
        th = threading.Thread(target=target, daemon=True)
        self.threads.append(th)
        th.start()
        return th

    def close(self):
        for s in self.port_systems + self.ref_systems:
            s.terminate()
        for s in self.port_systems:
            assert s.await_termination(10.0), f"{s} failed to terminate"
        for s in self.ref_systems:
            if not s.await_termination(0.2):
                s._finish_terminate()  # the reference fault above
        for h in self.handles:
            h.shutdown()
        deadline = time.monotonic() + 5.0
        left = [t for t in threading.enumerate()
                if t.ident not in self.before]
        for t in left:
            t.join(max(0.0, deadline - time.monotonic()))
        alive = [t.name for t in left if t.is_alive()]
        assert not alive, f"threads left running: {alive}"


def host(x) -> np.ndarray:
    """A host copy of a tensor or array of either package."""
    if isinstance(x, torch.Tensor):
        return host_array(x)
    return np.asarray(jax.device_get(x))


def steps_of(h) -> int:
    """The device step counter of a handle's system, either package."""
    rt = h.runtime
    with h._step_lock:
        return int(host(rt.step_count))


def state_of(h) -> dict:
    """Every state column of a handle's system, on the host."""
    rt = h.runtime
    with h._step_lock:
        return {k: host(v) for k, v in sorted(rt.state.items())}
