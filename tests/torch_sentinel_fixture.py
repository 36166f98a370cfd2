"""What the port's sentinel test files share (not a test module): the
bookkeeping behind each file's one fixture, which builds every
MeshSentinel of the file (the port's on the CPU, the reference's on its
virtual devices) and, at the end, shuts each one down (joining its
snapshot writer) and asserts that no thread the file started is still
alive (5 s join); and the behaviors both packages run.

The reference writes orbax directories whenever orbax imports; the
fleet patches `akka_tpu.persistence.slab_snapshot._try_orbax` to None
for its lifetime, so both packages write and read `.npz` snapshots.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import akka_tpu.batched as jb
from akka_tpu.batched.sentinel import MeshSentinel as JSentinel
from akka_tpu.persistence import slab_snapshot as jslab

import akka_tpu_torch.batched as tb
from akka_tpu_torch.batched.sentinel import MeshSentinel as TSentinel
from akka_tpu_torch.parallel import shard_slots

# the timing fields of the records and events (everything else compares)
TIMED = {"ts", "ts_mono", "elapsed_s", "mttr_s", "rebuild_s", "pause_s",
         "pause_ms", "at_clock", "path", "size_bytes", "size"}


def slots(n: int) -> list:
    """The first n shard slots of the CPU's pool."""
    return shard_slots(max(8, n), "cpu")[:n]


class Fleet:
    """Every sentinel of one test file, and the threads they start."""

    def __init__(self, root):
        self.root = root
        self.before = {t.ident for t in threading.enumerate()}
        self.sentinels = []
        self._patch = pytest.MonkeyPatch()
        self._patch.setattr(jslab, "_try_orbax", lambda: None)

    def port(self, tag, capacity, behaviors, **kw):
        """A port sentinel on the CPU (n_devices or devices in kw; its
        own checkpoint directory unless kw names one)."""
        kw.setdefault("checkpoint_dir", str(self.root / f"port-{tag}"))
        s = TSentinel(capacity, behaviors, device="cpu", **kw)
        self.sentinels.append(s)
        return s

    def ref(self, tag, capacity, behaviors, **kw):
        """A reference sentinel on the virtual devices; `devices` may be
        a count."""
        if isinstance(kw.get("devices"), int):
            kw["devices"] = jax.devices()[:kw["devices"]]
        s = JSentinel(capacity, behaviors,
                      checkpoint_dir=str(self.root / f"ref-{tag}"), **kw)
        self.sentinels.append(s)
        return s

    def close(self):
        try:
            for s in self.sentinels:
                s.shutdown()
            deadline = time.monotonic() + 5.0
            me = threading.current_thread()
            for t in threading.enumerate():
                if t.ident not in self.before and t is not me:
                    t.join(max(0.0, deadline - time.monotonic()))
            alive = [t.name for t in threading.enumerate()
                     if t.ident not in self.before and t.is_alive()
                     and t is not me]
            assert not alive, f"threads still alive: {alive}"
        finally:
            self._patch.undo()


# ---------------------------------------------------------------- behaviors
def sum_pair(p: int, name: str = "sum"):
    """(reference, port) behaviors adding payload column 0 to `total`."""

    @jb.behavior(name, {"total": ((), jnp.float32)})
    def j_sum(state, inbox, ctx):
        return {"total": state["total"] + inbox.sum[0]}, jb.Emit.none(1, p)

    @tb.behavior(name, {"total": ((), torch.float32)})
    def t_sum(state, inbox, ctx):
        n = inbox.sum.shape[0]
        return ({"total": state["total"] + inbox.sum[:, 0]},
                tb.Emit.none(n, 1, p, device=inbox.sum.device))

    return j_sum, t_sum


def echo_pair(p: int, name: str = "echo"):
    """(reference, port) behaviors replying 2x the request's column 0 to
    the reply row in the last payload column (the ask convention)."""

    @jb.behavior(name, {"seen": ((), jnp.float32)})
    def j_echo(state, inbox, ctx):
        reply_to = inbox.sum[p - 1].astype(jnp.int32)
        body = jnp.zeros((p,), jnp.float32).at[0].set(inbox.sum[0] * 2.0)
        return ({"seen": state["seen"] + inbox.sum[0]},
                jb.Emit.single(reply_to, body, 1, p,
                               when=inbox.count > 0))

    @tb.behavior(name, {"seen": ((), torch.float32)})
    def t_echo(state, inbox, ctx):
        reply_to = inbox.sum[:, p - 1].to(torch.int32)
        body = torch.zeros_like(inbox.sum)
        body[:, 0] = inbox.sum[:, 0] * 2.0
        return ({"seen": state["seen"] + inbox.sum[:, 0]},
                tb.Emit.single(reply_to, body, 1, p,
                               when=inbox.count > 0))

    return j_echo, t_echo


def relay_pair(p: int, name: str = "relay"):
    """(reference, port) behaviors forwarding every message to actor 0
    (a fan-in that overloads a small exchange pair)."""

    @jb.behavior(name, {"seen": ((), jnp.float32)})
    def j_relay(state, inbox, ctx):
        return ({"seen": state["seen"] + inbox.sum[0]},
                jb.Emit.single(0, jnp.stack([inbox.sum[0],
                                             jnp.float32(0.0)]),
                               1, p, when=inbox.count > 0))

    @tb.behavior(name, {"seen": ((), torch.float32)})
    def t_relay(state, inbox, ctx):
        n = inbox.sum.shape[0]
        body = torch.zeros((n, p), device=inbox.sum.device)
        body[:, 0] = inbox.sum[:, 0]
        return ({"seen": state["seen"] + inbox.sum[:, 0]},
                tb.Emit.single(torch.zeros((n,), dtype=torch.int32,
                                           device=inbox.sum.device),
                               body, 1, p, when=inbox.count > 0))

    return j_relay, t_relay


# ------------------------------------------------------------------- reading
def untimed(rec: dict) -> dict:
    return {k: v for k, v in rec.items() if k not in TIMED}


def events(fr, skip=("device_flush", "device_step")) -> list:
    """A recorder's events without their timings, phi rounded; the port's
    sharded run also records device_flush and device_step (a deliberate
    difference), which are left out."""
    out = []
    for e in fr.events():
        if e["event"] in skip:
            continue
        e = untimed(e)
        if "phi" in e:
            e["phi"] = round(float(e["phi"]), 6)
        out.append({k: (list(v) if isinstance(v, (list, tuple, np.ndarray))
                        else v) for k, v in e.items()})
    return out


def outcome(fut, timeout: float = 10.0):
    """("ok", reply column 0), the exception's class name, or "pending"
    for a future that is not done."""
    if not fut.done():
        return "pending"
    exc = fut.exception(timeout)
    if exc is not None:
        return type(exc).__name__
    return ("ok", float(np.asarray(fut.result(timeout))[0]))
