"""The device-actor bridge of the port (akka_tpu_torch.batched.bridge, the
`tpu-batched` dispatcher and the provider's device branch) held to the
reference's (akka_tpu) on the CPU, through the public ActorSystem API.

Both packages get the same behaviors, spawns and tells (from a numpy
seed where they are random); the reference runs as its own tests run it
(JAX on the CPU, its ranked/XLA families), the port with the dispatcher's
`device: "cpu"`. Integer state, step counts, generations and dead-letter
counts must be bit-identical; float state within rtol 1e-4 / atol 1e-3.
Where the auto-pump may add steps, each side is held to the scenario's
closed form in its own step count.

Every ActorSystem and handle starts through the `actors` fixture
(tests/torch_actor_fixture.py), which ends them and asserts that no
thread the test started is still alive. The depth-k pump's scenarios
(ask timeout in flight, rebuild racing a full pipeline, depth-k parity
with the chaos oracle) are in tests/test_torch_device_lifecycle.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import akka_tpu
import akka_tpu.batched as jb
from akka_tpu.batched import bridge as jbridge

import akka_tpu_torch
import akka_tpu_torch.batched as tb
from akka_tpu_torch.batched import bridge as tbridge

from torch_actor_fixture import Actors, steps_of

RTOL, ATOL = 1e-4, 1e-3
ADD, GET = 0, 1
P = 4
TIMEOUT = 10.0  # every ask, result() and probe wait

DISPATCHER = {"device": "cpu", "capacity": 512, "payload-width": P,
              "mailbox-slots": 4, "host-inbox": 512, "promise-rows": 32}
CFG = {"akka": {"stdout-loglevel": "OFF", "log-dead-letters": 0,
                "actor": {"tpu-dispatcher": DISPATCHER}}}


# ------------------------------------------------------- behaviors, twice
@jb.behavior("counter", {"count": ((), jnp.float32)}, inbox="slots")
def j_counter(state, mailbox, ctx):
    def apply(carry, t, pl):
        cnt, rdst = carry
        return (jnp.where(t == ADD, cnt + pl[0], cnt),
                jnp.where(t == GET, jb.reply_dst(pl), rdst))

    cnt, rdst = mailbox.fold((state["count"], jnp.asarray(-1, jnp.int32)),
                             apply)
    return ({"count": cnt},
            jb.Emit.single(rdst, cnt, 1, P, when=rdst >= 0))


@tb.behavior("counter", {"count": ((), torch.float32)}, inbox="slots")
def t_counter(state, mailbox, ctx):
    def apply(carry, t, pl):
        cnt, rdst = carry
        return (torch.where(t == ADD, cnt + pl[:, 0], cnt),
                torch.where(t == GET, tb.reply_dst(pl), rdst))

    n = ctx.actor_id.shape[0]
    cnt, rdst = mailbox.fold(
        (state["count"], torch.full((n,), -1, dtype=torch.int32)), apply)
    reply = torch.zeros((n, P))
    reply[:, 0] = cnt
    return ({"count": cnt}, tb.Emit.single(rdst, reply, 1, P, when=rdst >= 0))


@jb.behavior("pp", {"hits": ((), jnp.float32), "peer": ((), jnp.int32)},
             inbox="slots")
def j_pp(state, mailbox, ctx):
    got = mailbox.fold(jnp.asarray(0.0, jnp.float32),
                       lambda c, t, pl: c + pl[0])
    return ({"hits": state["hits"] + got},
            jb.Emit.single(state["peer"], jnp.asarray([1.0]), 1, P,
                           when=mailbox.count > 0))


@tb.behavior("pp", {"hits": ((), torch.float32), "peer": ((), torch.int32)},
             inbox="slots")
def t_pp(state, mailbox, ctx):
    got = mailbox.fold(torch.zeros_like(state["hits"]),
                       lambda c, t, pl: c + pl[:, 0])
    return ({"hits": state["hits"] + got},
            tb.Emit.single(state["peer"], [1.0], 1, P,
                           when=mailbox.count > 0))


RING = 256


@jb.behavior("ringb", {"received": ((), jnp.float32)}, inbox="slots")
def j_ringb(state, mailbox, ctx):
    got = mailbox.fold(jnp.asarray(0.0, jnp.float32),
                       lambda c, t, pl: c + pl[0])
    nxt = (ctx.actor_id + 1) % jnp.asarray(RING, jnp.int32)
    return ({"received": state["received"] + got},
            jb.Emit.single(nxt, jnp.asarray([1.0]), 1, P,
                           when=mailbox.count > 0))


@tb.behavior("ringb", {"received": ((), torch.float32)}, inbox="slots")
def t_ringb(state, mailbox, ctx):
    got = mailbox.fold(torch.zeros_like(state["received"]),
                       lambda c, t, pl: c + pl[:, 0])
    return ({"received": state["received"] + got},
            tb.Emit.single((ctx.actor_id + 1) % RING, [1.0], 1, P,
                           when=mailbox.count > 0))


@jb.behavior("other", {"seen": ((), jnp.float32)}, inbox="slots")
def j_other(state, mailbox, ctx):
    return ({"seen": state["seen"] + mailbox.fold(
        jnp.asarray(0.0, jnp.float32), lambda c, t, pl: c + pl[0])},
            jb.Emit.none(1, P))


@tb.behavior("other", {"seen": ((), torch.float32)}, inbox="slots")
def t_other(state, mailbox, ctx):
    n = ctx.actor_id.shape[0]
    return ({"seen": state["seen"] + mailbox.fold(
        torch.zeros_like(state["seen"]), lambda c, t, pl: c + pl[:, 0])},
            tb.Emit.none(n, 1, P))


@pytest.fixture()
def actors():
    a = Actors(CFG)
    try:
        yield a
    finally:
        a.close()


# --------------------------------------------------------------- scenarios
def test_tell_and_read(actors):
    t_sys, j_sys = actors.systems("bridge-tell")
    got = {}
    for name, s, b, cls in (("port", t_sys, t_counter, tb.DeviceActorRef),
                            ("ref", j_sys, j_counter, jb.DeviceActorRef)):
        ref = s.actor_of(tb.device_props(b) if name == "port"
                         else jb.device_props(b), "c1")
        assert isinstance(ref, cls) and ref.path.name == "c1"
        for x in (1.0, 2.0, 3.5):
            ref.tell((ADD, [x]))
        h = (tb.get_handle if name == "port" else jb.get_handle)(s)
        h.step()
        got[name] = (float(ref.read_state("count")), ref.gen,
                     int(h.generation_of(ref.row)[0]))
    assert got["port"] == got["ref"] == (6.5, 0, 0)


def test_ask_roundtrip(actors):
    t_sys, j_sys = actors.systems("bridge-ask")
    t = t_sys.actor_of(tb.device_props(t_counter), "c2")
    j = j_sys.actor_of(jb.device_props(j_counter), "c2")
    for ref in (t, j):
        ref.tell((ADD, [10.0]))
        ref.tell((ADD, [5.0]))
    rt = akka_tpu_torch.ask_sync(t, (GET, [0.0]), timeout=TIMEOUT)
    rj = akka_tpu.ask_sync(j, (GET, [0.0]), timeout=TIMEOUT)
    np.testing.assert_allclose(rt, np.asarray(rj), rtol=RTOL, atol=ATOL)
    assert rt[0] == 15.0
    # every promise slot is back in the pool once the reply resolved
    for h in (tb.get_handle(t_sys), jb.get_handle(j_sys)):
        st = h.ask_pool_stats()
        assert (st["waiting"], st["zombies"]) == (0, 0)


def test_ping_pong(actors):
    """Two device actors volley one token: a lands it at odd steps, b at
    even ones, so after S steps a holds ceil(S/2) hits and b floor(S/2)."""
    t_sys, j_sys = actors.systems("bridge-pp")
    got = {}
    for name, s, b, props, gh in (
            ("port", t_sys, t_pp, tb.device_props, tb.get_handle),
            ("ref", j_sys, j_pp, jb.device_props, jb.get_handle)):
        a = s.actor_of(props(b), "a")
        bb = s.actor_of(props(b, init_state={
            "peer": np.asarray([0], np.int32)}), "b")
        h = gh(s)
        st = h.runtime.state  # built here: spawns are replayed
        with h._step_lock:  # wire a -> b (rows are known now)
            if name == "port":
                st["peer"][a.row] = bb.row
            else:
                st["peer"] = st["peer"].at[a.row].set(bb.row)
        a.tell((0, [1.0]))
        h.step(20)
        n = steps_of(h)
        ha, hb = float(a.read_state("hits")), float(bb.read_state("hits"))
        assert n >= 20
        assert (ha, hb) == ((n + 1) // 2, n // 2), (name, ha, hb, n)
        got[name] = (a.row, bb.row, int(bb.read_state("peer")))
    assert got["port"] == got["ref"]


def test_block_ring(actors):
    """One block ref, one bulk tell to every row, on-device volleys: every
    actor receives one token per step."""
    t_sys, j_sys = actors.systems("bridge-ring")
    rows = {}
    for name, s, b, props, gh, cls in (
            ("port", t_sys, t_ringb, tb.device_props, tb.get_handle,
             tb.DeviceBlockRef),
            ("ref", j_sys, j_ringb, jb.device_props, jb.get_handle,
             jb.DeviceBlockRef)):
        block = s.actor_of(props(b, n=RING), "ring")
        assert isinstance(block, cls) and len(block) == RING
        block.tell((0, [1.0]))
        h = gh(s)
        h.step(10)
        n = steps_of(h)
        received = block.read_state("received")
        assert n >= 10
        np.testing.assert_array_equal(received, np.full(RING, n, np.float32))
        assert block[0].read_state("received") == received[0]
        rows[name] = (np.asarray(block.rows), np.asarray(block.gens))
    np.testing.assert_array_equal(rows["port"][0], rows["ref"][0])
    np.testing.assert_array_equal(rows["port"][1], rows["ref"][1])


def test_rebuild_on_new_behavior(actors):
    """A new behavior type after the build rebuilds the system and keeps
    rows, state and pending messages."""
    t_sys, j_sys = actors.systems("bridge-rebuild")
    got = {}
    for name, s, cnt, oth, props, gh in (
            ("port", t_sys, t_counter, t_other, tb.device_props,
             tb.get_handle),
            ("ref", j_sys, j_counter, j_other, jb.device_props,
             jb.get_handle)):
        c = s.actor_of(props(cnt), "c")
        c.tell((ADD, [7.0]))
        h = gh(s)
        h.step()
        assert c.read_state("count") == 7.0
        o = s.actor_of(props(oth), "o")
        c.tell((ADD, [3.0]))
        o.tell((0, [2.0]))
        h.step()
        got[name] = (float(c.read_state("count")),
                     float(o.read_state("seen")), c.row, o.row,
                     h._promise_base)
    assert got["port"] == got["ref"]
    assert got["port"][:2] == (10.0, 2.0)


def test_watch_stop_and_dead_letters(actors):
    from akka_tpu.actor.messages import DeadLetter as JDeadLetter
    from akka_tpu.testkit import TestProbe as JProbe
    from akka_tpu_torch.actor.messages import DeadLetter as TDeadLetter
    from akka_tpu_torch.testkit import TestProbe as TProbe
    t_sys, j_sys = actors.systems("bridge-watch")
    got = {}
    for name, s, b, props, gh, probe_cls, dl_cls in (
            ("port", t_sys, t_counter, tb.device_props, tb.get_handle,
             TProbe, TDeadLetter),
            ("ref", j_sys, j_counter, jb.device_props, jb.get_handle,
             JProbe, JDeadLetter)):
        ref = s.actor_of(props(b), "mortal")
        probe = probe_cls(s)
        probe.watch(ref)
        dl_probe = probe_cls(s)
        s.event_stream.subscribe(dl_probe.ref, dl_cls)
        ref.stop()
        term = probe.expect_terminated(ref, TIMEOUT)
        assert term.actor is ref
        ref.tell((ADD, [1.0]))  # a late tell goes to dead letters
        dl = dl_probe.receive_one(TIMEOUT)
        assert isinstance(dl, dl_cls) and dl.message == (ADD, [1.0])
        h = gh(s)
        got[name] = (int(h.generation_of(ref.row)[0]),
                     int(h.runtime.dead_lettered))
    assert got["port"] == got["ref"] == (1, 0)


def test_default_dispatcher_tpu_batched(actors):
    """default-dispatcher.type = tpu-batched: a host actor runs on the
    dispatcher's pool and a device actor lands on the device, through the
    same API."""
    cfg = {"akka": {"stdout-loglevel": "OFF", "log-dead-letters": 0,
                    "actor": {"default-dispatcher": {
                        "type": "tpu-batched", "device": "cpu",
                        "capacity": 1 << 10, "payload-width": P,
                        "mailbox-slots": 4, "promise-rows": 16,
                        "host-inbox": 1024}}}}
    t_sys, j_sys = actors.systems("bridge-default", cfg)
    replies = {}
    for name, s, pkg, b, props, probe_mod in (
            ("port", t_sys, akka_tpu_torch, t_counter, tb.device_props,
             "akka_tpu_torch.testkit"),
            ("ref", j_sys, akka_tpu, j_counter, jb.device_props,
             "akka_tpu.testkit")):
        import importlib
        probe_cls = importlib.import_module(probe_mod).TestProbe

        class Echo(pkg.Actor):
            def receive(self, message):
                self.sender.tell(("echo", message), self.self_ref)

        host = s.actor_of(pkg.Props(factory=Echo, cls=Echo), "host-echo")
        probe = probe_cls(s)
        host.tell("hi", probe.ref)
        assert probe.receive_one(TIMEOUT) == ("echo", "hi")
        dev = s.actor_of(props(b), "dev-counter")
        dev.tell((ADD, [4.0]))
        replies[name] = pkg.ask_sync(dev, (GET, [0.0]), timeout=TIMEOUT)
    assert type(t_sys.dispatchers.lookup(
        "akka.actor.default-dispatcher")).__name__ == "TpuBatchedDispatcher"
    np.testing.assert_allclose(replies["port"], np.asarray(replies["ref"]),
                               rtol=RTOL, atol=ATOL)
    assert replies["port"][0] == 4.0


@pytest.mark.parametrize("dtype, jdtype, capacity, ok", [
    (torch.float32, jnp.float32, 1 << 20, True),
    (torch.bfloat16, jnp.bfloat16, 1 << 20, False),
    (torch.bfloat16, jnp.bfloat16, 256, True),
    (torch.float16, jnp.float16, 1 << 12, False),
    (torch.int32, jnp.int32, 1 << 20, True),
], ids=["f32-1M", "bf16-1M", "bf16-256", "f16-4096", "i32-1M"])
def test_reply_id_dtype_refusal(dtype, jdtype, capacity, ok):
    """The reply-to row id is a value cast into the payload dtype: a
    capacity whose ids would round is refused at construction, in both
    packages alike (no runtime or thread is built either way)."""
    assert tbridge.max_exact_row_id(dtype) == \
        jbridge.max_exact_row_id(jdtype)
    kw = dict(capacity=capacity, promise_rows=8)
    if ok:
        tbridge.BatchedRuntimeHandle(payload_dtype=dtype, device="cpu", **kw)
        jbridge.BatchedRuntimeHandle(payload_dtype=jdtype, **kw)
        return
    name = str(dtype).removeprefix("torch.")
    with pytest.raises(ValueError, match=name):
        tbridge.BatchedRuntimeHandle(payload_dtype=dtype, device="cpu", **kw)
    with pytest.raises(ValueError, match=name):
        jbridge.BatchedRuntimeHandle(payload_dtype=jdtype, **kw)


def test_bf16_roundtrip(actors):
    """A bf16 payload handle within the exact-id range routes the reply
    through the value-cast id (the port's codec encodes float32 rows and
    staging casts them)."""
    @jb.behavior("bf16-echo", {})
    def j_echo(state, inbox, ctx):
        return state, jb.Emit.single(jb.reply_dst(inbox.sum), inbox.sum * 2,
                                     1, P, when=inbox.count > 0)

    @tb.behavior("bf16-echo", {})
    def t_echo(state, inbox, ctx):
        return state, tb.Emit.single(tb.reply_dst(inbox.sum), inbox.sum * 2,
                                     1, P, when=inbox.count > 0)

    th, jh = actors.handles_pair(capacity=128, payload_width=P,
                                 payload_dtype=torch.bfloat16,
                                 promise_rows=8, host_inbox=32)
    assert th.default_codec.dtype == np.float32
    got = {}
    for name, h, b in (("port", th, t_echo), ("ref", jh, j_echo)):
        rows = h.spawn(b, 1)
        reply = h.ask(int(rows[0]), (0, [3.0, 0, 0, 0]),
                      timeout=TIMEOUT).result(TIMEOUT)
        got[name] = np.asarray(reply, np.float32)
        assert h.runtime.inbox_payload.dtype in (torch.bfloat16,
                                                 jnp.bfloat16)
    np.testing.assert_array_equal(got["port"], got["ref"])
    assert got["port"][0] == 6.0


def test_a_cuda_handle_needs_a_card(actors):
    """The dispatcher's default device is CUDA: without a card, building
    its handle (the first device actor) raises instead of running on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbridge.BatchedRuntimeHandle(capacity=64, promise_rows=8)
    s = actors.port_system("bridge-cuda", {"akka": {
        "stdout-loglevel": "OFF", "log-dead-letters": 0,
        "actor": {"tpu-dispatcher": {"capacity": 64, "promise-rows": 8}}}})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        s.actor_of(tb.device_props(t_counter), "c")


def test_dispatcher_forwards_device_and_spill_capacity(actors):
    """The port's dispatcher keys: `device` and `spill-capacity` reach the
    handle's system (0: bounded slots mailboxes, the ring kernel K2's
    mode; absent: the default spill region)."""
    cfg = {"akka": {"stdout-loglevel": "OFF", "log-dead-letters": 0,
                    "actor": {"tpu-dispatcher": dict(DISPATCHER,
                                                     **{"spill-capacity": 0}),
                              "spill-dispatcher": dict(DISPATCHER,
                                                       type="tpu-batched")}}}
    t_sys = actors.port_system("bridge-keys", cfg)
    bounded = tb.get_handle(t_sys)
    spill = tb.get_handle(t_sys, "akka.actor.spill-dispatcher")
    assert bounded is not spill
    for h in (bounded, spill):
        h.spawn(t_counter, 1)
    assert bounded.runtime.device.type == spill.runtime.device.type == "cpu"
    assert bounded.runtime.spill_cap == 0
    assert spill.runtime.spill_cap == max(DISPATCHER["host-inbox"], 4 * 4)
