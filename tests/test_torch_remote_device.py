"""Device actors across nodes on the CPU: the port's remote provider over
rows of its tpu-batched dispatcher (akka_tpu_torch.remote.provider with
akka_tpu_torch.batched.bridge), held to the JAX package's.

The device leg: for each package two `provider = remote` systems over its
own in-proc transport; node B holds 64 slots counters (device rows on a
dispatcher with 4 bounded slots) and a host front actor at /user/front,
which answers a remote ask (i, v) by telling counter i the add, asking it
and piping the reply back (a device actor replies to asks only, through
its promise rows). Node A sends the same rounds of asks (numpy seed) to
B's front on each package: every reply equals the other package's and a
host oracle, and so does every counter's state (float32 within rtol 1e-4
/ atol 1e-3; the values are integers, so they are exact).

Then device refs by address, each scenario written once over a package
namespace and run on both packages through `side_by_side`
(tests/torch_remote_fixture.py), each package on its own in-proc wire,
with equal traces: a device ref on node B resolves under B's canonical
address to the very ref (`resolve_local`), and on node A to a
RemoteActorRef whose tells reach the row; a device ref inside a payload
crosses the wire under B's address; a remote watch of a device ref gives
Terminated when B stops it, and when B's transport dies (the watcher's
AddressTerminated). A counter's total is read there through its own ask:
an ask steps the row in both packages, where the reference does not step
on a tell alone.

Every system starts through the `nodes` fixture
(tests/torch_remote_fixture.py), which finishes the reference's systems
that hold device actors by hand (their known termination fault). Every
wait is at most 10 s.
"""

from concurrent.futures import Future

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import akka_tpu
import akka_tpu.batched as jb
from akka_tpu.pattern import ask as jask
from akka_tpu.remote.provider import RemoteActorRef as JRemoteActorRef

import akka_tpu_torch
import akka_tpu_torch.batched as tb
from akka_tpu_torch.pattern import ask as task

from torch_remote_fixture import WAIT, Nodes, addr_of, config, side_by_side

RTOL, ATOL = 1e-4, 1e-3
ADD, GET = 0, 1
P = 4
COUNTERS, ROUNDS, CONC = 64, 4, 16
DISPATCHER = {"device": "cpu", "capacity": 512, "payload-width": P,
              "mailbox-slots": 4, "spill-capacity": 0, "host-inbox": 512,
              "promise-rows": 32}


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


def front_class(P_):
    """The host front of a node's counters, for package `P_`: (i, v) adds
    v to counter i, asks it and pipes (i, total) to the sender."""
    pipe = (task if P_ is akka_tpu_torch else jask).pipe

    class Front(P_.Actor):
        def __init__(self, block):
            super().__init__()
            self.refs = [block[i] for i in range(len(block))]

        def receive(self, message):
            i, v = message
            ref = self.refs[i]
            ref.tell((ADD, [v]))
            out = Future()
            ref.ask((GET, [0.0]), timeout=WAIT).add_done_callback(
                lambda f: out.set_result((i, float(f.result()[0])))
                if f.exception() is None else out.set_exception(
                    f.exception()))
            pipe(out, self.sender, self.self_ref)

    return Front


@pytest.fixture()
def nodes():
    n = Nodes()
    try:
        yield n
    finally:
        n.close()


def _cfg():
    return config(actor={"tpu-dispatcher": DISPATCHER})


def _leg(a, b, P_, behavior, device_props, rounds):
    """B's counters and front; A's asks of B's front, round by round.
    Returns the replies by round (sorted by counter) and B's counts."""
    block = b.actor_of(device_props(behavior, n=COUNTERS), "counters")
    b.actor_of(P_.Props.create(front_class(P_), block), "front")
    front = a.provider.resolve_actor_ref(f"{addr_of(b)}/user/front")
    assert type(front).__name__ == "RemoteActorRef"
    ask = (task if P_ is akka_tpu_torch else jask).ask
    replies = []
    for picks, vals in rounds:
        futs = [ask(front, (int(i), float(v)), WAIT, a)
                for i, v in zip(picks, vals)]
        replies.append(sorted(f.result(WAIT) for f in futs))
    return replies, np.asarray(block.read_state("count"))


def test_remote_asks_of_device_counters_match_the_reference(nodes):
    rng = np.random.default_rng(5)
    rounds = [(rng.choice(COUNTERS, CONC, replace=False),
               rng.integers(1, 100, CONC).astype(np.float64))
              for _ in range(ROUNDS)]
    oracle, want = np.zeros(COUNTERS), []
    for picks, vals in rounds:
        oracle[picks] += vals
        want.append(sorted((int(i), float(oracle[i])) for i in picks))
    ta, ja = nodes.systems("devA", _cfg())
    tb_, jb_ = nodes.systems("devB", _cfg())
    got_t, state_t = _leg(ta, tb_, akka_tpu_torch, t_counter,
                          tb.device_props, rounds)
    got_j, state_j = _leg(ja, jb_, akka_tpu, j_counter, jb.device_props,
                          rounds)
    assert got_t == want
    for rt, rj in zip(got_t, got_j):
        assert [i for i, _ in rt] == [i for i, _ in rj]
        np.testing.assert_allclose([v for _, v in rt], [v for _, v in rj],
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(state_t, state_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(state_t, oracle.astype(np.float32))
    assert isinstance(ja.provider.resolve_actor_ref(
        f"{addr_of(jb_)}/user/front"), JRemoteActorRef)


# ------------------------------------------------- device refs by address
def _device(P):
    """Package P's device_props and slots counter behavior."""
    if P.name == "akka_tpu_torch":
        return tb.device_props, t_counter
    return jb.device_props, j_counter


def _pair(P, nodes, **kw):
    """Nodes A and B of package P with the counters' dispatcher (the
    reference's are finished by hand: they hold device actors)."""
    return tuple(nodes.node(name, P=P, device_rows=True,
                            actor={"tpu-dispatcher": DISPATCHER}, **kw)
                 for name in ("devA", "devB"))


def _count(ref) -> float:
    """A counter's total through its own ask (an ask steps the row in
    both packages; the reference does not step on a tell alone)."""
    return float(ref.ask((GET, [0.0]), timeout=WAIT).result(WAIT)[0])


def _await_count(P, ref, want: float) -> float:
    P.testkit.await_condition(lambda: _count(ref) == want, max_time=WAIT)
    return _count(ref)


def _canonical(P, nodes):
    a, b = _pair(P, nodes)
    device_props, counter = _device(P)
    ref = b.actor_of(device_props(counter), "counter-7")
    canonical = f"{addr_of(b)}/user/counter-7"
    remote = a.provider.resolve_actor_ref(canonical)
    trace = [type(ref).__name__,
             b.provider.resolve_actor_ref(canonical) is ref,
             b.provider.resolve_actor_ref("akka://devB/user/counter-7") is ref,
             type(remote).__name__, str(remote.path) == canonical]
    remote.tell((ADD, [5.0]))
    remote.tell((ADD, [2.5]))
    return trace + [_await_count(P, ref, 7.5)]


def test_device_ref_resolves_under_the_canonical_address(nodes):
    """B resolves its device ref's canonical path to the very ref; A to a
    RemoteActorRef whose tells reach the row."""
    assert side_by_side(_canonical, nodes) == [
        "DeviceActorRef", True, True, "RemoteActorRef", True, 7.5]


def _crosses(P, nodes):
    a, b = _pair(P, nodes)
    device_props, counter = _device(P)
    ref = b.actor_of(device_props(counter), "counter-x")
    probe = P.testkit.TestProbe(a)
    target = b.provider.resolve_actor_ref(str(probe.ref.path.with_address(
        a.provider.local_address)))
    target.tell(("counter", ref))
    _tag, got = probe.receive_one(WAIT)
    trace = [type(target).__name__, type(got).__name__,
             str(got.path) == f"{addr_of(b)}/user/counter-x"]
    got.tell((ADD, [3.0]))
    return trace + [_await_count(P, ref, 3.0)]


def test_device_ref_crosses_the_wire_under_its_nodes_address(nodes):
    """A device ref inside a payload arrives as a RemoteActorRef of B's
    canonical path, and a tell through it reaches the row."""
    assert side_by_side(_crosses, nodes) == [
        "RemoteActorRef", "RemoteActorRef", True, 3.0]


def _watch(P, nodes):
    a, b = _pair(P, nodes)
    device_props, counter = _device(P)
    ref = b.actor_of(device_props(counter), "mortal")
    remote = a.provider.resolve_actor_ref(f"{addr_of(b)}/user/mortal")
    probe = P.testkit.TestProbe(a)
    probe.watch(remote)
    P.testkit.await_condition(
        lambda: any(type(w).__name__ == "RemoteActorRef"
                    for w in ref._watched_by), max_time=WAIT)
    ref.stop()
    term = probe.expect_terminated(remote, WAIT)
    return [term.actor.path.elements, term.existence_confirmed,
            term.address_terminated]


def test_remote_watch_of_a_device_ref(nodes):
    """A Watch from node A reaches the device ref's send_system_message
    with a RemoteActorRef watcher; B stops the ref and A gets
    Terminated over the wire."""
    assert side_by_side(_watch, nodes) == [("user", "mortal"), True, False]


FAST_WATCH = {"watch-failure-detector": {
    "heartbeat-interval": "0.1s", "acceptable-heartbeat-pause": "1s",
    "expected-first-heartbeat-estimate": "0.1s"}}


def _address_terminated(P, nodes):
    a, b = _pair(P, nodes, remote=FAST_WATCH)
    device_props, counter = _device(P)
    b.actor_of(device_props(counter), "far")
    remote = a.provider.resolve_actor_ref(f"{addr_of(b)}/user/far")
    events = []
    a.event_stream.subscribe(events.append, P.provider.AddressTerminated)
    probe = P.testkit.TestProbe(a)
    probe.watch(remote)
    watcher = a.provider._remote_watcher.cell.actor
    P.testkit.await_condition(lambda: watcher.fd.is_monitoring(addr_of(b)),
                              max_time=WAIT)
    b.provider.shutdown_transport()
    term = probe.expect_terminated(remote, WAIT)
    return [term.address_terminated,
            [str(e.address) == addr_of(b) for e in events]]


def test_address_terminated_ends_a_watch_of_a_device_ref(nodes):
    """When B's transport dies, A's remote watcher stops hearing B, it
    publishes AddressTerminated, and A's watcher of B's device ref gets
    Terminated (address_terminated)."""
    assert side_by_side(_address_terminated, nodes) == [True, [True]]
