"""The port's remoting (akka_tpu_torch.remote: the provider, the in-proc
and TCP transports, remote deathwatch, quarantine, the wire's
serialization) on the CPU, held to the JAX package's: tests/test_remote.py's
10 scenarios, each written once over a package namespace and run on both
packages through `side_by_side` (tests/torch_remote_fixture.py), two
systems of one package in one process on that package's own wire. The
port's trace (replies, arrivals, Terminated and Quarantined events, the
lanes used) must equal the reference's, and each test also asserts the
trace's values.

Every system starts through the `nodes` fixture: the in-proc transport,
or TCP on 127.0.0.1 port 0; at the end every system is terminated and
awaited, the port transports' threads joined, and no thread may be
left. Every wait is at most 10 s.
"""

import hashlib
import threading

import numpy as np
import pytest

from torch_remote_fixture import WAIT, Nodes, addr_of, side_by_side


@pytest.fixture()
def nodes():
    n = Nodes()
    try:
        yield n
    finally:
        n.close()


def echo_class(P):
    class Echo(P.Actor):
        def receive(self, message):
            if isinstance(message, str) and message == "who":
                self.sender.tell(str(self.context.system.name),
                                 self.self_ref)
            else:
                self.sender.tell(("echo", message), self.self_ref)

    return Echo


def _pair(P, nodes):
    return nodes.node("sysA", P=P), nodes.node("sysB", P=P)


def _remote(a, b, path):
    return a.provider.resolve_actor_ref(f"{addr_of(b)}{path}")


def _array(x):
    return (type(x).__name__, str(x.dtype), list(x.shape),
            hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest())


BIG = np.arange(1 << 16, dtype=np.float32)   # 256 KiB >> the threshold


def _lane(P, nodes, kind):
    lane = {"large-message-threshold": 4096}
    a = nodes.node("laneA", "tcp", P, remote=lane)
    b = nodes.node("laneB", "tcp", P, remote=lane)
    b.actor_of(P.Props.create(echo_class(P)), "echo")
    ref = _remote(a, b, "/user/echo")
    small = P.ask_sync(ref, "hi", timeout=WAIT, system=a)
    sent = P.device_array(BIG.copy()) if kind == "tensor" else BIG
    tag, got = P.ask_sync(ref, sent, timeout=WAIT, system=a)
    lanes = sorted({k[2] for k in a.provider.transport._conns})
    return [type(ref).__name__, small, tag, _array(got), lanes]


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_large_message_lane_over_tcp(nodes, kind):
    """Oversized payloads ride a dedicated lane (its own TCP connection),
    so they cannot head-of-line-block ordinary traffic (Artery's lane
    partitioning). A device array (a torch tensor in the port, a jax.Array
    in the reference) travels as its host copy and arrives as a numpy
    array."""
    kind_, small, tag, got, lanes = side_by_side(_lane, nodes, kind)
    assert (kind_, small, tag) == ("RemoteActorRef", ("echo", "hi"), "echo")
    assert got == _array(BIG)
    assert "large" in lanes and set(lanes) - {"large"}, lanes


def _tell_and_reply(P, nodes):
    a, b = _pair(P, nodes)
    b.actor_of(P.Props.create(echo_class(P)), "echo")
    remote = _remote(a, b, "/user/echo")
    return [type(remote).__name__,
            P.ask_sync(remote, "who", timeout=WAIT, system=a),
            P.ask_sync(remote, ("x", 1), timeout=WAIT, system=a)]


def test_remote_tell_and_reply(nodes):
    assert side_by_side(_tell_and_reply, nodes) == [
        "RemoteActorRef", "sysB", ("echo", ("x", 1))]


def _tensor_payload(P, nodes):
    a, b = _pair(P, nodes)
    results = []
    got = threading.Event()

    class TensorSink(P.Actor):
        def receive(self, message):
            results.append(message)
            got.set()

    b.actor_of(P.Props.create(TensorSink), "sink")
    _remote(a, b, "/user/sink").tell(
        np.arange(12, dtype=np.float32).reshape(3, 4))
    assert got.wait(WAIT)
    return [_array(m) for m in results]


def test_remote_tensor_payload(nodes):
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    assert side_by_side(_tensor_payload, nodes) == [_array(arr)]


def _remote_stop(P, nodes):
    a, b = _pair(P, nodes)
    echo = b.actor_of(P.Props.create(echo_class(P)), "victim")
    _remote(a, b, "/user/victim").stop()
    P.testkit.await_condition(lambda: echo.is_terminated, max_time=WAIT)
    return [echo.is_terminated]


def test_remote_stop(nodes):
    assert side_by_side(_remote_stop, nodes) == [True]


def _blackhole(P, nodes):
    a, b = _pair(P, nodes)
    received = []
    probe = P.testkit.TestProbe(b)

    class Sink(P.Actor):
        def receive(self, message):
            received.append(message)
            probe.ref.tell(message)

    b.actor_of(P.Props.create(Sink), "sink")
    sink = _remote(a, b, "/user/sink")
    sink.tell("before")
    first = probe.receive_one(WAIT)
    la, lb = a.provider.local_address, b.provider.local_address
    a_addr, b_addr = f"{la.host}:{la.port}", f"{lb.host}:{lb.port}"
    injector = P.transport.InProcTransport.fault_injector
    injector.blackhole(a_addr, b_addr)
    sink.tell("dropped")
    injector.pass_through(a_addr, b_addr)
    sink.tell("after")
    return [first, probe.receive_one(WAIT), list(received)]


def test_blackhole_drops_messages(nodes):
    assert side_by_side(_blackhole, nodes) == [
        "before", "after", ["before", "after"]]


def _quarantine(P, nodes):
    a, b = _pair(P, nodes)
    b.actor_of(P.Props.create(echo_class(P)), "echo")
    remote = _remote(a, b, "/user/echo")
    trace = [P.ask_sync(remote, "who", timeout=WAIT, system=a)]
    events = []
    a.event_stream.subscribe(events.append, P.provider.QuarantinedEvent)
    assoc = a.provider._association(b.provider.local_address)
    a.provider.quarantine(b.provider.local_address, assoc.peer_uid)
    try:
        trace.append(("replied", P.ask_sync(remote, "who", timeout=0.5,
                                            system=a)))
    except Exception as e:   # noqa: BLE001 — its type enters the trace
        trace.append(("raised", type(e).__name__))
    trace.append([(type(e).__name__, e.uid == b.provider.uid)
                  for e in events[:1]])
    return trace


def test_quarantine_blocks_traffic(nodes):
    who, after, events = side_by_side(_quarantine, nodes)
    assert who == "sysB"
    assert after[0] == "raised", after
    assert events == [("QuarantinedEvent", True)]


def _plain(out):
    """A round-tripped value as a trace entry (arrays by content)."""
    return _array(out) if isinstance(out, np.ndarray) else out


ROUND_TRIPS = ["hello", b"raw", {"k": [1, 2, 3]}, ("tuple", 1), 42,
               np.arange(6, dtype=np.int32).reshape(2, 3)]


def _round_trips(P, nodes):
    s = P.serialization.Serialization()
    return [_plain(s.verify_round_trip(obj)) for obj in ROUND_TRIPS]


def test_serialization_round_trips(nodes):
    for obj, out in zip(ROUND_TRIPS, side_by_side(_round_trips, nodes)):
        if isinstance(obj, np.ndarray):
            assert out == _array(obj)
        else:
            assert out == obj or out == list(obj)


def _binding(P, nodes):
    class MyMsg(dict):
        pass

    class MySerializer(P.serialization.Serializer):
        identifier = 99

        def to_binary(self, obj):
            return b"custom"

        def from_binary(self, data, manifest=""):
            return MyMsg(marker=True)

    s = P.serialization.Serialization()
    s.add_binding(MyMsg, MySerializer())
    sid, _, data = s.serialize(MyMsg(a=1))
    sid2, _, _ = s.serialize({"a": 1})
    return [sid, data, sid2 != 99]


def test_serializer_binding_most_specific_wins(nodes):
    assert side_by_side(_binding, nodes) == [99, b"custom", True]


def _watch_graceful_stop(P, nodes):
    a, b = _pair(P, nodes)
    target = b.actor_of(P.Props.create(echo_class(P)), "target")
    remote = _remote(a, b, "/user/target")
    probe = P.testkit.TestProbe(a)
    probe.watch(remote)
    # the Watch rides the control lane; a reply on the ordinary lane after
    # it shows node b has it
    who = P.ask_sync(remote, "who", timeout=WAIT, system=a)
    P.testkit.await_condition(lambda: bool(target.cell._watched_by),
                              max_time=WAIT)
    target.tell(P.PoisonPill)
    t = probe.expect_msg_class(P.Terminated, timeout=WAIT)
    return [who, t.actor.path.elements, t.existence_confirmed,
            t.address_terminated]


def test_remote_watch_actor_level_graceful_stop(nodes):
    """Watching a remote actor gives Terminated when the actor stops
    while its node stays up (actor-level deathwatch over the wire)."""
    assert side_by_side(_watch_graceful_stop, nodes) == [
        "sysB", ("user", "target"), True, False]


def _refs_inside_payloads(P, nodes):
    a, b = _pair(P, nodes)

    class ReplyToInner(P.Actor):
        def receive(self, message):
            _tag, ref = message
            ref.tell(("from", str(self.context.system.name)), self.self_ref)

    b.actor_of(P.Props.create(ReplyToInner), "inner")
    probe = P.testkit.TestProbe(a)
    _remote(a, b, "/user/inner").tell(("reply-to", probe.ref))
    return [probe.receive_one(WAIT)]


def test_remote_refs_inside_payloads(nodes):
    """ActorRefs inside message payloads survive the wire and can be told
    on the other side."""
    assert side_by_side(_refs_inside_payloads, nodes) == [("from", "sysB")]
