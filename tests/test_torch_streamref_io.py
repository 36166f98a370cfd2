"""The port's stream refs across two nodes (akka_tpu_torch.stream.streamref
over the in-proc transport) and its actor IO (akka_tpu_torch.io: TCP, UDP
and DNS over real loopback sockets) on the CPU, side by side with the JAX
package's: the 8 cases of tests/test_streamref_io.py.

The stream-ref scenarios run on two `provider = remote` nodes of each
package through the file's `nodes` fixture (tests/torch_remote_fixture.py:
each package on its own wire, since each trusts only its own package's
classes, so the refs and the protocol messages that cross the port's wire
are the port's own). The IO scenarios run on one system of each package
(tests/torch_stream_fixture.py). The port's trace must equal the
reference's. Every listener binds 127.0.0.1 port 0 and reads its port
back; every wait is at most WAIT.
"""

import importlib
import pickle
import time

import pytest

import torch_remote_fixture as remote
from torch_stream_fixture import WAIT, side_by_side

HOST = "127.0.0.1"


@pytest.fixture()
def nodes():
    n = remote.Nodes()
    try:
        yield n
    finally:
        n.close()


def _m(P, sub):
    return importlib.import_module(f"{P.name}.{sub}")


# ---------------------------------------------------------- stream refs

def _pair(P, nodes):
    return nodes.node("sr-a", P=P), nodes.node("sr-b", P=P)


def _source_ref_across_nodes(P, nodes):
    st, sr = _m(P, "stream"), _m(P, "stream.streamref")
    a, b = _pair(P, nodes)
    source_ref = st.Source.from_iterable(range(50)).run_with(
        st.StreamRefs.source_ref(), a)
    # shipping over the wire: the mat value pickles to a SourceRef
    shipped = pickle.loads(pickle.dumps(source_ref))
    assert isinstance(shipped, sr.SourceRef)
    out = sr.SourceRef.source(shipped).run_with(st.Sink.seq(), b) \
        .result(WAIT)
    assert out == list(range(50))
    return type(shipped).__name__, remote.norm(shipped.origin_path) \
        .split("/user/")[0], out


def test_source_ref_streams_data_across_nodes(nodes):
    """The origin runs a stream into a source-ref sink; the shipped
    SourceRef is consumed on the other node, demand flowing back."""
    remote.side_by_side(_source_ref_across_nodes, nodes)


def _sink_ref_across_nodes(P, nodes):
    st, sr = _m(P, "stream"), _m(P, "stream.streamref")
    a, b = _pair(P, nodes)
    sink_ref, fut = st.StreamRefs.sink_ref().to_mat(
        st.Sink.seq(), st.Keep.both).run(a)
    shipped = pickle.loads(pickle.dumps(sink_ref))
    assert isinstance(shipped, sr.SinkRef)
    st.Source.from_iterable(["x", "y", "z"]).to(
        sr.SinkRef.sink(shipped), st.Keep.right).run(b)
    out = fut.result(WAIT)
    assert out == ["x", "y", "z"]
    return type(shipped).__name__, out


def test_sink_ref_accepts_remote_stream(nodes):
    remote.side_by_side(_sink_ref_across_nodes, nodes)


def _source_ref_backpressure(P, nodes):
    st, sr = _m(P, "stream"), _m(P, "stream.streamref")
    a, b = _pair(P, nodes)
    produced = []
    src = st.Source.unfold(0, lambda s: (s + 1, s) if s < 1000 else None) \
        .via(st.Flow().wire_tap(produced.append))
    ref = src.run_with(st.StreamRefs.source_ref(), a)
    time.sleep(0.3)
    early = len(produced)
    assert early == 0  # no consumer yet: demand-driven, nothing produced
    out = sr.SourceRef.source(sr.SourceRef(ref.origin_path)).via(
        st.Flow().take(10)).run_with(st.Sink.seq(), b).result(WAIT)
    assert out == list(range(10))
    time.sleep(0.2)
    # the origin produced up to the demand window, not all 1000
    bounded = len(produced) <= 10 + 2 * 16
    assert bounded, len(produced)
    return early, out, bounded


def test_source_ref_backpressure(nodes):
    """The origin does not race ahead of the consumer's cumulative
    demand."""
    remote.side_by_side(_source_ref_backpressure, nodes)


# -------------------------------------------------------------------- TCP

def _echo_handler(S):
    io = _m(S, "io")

    class EchoServerHandler(S.Actor):
        """Registers itself for each accepted connection and echoes."""

        def receive(self, message):
            if isinstance(message, io.Connected):
                self.sender.tell(io.Register(self.self_ref), self.self_ref)
            elif isinstance(message, io.Received):
                self.sender.tell(io.Write(b"echo:" + message.data),
                                 self.self_ref)

    return S.system.actor_of(S.Props.create(EchoServerHandler))


def _bind_echo(S):
    """An echo listener on HOST port 0; its bound port."""
    io = _m(S, "io")
    probe = S.TestProbe(S.system)
    io.Tcp.get(S.system).manager.tell(
        io.Bind(_echo_handler(S), (HOST, 0)), probe.ref)
    bound = probe.expect_msg_class(io.Bound, WAIT)
    assert bound.local_address[0] == HOST and bound.local_address[1] > 0
    return bound.local_address[1]


def _connect(S, port):
    io = _m(S, "io")
    client = S.TestProbe(S.system)
    io.Tcp.get(S.system).manager.tell(io.Connect((HOST, port)), client.ref)
    connected = client.expect_msg_class(io.Connected, WAIT)
    conn = client.last_sender
    conn.tell(io.Register(client.ref), client.ref)
    return client, conn, connected


@side_by_side
def test_tcp_bind_connect_echo(S):
    io = _m(S, "io")
    port = _bind_echo(S)
    client, conn, connected = _connect(S, port)
    assert connected.remote_address == (HOST, port)
    conn.tell(io.Write(b"hello", ack="ok"), client.ref)
    acked = client.receive_one(WAIT)
    rec = client.expect_msg_class(io.Received, WAIT)
    assert acked == "ok" and rec.data == b"echo:hello"
    conn.tell(io.Close(), client.ref)
    closed = client.expect_msg_class(io.Closed, WAIT)
    return acked, rec.data, type(closed).__name__


@side_by_side
def test_tcp_write_ack_ordering(S):
    io = _m(S, "io")
    client, conn, _ = _connect(S, _bind_echo(S))
    for i in range(5):
        conn.tell(io.Write(f"m{i}".encode(), ack=f"ack{i}"), client.ref)
    acks, data = [], b""
    deadline = time.monotonic() + WAIT
    # TCP may coalesce the writes into fewer segments: strip the echo
    # prefixes and hold the payload bytes to their order
    while (len(acks) < 5 or data.replace(b"echo:", b"") !=
           b"m0m1m2m3m4") and time.monotonic() < deadline:
        m = client.receive_one(WAIT)
        if isinstance(m, str):
            acks.append(m)
        elif isinstance(m, io.Received):
            data += m.data
    assert acks == [f"ack{i}" for i in range(5)]  # acks in write order
    assert data.replace(b"echo:", b"") == b"m0m1m2m3m4"
    return acks, data.replace(b"echo:", b"")


@side_by_side
def test_tcp_connect_refused(S):
    io = _m(S, "io")
    probe = S.TestProbe(S.system)
    io.Tcp.get(S.system).manager.tell(
        io.Connect((HOST, 1), timeout=2.0), probe.ref)
    failed = probe.receive_one(WAIT)
    assert isinstance(failed, io.CommandFailed)
    return type(failed).__name__, type(failed.cmd).__name__


# -------------------------------------------------------------------- UDP

@side_by_side
def test_udp_bind_and_send(S):
    io = _m(S, "io")
    udp = io.Udp.get(S.system)
    probe = S.TestProbe(S.system)
    udp.manager.tell(io.UdpBind(probe.ref, (HOST, 0)), probe.ref)
    addr = probe.expect_msg_class(io.UdpBound, WAIT).local_address
    assert addr[0] == HOST and addr[1] > 0
    udp.manager.tell(io.SimpleSender(), probe.ref)
    ready = probe.expect_msg_class(io.SimpleSenderReady, WAIT)
    ready.sender_ref.tell(io.UdpSend(b"datagram", addr), probe.ref)
    got = probe.expect_msg_class(io.UdpReceived, WAIT)
    assert got.data == b"datagram" and got.sender_address[0] == HOST
    return got.data


# -------------------------------------------------------------------- DNS

@side_by_side
def test_dns_resolve_localhost(S):
    io = _m(S, "io")
    dns = io.Dns.get(S.system)
    probe = S.TestProbe(S.system)
    dns.manager.tell(io.Resolve("localhost"), probe.ref)
    res = probe.expect_msg_class(io.Resolved, WAIT)
    assert "127.0.0.1" in res.addresses or "::1" in res.addresses
    # the second ask is answered from the cache
    dns.manager.tell(io.Resolve("localhost"), probe.ref)
    again = probe.receive_one(WAIT)
    assert again == res
    return res.name, "127.0.0.1" in res.addresses or "::1" in res.addresses
