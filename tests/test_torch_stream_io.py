"""The port's framing, file, compression and TCP stages
(akka_tpu_torch.stream.framing, .fileio, .tcp over akka_tpu_torch.io) on
the CPU, side by side with the JAX package's: the framing, file IO, gzip
and TCP cases of tests/test_stream_breadth.py and the 5 cases of
tests/test_stream_tcp.py, over real loopback sockets. Each scenario is
written once over a package's names, runs on both packages, and the
port's trace must equal the reference's (tests/torch_stream_fixture.py).

Every listener of this file is opened by `listen` (stream binds) or
`raw_listener` (a plain socket), on 127.0.0.1 port 0: the bound port is
read back, never picked beforehand. Every wait is at most WAIT; no test
holds a duration against a budget.
"""

import importlib
import socket
import threading
import time

import pytest

from torch_stream_fixture import WAIT, err, side_by_side

HOST = "127.0.0.1"


def _m(S, sub):
    return importlib.import_module(f"{S.name}.{sub}")


def listen(S, handle):
    """Bind a stream TCP listener on HOST port 0 whose every accepted
    connection goes to `handle`; its ServerBinding."""
    tcp = _m(S, "stream.tcp").Tcp.get(S.system)
    return tcp.bind(HOST, 0).to_mat(S.Sink.foreach(handle), S.Keep.left) \
        .run(S.system).result(WAIT)


def raw_listener():
    """A plain listening socket on HOST port 0, and its port."""
    srv = socket.socket()
    srv.bind((HOST, 0))
    srv.listen(1)
    return srv, srv.getsockname()[1]


def _rechunk(data: bytes, size: int):
    return [data[i:i + size] for i in range(0, len(data), size)]


# ------------------------------- tests/test_stream_breadth.py: framing

@side_by_side
def test_delimiter_framing_across_chunk_boundaries(S):
    payload = b"alpha\nbeta\ngamma-longer\n"
    t = [S.seq(S.Source.from_iterable(_rechunk(payload, chunk))
               .via(S.Framing.delimiter(b"\n", 64)))
         for chunk in (1, 2, 3, 7, len(payload))]
    assert t == [[b"alpha", b"beta", b"gamma-longer"]] * 5
    return t


@side_by_side
def test_delimiter_framing_truncation_fails(S):
    fut = S.Source.from_iterable([b"no-delimiter-here"]) \
        .via(S.Framing.delimiter(b"\n", 64)).run_with(S.Sink.seq(), S.system)
    with pytest.raises(S.FramingException):
        fut.result(WAIT)
    return err(fut), str(fut.exception())


@side_by_side
def test_length_field_framing_round_trip(S):
    frames = [b"x", b"hello", b"", b"world!" * 10]
    encoded = b"".join(len(f).to_bytes(4, "big") + f for f in frames)
    t = [S.seq(S.Source.from_iterable(_rechunk(encoded, chunk))
               .via(S.Framing.length_field(4, 1024)))
         for chunk in (1, 3, 8, 64)]
    assert t == [frames] * 4
    return t


@side_by_side
def test_simple_framing_protocol_over_tcp_socket(S):
    """Frames encoded by the protocol survive a real TCP hop with
    arbitrary re-chunking."""
    frames = [b"alpha", b"b" * 300, b"gamma"]
    received = []
    srv, port = raw_listener()

    def server():
        conn, _ = srv.accept()
        while True:
            chunk = conn.recv(7)  # awkward chunking on purpose
            if not chunk:
                break
            received.append(chunk)
        conn.close()

    t = threading.Thread(target=server)
    t.start()
    try:
        encoded = S.seq(S.Source.from_iterable(frames)
                        .via(S.Framing.simple_framing_protocol_encoder(1024)))
        with socket.create_connection((HOST, port), timeout=WAIT) as cli:
            for blob in encoded:
                cli.sendall(blob)
    finally:
        t.join(WAIT)
        srv.close()
    assert not t.is_alive()
    decoded = S.seq(S.Source.from_iterable(list(received))
                    .via(S.Framing.simple_framing_protocol_decoder(1024)))
    assert decoded == frames
    return encoded, decoded


# ---------------------------- tests/test_stream_breadth.py: file + gzip

@side_by_side
def test_file_sink_and_source_round_trip(S):
    import tempfile
    fileio = _m(S, "stream.fileio")
    blob = bytes(range(256)) * 100
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/data.bin"
        res = S.Source.from_iterable(_rechunk(blob, 1000)) \
            .run_with(fileio.FileIO.to_path(path), S.system).result(WAIT)
        assert res.count == len(blob) and res.was_successful
        back = S.seq(fileio.FileIO.from_path(path, chunk_size=777))
    assert b"".join(back) == blob
    return res.count, res.was_successful, [len(c) for c in back]


@side_by_side
def test_gzip_round_trip(S):
    import gzip
    compression = _m(S, "stream.fileio").Compression
    blob = b"the quick brown fox " * 200
    compressed = S.seq(S.Source.from_iterable(_rechunk(blob, 128))
                       .via(compression.gzip()))
    assert sum(map(len, compressed)) < len(blob)
    back = S.seq(S.Source.from_iterable(compressed)
                 .via(compression.gunzip()))
    assert b"".join(back) == blob
    assert gzip.decompress(b"".join(compressed)) == blob
    return b"".join(back), [len(c) for c in back]


# ------------------------------------------- tests/test_stream_tcp.py

@side_by_side
def test_bind_and_outgoing_connection_echo(S):
    tcp = _m(S, "stream.tcp")

    # echo server: every accepted connection's bytes come back uppercased
    def handle(conn):
        conn.handle_with(S.Flow().map(lambda b: b.upper()), S.system)

    binding = listen(S, handle)
    host, port = binding.local_address[:2]
    assert host == HOST and port > 0
    out = S.Source.single(b"hello") \
        .via(tcp.Tcp.get(S.system).outgoing_connection(HOST, port)) \
        .take(1).run_with(S.Sink.seq(), S.system).result(WAIT)
    assert b"".join(out) == b"HELLO"
    binding.unbind()
    return b"".join(out)


@side_by_side
def test_framing_roundtrip_through_tcp_flow(S):
    """Framing round-trips through a TCP stream Flow, not just a raw
    socket."""
    tcp = _m(S, "stream.tcp")

    # server: delimiter-framed lines, reversed per frame, re-delimited
    def handle(conn):
        conn.handle_with(S.Framing.delimiter(b"\n", 1024)
                         .map(lambda line: line[::-1] + b"\n"), S.system)

    port = listen(S, handle).local_address[1]
    frames = S.Source.from_iterable([b"abc\nde", b"f\n"]) \
        .via(tcp.Tcp.get(S.system).outgoing_connection(HOST, port)) \
        .via(S.Framing.delimiter(b"\n", 1024)) \
        .take(2).run_with(S.Sink.seq(), S.system).result(WAIT)
    assert frames == [b"cba", b"fed"]
    return frames


@side_by_side
def test_outgoing_connection_mat_value_and_refused(S):
    """A connection to a port nothing listens on fails its materialized
    value with ConnectionError (the port: a listener opened and closed)."""
    tcp = _m(S, "stream.tcp")
    srv, port = raw_listener()
    srv.close()
    fut = S.Source.single(b"x") \
        .via_mat(tcp.Tcp.get(S.system).outgoing_connection(HOST, port),
                 S.Keep.right) \
        .to_mat(S.Sink.ignore(), S.Keep.left).run(S.system)
    assert isinstance(fut.exception(WAIT), ConnectionError)
    return err(fut)


@side_by_side
def test_connection_closed_when_stage_cancelled(S):
    """A stage that dies by cancellation (take(1)) closes its socket: the
    connection actor under the IO-TCP manager does not leak."""
    tcp = _m(S, "stream.tcp")

    def handle(conn):
        conn.handle_with(S.Flow(), S.system)

    port = listen(S, handle).local_address[1]
    manager = _m(S, "io.tcp").Tcp.get(S.system).manager
    baseline = len(manager.cell._children)
    out = S.Source.single(b"ping") \
        .via(tcp.Tcp.get(S.system).outgoing_connection(HOST, port)) \
        .take(1).run_with(S.Sink.seq(), S.system).result(WAIT)
    assert out == [b"ping"]
    deadline = time.monotonic() + WAIT
    while len(manager.cell._children) > baseline:
        assert time.monotonic() < deadline, \
            "connection actor leaked after stage stop"
        time.sleep(0.02)
    return out


@side_by_side
def test_many_frames_with_write_backpressure(S):
    tcp = _m(S, "stream.tcp")

    def handle(conn):
        conn.handle_with(S.Flow(), S.system)  # plain echo

    port = listen(S, handle).local_address[1]
    n = 200
    frames = S.Source.from_iterable([b"%04d\n" % i for i in range(n)]) \
        .via(tcp.Tcp.get(S.system).outgoing_connection(HOST, port)) \
        .via(S.Framing.delimiter(b"\n", 64)) \
        .take(n).run_with(S.Sink.seq(), S.system).result(WAIT)
    assert frames == [b"%04d" % i for i in range(n)]
    return frames


def test_unbind_frees_the_port_and_its_threads():
    """The port's ServerBinding.unbind() completes once nothing listens:
    a connect right after is refused, the bind stream completes, and once
    the system ends no thread it started is left."""
    from torch_host_fixture import assert_no_new_threads, threads
    from torch_stream_fixture import Run

    before = threads()
    S = Run("akka_tpu_torch")
    try:
        accepted = []
        tcp = _m(S, "stream.tcp").Tcp.get(S.system)
        binding, done = tcp.bind(HOST, 0) \
            .to_mat(S.Sink.foreach(accepted.append), S.Keep.both) \
            .run(S.system)
        binding = binding.result(WAIT)
        port = binding.local_address[1]
        socket.create_connection((HOST, port), timeout=WAIT).close()
        deadline = time.monotonic() + WAIT
        while not accepted:
            assert time.monotonic() < deadline, "no connection accepted"
            time.sleep(0.01)
        fut = binding.unbind()
        assert fut is binding.unbound and fut.result(WAIT) is None
        with pytest.raises(ConnectionRefusedError):
            socket.create_connection((HOST, port), timeout=WAIT)
        done.result(WAIT)
        assert len(accepted) == 1
        assert binding.unbind().result(WAIT) is None  # idempotent
    finally:
        S.close()
    assert_no_new_threads(before)
