"""Selector event-loop front door: C1M-shaped gateway ingress.

A copy of `akka_tpu/gateway/evloop.py` (host code).

The stream transport (`GatewayServer.start`, `transport="stream"`)
materializes a full stream graph per accepted connection — decoder stage,
MapAsync stage, encoder stage, each an actor with its own mailbox — so
10k sockets mean tens of thousands of Python objects exchanging per-frame
messages. That is the per-connection ceiling ROADMAP item 5 names: the
device path already serves WINDOWS (one `IngestAggregator`, one columnar
serve per window), but reaching the aggregator costs a thread-herd of
stream actors per socket.

This module is the mechanical alternative, shaped like Artery's
event-loop transport (PAPER.md substrate stance): ONE thread (optionally
N `SO_REUSEPORT` accept shards, default 1) owns accept/read/write for ALL
gateway sockets through a `selectors` loop. Per connection the state is a
`_EvConn` struct — a `FrameReader` for reassembly, a deque of pending
bodies, a deque of in-order reply futures, an output buffer — not an
actor in sight. Complete frames go straight into the ONE shared
`IngestAggregator` (`submit(body, conn_id)`, exactly the tag the stream
path uses), so more sockets make ingest windows BIGGER, never threads
more numerous.

Backpressure contracts preserved from the stream twin, per connection:

* `pipeline_depth` in-flight bound — at most `depth` frames of one socket
  submitted-and-unreplied at the aggregator; further parsed frames queue
  in `pending` and the socket's READ interest drops while the bound (or
  the write high-water mark) holds, so the kernel window closes back to
  the producer.
* FIFO replies — futures are drained strictly in submit order even when
  continuous windows resolve out of order (the head future gates the
  queue).
* a slow consumer stalls only its own connection — reply bytes queue in
  that connection's `outbuf` with write-interest toggling; past
  `HIGH_WATER` the connection stops reading (and therefore submitting)
  until the consumer drains below `LOW_WATER`.

The loop thread never blocks on the device: window serves run on the
aggregator's dispatcher exactly as for the stream transport, and resolved
futures re-enter the loop through a self-pipe wakeup.
"""

from __future__ import annotations

import collections
import selectors
import socket
import struct
import threading
import time
from typing import Any, Deque, Dict, List, Optional, Tuple

from ..serialization import frames

__all__ = ["EvLoopIngress", "HIGH_WATER", "LOW_WATER"]

# per-connection userspace reply buffer watermarks: above HIGH the
# connection stops reading (backpressure reaches the producer through the
# kernel window), below LOW it resumes. Userspace buffering is bounded by
# HIGH + one reply burst; the kernel sndbuf adds its own bounded slack.
HIGH_WATER = 1 << 18
LOW_WATER = 1 << 16

_RECV_CHUNK = 1 << 16


class _EvConn:
    """One accepted socket's loop-thread-only state. No locks: every
    field is touched exclusively on the owning shard's loop thread
    (future callbacks cross threads through the shard's completion
    queue, never through this struct)."""

    __slots__ = ("sock", "fd", "conn_id", "reader", "pending", "inflight",
                 "replies", "outbuf", "out_len", "mask", "read_done",
                 "closed", "last_rx")

    def __init__(self, sock: socket.socket, conn_id: int, max_frame: int):
        from .ingress import FrameReader
        self.sock = sock
        self.fd = sock.fileno()
        self.conn_id = conn_id
        self.reader = FrameReader(max_frame=max_frame)
        self.pending: Deque[bytes] = collections.deque()   # parsed, unsubmitted
        self.inflight = 0                # submitted frames awaiting replies
        self.replies: Deque[Any] = collections.deque()     # futures, FIFO
        self.outbuf: Deque[memoryview] = collections.deque()
        self.out_len = 0
        self.mask = 0                    # currently-registered selector mask
        self.read_done = False           # peer half-closed
        self.closed = False
        self.last_rx = time.monotonic()  # idle-reap clock


class _AcceptShard(threading.Thread):
    """One selector loop: a listening socket (its accept shard) plus
    every connection it accepted. With `n_shards > 1` each shard binds
    the same port under SO_REUSEPORT and the kernel spreads accepts."""

    def __init__(self, ingress: "EvLoopIngress", lsock: socket.socket,
                 shard_id: int):
        super().__init__(daemon=True,
                         name=f"akka-tpu-gw-evloop-{shard_id}")
        self.ingress = ingress
        self.lsock = lsock
        self.shard_id = shard_id
        self.sel = selectors.DefaultSelector()
        self.conns: Dict[int, _EvConn] = {}
        # cross-thread completion queue: future callbacks append conns
        # here and poke the self-pipe; only the loop thread pops
        self._completions: Deque[_EvConn] = collections.deque()
        self._rd_wake, self._wr_wake = socket.socketpair()
        self._rd_wake.setblocking(False)
        self._wr_wake.setblocking(False)
        self._halt = False
        self._last_sweep = time.monotonic()

    # ---------------------------------------------------- cross-thread API
    def notify(self, conn: _EvConn) -> None:
        """Called from any thread when one of `conn`'s reply futures
        resolves: enqueue for the loop thread and wake the selector."""
        self._completions.append(conn)
        try:
            self._wr_wake.send(b"\x01")
        except (BlockingIOError, OSError):
            pass  # pipe already signaled (or shard shutting down)

    def stop(self) -> None:
        self._halt = True
        try:
            self._wr_wake.send(b"\x01")
        except (BlockingIOError, OSError):
            pass

    # ------------------------------------------------------------ the loop
    def run(self) -> None:
        ing = self.ingress
        self.sel.register(self.lsock, selectors.EVENT_READ, "accept")
        self.sel.register(self._rd_wake, selectors.EVENT_READ, "wake")
        try:
            while True:
                events = self.sel.select(timeout=1.0)
                ing._wakeups += 1
                for key, mask in events:
                    what = key.data
                    if what == "accept":
                        self._accept_ready()
                    elif what == "wake":
                        try:
                            while self._rd_wake.recv(4096):
                                pass
                        except (BlockingIOError, OSError):
                            pass
                    else:
                        conn = what
                        if mask & selectors.EVENT_WRITE:
                            self._flush(conn)
                        if mask & selectors.EVENT_READ and not conn.closed:
                            self._read_ready(conn)
                self._drain_completions()
                self._reap_idle()
                if self._halt:
                    return
        finally:
            for conn in list(self.conns.values()):
                self._close(conn)
            try:
                self.sel.unregister(self.lsock)
            except (KeyError, ValueError):
                pass
            self.lsock.close()
            self._rd_wake.close()
            self._wr_wake.close()
            self.sel.close()

    # ---------------------------------------------------------- idle reaping
    def _reap_idle(self) -> None:
        """Close connections with no frame for `idle_timeout_s` (
        20 satellite; 0 = off, the default). Only fully-quiescent
        connections reap — anything with parsed-but-unsubmitted frames,
        in-flight windows or unflushed reply bytes is WORKING, not idle.
        Swept at most once a second off the selector's 1s tick, so the
        cost is one timestamp compare per connection per second."""
        ing = self.ingress
        timeout = ing.idle_timeout_s
        if timeout <= 0:
            return
        now = time.monotonic()
        if now - self._last_sweep < min(1.0, timeout / 2):
            return
        self._last_sweep = now
        for conn in [c for c in self.conns.values()
                     if not c.closed and not c.pending and not c.replies
                     and not c.outbuf and c.inflight == 0
                     and now - c.last_rx > timeout]:
            self._close(conn)
            ing._idle_reaped += 1

    # -------------------------------------------------------------- accept
    def _accept_ready(self) -> None:
        ing = self.ingress
        while True:
            try:
                sock, _addr = self.lsock.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            conn = _EvConn(sock, ing._next_conn_id(), ing.max_frame)
            self.conns[conn.fd] = conn
            ing._accepted += 1
            n = sum(len(s.conns) for s in ing._shards)
            if n > ing._max_conns_seen:
                ing._max_conns_seen = n
            self._set_mask(conn, selectors.EVENT_READ)

    # ---------------------------------------------------------------- read
    def _read_ready(self, conn: _EvConn) -> None:
        ing = self.ingress
        try:
            data = conn.sock.recv(_RECV_CHUNK)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._close(conn)
            return
        if not data:
            conn.read_done = True
            self._maybe_finish(conn)
            return
        conn.last_rx = time.monotonic()
        ing._bytes_in += len(data)
        try:
            for body in conn.reader.feed_raw(data):
                conn.pending.append(body)
        except ValueError:
            # oversized frame: protocol violation, same fate as the
            # stream decoder's FramingError — drop the connection
            self._close(conn)
            return
        self._pump_submits(conn)
        self._update_interest(conn)

    def _pump_submits(self, conn: _EvConn) -> None:
        """Move parsed bodies into the shared aggregator while the
        per-connection in-flight bound allows."""
        ing = self.ingress
        while conn.pending and conn.inflight < ing.pipeline_depth:
            body = conn.pending.popleft()
            conn.inflight += 1
            ing._frames_in += 1
            fut = ing.aggregator.submit(body, conn.conn_id)
            conn.replies.append(fut)
            fut.add_done_callback(
                lambda _f, c=conn, s=self: s.notify(c))

    # --------------------------------------------------------- completions
    def _drain_completions(self) -> None:
        while self._completions:
            conn = self._completions.popleft()
            if conn.closed:
                continue
            self._pump_replies(conn)

    def _pump_replies(self, conn: _EvConn) -> None:
        """Queue resolved replies in submit order (the head future gates
        the drain: out-of-order window resolution never reorders one
        connection's replies), then top up submissions and flush."""
        ing = self.ingress
        wrote = False
        while conn.replies and conn.replies[0].done():
            fut = conn.replies.popleft()
            conn.inflight -= 1
            try:
                body = fut.result()
            except BaseException:  # noqa: BLE001 — window serve failed:
                self._close(conn)  # the stream twin fails the connection
                return
            buf = frames.frame(body)
            conn.outbuf.append(memoryview(buf))
            conn.out_len += len(buf)
            ing._replies_out += 1
            wrote = True
        self._pump_submits(conn)
        if wrote:
            self._flush(conn)
        else:
            self._update_interest(conn)

    # --------------------------------------------------------------- write
    def _flush(self, conn: _EvConn) -> None:
        ing = self.ingress
        try:
            while conn.outbuf:
                head = conn.outbuf[0]
                n = conn.sock.send(head)
                ing._bytes_out += n
                conn.out_len -= n
                if n == len(head):
                    conn.outbuf.popleft()
                else:
                    conn.outbuf[0] = head[n:]
                    ing._write_blocks += 1
                    break
        except (BlockingIOError, InterruptedError):
            ing._write_blocks += 1
        except OSError:
            self._close(conn)
            return
        self._maybe_finish(conn)

    # ----------------------------------------------------- interest + close
    def _update_interest(self, conn: _EvConn) -> None:
        if conn.closed:
            return
        ing = self.ingress
        mask = 0
        if not conn.read_done:
            # stop reading while the in-flight bound or the reply buffer
            # high-water mark holds — this is the backpressure edge
            paused = (conn.inflight >= ing.pipeline_depth
                      or conn.out_len >= HIGH_WATER
                      or (conn.out_len > LOW_WATER
                          and conn.mask & selectors.EVENT_READ == 0))
            if paused:
                if conn.mask & selectors.EVENT_READ:
                    ing._read_pauses += 1
            else:
                mask |= selectors.EVENT_READ
        if conn.outbuf:
            mask |= selectors.EVENT_WRITE
        self._set_mask(conn, mask)

    def _set_mask(self, conn: _EvConn, mask: int) -> None:
        if mask == conn.mask:
            return
        try:
            if mask == 0:
                self.sel.unregister(conn.sock)
            elif conn.mask == 0:
                self.sel.register(conn.sock, mask, conn)
            else:
                self.sel.modify(conn.sock, mask, conn)
            conn.mask = mask
        except (KeyError, ValueError, OSError):
            self._close(conn)

    def _maybe_finish(self, conn: _EvConn) -> None:
        if conn.read_done and not conn.outbuf and not conn.replies \
                and not conn.pending:
            self._close(conn)
        else:
            self._update_interest(conn)

    def _close(self, conn: _EvConn) -> None:
        if conn.closed:
            return
        conn.closed = True
        if conn.mask:
            try:
                self.sel.unregister(conn.sock)
            except (KeyError, ValueError, OSError):
                pass
            conn.mask = 0
        self.conns.pop(conn.fd, None)
        try:
            conn.sock.close()
        except OSError:
            pass
        self.ingress._closed_conns += 1


class EvLoopIngress:
    """The evloop transport behind `GatewayServer(transport="evloop")`:
    owns the listening socket(s) and every accepted connection on
    `n_shards` selector loops (default 1). All frame handling funnels
    into `server.aggregator` — the SAME windows, admission charges and
    serve path as the stream transport, which stays available as the
    bit-identical A/B twin."""

    def __init__(self, server, host: str = "127.0.0.1", port: int = 0,
                 n_shards: int = 1, backlog: int = 4096,
                 registry=None, idle_timeout_s: float = 0.0):
        if server.aggregator is None:
            raise ValueError("evloop transport requires the shared "
                             "IngestAggregator (GatewayServer creates it "
                             "for transport='evloop')")
        self.server = server
        self.aggregator = server.aggregator
        self.max_frame = server.max_frame
        self.pipeline_depth = max(1, int(server.pipeline_depth))
        self.host = host
        self.port = int(port)
        self.n_shards = max(1, int(n_shards))
        self.backlog = int(backlog)
        # idle-connection reaping: 0 disables
        self.idle_timeout_s = float(idle_timeout_s)
        self._idle_reaped = 0
        self._shards: List[_AcceptShard] = []
        self._conn_lock = threading.Lock()
        self._started = False
        # counters (loop-thread writes; torn reads are fine for stats)
        self._accepted = 0
        self._closed_conns = 0
        self._frames_in = 0
        self._replies_out = 0
        self._bytes_in = 0
        self._bytes_out = 0
        self._read_pauses = 0
        self._write_blocks = 0
        self._wakeups = 0
        self._max_conns_seen = 0
        self._t_start = time.monotonic()
        if registry is not None:
            registry.register_collector("gateway_evloop", self.stats)

    def _next_conn_id(self) -> int:
        # shares the server's conn-id space so aggregator window tags
        # stay unique across transports (A/B runs in one process)
        with self._conn_lock:
            return next(self.server._conn_ids)

    # ----------------------------------------------------------- lifecycle
    def _bind_one(self, port: int, reuseport: bool) -> socket.socket:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if reuseport:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        s.bind((self.host, port))
        s.listen(self.backlog)
        s.setblocking(False)
        return s

    def start(self) -> Tuple[str, int]:
        if self._started:
            return self.host, self.port
        reuseport = self.n_shards > 1
        first = self._bind_one(self.port, reuseport)
        self.port = first.getsockname()[1]
        socks = [first] + [self._bind_one(self.port, True)
                           for _ in range(self.n_shards - 1)]
        self._shards = [_AcceptShard(self, s, i)
                        for i, s in enumerate(socks)]
        for sh in self._shards:
            sh.start()
        self._started = True
        return self.host, self.port

    def stop(self, timeout: float = 5.0) -> None:
        for sh in self._shards:
            sh.stop()
        for sh in self._shards:
            sh.join(timeout)
        self._shards = []
        self._started = False

    # --------------------------------------------------------------- stats
    def stats(self) -> Dict[str, float]:
        elapsed = max(1e-9, time.monotonic() - self._t_start)
        conns = sum(len(sh.conns) for sh in self._shards)
        return {"connections": float(conns),
                "max_connections": float(self._max_conns_seen),
                "accepted": float(self._accepted),
                "closed": float(self._closed_conns),
                "frames_in": float(self._frames_in),
                "replies_out": float(self._replies_out),
                "bytes_in": float(self._bytes_in),
                "bytes_out": float(self._bytes_out),
                "read_pauses": float(self._read_pauses),
                "write_blocks": float(self._write_blocks),
                "wakeups": float(self._wakeups),
                "wakeups_per_s": self._wakeups / elapsed,
                "idle_reaped": float(self._idle_reaped),
                "idle_timeout_s": float(self.idle_timeout_s),
                "accept_shards": float(self.n_shards)}
