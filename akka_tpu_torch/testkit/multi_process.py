"""Multi-PROCESS test harness: real OS processes, real TCP, barriers.

A copy of `akka_tpu/testkit/multi_process.py` at commit 5834bbc (host
code, no jax; the port keeps its own copy of every module it needs).

Reference parity: akka-multi-node-testkit — MultiNodeSpec assigns roles to
separate JVMs with named barriers (remote/testkit/MultiNodeSpec.scala:258,
373,388-401) coordinated by a TestConductor over a control channel
(remote/testconductor/Conductor.scala:56). Here:

- Conductor: a tiny line-protocol TCP server in the test process. Workers
  ENTER named barriers (released when all N arrive), POST json results,
  and the conductor collects exit codes.
- spawn_nodes(): launches N real python processes running a worker script
  with the parent's environment and the repo on the path, giving each
  its node index and the conductor address.
- node_barrier()/node_result(): called from inside worker scripts.

Fault injection (throttle/blackhole, Conductor.scala:128,148) is applied
in-process by workers on their own TcpTransport.fault_injector — the same
seam the in-proc multi-node harness uses.

A deliberate difference from the reference: `sanitized_env` sets no
JAX_PLATFORMS or XLA_FLAGS and hides no card. Each child picks its device
through its own config (the `tpu-batched` dispatcher's `device`, a
region's `device=`), so a child may run on the card.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Sequence


class Conductor:
    """Barrier + result collection server (one per test)."""

    def __init__(self, n_nodes: int):
        self.n_nodes = n_nodes
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(n_nodes * 4)
        self.port = self._srv.getsockname()[1]
        self._lock = threading.Lock()
        self._barriers: Dict[str, List[socket.socket]] = {}
        self.results: Dict[int, Any] = {}
        self._stop = threading.Event()
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="akka-tpu-conductor").start()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn: socket.socket) -> None:
        try:
            buf = b""
            while not self._stop.is_set():
                while b"\n" not in buf:
                    chunk = conn.recv(4096)
                    if not chunk:
                        return
                    buf += chunk
                line, _, buf = buf.partition(b"\n")
                parts = line.decode("utf-8").split(" ", 2)
                if parts[0] == "ENTER":
                    self._enter(parts[1], conn)
                elif parts[0] == "RESULT":
                    with self._lock:
                        self.results[int(parts[1])] = json.loads(parts[2])
                    conn.sendall(b"OK\n")
        except OSError:
            pass

    def _enter(self, name: str, conn: socket.socket) -> None:
        """Block the caller until n_nodes have entered barrier `name`
        (enterBarrier semantics: all-or-timeout)."""
        release: Optional[List[socket.socket]] = None
        with self._lock:
            waiting = self._barriers.setdefault(name, [])
            waiting.append(conn)
            if len(waiting) >= self.n_nodes:
                release = self._barriers.pop(name)
        if release is not None:
            for c in release:
                try:
                    c.sendall(b"GO\n")
                except OSError:
                    pass
        # non-releasing entrants just wait for GO on their socket (handled
        # client-side); the server keeps the connection open either way

    def shutdown(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass


def sanitized_env(extra: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """Child env for worker processes: the parent's, with the repo on the
    path. No device is forced: each child picks its own through its
    config."""
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    if extra:
        env.update(extra)
    return env


def spawn_nodes(worker_source: str, n_nodes: int,
                timeout: float = 120.0,
                extra_env: Optional[Dict[str, str]] = None):
    """Run `worker_source` in n real processes. The source sees
    AKKA_TPU_NODE_INDEX / AKKA_TPU_NODE_COUNT / AKKA_TPU_CONDUCTOR_PORT
    and uses node_barrier()/node_result(). Returns (results, stderrs).
    Raises on nonzero exit or timeout (with stderr attached). The overall
    timeout dilates with machine load (testkit.dilation) — n extra python
    processes on a busy box legitimately take longer to reach barriers."""
    from .dilation import dilated
    timeout = dilated(timeout)
    conductor = Conductor(n_nodes)
    procs: List[subprocess.Popen] = []
    drains: List[threading.Thread] = []
    outs: List[Dict[str, bytes]] = []
    try:
        for i in range(n_nodes):
            env = sanitized_env(extra_env)
            env["AKKA_TPU_NODE_INDEX"] = str(i)
            env["AKKA_TPU_NODE_COUNT"] = str(n_nodes)
            env["AKKA_TPU_CONDUCTOR_PORT"] = str(conductor.port)
            p = subprocess.Popen(
                [sys.executable, "-u", "-c", worker_source],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env)
            procs.append(p)
            # drain BOTH pipes concurrently for EVERY node: a verbose
            # worker blocked on a full pipe would otherwise never reach
            # its barrier and stall the whole group until timeout
            cap: Dict[str, bytes] = {"out": b"", "err": b""}
            outs.append(cap)

            def _drain(stream, key, cap=cap):
                cap[key] = stream.read()

            for stream, key in ((p.stdout, "out"), (p.stderr, "err")):
                t = threading.Thread(target=_drain, args=(stream, key),
                                     daemon=True)
                t.start()
                drains.append(t)
        deadline = time.monotonic() + timeout
        stderrs: List[str] = []
        for i, p in enumerate(procs):
            left = max(1.0, deadline - time.monotonic())
            try:
                p.wait(timeout=left)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                for t in drains:
                    t.join(2.0)
                raise AssertionError(
                    f"node {i} timed out after {timeout}s\n"
                    f"--- node {i} stderr ---\n"
                    f"{outs[i]['err'].decode()[-4000:]}")
        for t in drains:
            t.join(5.0)
        for i, p in enumerate(procs):
            stderrs.append(outs[i]["err"].decode())
            if p.returncode != 0:
                raise AssertionError(
                    f"node {i} exited {p.returncode}\n"
                    f"--- node {i} stderr ---\n{outs[i]['err'].decode()[-4000:]}\n"
                    f"--- node {i} stdout ---\n{outs[i]['out'].decode()[-2000:]}")
        return dict(conductor.results), stderrs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        conductor.shutdown()


# ----------------------------------------------------------- worker helpers
_conductor_conn: Optional[socket.socket] = None
_conn_lock = threading.Lock()


def _conn() -> socket.socket:
    global _conductor_conn
    with _conn_lock:
        if _conductor_conn is None:
            port = int(os.environ["AKKA_TPU_CONDUCTOR_PORT"])
            _conductor_conn = socket.create_connection(("127.0.0.1", port),
                                                       timeout=30.0)
        return _conductor_conn


def node_index() -> int:
    return int(os.environ["AKKA_TPU_NODE_INDEX"])


def node_count() -> int:
    return int(os.environ["AKKA_TPU_NODE_COUNT"])


def node_barrier(name: str, timeout: float = 60.0) -> None:
    """enterBarrier(name) — blocks until every node has entered."""
    c = _conn()
    c.sendall(f"ENTER {name}\n".encode())
    c.settimeout(timeout)
    buf = b""
    while b"\n" not in buf:
        chunk = c.recv(64)
        if not chunk:
            raise RuntimeError(f"conductor died in barrier {name!r}")
        buf += chunk
    if not buf.startswith(b"GO"):
        raise RuntimeError(f"barrier {name!r}: unexpected {buf!r}")


def node_result(value: Any) -> None:
    """Report this node's result dict to the test process."""
    c = _conn()
    c.sendall(f"RESULT {node_index()} {json.dumps(value)}\n".encode())
    c.settimeout(30.0)
    buf = b""
    while b"\n" not in buf:
        chunk = c.recv(16)
        if not chunk:
            raise RuntimeError("conductor died in result post")
        buf += chunk
