"""Bookkeeping for the tests that run one stream scenario through the JAX
package's stream DSL and the port's side by side
(tests/test_torch_stream.py, test_torch_stream_ops.py,
test_torch_stream_graph.py).

A scenario is a function `scenario(S) -> trace`, written once. `S` is a
`Run` of one package: its names by short name (`S.Source`, `S.Flow`,
`S.Sink`, `S.Keep`, `S.TestSource`, `S.Status`, ...), a fresh
`S.system`, and `S.seq(source)`, `S.later(v)` as the reference tests'
helpers. `side_by_side` makes a test of a scenario: it runs it on the
reference, then on the port, and holds the port's trace (elements,
materialized values, failures by class name, in order) to the
reference's. After each package's run the system is terminated,
`await_termination(WAIT)` must hold, the run's thread pool is shut down
and no thread the run started may be left. Every wait is at most WAIT.
"""

import importlib
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

from torch_host_fixture import (PACKAGES, QUIET, WAIT,  # noqa: F401
                                assert_no_new_threads, threads)


def package(name: str) -> SimpleNamespace:
    """The names of one package that the stream scenarios use: every
    export of `<name>.stream`, the stream probes, the exceptions of the
    operator modules, and the actor names the stages meet."""
    def m(sub):
        return importlib.import_module(f"{name}.{sub}")

    root = importlib.import_module(name)
    stream = m("stream")
    ns = SimpleNamespace(**{n: getattr(stream, n) for n in stream.__all__})
    testkit = m("stream.testkit")
    ops2, ops4 = m("stream.ops2"), m("stream.ops4")
    messages = m("actor.messages")
    ns.__dict__.update(
        name=name, stream=stream, ActorSystem=root.ActorSystem,
        Actor=root.Actor, Props=root.Props,
        TestSource=testkit.TestSource, TestSink=testkit.TestSink,
        StreamLimitReachedException=ops2.StreamLimitReachedException,
        BackpressureTimeoutException=ops4.BackpressureTimeoutException,
        WatchedActorTerminatedException=(
            ops4.WatchedActorTerminatedException),
        NeverMaterializedException=ops4.NeverMaterializedException,
        Status=messages.Status, DeadLetter=messages.DeadLetter,
        TestProbe=m("testkit").TestProbe,
        OptimalSizeExploringResizer=(
            m("routing.router").OptimalSizeExploringResizer),
        restart=m("stream.restart"))
    return ns


class Run:
    """One package's run of a scenario: its names, a system, a pool."""

    _n = 0

    def __init__(self, name: str):
        Run._n += 1
        self.P = package(name)
        self.system = self.P.ActorSystem.create(f"stream-{Run._n}", QUIET)
        self._pool = None

    def __getattr__(self, attr):
        return getattr(self.P, attr)

    @property
    def pool(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(4)
        return self._pool

    def later(self, v, delay: float = 0.01):
        """A Future of `v`, set from the pool after `delay` seconds."""
        import time

        def work():
            time.sleep(delay)
            return v
        return self.pool.submit(work)

    def seq(self, source, timeout: float = WAIT):
        return source.run_with(self.P.Sink.seq(), self.system).result(timeout)

    def close(self) -> None:
        self.system.terminate()
        ok = self.system.await_termination(WAIT)
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
        assert ok, f"{self.system} failed to terminate"


def both(scenario, *args) -> dict:
    """The scenario's trace on each package, by package name."""
    traces = {}
    for name in PACKAGES:
        before = threads()
        run = Run(name)
        try:
            traces[name] = scenario(run, *args)
        finally:
            run.close()
        assert_no_new_threads(before)
    return traces


def side_by_side(scenario):
    """A test of `scenario(S)`: run on both packages, the port's trace
    equal to the reference's."""
    def test():
        traces = both(scenario)
        assert traces["akka_tpu_torch"] == traces["akka_tpu"], traces

    test.__name__ = test.__qualname__ = scenario.__name__
    test.__doc__ = scenario.__doc__
    test.__module__ = scenario.__module__
    return test


def err(fut, timeout: float = WAIT) -> str:
    """The class name of the failure a future ends with ("" if none)."""
    ex = fut.exception(timeout)
    return type(ex).__name__ if ex is not None else ""
