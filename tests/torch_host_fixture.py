"""Bookkeeping for the tests that run one script through the JAX
package's host actor layer and the port's side by side
(tests/test_torch_typed.py, test_torch_persistence_host.py,
test_torch_versioned.py).

A scenario is a function `scenario(P, systems, *args) -> trace`, written
once against a package namespace `P` (`package("akka_tpu")` or
`package("akka_tpu_torch")`); `side_by_side` runs it on both and holds the
port's trace (replies, states, listings, in order) to the reference's.
Every system a scenario starts goes through the file's `systems` fixture
(a `Systems`), which terminates each, asserts `await_termination(10.0)`
and asserts that no thread a test started is still alive.
"""

import contextlib
import importlib
import sys
import threading
import time
from dataclasses import dataclass
from types import ModuleType, SimpleNamespace

PACKAGES = ("akka_tpu", "akka_tpu_torch")
QUIET = {"akka": {"stdout-loglevel": "OFF", "log-dead-letters": 0}}
WAIT = 10.0         # every wait of these tests, at most


def package(name: str) -> SimpleNamespace:
    """The modules of one package a scenario uses, by short names."""
    def m(sub):
        return importlib.import_module(f"{name}.{sub}")

    root = importlib.import_module(name)
    return SimpleNamespace(
        name=name, ActorSystem=root.ActorSystem, Actor=root.Actor,
        Props=root.Props, ask_sync=root.ask_sync,
        typed=m("typed"), delivery=m("typed.delivery"),
        props_from_behavior=m("typed.adapter").props_from_behavior,
        persistence=m("persistence"), journal=m("persistence.journal"),
        messages=m("persistence.messages"),
        testkit=m("testkit"), backoff=m("pattern.backoff"),
        serialization=m("serialization"), ask=m("pattern.ask"))


@contextlib.contextmanager
def class_of_no_package():
    """A class that the JAX package can pickle and that maps to no module
    of the port: it lives in `akka_tpu.no_such_module`, registered in
    sys.modules only inside the block. The port's reader maps the path to
    `akka_tpu_torch.no_such_module`, which neither package has, now or
    later, so a record of it stays unresolvable."""
    name = "akka_tpu.no_such_module"
    mod = ModuleType(name)

    @dataclass(frozen=True)
    class Absent:
        entity_id: str
        message: object

    Absent.__module__ = name
    Absent.__qualname__ = "Absent"
    mod.Absent = Absent
    sys.modules[name] = mod
    try:
        yield Absent
    finally:
        del sys.modules[name]


def threads() -> set:
    return {t.ident for t in threading.enumerate()}


def assert_no_new_threads(before: set) -> None:
    """Join every thread started since `before` (5 s in all) and fail on
    any still alive."""
    deadline = time.monotonic() + 5.0
    left = [t for t in threading.enumerate() if t.ident not in before]
    for t in left:
        t.join(max(0.0, deadline - time.monotonic()))
    alive = [t.name for t in left if t.is_alive()]
    assert not alive, f"threads left running: {alive}"


class Systems:
    """The systems of one test: `classic`/`typed` start one, `close_one`
    ends one before the test does, `close` ends the rest and checks."""

    _n = 0

    def __init__(self):
        self.before = threads()
        self.open = []

    def _name(self, stem: str) -> str:
        Systems._n += 1
        return f"{stem}-{Systems._n}"

    def classic(self, P, stem: str = "host", config=None):
        s = P.ActorSystem.create(self._name(stem), config or QUIET)
        self.open.append(s)
        return s

    def typed(self, P, guardian, stem: str = "typed", config=None):
        s = P.typed.ActorSystem.create(guardian, self._name(stem),
                                       config or QUIET)
        self.open.append(s)
        return s

    def close_one(self, s) -> None:
        self.open.remove(s)
        s.terminate()
        assert s.await_termination(WAIT), f"{s} failed to terminate"

    def close(self) -> None:
        left, self.open = self.open, []
        for s in left:
            s.terminate()
        for s in left:
            assert s.await_termination(WAIT), f"{s} failed to terminate"
        assert_no_new_threads(self.before)


def side_by_side(scenario, systems: Systems, *args):
    """Run `scenario` on the reference, then on the port; the two traces
    must be equal. Returns the port's trace."""
    traces = {name: scenario(package(name), systems, *args)
              for name in PACKAGES}
    assert traces["akka_tpu_torch"] == traces["akka_tpu"], traces
    return traces["akka_tpu_torch"]
