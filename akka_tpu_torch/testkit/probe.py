"""TestProbe + TestKit assertions for async single-process tests.

A copy of `akka_tpu/testkit/probe.py` at commit 5d9b7cd (host code, no jax;
the port keeps its own copy of every module it needs).

Reference parity: akka-testkit/src/main/scala/akka/testkit/TestKit.scala —
`expectMsg`/`expectMsgClass`/`expectNoMessage`/`fishForMessage`/`awaitAssert`
(:244-319 area), time dilation via `akka.test.timefactor`, `watch` +
`expectTerminated`; TestProbe (TestKit.scala TestProbe factory).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Iterable, Optional, Sequence, Type

from ..actor.actor import Actor
from ..actor.messages import Terminated
from ..actor.props import Props
from ..actor.ref import ActorRef


class _ProbeActor(Actor):
    def __init__(self, q: "queue.Queue[tuple[Any, Any]]"):
        super().__init__()
        self._q = q

    def receive(self, message):
        self._q.put((message, self.sender))


class AssertionFailure(AssertionError):
    pass


class TestProbe:
    """A queue-backed actor you can make assertions against.

    All timeouts are dilated by `akka.test.timefactor` from the system config
    (reference: TestKit.scala `dilated`).
    """

    _count = 0
    _count_lock = threading.Lock()

    def __init__(self, system, name: Optional[str] = None):
        self.system = system
        self._queue: "queue.Queue[tuple[Any, Any]]" = queue.Queue()
        if name is None:
            with TestProbe._count_lock:
                TestProbe._count += 1
                name = f"testProbe-{TestProbe._count}"
        self.ref: ActorRef = system.actor_of(
            Props.create(_ProbeActor, self._queue), name)
        self._last_sender: Optional[ActorRef] = None
        self._timefactor = float(
            system.settings.config.get("akka.test.timefactor", 1.0) or 1.0)
        self._default_timeout = system.settings.config.get_duration(
            "akka.test.single-expect-default", "3s")

    # -- timing ---------------------------------------------------------------
    def dilated(self, timeout: Optional[float]) -> float:
        if timeout is None:
            timeout = self._default_timeout
        return timeout * self._timefactor

    # -- sending --------------------------------------------------------------
    def send(self, target: ActorRef, message: Any) -> None:
        target.tell(message, self.ref)

    def reply(self, message: Any) -> None:
        if self._last_sender is None:
            raise AssertionFailure("no last sender to reply to")
        self._last_sender.tell(message, self.ref)

    def forward(self, target: ActorRef, message: Any) -> None:
        target.tell(message, self._last_sender)

    @property
    def last_sender(self) -> Optional[ActorRef]:
        return self._last_sender

    # -- watching -------------------------------------------------------------
    def watch(self, ref: ActorRef) -> ActorRef:
        self.ref.cell.watch(ref)
        return ref

    def unwatch(self, ref: ActorRef) -> ActorRef:
        self.ref.cell.unwatch(ref)
        return ref

    # -- receiving ------------------------------------------------------------
    def _next(self, timeout: Optional[float]) -> tuple[Any, Any]:
        try:
            msg, sender = self._queue.get(timeout=self.dilated(timeout))
        except queue.Empty:
            raise AssertionFailure(
                f"timeout ({self.dilated(timeout):.1f}s) while waiting for a message")
        self._last_sender = sender
        return msg, sender

    def receive_one(self, timeout: Optional[float] = None) -> Any:
        return self._next(timeout)[0]

    def receive_n(self, n: int, timeout: Optional[float] = None) -> list:
        deadline = time.monotonic() + self.dilated(timeout)
        out = []
        for _ in range(n):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise AssertionFailure(
                    f"timeout receiving {n} messages; got {len(out)}")
            try:
                msg, sender = self._queue.get(timeout=remaining)
            except queue.Empty:
                raise AssertionFailure(
                    f"timeout receiving {n} messages; got {len(out)}")
            self._last_sender = sender
            out.append(msg)
        return out

    def expect_msg(self, expected: Any, timeout: Optional[float] = None) -> Any:
        msg, _ = self._next(timeout)
        if msg != expected:
            raise AssertionFailure(f"expected {expected!r}, got {msg!r}")
        return msg

    def expect_msg_class(self, cls: Type, timeout: Optional[float] = None) -> Any:
        msg, _ = self._next(timeout)
        if not isinstance(msg, cls):
            raise AssertionFailure(f"expected {cls.__name__}, got {msg!r}")
        return msg

    def expect_msg_any_of(self, *candidates: Any, timeout: Optional[float] = None) -> Any:
        msg, _ = self._next(timeout)
        if msg not in candidates:
            raise AssertionFailure(f"expected one of {candidates!r}, got {msg!r}")
        return msg

    def expect_msg_all_of(self, *expected: Any, timeout: Optional[float] = None) -> list:
        remaining = list(expected)
        got = []
        deadline = time.monotonic() + self.dilated(timeout)
        while remaining:
            t = deadline - time.monotonic()
            if t <= 0:
                raise AssertionFailure(f"missing {remaining!r}; got {got!r}")
            try:
                msg, sender = self._queue.get(timeout=t)
            except queue.Empty:
                raise AssertionFailure(f"missing {remaining!r}; got {got!r}")
            self._last_sender = sender
            got.append(msg)
            if msg in remaining:
                remaining.remove(msg)
        return got

    def expect_no_message(self, timeout: float = 0.1) -> None:
        try:
            msg, _ = self._queue.get(timeout=self.dilated(timeout))
            raise AssertionFailure(f"expected no message, got {msg!r}")
        except queue.Empty:
            pass

    def expect_terminated(self, ref: ActorRef, timeout: Optional[float] = None) -> Terminated:
        msg = self.expect_msg_class(Terminated, timeout=timeout)
        if msg.actor != ref:
            raise AssertionFailure(f"expected Terminated({ref}), got {msg!r}")
        return msg

    def fish_for_message(self, predicate: Callable[[Any], bool],
                         timeout: Optional[float] = None) -> Any:
        """Skip messages until predicate matches (reference: fishForMessage)."""
        deadline = time.monotonic() + self.dilated(timeout)
        while True:
            t = deadline - time.monotonic()
            if t <= 0:
                raise AssertionFailure("fish_for_message timed out")
            try:
                msg, sender = self._queue.get(timeout=t)
            except queue.Empty:
                raise AssertionFailure("fish_for_message timed out")
            self._last_sender = sender
            if predicate(msg):
                return msg

    def receive_while(self, predicate: Callable[[Any], bool],
                      idle: float = 0.3, max_time: float = 3.0) -> list:
        out = []
        deadline = time.monotonic() + self.dilated(max_time)
        while time.monotonic() < deadline:
            try:
                msg, sender = self._queue.get(timeout=self.dilated(idle))
            except queue.Empty:
                break
            if not predicate(msg):
                # put it back conceptually: reference stops and keeps it for next expect
                self._queue.put((msg, sender))
                break
            self._last_sender = sender
            out.append(msg)
        return out


def await_assert(assertion: Callable[[], Any], max_time: float = 3.0,
                 interval: float = 0.05) -> Any:
    """Poll an assertion until it passes (reference: TestKit.awaitAssert)."""
    deadline = time.monotonic() + max_time
    last: Optional[BaseException] = None
    while time.monotonic() < deadline:
        try:
            return assertion()
        except BaseException as e:  # noqa: BLE001
            last = e
            time.sleep(interval)
    try:
        return assertion()
    except BaseException as e:  # noqa: BLE001
        raise AssertionFailure(f"await_assert never passed within {max_time}s: {e!r}") from (last or e)


def await_condition(condition: Callable[[], bool], max_time: float = 3.0,
                    interval: float = 0.05, message: str = "") -> None:
    deadline = time.monotonic() + max_time
    while time.monotonic() < deadline:
        if condition():
            return
        time.sleep(interval)
    if condition():
        return
    raise AssertionFailure(message or f"condition not met within {max_time}s")
