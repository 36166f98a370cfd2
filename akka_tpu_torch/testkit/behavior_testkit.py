"""Synchronous, deterministic behavior testing: BehaviorTestKit + TestInbox.

A copy of `akka_tpu/testkit/behavior_testkit.py` at commit 5834bbc (host
code, no jax; the port keeps its own copy of every module it needs).

Reference parity: akka-actor-testkit-typed/.../internal/BehaviorTestKitImpl.scala
(:26 runs the behavior on the caller thread; :79-107 records Effects), effect
vocabulary from .../scaladsl/Effects.scala (Spawned, Stopped, Watched,
Scheduled, MessageAdapter, ReceiveTimeoutSet, ...), TestInbox from
.../scaladsl/TestInbox.scala. No threads, no dispatchers: receive runs inline
and effects/messages are recorded for assertion — the TPU analogue of testing
a behavior as a pure function.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

from ..typed.behavior import (Behavior, PostStop, Signal, canonicalize,
                              interpret_message, interpret_signal, is_alive,
                              start)


# -- effects (reference: akka-actor-testkit-typed scaladsl/Effects.scala) ----

@dataclass(frozen=True)
class Effect:
    pass


@dataclass(frozen=True)
class Spawned(Effect):
    behavior: Any
    child_name: str
    ref: Any = None


@dataclass(frozen=True)
class SpawnedAnonymous(Effect):
    behavior: Any
    ref: Any = None


@dataclass(frozen=True)
class Stopped(Effect):
    child_name: str


@dataclass(frozen=True)
class Watched(Effect):
    ref: Any


@dataclass(frozen=True)
class WatchedWith(Effect):
    ref: Any
    message: Any


@dataclass(frozen=True)
class Unwatched(Effect):
    ref: Any


@dataclass(frozen=True)
class Scheduled(Effect):
    delay: float
    target: Any
    message: Any


@dataclass(frozen=True)
class ReceiveTimeoutSet(Effect):
    timeout: float
    message: Any


@dataclass(frozen=True)
class ReceiveTimeoutCancelled(Effect):
    pass


@dataclass(frozen=True)
class MessageAdapter(Effect):
    fn: Callable[[Any], Any]
    ref: Any


class TestInbox:
    """Captures messages sent to a synthetic ref (reference: TestInbox.scala)."""

    _counter = itertools.count(1)

    def __init__(self, name: Optional[str] = None):
        self.name = name or f"inbox-{next(TestInbox._counter)}"
        self._messages: List[Any] = []
        self.ref = _InboxRef(self)

    def receive_message(self) -> Any:
        if not self._messages:
            raise AssertionError(f"TestInbox {self.name} is empty")
        return self._messages.pop(0)

    def expect_message(self, expected: Any) -> Any:
        msg = self.receive_message()
        if msg != expected:
            raise AssertionError(f"expected {expected!r}, got {msg!r}")
        return msg

    @property
    def has_messages(self) -> bool:
        return bool(self._messages)

    def all_messages(self) -> List[Any]:
        return list(self._messages)

    def clear(self) -> List[Any]:
        out, self._messages = self._messages, []
        return out


class _InboxRef:
    def __init__(self, inbox: TestInbox):
        self._inbox = inbox
        self.path = f"test://{inbox.name}"

    def tell(self, message: Any, sender: Any = None) -> None:
        self._inbox._messages.append(message)

    __call__ = tell

    def __repr__(self):
        return f"TestInboxRef({self._inbox.name})"


class _RecordedCancellable:
    __slots__ = ("is_cancelled",)

    def __init__(self):
        self.is_cancelled = False

    def cancel(self) -> bool:
        if self.is_cancelled:
            return False
        self.is_cancelled = True
        return True


class _StubScheduler:
    """Recording scheduler so Behaviors.with_timers works synchronously."""

    def __init__(self, kit: "BehaviorTestKit"):
        self._kit = kit

    def schedule_once(self, delay: float, fn=None) -> _RecordedCancellable:
        return _RecordedCancellable()

    def schedule_tell_with_fixed_delay(self, initial: float, delay: float,
                                       target: Any, msg: Any) -> _RecordedCancellable:
        self._kit._effects.append(Scheduled(delay, target, msg))
        return _RecordedCancellable()

    schedule_tell_at_fixed_rate = schedule_tell_with_fixed_delay


class _StubSystem:
    def __init__(self, kit: "BehaviorTestKit"):
        self.scheduler = _StubScheduler(kit)
        self.name = "BehaviorTestKit"


class _SyncContext:
    """Duck-typed TypedActorContext recording effects instead of doing them
    (reference: akka-actor-testkit-typed EffectfulActorContext)."""

    def __init__(self, kit: "BehaviorTestKit", name: str):
        self._kit = kit
        self._self_inbox = TestInbox(name)
        self._children: dict = {}
        self._system = _StubSystem(kit)
        self.log = _ListLogger(kit.logs)

    @property
    def self(self) -> Any:  # noqa: A003
        return self._self_inbox.ref

    @property
    def system(self):
        return self._system

    @property
    def children(self):
        return list(self._children.values())

    def child(self, name: str):
        return self._children.get(name)

    def child_inbox(self, name: str) -> Optional[TestInbox]:
        ref = self._children.get(name)
        return ref._inbox if ref is not None else None

    def spawn(self, behavior: Behavior, name: Optional[str] = None, **_kw):
        if name is None:
            return self.spawn_anonymous(behavior)
        inbox = TestInbox(name)
        self._children[name] = inbox.ref
        self._kit._effects.append(Spawned(behavior, name, inbox.ref))
        return inbox.ref

    def spawn_anonymous(self, behavior: Behavior):
        inbox = TestInbox()
        self._children[inbox.name] = inbox.ref
        self._kit._effects.append(SpawnedAnonymous(behavior, inbox.ref))
        return inbox.ref

    def stop(self, child) -> None:
        for name, ref in list(self._children.items()):
            if ref is child:
                del self._children[name]
                self._kit._effects.append(Stopped(name))
                return
        self._kit._effects.append(Stopped(getattr(child, "path", str(child))))

    def watch(self, ref) -> None:
        self._kit._effects.append(Watched(ref))

    def watch_with(self, ref, msg) -> None:
        self._kit._effects.append(WatchedWith(ref, msg))

    def unwatch(self, ref) -> None:
        self._kit._effects.append(Unwatched(ref))

    def set_receive_timeout(self, timeout: float, msg: Any) -> None:
        self._kit._effects.append(ReceiveTimeoutSet(timeout, msg))

    def cancel_receive_timeout(self) -> None:
        self._kit._effects.append(ReceiveTimeoutCancelled())

    def schedule_once(self, delay: float, target, msg):
        self._kit._effects.append(Scheduled(delay, target, msg))
        return _RecordedCancellable()

    def message_adapter(self, fn: Callable[[Any], Any], for_type: type = object):
        class _AdapterRef:
            path = "test://adapter"

            def tell(_s, message, sender=None):
                self._self_inbox._messages.append(fn(message))
        ref = _AdapterRef()
        self._kit._effects.append(MessageAdapter(fn, ref))
        return ref

    def pipe_to_self(self, future, map_result):
        # synchronous kit: resolve immediately if done, else record nothing
        if future.done():
            try:
                self._self_inbox._messages.append(map_result(future.result(), None))
            except BaseException as e:  # noqa: BLE001
                self._self_inbox._messages.append(map_result(None, e))


class _ListLogger:
    def __init__(self, sink: List[tuple]):
        self._sink = sink

    def debug(self, msg, *a):
        self._sink.append(("DEBUG", msg % a if a else msg))

    def info(self, msg, *a):
        self._sink.append(("INFO", msg % a if a else msg))

    def warning(self, msg, *a):
        self._sink.append(("WARNING", msg % a if a else msg))

    warn = warning

    def error(self, msg, *a):
        self._sink.append(("ERROR", msg % a if a else msg))


class BehaviorTestKit:
    """Run a Behavior synchronously, asserting on effects and child inboxes."""

    def __init__(self, behavior: Behavior, name: str = "testkit"):
        self._effects: List[Effect] = []
        self.logs: List[tuple] = []
        self.context = _SyncContext(self, name)
        self.current = start(behavior, self.context)

    # -- driving --------------------------------------------------------------
    def run(self, message: Any) -> None:
        nxt = interpret_message(self.current, self.context, message)
        self.current = canonicalize(nxt, self.current, self.context)

    def run_one(self) -> None:
        """Deliver the next message from the self inbox."""
        self.run(self.self_inbox.receive_message())

    def signal(self, sig: Signal) -> None:
        nxt = interpret_signal(self.current, self.context, sig)
        self.current = canonicalize(nxt, self.current, self.context)

    @property
    def is_alive(self) -> bool:
        return is_alive(self.current)

    # -- inspection -----------------------------------------------------------
    @property
    def self_inbox(self) -> TestInbox:
        return self.context._self_inbox

    def retrieve_all_effects(self) -> List[Effect]:
        out, self._effects = self._effects, []
        return out

    def retrieve_effect(self) -> Effect:
        if not self._effects:
            raise AssertionError("no effects recorded")
        return self._effects.pop(0)

    def expect_effect(self, expected: Effect) -> Effect:
        eff = self.retrieve_effect()
        if eff != expected:
            raise AssertionError(f"expected {expected!r}, got {eff!r}")
        return eff

    def expect_effect_class(self, cls: type) -> Effect:
        eff = self.retrieve_effect()
        if not isinstance(eff, cls):
            raise AssertionError(f"expected {cls.__name__}, got {eff!r}")
        return eff

    def has_effects(self) -> bool:
        return bool(self._effects)

    def child_inbox(self, name: str) -> Optional[TestInbox]:
        return self.context.child_inbox(name)
