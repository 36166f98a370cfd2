"""Typed Behavior: immutable message -> Behavior functions, tag-interpreted.

A copy of `akka_tpu/typed/behavior.py` at commit 1001e26 (host code, no jax;
the port keeps its own copy of every module it needs).

Reference parity: akka-actor-typed/src/main/scala/akka/actor/typed/Behavior.scala
(:41) — `interpretMessage` (:229) and the tag switch (:244-278); behavior tags
from typed/internal/BehaviorImpl.scala:20. Signals from typed/Signal.scala.

The same tag model is what the batched runtime steps on the device: a
BatchedBehavior is the tensor-wide analogue of ReceiveBehavior, with the tag
switch becoming a select over behavior ids (see akka_tpu_torch/batched).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

# -- signals (reference: akka/actor/typed/Signal.scala) ---------------------


class Signal:
    __slots__ = ()


class _PreRestart(Signal):
    def __repr__(self):
        return "PreRestart"


class _PostStop(Signal):
    def __repr__(self):
        return "PostStop"


PreRestart = _PreRestart()
PostStop = _PostStop()


@dataclass(frozen=True)
class Terminated(Signal):
    ref: Any


@dataclass(frozen=True)
class ChildFailed(Terminated):
    cause: BaseException = None  # type: ignore[assignment]


# -- behavior tags ----------------------------------------------------------


class Behavior:
    """Base. Subclass tags mirror BehaviorTags (typed/internal/BehaviorImpl.scala:20)."""

    __slots__ = ()

    def narrow(self) -> "Behavior":
        return self


class ExtensibleBehavior(Behavior):
    """User-extensible: receive(ctx, msg) -> Behavior, receive_signal(ctx, sig)
    (reference: typed/ExtensibleBehavior.scala / AbstractBehavior)."""

    def receive(self, ctx, msg) -> "Behavior":
        raise NotImplementedError

    def receive_signal(self, ctx, signal: Signal) -> "Behavior":
        return UNHANDLED


class ReceiveBehavior(ExtensibleBehavior):
    __slots__ = ("on_message", "on_signal")

    def __init__(self, on_message: Callable[[Any, Any], Behavior],
                 on_signal: Optional[Callable[[Any, Signal], Behavior]] = None):
        self.on_message = on_message
        self.on_signal = on_signal

    def receive(self, ctx, msg) -> Behavior:
        return self.on_message(ctx, msg)

    def receive_signal(self, ctx, signal: Signal) -> Behavior:
        if self.on_signal is None:
            return UNHANDLED
        return self.on_signal(ctx, signal)


class DeferredBehavior(Behavior):
    """Behaviors.setup — materialized on start (reference: BehaviorImpl.DeferredBehavior)."""

    __slots__ = ("factory",)

    def __init__(self, factory: Callable[[Any], Behavior]):
        self.factory = factory

    def __call__(self, ctx) -> Behavior:
        return self.factory(ctx)


class _Same(Behavior):
    def __repr__(self):
        return "Behaviors.same"


class _Unhandled(Behavior):
    def __repr__(self):
        return "Behaviors.unhandled"


class _Empty(Behavior):
    def __repr__(self):
        return "Behaviors.empty"


class _Ignore(Behavior):
    def __repr__(self):
        return "Behaviors.ignore"


class StoppedBehavior(Behavior):
    __slots__ = ("post_stop_cb",)

    def __init__(self, post_stop_cb: Optional[Callable[[], None]] = None):
        self.post_stop_cb = post_stop_cb

    def __repr__(self):
        return "Behaviors.stopped"


class FailedBehavior(Behavior):
    __slots__ = ("cause",)

    def __init__(self, cause: BaseException):
        self.cause = cause


SAME = _Same()
UNHANDLED = _Unhandled()
EMPTY = _Empty()
IGNORE = _Ignore()
STOPPED = StoppedBehavior()


class BehaviorInterceptor:
    """Decorator around a nested behavior (reference: typed/BehaviorInterceptor.scala)."""

    def around_receive(self, ctx, msg, target: Callable[[Any, Any], Behavior]) -> Behavior:
        return target(ctx, msg)

    def around_signal(self, ctx, signal: Signal, target: Callable[[Any, Signal], Behavior]) -> Behavior:
        return target(ctx, signal)

    def around_start(self, ctx, target: Callable[[Any], Behavior]) -> Behavior:
        return target(ctx)

    def is_same(self, other: "BehaviorInterceptor") -> bool:
        return type(self) is type(other)


class InterceptedBehavior(Behavior):
    __slots__ = ("interceptor", "nested")

    def __init__(self, interceptor: BehaviorInterceptor, nested: Behavior):
        self.interceptor = interceptor
        self.nested = nested


# -- interpretation (reference: Behavior.scala:229,244-278) ------------------


def start(behavior: Behavior, ctx) -> Behavior:
    """Undefer setup chains until a concrete behavior emerges."""
    while isinstance(behavior, (DeferredBehavior, InterceptedBehavior)):
        if isinstance(behavior, DeferredBehavior):
            behavior = behavior(ctx)
        else:
            started = behavior.interceptor.around_start(ctx, lambda c: start(behavior.nested, c))
            if started is behavior.nested or isinstance(started, _Same):
                started = behavior.nested
            if isinstance(started, (DeferredBehavior,)):
                started = start(started, ctx)
            return InterceptedBehavior(behavior.interceptor, started) \
                if not isinstance(started, (StoppedBehavior, FailedBehavior)) else started
    return behavior


def is_alive(behavior: Behavior) -> bool:
    return not isinstance(behavior, (StoppedBehavior, FailedBehavior))

def is_unhandled(behavior: Behavior) -> bool:
    return isinstance(behavior, _Unhandled)


def canonicalize(behavior: Behavior, current: Behavior, ctx) -> Behavior:
    if isinstance(behavior, _Same) or behavior is current:
        return current
    if isinstance(behavior, _Unhandled):
        return current
    if isinstance(behavior, DeferredBehavior):
        return canonicalize(start(behavior, ctx), current, ctx)
    return behavior


def interpret_message(behavior: Behavior, ctx, msg) -> Behavior:
    return _interpret(behavior, ctx, msg, is_signal=False)


def interpret_signal(behavior: Behavior, ctx, signal: Signal) -> Behavior:
    return _interpret(behavior, ctx, signal, is_signal=True)


def _interpret(behavior: Behavior, ctx, payload, is_signal: bool) -> Behavior:
    if isinstance(behavior, (_Same, _Unhandled)):
        raise ValueError(f"cannot execute {behavior!r} as an initial behavior")
    if isinstance(behavior, DeferredBehavior):
        raise ValueError("deferred behavior must be start()ed before interpretation")
    if isinstance(behavior, (StoppedBehavior, FailedBehavior, _Empty)):
        return UNHANDLED if not isinstance(behavior, StoppedBehavior) else behavior
    if isinstance(behavior, _Ignore):
        return SAME
    if isinstance(behavior, InterceptedBehavior):
        nested = behavior.nested

        def target(c, m):
            inner = _interpret(nested, c, m, is_signal)
            return inner

        if is_signal:
            result = behavior.interceptor.around_signal(ctx, payload, target)
        else:
            result = behavior.interceptor.around_receive(ctx, payload, target)
        result = canonicalize(result, nested, ctx)
        if result is nested:
            return behavior
        if not is_alive(result):
            return result
        return InterceptedBehavior(behavior.interceptor, result)
    if isinstance(behavior, ExtensibleBehavior):
        if is_signal:
            return behavior.receive_signal(ctx, payload)
        return behavior.receive(ctx, payload)
    raise TypeError(f"unknown behavior tag: {type(behavior).__name__}")
