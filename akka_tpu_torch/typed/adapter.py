"""Adapter: typed behaviors run as classic actors.

A copy of `akka_tpu/typed/adapter.py` at commit 1001e26 (host code, no jax;
the port keeps its own copy of every module it needs).

Reference parity: akka-actor-typed/src/main/scala/akka/actor/typed/internal/adapter/
ActorAdapter.scala (:55 — receive → Behavior.interpretMessage :123-129),
ActorSystemAdapter, PropsAdapter. The typed ActorContext wraps the classic cell.
"""

from __future__ import annotations

from concurrent.futures import Future
from typing import Any, Callable, Optional

from ..actor.actor import Actor
from ..actor.messages import Terminated as ClassicTerminated
from ..actor.props import Props
from ..actor.ref import ActorRef
from ..event.logging import LoggingAdapter
from .behavior import (Behavior, ChildFailed, FailedBehavior, PostStop,
                       PreRestart, StoppedBehavior, Terminated, canonicalize,
                       interpret_message, interpret_signal, is_alive,
                       is_unhandled, start)


class TypedActorContext:
    """Typed ActorContext facade over the classic ActorCell
    (reference: typed/internal/adapter/ActorContextAdapter.scala)."""

    def __init__(self, cell):
        self._cell = cell
        self._current_behavior: Optional[Behavior] = None
        self._adapters: dict = {}
        self.log = LoggingAdapter(cell.system.event_stream, str(cell.self_ref.path))

    # -- identity ------------------------------------------------------------
    @property
    def self(self) -> ActorRef:  # noqa: A003 — mirrors the reference name
        return self._cell.self_ref

    @property
    def system(self):
        return self._cell.system

    @property
    def children(self):
        return self._cell.children

    def child(self, name: str):
        return self._cell.child(name)

    # -- spawning ------------------------------------------------------------
    def spawn(self, behavior: Behavior, name: Optional[str] = None,
              props: Optional[Props] = None) -> ActorRef:
        p = props_from_behavior(behavior) if props is None else props
        return self._cell.actor_of(p, name)

    def spawn_anonymous(self, behavior: Behavior) -> ActorRef:
        return self.spawn(behavior, None)

    def stop(self, child: ActorRef) -> None:
        self._cell.stop(child)

    def watch(self, ref: ActorRef) -> None:
        self._cell.watch(ref)

    def watch_with(self, ref: ActorRef, msg: Any) -> None:
        self._cell.watch(ref, msg)

    def unwatch(self, ref: ActorRef) -> None:
        self._cell.unwatch(ref)

    def set_receive_timeout(self, timeout: float, msg: Any) -> None:
        self._receive_timeout_msg = msg
        self._cell.set_receive_timeout(timeout)

    def cancel_receive_timeout(self) -> None:
        self._cell.set_receive_timeout(None)

    # -- scheduling / interop -------------------------------------------------
    def schedule_once(self, delay: float, target: ActorRef, msg: Any):
        return self.system.scheduler.schedule_tell_once(delay, target, msg, self.self)

    def message_adapter(self, fn: Callable[[Any], Any], for_type: type = object) -> ActorRef:
        """Adapter ref translating foreign replies into our protocol.
        Re-registering for the same type replaces the function (reference:
        ActorContext.messageAdapter semantics)."""
        key = for_type
        self._adapter_fns = getattr(self, "_adapter_fns", {})
        self._adapter_fns[key] = fn
        if key in self._adapters:
            return self._adapters[key]
        me = self.self
        fns = self._adapter_fns

        def _handler(msg, sender):
            me.tell(fns[key](msg), sender)

        ref = self.system.provider.create_function_ref(_handler)
        self._adapters[key] = ref
        return ref

    def _release_resources(self) -> None:
        """Stop adapter refs + cancel timers when the actor stops."""
        for ref in self._adapters.values():
            try:
                self.system.provider.stop_function_ref(ref)
            except Exception:  # noqa: BLE001
                pass
        self._adapters.clear()
        for ts in getattr(self, "_timer_schedulers", []):
            ts.cancel_all()

    def pipe_to_self(self, future: Future, map_result: Callable[[Any, Optional[BaseException]], Any]) -> None:
        me = self.self

        def _done(f: Future):
            exc = f.exception()
            me.tell(map_result(None, exc) if exc is not None else map_result(f.result(), None))

        future.add_done_callback(_done)

    def ask(self, target: ActorRef, make_message: Callable[[ActorRef], Any],
            adapt: Callable[[Any, Optional[BaseException]], Any], timeout: float = 5.0) -> None:
        """Typed ask: reply adapted into our own protocol and self-told."""
        from ..pattern.ask import ask as _ask
        fut = _ask(target, make_message, timeout=timeout, system=self.system)
        self.pipe_to_self(fut, adapt)


class TypedActorAdapter(Actor):
    """(reference: typed/internal/adapter/ActorAdapter.scala:55)"""

    def __init__(self, behavior: Behavior):
        super().__init__()
        self._initial = behavior
        self.ctx = TypedActorContext(self.context)
        self._behavior: Optional[Behavior] = None

    def pre_start(self) -> None:
        self._behavior = start(self._initial, self.ctx)
        self.ctx._current_behavior = self._behavior
        self._last_alive: Optional[Behavior] = self._behavior if is_alive(self._behavior) else None
        self._check_alive()

    def receive(self, message: Any):
        try:
            self._receive(message)
        except Exception as e:  # noqa: BLE001
            # typed default: an unhandled exception STOPS the actor (reference:
            # typed failure handling — no restart unless Behaviors.supervise)
            self.ctx.log.error(f"typed behavior failed, stopping: {e!r}", e)
            self._behavior = FailedBehavior(e)
            self.context.stop()

    def _receive(self, message: Any):
        if isinstance(message, ClassicTerminated):
            cause = getattr(message, "cause", None)
            is_child = message.actor.path.parent == self.context.self_ref.path
            sig = (ChildFailed(message.actor, cause) if (cause is not None and is_child)
                   else Terminated(message.actor))
            nxt = interpret_signal(self._behavior, self.ctx, sig)
            if is_unhandled(nxt):
                # typed semantics: unhandled Terminated throws DeathPactException
                from ..actor.messages import DeathPactException
                raise DeathPactException(message.actor)
        else:
            timeout_msg = getattr(self.ctx, "_receive_timeout_msg", None)
            from ..actor.messages import ReceiveTimeout as _RT
            if message is _RT and timeout_msg is not None:
                message = timeout_msg
            nxt = interpret_message(self._behavior, self.ctx, message)
            if is_unhandled(nxt):
                from ..actor.messages import UnhandledMessage
                self.context.system.event_stream.publish(
                    UnhandledMessage(message, self.context.sender, self.context.self_ref))
        self._behavior = canonicalize(nxt, self._behavior, self.ctx)
        self.ctx._current_behavior = self._behavior
        if is_alive(self._behavior):
            self._last_alive = self._behavior
        self._check_alive()

    def _check_alive(self) -> None:
        if not is_alive(self._behavior):
            self.context.stop()

    def post_stop(self) -> None:
        self.ctx._release_resources()
        b = self._behavior
        if isinstance(b, StoppedBehavior) and b.post_stop_cb is not None:
            try:
                b.post_stop_cb()
            except Exception:  # noqa: BLE001
                pass
        else:
            target = b if (b is not None and is_alive(b)) else getattr(self, "_last_alive", None)
            if target is not None:
                try:
                    interpret_signal(target, self.ctx, PostStop)
                except Exception:  # noqa: BLE001
                    pass

    def pre_restart(self, reason, message) -> None:
        if self._behavior is not None and is_alive(self._behavior):
            try:
                interpret_signal(self._behavior, self.ctx, PreRestart)
            except Exception:  # noqa: BLE001
                pass
        super().pre_restart(reason, message)


def props_from_behavior(behavior: Behavior, dispatcher: Optional[str] = None) -> Props:
    p = Props.create(TypedActorAdapter, behavior)
    return p.with_dispatcher(dispatcher) if dispatcher else p
