"""Classic Actor base class + Stash + FunctionActor.

A copy of `akka_tpu/actor/actor.py` at commit 5d9b7cd (host code, no jax;
the port keeps its own copy of every module it needs).

Reference parity: akka-actor/src/main/scala/akka/actor/Actor.scala (lifecycle
hooks: preStart/postStop/preRestart/postRestart, aroundReceive, unhandled) and
actor/Stash.scala (:61,172,216 — stash into a deque-based mailbox).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from .cell import ActorCell, current_cell
from .messages import Terminated
from .ref import ActorRef
from ..dispatch.mailbox import DequeBasedMessageQueue, Envelope


class Actor:
    """Subclass and implement `receive(message)`. The context is available
    as `self.context` already inside __init__ (grabbed from the construction
    contextvar, mirroring the reference's contextStack ThreadLocal)."""

    # optional mailbox requirement marker (see Mailboxes.for_props)
    mailbox_requirement: Optional[type] = None

    def __init__(self) -> None:
        self._cell: Optional[ActorCell] = current_cell()

    # -- context accessors ---------------------------------------------------
    @property
    def context(self) -> ActorCell:
        if self._cell is None:
            raise RuntimeError("actor has no context (not created via actor_of?)")
        return self._cell

    @property
    def self_ref(self) -> ActorRef:
        return self.context.self_ref

    @property
    def sender(self) -> ActorRef:
        return self.context.sender

    @property
    def supervisor_strategy(self):
        return None  # None -> cell uses default_strategy()

    # -- lifecycle (reference: Actor.scala preStart/postStop/pre/postRestart) --
    def pre_start(self) -> None:
        pass

    def post_stop(self) -> None:
        pass

    def pre_restart(self, reason: Optional[BaseException], message: Any) -> None:
        """Default: unwatch+stop all children, then post_stop."""
        ctx = self.context
        for child in ctx.children:
            ctx.unwatch(child)
            ctx.stop(child)
        self.post_stop()

    def post_restart(self, reason: Optional[BaseException]) -> None:
        self.pre_start()

    # -- message handling ----------------------------------------------------
    def around_receive(self, receive: Callable[[Any], Any], msg: Any) -> None:
        handled = receive(msg)
        if handled is NotImplemented:
            self.unhandled(msg)

    def receive(self, message: Any) -> Any:
        """Return NotImplemented to signal 'unhandled' (maps the reference's
        partial-function miss to a sentinel)."""
        return NotImplemented

    def unhandled(self, message: Any) -> None:
        self.context.unhandled(message)


class FunctionActor(Actor):
    """Actor from a plain function receive(context, message)."""

    def __init__(self, fn: Callable[[ActorCell, Any], Any]):
        super().__init__()
        self._fn = fn

    def receive(self, message: Any) -> Any:
        return self._fn(self.context, message)


class Stash(Actor):
    """Mixin: stash() the current message, unstash_all() to re-prepend them
    (reference: actor/Stash.scala; requires a deque-based mailbox)."""

    mailbox_requirement = DequeBasedMessageQueue

    def __init__(self) -> None:
        super().__init__()
        self._theStash: list[Envelope] = []

    def stash(self) -> None:
        env = self.context.current_message
        if env is None:
            raise RuntimeError("no current message to stash")
        if self._theStash and self._theStash[-1] is env:
            raise RuntimeError("cannot stash the same message twice")
        cap = self.context.stash_capacity
        if 0 <= cap <= len(self._theStash):
            raise RuntimeError(f"stash capacity {cap} exceeded")
        self._theStash.append(env)

    def unstash_all(self, predicate: Callable[[Any], bool] = lambda _: True) -> None:
        mq = self.context.mailbox.message_queue
        if not isinstance(mq, DequeBasedMessageQueue):
            raise RuntimeError("unstash_all requires a deque-based mailbox")
        try:
            for env in reversed(self._theStash):
                if predicate(env.message):
                    mq.enqueue_first(self.context.self_ref, env)
        finally:
            self._theStash = []

    def unstash(self) -> None:
        """Prepend the OLDEST stashed message (reference: Stash.unstash)."""
        if self._theStash:
            mq = self.context.mailbox.message_queue
            mq.enqueue_first(self.context.self_ref, self._theStash.pop(0))

    def post_stop(self) -> None:
        # dead-letter remaining stash (reference: Stash.scala:216)
        from .messages import DeadLetter
        for env in self._theStash:
            self.context.system.dead_letters.tell(
                DeadLetter(env.message, env.sender, self.context.self_ref), env.sender)
        self._theStash = []
        super().post_stop()
