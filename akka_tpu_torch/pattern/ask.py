"""Ask pattern: request-response as a Future via a temporary promise ref.

A copy of `akka_tpu/pattern/ask.py` at commit 5d9b7cd (host code, no jax;
the port keeps its own copy of every module it needs).

Reference parity: akka-actor/src/main/scala/akka/pattern/AskSupport.scala —
`ask` (:84) creates a PromiseActorRef (:476) registered under /temp, which
completes a future on the first reply and fails with AskTimeoutException
after the timeout.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future
from typing import Any, Optional

from ..actor.messages import Status
from ..actor.path import ActorPath
from ..actor.ref import ActorRef, InternalActorRef, MinimalActorRef
from ..dispatch import sysmsg


class AskTimeoutException(Exception):
    pass


class PromiseActorRef(MinimalActorRef):
    """(reference: pattern/AskSupport.scala:476)"""

    def __init__(self, path: ActorPath, provider, future: Future, timeout_task=None,
                 on_complete=None):
        super().__init__(path, provider)
        self.future = future
        self._timeout_task = timeout_task
        self._on_complete = on_complete
        self._done = threading.Event()
        self._done_lock = threading.Lock()
        self._watched_by: set = set()

    def _try_complete(self) -> bool:
        """Atomically claim completion — racing replies/timeouts lose cleanly."""
        with self._done_lock:
            if self._done.is_set():
                return False
            self._done.set()
            return True

    def tell(self, message: Any, sender: Optional[ActorRef] = None) -> None:
        if not self._try_complete():
            return
        if self._timeout_task is not None:
            self._timeout_task.cancel()
        if isinstance(message, Status.Failure):
            self.future.set_exception(message.cause)
        elif isinstance(message, Status.Success):
            self.future.set_result(message.status)
        else:
            self.future.set_result(message)
        self._cleanup()

    def send_system_message(self, message: sysmsg.SystemMessage) -> None:
        if isinstance(message, sysmsg.Watch):
            self._watched_by.add(message.watcher)
        elif isinstance(message, sysmsg.Unwatch):
            self._watched_by.discard(message.watcher)
        elif isinstance(message, sysmsg.DeathWatchNotification):
            from ..actor.messages import Terminated
            self.tell(Terminated(message.actor, message.existence_confirmed,
                                 message.address_terminated))

    def _cleanup(self) -> None:
        if self.provider is not None:
            self.provider.unregister_temp_actor(self.path)
        for w in list(self._watched_by):
            w.send_system_message(sysmsg.DeathWatchNotification(self, existence_confirmed=True))
        self._watched_by.clear()
        if self._on_complete is not None:
            self._on_complete(self)

    def stop(self) -> None:
        self.tell(Status.Failure(AskTimeoutException("promise ref stopped")))

    @property
    def is_terminated(self) -> bool:
        return self._done.is_set()


def ask(target: ActorRef, message: Any, timeout: float = 5.0, system=None) -> Future:
    """Send `message` to `target` with a promise ref as sender; returns a
    concurrent.futures.Future of the first reply. `message` may also be a
    callable ref -> message for typed-style ask."""
    import sys
    bridge = sys.modules.get("akka_tpu_torch.batched.bridge")
    if bridge is not None:
        # only consult the device path if the batched runtime is actually
        # loaded — host-only systems never import the device runtime here
        if isinstance(target, bridge.DeviceActorRef):
            # device actors complete asks via promise rows read back after
            # a step (the PromiseActorRef analogue lives in HBM)
            if callable(message) and not isinstance(message, type):
                raise TypeError(
                    "callable (typed-style) ask messages are not supported "
                    "for device actors; encode the reply-to via the codec")
            return target.ask(message, timeout)
        if isinstance(target, bridge.DeviceBlockRef):
            raise TypeError(
                "ask() on a DeviceBlockRef is ambiguous (which row would "
                "reply?); ask a single actor via block[i]")
    if system is None:
        system = getattr(target, "_system", None) or getattr(getattr(target, "cell", None), "system", None)
    if system is None:
        raise ValueError("ask: cannot determine actor system; pass system=")
    provider = system.provider
    fut: Future = Future()
    path = provider.temp_path()
    ref = PromiseActorRef(path, provider, fut)
    task = system.scheduler.schedule_once(
        timeout, lambda: _timeout(ref, fut, target, message, timeout))
    ref._timeout_task = task
    provider.register_temp_actor(ref, path)
    msg = message(ref) if callable(message) and not isinstance(message, type) else message
    target.tell(msg, ref)
    return fut


def _timeout(ref: PromiseActorRef, fut: Future, target, message, timeout: float) -> None:
    if ref._try_complete():
        ref._cleanup()
        fut.set_exception(AskTimeoutException(
            f"Ask timed out on [{target}] after [{timeout}s]. "
            f"Message of type [{type(message).__name__}]."))


def ask_sync(target: ActorRef, message: Any, timeout: float = 5.0, system=None) -> Any:
    """Blocking ask."""
    return ask(target, message, timeout, system).result(timeout + 1.0)


def pipe(future: Future, recipient: ActorRef, sender: Optional[ActorRef] = None) -> None:
    """Pipe a future's outcome to an actor (reference: pattern/PipeToSupport.scala)."""

    def _done(f: Future) -> None:
        exc = f.exception()
        if exc is not None:
            recipient.tell(Status.Failure(exc), sender)
        else:
            recipient.tell(f.result(), sender)

    future.add_done_callback(_done)
