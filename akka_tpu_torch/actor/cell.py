"""ActorCell: per-actor execution context.

A copy of `akka_tpu/actor/cell.py` at commit 5d9b7cd (host code, no jax; the
port keeps its own copy of every module it needs).

Reference parity: akka-actor/src/main/scala/akka/actor/ActorCell.scala —
`invoke` (:539-555), `systemInvoke` (:471-536), become/unbecome (:589-602),
`newActor` (:609-627) — plus the dungeon traits it mixes in:
Dispatch (actor/dungeon/Dispatch.scala: mailbox init :63-100, sendMessage :153-160),
FaultHandling (actor/dungeon/FaultHandling.scala), DeathWatch
(actor/dungeon/DeathWatch.scala:25,81), Children, ReceiveTimeout.

The cell doubles as the user-facing ActorContext (as in the reference, where
ActorCell extends ActorContext, actor/ActorCell.scala:49).
"""

from __future__ import annotations

import contextvars
import itertools
import threading
from typing import Any, Callable, Dict, Optional

from . import messages as msgs
from .messages import (ActorInitializationException, ActorKilledException,
                       DeathPactException, InvalidActorNameException, Terminated,
                       UnhandledMessage)
from .path import ActorPath, new_uid, validate_path_element
from .props import Props
from .ref import ActorRef, InternalActorRef, LocalActorRef, Nobody
from .supervision import ChildRestartStats, default_strategy
from ..dispatch import sysmsg
from ..dispatch.mailbox import Envelope

# the cell under construction, so Actor.__init__ can grab its context
# (reference: ActorCell.contextStack ThreadLocal)
_current_cell: contextvars.ContextVar = contextvars.ContextVar("akka_tpu_current_cell", default=None)


def current_cell():
    return _current_cell.get()


class ActorCell:
    _temp_counter = itertools.count()

    def __init__(self, system, self_ref: LocalActorRef, props: Props,
                 dispatcher_id: Optional[str], parent: Optional[InternalActorRef]):
        self.system = system
        self.self_ref = self_ref
        self.props = props
        self.parent = parent
        self.dispatcher = system.dispatchers.lookup(
            dispatcher_id or props.dispatcher or system.dispatchers.DEFAULT_DISPATCHER_ID)
        self.mailbox = None
        self.actor = None
        self._behavior_stack: list[Callable[[Any], Any]] = []
        self._children: Dict[str, InternalActorRef] = {}
        self._child_stats: Dict[str, ChildRestartStats] = {}
        # remote-deployed children: named like children (uniqueness, lookup,
        # stop-on-terminate) but NOT awaited during termination — their cell
        # lives on another node (remote/deploy.py daemon owns supervision)
        self._remote_children: Dict[str, InternalActorRef] = {}
        self._children_lock = threading.RLock()
        self.current_message: Optional[Envelope] = None
        self.sender: Optional[ActorRef] = None
        self._watching: Dict[ActorRef, Any] = {}     # ref -> custom Terminated-replacement or None
        self._watched_by: set = set()
        self._terminating = False
        self._terminated = False
        self._failed_perpetrator: Optional[ActorRef] = None
        self._failure_cause: Optional[BaseException] = None
        self._pending_recreate_cause: Optional[BaseException] = None
        self._pending_recreate_wait: set = set()
        self.uid = self_ref.path.uid
        self.receive_timeout: Optional[float] = None
        self._receive_timeout_task = None
        self.stash_capacity = -1

    # ------------------------------------------------------------------ init
    def init(self, send_supervise: bool, mailbox_type) -> None:
        """Create mailbox + enqueue Create (reference: dungeon/Dispatch.scala:63-100)."""
        self.mailbox = self.dispatcher.create_mailbox(self, mailbox_type)
        self.mailbox.actor = self
        self.mailbox.system_enqueue(self.self_ref, sysmsg.Create())
        if send_supervise and self.parent is not None:
            self.parent.send_system_message(sysmsg.Supervise(child=self.self_ref))

    def start(self) -> None:
        self.dispatcher.attach(self)

    def swap_mailbox(self, new):
        old = self.mailbox
        self.mailbox = new
        return old

    # ----------------------------------------------------------- ctx surface
    @property
    def context(self) -> "ActorCell":
        return self

    @property
    def self_(self) -> ActorRef:
        return self.self_ref

    @property
    def children(self):
        return list(self._children.values())

    def child(self, name: str) -> Optional[InternalActorRef]:
        c = self._children.get(name)
        return c if c is not None else self._remote_children.get(name)

    def get_single_child(self, name: str) -> Optional[InternalActorRef]:
        if "#" in name:
            name, uid_s = name.split("#", 1)
            child = self._children.get(name)
            if child is not None and child.path.uid == int(uid_s):
                return child
            # remote-deployed children's paths carry no uid; a selection to
            # the logical /user path must still resolve (the reference's
            # children container holds the RemoteActorRef, so getChild finds
            # it; skipping the uid check mirrors that)
            return self._remote_children.get(name)
        child = self._children.get(name)
        return child if child is not None else self._remote_children.get(name)

    def actor_of(self, props: Props, name: Optional[str] = None) -> ActorRef:
        """Spawn a child (reference: dungeon/Children.attachChild →
        provider.actorOf, actor/ActorRefProvider.scala:116)."""
        if self._terminating or self._terminated:
            raise msgs.IllegalActorStateException(f"cannot create children while terminating: {self.self_ref}")
        with self._children_lock:
            if name is None:
                name = f"$" + _base64(next(self._temp_counter))
            else:
                validate_path_element(name)
            if name in self._children or name in self._remote_children:
                raise InvalidActorNameException(
                    f"actor name [{name}] is not unique in {self.self_ref.path}")
            child = self.system.provider.actor_of(
                self.system, props, self.self_ref, self.self_ref.path.child(name).with_uid(new_uid()))
            if getattr(child, "is_local", True):
                self._children[name] = child
                self._child_stats[name] = ChildRestartStats(child)
            else:
                # remote-deployed — it lives under the remote daemon, which
                # watches this parent and stops the child when we die
                # (remote/deploy.py; no local sysmsg channel exists for it),
                # but it keeps its name here for uniqueness + child() lookup.
                # Watch it (internal, NOT via self._watching, so the user
                # never sees a Terminated they didn't ask for) so the entry
                # is pruned when the remote child dies — otherwise the name
                # stays reserved forever and the dict grows unboundedly
                # under routee churn.
                self._remote_children[name] = child
                child.send_system_message(
                    sysmsg.Watch(watchee=child, watcher=self.self_ref))
        child.start()
        return child

    spawn = actor_of

    def stop(self, ref: Optional[ActorRef] = None) -> None:
        """Stop self or a child (reference: ActorCell.stop)."""
        target = ref if ref is not None else self.self_ref
        if isinstance(target, InternalActorRef):
            target.send_system_message(sysmsg.Terminate())

    def become(self, behavior: Callable[[Any], Any], discard_old: bool = True) -> None:
        """(reference: ActorCell.become :589-602)"""
        if discard_old and self._behavior_stack:
            self._behavior_stack.pop()
        self._behavior_stack.append(behavior)

    def unbecome(self) -> None:
        if len(self._behavior_stack) > 1:
            self._behavior_stack.pop()

    def watch(self, ref: ActorRef, message: Any = None) -> ActorRef:
        """DeathWatch (reference: dungeon/DeathWatch.scala:25); `message`
        implements watchWith."""
        if ref != self.self_ref and ref not in self._watching:
            self._watching[ref] = message
            if isinstance(ref, InternalActorRef):
                ref.send_system_message(sysmsg.Watch(watchee=ref, watcher=self.self_ref))
        elif ref in self._watching:
            self._watching[ref] = message
        return ref

    def unwatch(self, ref: ActorRef) -> ActorRef:
        if ref in self._watching:
            del self._watching[ref]
            if isinstance(ref, InternalActorRef):
                ref.send_system_message(sysmsg.Unwatch(watchee=ref, watcher=self.self_ref))
        return ref

    def set_receive_timeout(self, timeout: Optional[float]) -> None:
        """(reference: dungeon/ReceiveTimeout.scala)"""
        self.receive_timeout = timeout if timeout and timeout > 0 else None
        self._reschedule_receive_timeout()

    def _reschedule_receive_timeout(self) -> None:
        if self._receive_timeout_task is not None:
            self._receive_timeout_task.cancel()
            self._receive_timeout_task = None
        if self.receive_timeout is not None and not self._terminated:
            self._receive_timeout_task = self.system.scheduler.schedule_once(
                self.receive_timeout,
                lambda: self.self_ref.tell(msgs.ReceiveTimeout, self.self_ref))

    # -------------------------------------------------------------- dispatch
    def send_message(self, envelope: Envelope) -> None:
        if self.mailbox is None or self._terminated:
            self.system.dead_letters.tell(
                msgs.DeadLetter(envelope.message, envelope.sender, self.self_ref), envelope.sender)
            return
        self.dispatcher.dispatch(self, envelope)

    def send_system_message(self, message: sysmsg.SystemMessage) -> None:
        if self.mailbox is None or self._terminated:
            self._system_message_post_mortem(message)
            return
        self.dispatcher.system_dispatch(self, message)

    def _system_message_post_mortem(self, message: sysmsg.SystemMessage) -> None:
        """System messages to an already-dead cell (reference: the
        deadLetterMailbox special-casing in dispatch/Mailbox.scala:445-465)."""
        if isinstance(message, sysmsg.Watch):
            if message.watcher is not None and message.watcher != self.self_ref:
                message.watcher.send_system_message(
                    sysmsg.DeathWatchNotification(self.self_ref, existence_confirmed=True))
        elif isinstance(message, (sysmsg.Unwatch, sysmsg.Terminate,
                                  sysmsg.DeathWatchNotification, sysmsg.Failed)):
            pass
        else:
            self.system.dead_letters.tell(
                msgs.DeadLetter(message, self.self_ref, self.self_ref), self.self_ref)

    @property
    def is_terminated(self) -> bool:
        return self._terminated

    @property
    def is_terminating(self) -> bool:
        return self._terminating

    # ------------------------------------------------------------ system path
    def system_invoke(self, message: sysmsg.SystemMessage) -> None:
        """(reference: ActorCell.systemInvoke :471-536)"""
        try:
            if isinstance(message, sysmsg.Create):
                self._create(message.failure)
            elif isinstance(message, sysmsg.Recreate):
                self._fault_recreate(message.cause)
            elif isinstance(message, sysmsg.Suspend):
                self._fault_suspend()
            elif isinstance(message, sysmsg.Resume):
                self._fault_resume(message.caused_by_failure)
            elif isinstance(message, sysmsg.Terminate):
                self._terminate()
            elif isinstance(message, sysmsg.Supervise):
                self._supervise(message.child)
            elif isinstance(message, sysmsg.Watch):
                self._add_watcher(message.watchee, message.watcher)
            elif isinstance(message, sysmsg.Unwatch):
                self._rem_watcher(message.watchee, message.watcher)
            elif isinstance(message, sysmsg.Failed):
                self._handle_failed(message)
            elif isinstance(message, sysmsg.DeathWatchNotification):
                self._watched_actor_terminated(message.actor, message.existence_confirmed,
                                               message.address_terminated, message.cause)
            elif isinstance(message, sysmsg.NoMessage):
                pass
        except Exception as e:  # noqa: BLE001 — supervision boundary
            self.handle_invoke_failure(e)

    def _create(self, failure: Optional[BaseException]) -> None:
        """(reference: ActorCell.create :629-664)"""
        if failure is not None:
            raise failure
        try:
            token = _current_cell.set(self)
            try:
                instance = self.props.new_actor()
            finally:
                _current_cell.reset(token)
            if instance is None:
                raise ActorInitializationException(self.self_ref, "Actor instance is None")
            self.actor = instance
            if not hasattr(instance, "_cell") or instance._cell is None:
                instance._cell = self
            if not self._behavior_stack:
                self._behavior_stack = [instance.receive]
            instance.pre_start()
            _fr = self.system.flight_recorder
            if _fr.enabled:
                _fr.actor_spawned(str(self.self_ref.path))
            if self.system.settings.debug_lifecycle:
                self._log_debug("started")
        except ActorInitializationException:
            raise
        except Exception as e:  # noqa: BLE001
            raise ActorInitializationException(
                self.self_ref, f"exception during creation: {e!r}", e) from e

    def _supervise(self, child: ActorRef) -> None:
        if not self._terminating and child.path.name not in self._children:
            # child created via provider directly (e.g. guardians)
            self._children[child.path.name] = child
            self._child_stats[child.path.name] = ChildRestartStats(child)

    # -- fault handling (reference: actor/dungeon/FaultHandling.scala) -------
    def handle_invoke_failure(self, cause: BaseException) -> None:
        if self._failed_perpetrator is not None:
            return
        self._failed_perpetrator = self.self_ref
        self._failure_cause = cause
        _fr = self.system.flight_recorder
        if _fr.enabled:
            _fr.actor_failed(str(self.self_ref.path), repr(cause))
        try:
            self.suspend_self_and_children()
            if self.parent is not None:
                self.parent.send_system_message(
                    sysmsg.Failed(child=self.self_ref, cause=cause, uid=self.uid))
            else:
                # root guardian failure: log + stop
                self._log_error(cause, "root-level failure; stopping")
                self.stop()
        except Exception:  # noqa: BLE001 pragma: no cover
            self.stop()

    def suspend_self_and_children(self) -> None:
        self.mailbox.suspend()
        for child in self.children:
            if isinstance(child, InternalActorRef):
                child.suspend()

    def suspend(self) -> None:
        self.send_system_message(sysmsg.Suspend())

    def resume(self, caused_by_failure: Optional[BaseException] = None) -> None:
        self.send_system_message(sysmsg.Resume(caused_by_failure=caused_by_failure))

    def restart(self, cause: Optional[BaseException] = None) -> None:
        self.send_system_message(sysmsg.Recreate(cause=cause))

    def _fault_suspend(self) -> None:
        self.mailbox.suspend()
        for child in self.children:
            if isinstance(child, InternalActorRef):
                child.suspend()

    def _fault_resume(self, caused_by_failure: Optional[BaseException]) -> None:
        if caused_by_failure is not None:
            self._failed_perpetrator = None
            self._failure_cause = None
        if self.mailbox.resume():
            for child in self.children:
                if isinstance(child, InternalActorRef):
                    child.resume(caused_by_failure=None)
        self.dispatcher.register_for_execution(self.mailbox, False, False)

    def _handle_failed(self, f: sysmsg.Failed) -> None:
        """Parent-side supervision decision (reference: FaultHandling.handleFailure)."""
        child = f.child
        stats = self._child_stats.get(child.path.name)
        if stats is None or stats.child != child:
            return  # stale
        strategy = self._strategy()
        handled = strategy.handle_failure(self, child, f.cause, stats,
                                          list(self._child_stats.values()))
        if not handled:
            # escalate: we fail ourselves with the child's cause
            raise f.cause if f.cause is not None else RuntimeError("escalated failure")

    def _strategy(self):
        if self.actor is not None:
            s = getattr(self.actor, "supervisor_strategy", None)
            if s is not None:
                return s
        return default_strategy()

    def _fault_recreate(self, cause: Optional[BaseException]) -> None:
        """(reference: FaultHandling.faultRecreate)"""
        if self.actor is None:
            self._create(None)
            self._fault_resume(cause)
            return
        if self._terminating:
            return
        failed_actor = self.actor
        try:
            failed_actor.pre_restart(cause, self.current_message.message if self.current_message else None)
        except Exception as e:  # noqa: BLE001
            self._log_error(e, "exception in pre_restart")
        # wait only for children that are actually terminating (the default
        # pre_restart stops them all, but a user pre_restart may keep children
        # alive — reference: faultRecreate waits for ChildrenContainer.Termination
        # entries only, not all children)
        stopping = {name for name, child in self._children.items()
                    if self._child_is_terminating(child)}
        if stopping:
            self._pending_recreate_cause = cause if cause is not None else RuntimeError("restart")
            self._pending_recreate_wait = stopping
        else:
            self._finish_recreate(cause)

    @staticmethod
    def _child_is_terminating(child) -> bool:
        cell = getattr(child, "cell", None)
        if cell is None:
            return False
        return cell._terminating or cell._terminated

    def _finish_recreate(self, cause: Optional[BaseException]) -> None:
        self._failed_perpetrator = None
        self._failure_cause = None
        self._pending_recreate_cause = None
        self._pending_recreate_wait = set()
        try:
            token = _current_cell.set(self)
            try:
                fresh = self.props.new_actor()
            finally:
                _current_cell.reset(token)
            self.actor = fresh
            fresh._cell = self
            self._behavior_stack = [fresh.receive]
            fresh.post_restart(cause)
            _fr = self.system.flight_recorder
            if _fr.enabled:
                _fr.actor_restarted(str(self.self_ref.path), repr(cause))
            if self.system.settings.debug_lifecycle:
                self._log_debug("restarted")
            if self.mailbox.resume():
                for child in self.children:
                    if isinstance(child, InternalActorRef):
                        child.resume(caused_by_failure=None)
            self.dispatcher.register_for_execution(self.mailbox, False, False)
        except Exception as e:  # noqa: BLE001
            self.actor = None
            self.handle_invoke_failure(
                msgs.PostRestartException(self.self_ref, f"exception post restart: {e!r}", e))

    # -- termination (reference: FaultHandling.terminate/finishTerminate) ----
    def _terminate(self) -> None:
        if self._terminated:
            return
        self.set_receive_timeout(None)
        if not self._terminating:
            self._terminating = True
            # remote-deployed children: fire-and-forget stop (their daemon
            # also watches us, so this is belt-and-braces, not awaited)
            for rc in list(self._remote_children.values()):
                rc.stop()
            self._remote_children.clear()
            children = self.children
            if children:
                for child in children:
                    if isinstance(child, InternalActorRef):
                        child.stop()
                # do not process user messages while waiting for children; the
                # reference suspends here (dungeon/FaultHandling.terminate) so
                # the children's DeathWatchNotifications can still arrive
                self.mailbox.suspend()
            else:
                self._finish_terminate()
        elif not self._children:
            self._finish_terminate()

    def _finish_terminate(self) -> None:
        if self._terminated:
            return
        self._terminated = True
        self._terminating = True
        _fr = self.system.flight_recorder
        if _fr.enabled:
            _fr.actor_stopped(str(self.self_ref.path))
        actor = self.actor
        try:
            if actor is not None:
                actor.post_stop()
        except Exception as e:  # noqa: BLE001
            self._log_error(e, "exception in post_stop")
        finally:
            self.mailbox.become_closed()
            self.mailbox.clean_up()
            self.dispatcher.detach(self)
            # unwatch everything we watch
            for ref in list(self._watching):
                if isinstance(ref, InternalActorRef):
                    ref.send_system_message(sysmsg.Unwatch(watchee=ref, watcher=self.self_ref))
            self._watching.clear()
            # notify watchers + parent (cause propagates failure deaths
            # into typed ChildFailed signals)
            for watcher in list(self._watched_by):
                watcher.send_system_message(
                    sysmsg.DeathWatchNotification(self.self_ref, existence_confirmed=True,
                                                  cause=self._failure_cause))
            self._watched_by.clear()
            if self.parent is not None:
                self.parent.send_system_message(
                    sysmsg.DeathWatchNotification(self.self_ref, existence_confirmed=True,
                                                  cause=self._failure_cause))
            self.actor = None
            if self.system.settings.debug_lifecycle:
                self._log_debug("stopped")
            self.system.provider.actor_terminated(self.self_ref)

    # -- deathwatch plumbing -------------------------------------------------
    def _add_watcher(self, watchee: ActorRef, watcher: ActorRef) -> None:
        if watchee == self.self_ref and watcher != self.self_ref:
            if self._terminated:
                watcher.send_system_message(
                    sysmsg.DeathWatchNotification(self.self_ref, existence_confirmed=True))
            else:
                self._watched_by.add(watcher)

    def _rem_watcher(self, watchee: ActorRef, watcher: ActorRef) -> None:
        if watchee == self.self_ref:
            self._watched_by.discard(watcher)

    def _watched_actor_terminated(self, actor: ActorRef, existence_confirmed: bool,
                                  address_terminated: bool,
                                  cause: Optional[BaseException] = None) -> None:
        """(reference: dungeon/DeathWatch.watchedActorTerminated :81)"""
        name = actor.path.name
        # remote-deployed child died: free its LOCAL name (the internal watch
        # placed at spawn; mirrors how local children leave _children). The
        # remote ref's path name is the daemon-side mangled name, so match by
        # path value, lenient on uid like _find_watched.
        from .path import undefined_uid
        for rname, rref in list(self._remote_children.items()):
            if rref.path == actor.path or (
                    rref.path.address == actor.path.address
                    and rref.path.elements == actor.path.elements
                    and (rref.path.uid == undefined_uid
                         or actor.path.uid == undefined_uid)):
                with self._children_lock:
                    self._remote_children.pop(rname, None)
                break
        is_child = self._children.get(name) == actor
        if is_child:
            with self._children_lock:
                self._children.pop(name, None)
                self._child_stats.pop(name, None)
            if self.actor is not None:
                self._strategy().handle_child_terminated(self, actor, self.children)
            self._pending_recreate_wait.discard(name)
            if self._pending_recreate_cause is not None and not self._pending_recreate_wait:
                self._finish_recreate(self._pending_recreate_cause)
            elif self._terminating and not self._children:
                self._finish_terminate()
        watched_key = self._find_watched(actor)
        if watched_key is not None:
            custom = self._watching.pop(watched_key)
            if not self._terminating and not self._terminated:
                message = custom if custom is not None else Terminated(
                    watched_key, existence_confirmed, address_terminated, cause)
                # delivered as a normal user message, bypassing the closed check
                self._invoke_terminated(Envelope(message, watched_key))

    def _find_watched(self, actor: ActorRef) -> Optional[ActorRef]:
        """Exact (path+uid) match first; else a path match where either side
        lacks a uid — a remote watch resolved without uid must still match the
        uid-carrying ref inside an inbound DeathWatchNotification."""
        if actor in self._watching:
            return actor
        from .path import undefined_uid
        for key in self._watching:
            if key.path == actor.path and (
                    key.path.uid == undefined_uid
                    or actor.path.uid == undefined_uid
                    or key.path.uid == actor.path.uid):
                return key
        return None

    def _invoke_terminated(self, envelope: Envelope) -> None:
        # Terminated must reach the actor even while mailbox is suspended;
        # enqueue through the dispatcher like any message.
        self.dispatcher.dispatch(self, envelope)

    # --------------------------------------------------------------- invoke
    def invoke(self, envelope: Envelope) -> None:
        """(reference: ActorCell.invoke :539-555)"""
        if self._terminated:
            self.system.dead_letters.tell(
                msgs.DeadLetter(envelope.message, envelope.sender, self.self_ref), envelope.sender)
            return
        self.current_message = envelope
        self.sender = envelope.sender if envelope.sender is not None else self.system.dead_letters
        msg = envelope.message
        try:
            # re-arm on every message, including ReceiveTimeout itself, so the
            # timeout keeps firing while the actor stays idle (reference:
            # dungeon/ReceiveTimeout re-arms after delivery)
            if self.receive_timeout is not None:
                self._reschedule_receive_timeout()
            if isinstance(msg, msgs.AutoReceivedMessage):
                self._auto_receive_message(envelope)
            else:
                self.receive_message(msg)
        except Exception as e:  # noqa: BLE001 — the supervision boundary
            self.handle_invoke_failure(e)
        finally:
            self.current_message = None

    def _auto_receive_message(self, envelope: Envelope) -> None:
        """(reference: ActorCell.autoReceiveMessage :557-568)"""
        msg = envelope.message
        if self.system.settings.debug_autoreceive:
            self._log_debug(f"received AutoReceiveMessage {msg!r}")
        if isinstance(msg, Terminated):
            self.receive_message(msg)
        elif msg is msgs.PoisonPill:
            self.stop()
        elif msg is msgs.Kill:
            raise ActorKilledException("Kill")
        elif isinstance(msg, msgs.Identify):
            sender = self.sender
            if sender is not None:
                sender.tell(msgs.ActorIdentity(msg.message_id, self.self_ref), self.self_ref)

    def receive_message(self, msg: Any) -> None:
        """(reference: ActorCell.receiveMessage :577 → Actor.aroundReceive)"""
        behavior = self._behavior_stack[-1] if self._behavior_stack else None
        if behavior is None:
            self.unhandled(msg)
            return
        if self.actor is not None:
            self.actor.around_receive(behavior, msg)
        else:
            behavior(msg)

    def unhandled(self, msg: Any) -> None:
        """(reference: Actor.unhandled — Terminated => DeathPactException)"""
        if isinstance(msg, Terminated):
            raise DeathPactException(msg.actor)
        self.system.event_stream.publish(UnhandledMessage(msg, self.sender, self.self_ref))

    # --------------------------------------------------------------- logging
    def _log_debug(self, text: str) -> None:
        from ..event.logging import Debug
        self.system.event_stream.publish(Debug(str(self.self_ref.path), type(self.actor).__name__
                                               if self.actor else "ActorCell", text))

    def _log_error(self, cause: BaseException, text: str) -> None:
        from ..event.logging import Error
        self.system.event_stream.publish(Error(str(self.self_ref.path), type(self.actor).__name__
                                               if self.actor else "ActorCell", text, cause=cause))


_B64 = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+~"


def _base64(n: int) -> str:
    s = ""
    while True:
        s += _B64[n & 63]
        n >>= 6
        if n == 0:
            return s
