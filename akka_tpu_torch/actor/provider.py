"""LocalActorRefProvider: creates/resolves refs, owns the guardian hierarchy.

A copy of `akka_tpu/actor/provider.py` at commit 5d9b7cd (host code, no jax;
the port keeps its own copy of every module it needs). One change: a
device ref is told its parent, which it notifies when it stops.

Reference parity: akka-actor/src/main/scala/akka/actor/ActorRefProvider.scala —
LocalActorRefProvider (:370), rootGuardian (:513-514), actorOf (:116,215,231),
the /temp container for short-lived ask refs, and deadLetters.
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Dict, Optional

from .actor import Actor
from .cell import _base64
from .messages import Terminated
from .path import ActorPath, Address, new_uid, parse_actor_path
from .props import Props
from .ref import (ActorRef, DeadLetterActorRef, FunctionRef, InternalActorRef,
                  LocalActorRef, MinimalActorRef, Nobody)
from .supervision import (OneForOneStrategy, Escalate, Restart, Stop,
                          default_decider)
from ..dispatch import sysmsg


class Guardian(Actor):
    """Root/user/system guardian behavior (reference: ActorRefProvider.scala
    guardianProps — default SupervisorStrategy, Terminated stops the system)."""

    def __init__(self, strategy=None):
        super().__init__()
        self._strategy = strategy

    @property
    def supervisor_strategy(self):
        return self._strategy

    def receive(self, message: Any):
        if isinstance(message, Terminated):
            self.context.stop()
            return None
        return NotImplemented


class LocalActorRefProvider:
    def __init__(self, system_name: str, settings, event_stream):
        from .deploy import Deployer
        self.system_name = system_name
        self.settings = settings
        self.event_stream = event_stream
        self.deployer = Deployer(settings)
        self.root_path = ActorPath(Address("akka", system_name))
        self.dead_letters = DeadLetterActorRef(self.root_path / "deadLetters", event_stream)
        self.ignore_ref = MinimalActorRef(self.root_path / "ignore")
        self.root_guardian: Optional[LocalActorRef] = None
        self.user_guardian: Optional[LocalActorRef] = None
        self.system_guardian: Optional[LocalActorRef] = None
        self.system = None
        self._temp: Dict[str, InternalActorRef] = {}
        self._temp_lock = threading.Lock()
        self._temp_counter = itertools.count()
        self._terminated_event = threading.Event()

    # -- init (reference: ActorRefProvider.init + rootGuardian creation) -----
    def init(self, system) -> None:
        self.system = system
        root_props = Props.create(Guardian, OneForOneStrategy(decider=default_decider))
        self.root_guardian = LocalActorRef(
            system, root_props, system.dispatchers.INTERNAL_DISPATCHER_ID, None,
            self.root_path.with_uid(new_uid()))
        mailboxes = system.mailboxes
        self.root_guardian.initialize(send_supervise=False,
                                      mailbox_type=mailboxes.default_mailbox())
        self.root_guardian.start()
        root_cell = self.root_guardian.cell
        self.system_guardian = root_cell.actor_of(
            Props.create(Guardian).with_dispatcher(system.dispatchers.INTERNAL_DISPATCHER_ID),
            "system")
        self.user_guardian = root_cell.actor_of(Props.create(Guardian), "user")

    @property
    def guardian(self) -> LocalActorRef:
        return self.user_guardian

    # -- deployment resolution (reference: Deployer.lookup consulted from
    # actorOf; the config entry wins over the programmatic Props.deploy) -----
    def effective_props(self, props: Props, path: ActorPath):
        """Merge `akka.actor.deployment` config with props.deploy; returns
        (props, deploy). Only /user-subtree actors are deployable."""
        from .deploy import NO_SCOPE, Deploy
        from dataclasses import replace as _replace
        elements = list(path.elements)
        cfg_deploy = (self.deployer.lookup(elements[1:])
                      if len(elements) > 1 and elements[0] == "user" else None)
        deploy = props.deploy
        if cfg_deploy is not None:
            deploy = cfg_deploy.with_fallback(deploy) if deploy is not None \
                else cfg_deploy
        if deploy is None:
            return props, None
        if props.router_config is None and deploy.router_config is not None:
            props = _replace(props, router_config=deploy.router_config)
        if props.dispatcher is None and deploy.dispatcher is not None:
            props = props.with_dispatcher(deploy.dispatcher)
        if props.mailbox is None and deploy.mailbox is not None:
            props = props.with_mailbox(deploy.mailbox)
        return props, deploy

    # -- actorOf (reference: ActorRefProvider.actorOf :116) ------------------
    def actor_of(self, system, props: Props, supervisor: InternalActorRef,
                 path: ActorPath, _resolved: bool = False) -> InternalActorRef:
        if not _resolved:
            props, _deploy = self.effective_props(props, path)
        if props.device is not None:
            # device-resident actor: rows in the tpu-batched runtime behind
            # an ordinary ref — no cell, no host mailbox (the Dispatchers
            # seam selects the backend, dispatch/Dispatchers.scala:121-259)
            from ..batched.bridge import (DeviceActorRef, DeviceBlockRef,
                                          get_handle)
            spec = props.device
            handle = get_handle(system, props.dispatcher)
            rows = handle.spawn(spec.behavior, spec.n, spec.init_state)
            # the port passes the parent, which a device ref notifies when
            # it stops (the reference's refs do not: a system holding device
            # actors never finishes terminating)
            if spec.n == 1:
                return DeviceActorRef(system, handle, int(rows[0]), path,
                                      spec.codec, parent=supervisor)
            return DeviceBlockRef(system, handle, rows, path, spec.codec,
                                  parent=supervisor)
        if props.router_config is not None:
            from ..routing.routed_cell import RoutedActorRef
            ref = RoutedActorRef(system, props, props.dispatcher, supervisor, path)
        else:
            ref = LocalActorRef(system, props, props.dispatcher, supervisor, path)
        mailbox_type = system.mailboxes.for_props(props)
        ref.initialize(send_supervise=True, mailbox_type=mailbox_type)
        return ref

    # -- temp refs for ask (reference: ActorRefProvider tempContainer) -------
    def temp_path(self) -> ActorPath:
        return (self.root_path / "temp").child("$" + _base64(next(self._temp_counter)))

    def register_temp_actor(self, ref: InternalActorRef, path: ActorPath) -> None:
        with self._temp_lock:
            self._temp[path.name] = ref

    def unregister_temp_actor(self, path: ActorPath) -> None:
        with self._temp_lock:
            self._temp.pop(path.name, None)

    def create_function_ref(self, handler) -> FunctionRef:
        path = self.temp_path()
        ref = FunctionRef(path, self, handler)
        self.register_temp_actor(ref, path)
        return ref

    def stop_function_ref(self, ref: FunctionRef) -> None:
        ref.stop()
        self.unregister_temp_actor(ref.path)

    # -- resolution ----------------------------------------------------------
    def resolve_actor_ref(self, path: Any) -> ActorRef:
        if isinstance(path, str):
            try:
                path = parse_actor_path(path)
            except ValueError:
                return self.dead_letters
        if path.address != self.root_path.address:
            return self.dead_letters
        return self.resolve_local(path)

    def resolve_local(self, path: ActorPath) -> ActorRef:
        elements = list(path.elements)
        if not elements:
            return self.root_guardian
        if elements[0] == "temp":
            with self._temp_lock:
                ref = self._temp.get(elements[1]) if len(elements) > 1 else None
            return ref if ref is not None else self.dead_letters
        if elements == ["deadLetters"]:
            return self.dead_letters
        ref = self.root_guardian.get_child(elements)
        return ref if ref is not Nobody else self.dead_letters

    # -- termination bookkeeping --------------------------------------------
    def actor_terminated(self, ref: ActorRef) -> None:
        if self.system is None:
            return
        if ref == self.user_guardian:
            if self.system_guardian is not None:
                self.system_guardian.stop()
        elif ref == self.system_guardian:
            if self.root_guardian is not None:
                self.root_guardian.stop()
        elif ref == self.root_guardian:
            self._terminated_event.set()
            self.system._finish_terminate()

    @property
    def terminated_event(self) -> threading.Event:
        return self._terminated_event

    def get_external_address_for(self, remote_address) -> Optional[Address]:
        return None

    @property
    def default_address(self) -> Address:
        return self.root_path.address
