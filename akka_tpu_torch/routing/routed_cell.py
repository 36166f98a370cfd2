"""RoutedActorRef / RoutedActorCell: messages bypass the router's mailbox.

A copy of `akka_tpu/routing/routed_cell.py` at commit 5d9b7cd (host code, no
jax; the port keeps its own copy of every module it needs).

Reference parity: routing/RoutedActorCell.scala:137-141 (sendMessage routes
directly on the caller's thread), RouterActor (manages routees + resizer),
RouterPoolActor supervision of pool routees.
"""

from __future__ import annotations

from typing import Any, Optional

from ..actor.actor import Actor
from ..actor.cell import ActorCell
from ..actor.messages import PoisonPill, Terminated
from ..actor.props import Props
from ..actor.ref import ActorRef, LocalActorRef
from ..actor.supervision import default_strategy
from ..dispatch.mailbox import Envelope
from .router import (ActorRefRoutee, AddRoutee, AdjustPoolSize, Broadcast,
                     GetRoutees, RemoveRoutee, Routees, Router,
                     RouterManagementMessage)


class RouterActor(Actor):
    """The actor living at the router ref: handles management messages and
    watches routees (reference: routing/RouterActor.scala)."""

    def __init__(self, router_config):
        super().__init__()
        self.router_config = router_config
        self._message_counter = 0

    @property
    def supervisor_strategy(self):
        return self.router_config.supervisor_strategy or default_strategy()

    @property
    def _rcell(self) -> "RoutedActorCell":
        return self.context  # type: ignore[return-value]

    def pre_start(self) -> None:
        # routees are created synchronously by RoutedActorCell.init (the
        # reference does this in RoutedActorCell's constructor so no message
        # can arrive before the routees exist); watch them here
        for r in self._rcell.router.routees:
            ref = getattr(r, "ref", None)
            if ref is not None:
                self.context.watch(ref)

    def _spawn_routee(self) -> None:
        cell = self._rcell
        child = cell.actor_of(cell.routee_props)
        cell.watch(child)
        cell.router.add_routee(ActorRefRoutee(child))

    def receive(self, message: Any):
        cell = self._rcell
        if isinstance(message, GetRoutees):
            self.sender.tell(Routees(tuple(cell.router.routees)), self.self_ref)
        elif isinstance(message, AddRoutee):
            cell.router.add_routee(message.routee)
        elif isinstance(message, RemoveRoutee):
            cell.router.remove_routee(message.routee)
            ref = getattr(message.routee, "ref", None)
            if ref is not None:
                self.context.unwatch(ref)
                ref.tell(PoisonPill)
        elif isinstance(message, AdjustPoolSize):
            if message.change > 0:
                for _ in range(message.change):
                    self._spawn_routee()
            else:
                for _ in range(-message.change):
                    if cell.router.routees:
                        r = cell.router.routees[-1]
                        cell.router.remove_routee(r)
                        ref = getattr(r, "ref", None)
                        if ref is not None:
                            ref.tell(PoisonPill)
        elif isinstance(message, Terminated):
            cell.router.routees = [
                r for r in cell.router.routees
                if getattr(r, "ref", None) != message.actor]
            if not self.router_config.is_group and not cell.is_terminating:
                # pool keeps its size (reference: RouterPoolActor supervision)
                if len(cell.router.routees) < self.router_config.nr_of_instances:
                    self._spawn_routee()
        else:
            return NotImplemented
        return None

    def maybe_resize(self) -> None:
        resizer = self.router_config.resizer
        if resizer is None:
            return
        self._message_counter += 1
        if resizer.is_time_for_resize(self._message_counter):
            change = resizer.resize(self._rcell.router.routees)
            if change:
                self.self_ref.tell(AdjustPoolSize(change))


class RoutedActorCell(ActorCell):
    def __init__(self, system, self_ref, props: Props, dispatcher_id, parent):
        # the cell's own actor is the RouterActor; routees use the user props
        from dataclasses import replace
        router_config = props.router_config
        self.routee_props = replace(props, router_config=None, deploy=None,
                                    device=None)
        # cluster-aware configs supply their own router actor (cluster/
        # routing.py; reference: ClusterRouterActor in cluster/routing/)
        actor_cls = getattr(router_config, "router_actor_class", RouterActor)
        router_actor_props = Props.create(actor_cls, router_config)
        super().__init__(system, self_ref, router_actor_props, dispatcher_id, parent)
        self.router: Router = router_config.create_router(system)
        self.router_config = router_config

    def init(self, send_supervise: bool, mailbox_type) -> None:
        super().init(send_supervise, mailbox_type)
        # populate routees synchronously before any message can be routed
        cfg = self.router_config
        if cfg.is_group:
            from .router import ActorSelectionRoutee
            for path in cfg.paths:
                self.router.add_routee(ActorSelectionRoutee(path, self.system))
        else:
            for _ in range(max(cfg.nr_of_instances, 0)):
                child = self.actor_of(self.routee_props)
                self.router.add_routee(ActorRefRoutee(child))

    def send_message(self, envelope: Envelope) -> None:
        """Route on the caller's thread, bypassing our mailbox
        (reference: RoutedActorCell.sendMessage :137-141)."""
        msg = envelope.message
        from ..actor.messages import AutoReceivedMessage
        if isinstance(msg, (RouterManagementMessage, AutoReceivedMessage)):
            super().send_message(envelope)
            return
        if isinstance(self.actor, RouterActor):
            self.actor.maybe_resize()
        self.router.route(msg, envelope.sender)


class RoutedActorRef(LocalActorRef):
    def __init__(self, system, props, dispatcher_id, parent, path):
        from ..actor.ref import InternalActorRef  # noqa: F401
        self.path = path
        self._system = system
        self.cell = RoutedActorCell(system, self, props, dispatcher_id, parent)
