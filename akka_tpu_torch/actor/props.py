"""Props: immutable recipe for creating an actor.

A copy of `akka_tpu/actor/props.py` at commit 5d9b7cd (host code, no jax;
the port keeps its own copy of every module it needs).

Reference parity: akka-actor/src/main/scala/akka/actor/Props.scala — class +
constructor args + deploy info (dispatcher/mailbox/router/scope selection,
reference: actor/Deployer.scala, actor/Deploy.scala). `Props.create` keeps the
(cls, args, kwargs) triple so a Props can travel to another node for remote
deployment (remote/RemoteDeployer.scala; DaemonMsgCreate carries the recipe,
not a closure).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Callable, Optional, Tuple


@dataclass(frozen=True)
class Props:
    factory: Callable[[], Any]                 # () -> Actor
    cls: Optional[type] = None
    args: Tuple[Any, ...] = ()                 # ctor args (wire-able recipe)
    kwargs: Tuple[Tuple[str, Any], ...] = ()   # ctor kwargs as sorted items
    dispatcher: Optional[str] = None           # dispatcher config id
    mailbox: Optional[Any] = None              # mailbox name or MailboxType
    router_config: Optional[Any] = None        # RouterConfig (akka_tpu_torch.routing)
    deploy: Optional[Any] = None               # Deploy (akka_tpu_torch.actor.deploy)
    device: Optional[Any] = None               # DeviceSpec: rows in the
                                               # tpu-batched runtime instead
                                               # of a host cell (bridge.py)
    recipe: bool = False                       # built via Props.create, so
                                               # (cls, args, kwargs) is complete

    @staticmethod
    def create(cls: type, *args, **kwargs) -> "Props":
        return Props(factory=lambda: cls(*args, **kwargs), cls=cls,
                     args=tuple(args), kwargs=tuple(sorted(kwargs.items())),
                     recipe=True)

    @staticmethod
    def from_factory(factory: Callable[[], Any], cls: Optional[type] = None) -> "Props":
        return Props(factory=factory, cls=cls)

    @staticmethod
    def from_receive(receive: Callable[[Any, Any], None]) -> "Props":
        """Props from a plain function receive(context, message)."""
        from .actor import FunctionActor
        return Props(factory=lambda: FunctionActor(receive), cls=FunctionActor)

    def with_dispatcher(self, dispatcher_id: str) -> "Props":
        return replace(self, dispatcher=dispatcher_id)

    def with_mailbox(self, mailbox: Any) -> "Props":
        return replace(self, mailbox=mailbox)

    def with_router(self, router_config: Any) -> "Props":
        return replace(self, router_config=router_config)

    def with_deploy(self, deploy: Any) -> "Props":
        """Attach a Deploy (e.g. Deploy(scope=RemoteScope(addr)))."""
        return replace(self, deploy=deploy)

    def new_actor(self) -> Any:
        return self.factory()

    def actor_class(self) -> Optional[type]:
        return self.cls

    @property
    def has_recipe(self) -> bool:
        """True when (cls, args, kwargs) fully describes construction — the
        precondition for shipping this Props to another node."""
        return self.recipe and self.cls is not None
