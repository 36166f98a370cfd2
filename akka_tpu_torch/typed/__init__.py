"""Typed actor API (reference: akka-actor-typed).

A copy of `akka_tpu/typed/__init__.py` at commit 1001e26 (host code, no jax;
the port keeps its own copy of every module it needs).

Usage:
    from akka_tpu_torch.typed import ActorSystem, Behaviors

    def counter(count=0):
        def on_message(ctx, msg):
            if msg == "inc":
                return counter(count + 1)
            ...
        return Behaviors.receive(on_message)

    system = ActorSystem.create(counter(), "counter")
"""

from .behavior import (Behavior, Signal, PreRestart, PostStop, Terminated,  # noqa: F401
                       ChildFailed)
from .behaviors import (Behaviors, SupervisorStrategy, TimerScheduler,  # noqa: F401
                        StashBuffer, StashException)
from .adapter import TypedActorContext, props_from_behavior  # noqa: F401
from .actor_system import ActorSystem  # noqa: F401
from .receptionist import (Deregister, Deregistered, Find, Listing,  # noqa: F401
                           Receptionist, Register, Registered, ServiceKey,
                           Subscribe)
from . import delivery  # noqa: F401
from .pubsub import Publish, Topic, TopicSubscribe, TopicUnsubscribe  # noqa: F401
from .routers import Routers  # noqa: F401
