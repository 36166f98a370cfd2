"""akka_tpu_torch: the PyTorch/CUDA port of akka_tpu.

A second package beside `akka_tpu` (the JAX reference). It mirrors the
reference's module layout (`akka_tpu/batched/step.py` <->
`akka_tpu_torch/batched/step.py`) and public surface, and imports `torch`
only: never `jax`, and nothing of `akka_tpu`. What it needs from the
reference it keeps as its own copy.

Host actors run as in the reference (`ActorSystem`, `Actor`, `Props`,
`ask_sync`); `system.actor_of(batched.device_props(b))` puts device
actors, rows of a BatchedSystem, behind ordinary ActorRefs
(`batched/bridge.py`). Entry points take `device=` (the dispatcher: its
`device` key) and default to CUDA; without a card they raise unless the
caller asks for the CPU (`akka_tpu_torch.utils.device`). The ring mailbox,
the reference's one Pallas kernel, is a hand-written CUDA kernel here
(`akka_tpu_torch/csrc/ring_mailbox.cu`, bound in `ops/cuda_mailbox.py`).
"""

__version__ = "0.1.0"

from .config import Config, reference_config
from .actor.system import ActorSystem, ExtensionId, CoordinatedShutdown
from .actor.actor import Actor, Stash, FunctionActor
from .actor.props import Props
from .actor.deploy import Deploy, LocalScope, RemoteScope
from .actor.ref import ActorRef, Nobody
from .actor.path import ActorPath, Address
from .actor.messages import (
    PoisonPill, Kill, ReceiveTimeout, Terminated, Identify, ActorIdentity,
    DeadLetter, Status, UnhandledMessage)
from .actor.supervision import (
    OneForOneStrategy, AllForOneStrategy, Resume, Restart, Stop, Escalate,
    default_strategy, stopping_strategy)
from .pattern.ask import ask, ask_sync, pipe, AskTimeoutException
from .batched import (BatchedBehavior, BatchedSystem, Ctx, Emit, Inbox,
                      Mailbox, behavior)

__all__ = [
    "Config", "reference_config", "ActorSystem", "ExtensionId",
    "CoordinatedShutdown", "Actor", "Stash", "FunctionActor", "Props",
    "Deploy", "LocalScope", "RemoteScope", "ActorRef", "Nobody", "ActorPath",
    "Address", "PoisonPill", "Kill", "ReceiveTimeout", "Terminated",
    "Identify", "ActorIdentity", "DeadLetter", "Status", "UnhandledMessage",
    "OneForOneStrategy", "AllForOneStrategy", "Resume", "Restart", "Stop",
    "Escalate", "default_strategy", "stopping_strategy", "ask", "ask_sync",
    "pipe", "AskTimeoutException", "BatchedBehavior", "BatchedSystem", "Ctx",
    "Emit", "Inbox", "Mailbox", "behavior"]
