"""The batched device runtime: behaviors, supervision, the step core and
BatchedSystem (port of akka_tpu/batched, single device)."""

from .behavior import BatchedBehavior, Ctx, Emit, Inbox, Mailbox, behavior
from .core import BatchedSystem
from .supervision import Directive, LaneSupervisor

__all__ = ["BatchedBehavior", "BatchedSystem", "Ctx", "Directive", "Emit",
           "Inbox", "LaneSupervisor", "Mailbox", "behavior"]
