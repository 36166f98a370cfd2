"""The batched device runtime: behaviors, supervision, the step core and
BatchedSystem (port of akka_tpu/batched, single device). The reference's
exports of items still to port (the bridge's runtime handle and device
refs, ROADMAP A6; the autoscaler, A10) join with them."""

from .behavior import BatchedBehavior, Ctx, Emit, Inbox, Mailbox, behavior
from .bridge import reply_dst
from .core import BatchedSystem
from .step import StepCore
from .supervision import (ATT_WORDS, COUNTER_NAMES, SUP_COLUMNS, Directive,
                          LaneSupervisor, decode_attention)

__all__ = ["ATT_WORDS", "BatchedBehavior", "BatchedSystem", "COUNTER_NAMES",
           "Ctx", "Directive", "Emit", "Inbox", "LaneSupervisor", "Mailbox",
           "SUP_COLUMNS", "StepCore", "behavior", "decode_attention",
           "reply_dst"]
