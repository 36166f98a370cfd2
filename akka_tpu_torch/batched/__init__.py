"""The batched device runtime: behaviors, supervision, the step core,
BatchedSystem and the bridge that puts device actors behind ActorRefs
(port of akka_tpu/batched, single device). The reference's exports of
items still to port (the autoscaler, ROADMAP A10) join with them."""

from .behavior import BatchedBehavior, Ctx, Emit, Inbox, Mailbox, behavior
from .bridge import (BatchedRuntimeHandle, DefaultCodec, DeviceActorRef,
                     DeviceBlockRef, MessageCodec, device_props, get_handle,
                     reply_dst)
from .core import BatchedSystem
from .step import StepCore
from .supervision import (ATT_WORDS, COUNTER_NAMES, SUP_COLUMNS, Directive,
                          LaneSupervisor, decode_attention)

__all__ = ["ATT_WORDS", "BatchedBehavior", "BatchedRuntimeHandle",
           "BatchedSystem", "COUNTER_NAMES", "Ctx", "DefaultCodec",
           "DeviceActorRef", "DeviceBlockRef", "Directive", "Emit", "Inbox",
           "LaneSupervisor", "Mailbox", "MessageCodec", "SUP_COLUMNS",
           "StepCore", "behavior", "decode_attention", "device_props",
           "get_handle", "reply_dst"]
