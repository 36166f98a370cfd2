"""The batched device runtime: behaviors, supervision, the step core,
BatchedSystem, the bridge that puts device actors behind ActorRefs, and
the failover sentinel and elastic-mesh autoscaler over shard slots of one
card (port of akka_tpu/batched)."""

from .autoscale import (AutoscaleDecision, AutoscalePolicy, MeshAutoscaler,
                        autoscaler_from_config)
from .behavior import BatchedBehavior, Ctx, Emit, Inbox, Mailbox, behavior
from .bridge import (BatchedRuntimeHandle, DefaultCodec, DeviceActorRef,
                     DeviceBlockRef, MessageCodec, device_props, get_handle,
                     reply_dst)
from .core import BatchedSystem
from .sentinel import MeshSentinel, SentinelHalted
from .step import StepCore
from .supervision import (ATT_WORDS, COUNTER_NAMES, SUP_COLUMNS, Directive,
                          LaneSupervisor, decode_attention)

__all__ = ["ATT_WORDS", "AutoscaleDecision", "AutoscalePolicy",
           "BatchedBehavior", "BatchedRuntimeHandle", "BatchedSystem",
           "COUNTER_NAMES", "Ctx", "DefaultCodec", "DeviceActorRef",
           "DeviceBlockRef", "Directive", "Emit", "Inbox", "LaneSupervisor",
           "Mailbox", "MeshAutoscaler", "MeshSentinel", "MessageCodec",
           "SUP_COLUMNS", "SentinelHalted", "StepCore", "autoscaler_from_config",
           "behavior", "decode_attention", "device_props", "get_handle",
           "reply_dst"]
