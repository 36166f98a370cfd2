"""Streams: backpressured processing pipelines.

Host path: the push/pull GraphInterpreter port-state machine hosted in
one actor per materialized graph, with the Source/Flow/Sink DSL, the
operator library (ops, ops2-ops4, sub-streams, restart, kill switches),
the hubs, framing, retry, the context flows, stream refs, TCP and file
stages, the typed adapters, the compliance harness (`stream.tck`) and the
stream probes of `stream.testkit`; copies of the reference package's host
code. Device path: `DevicePipeline`, a chain of per-chunk tensor ops run
as one CUDA-graph replay per chunk on a card, which `as_flow()` puts into
a host stream.
"""

from .stage import (FanInShape, FanOutShape, FlowShape, GraphStage,  # noqa: F401
                    GraphStageLogic, InHandler, Inlet, OutHandler, Outlet,
                    Shape, SinkShape, SourceShape, make_in_handler,
                    make_out_handler)
from .interpreter import (ActorGraphInterpreter, Connection,  # noqa: F401
                          GraphInterpreter, IllegalStateException)
from .dsl import (BidiFlow, Flow, GraphDSL, Keep, Materializer,  # noqa: F401
                  RunnableGraph, Sink, Source)
from .ops import (BufferOverflowException, NoSuchElementException,  # noqa: F401
                  SinkQueue, SourceQueue, TickCancellable)
from .killswitch import (KillSwitches, SharedKillSwitch,  # noqa: F401
                         UniqueKillSwitch)
from .hub import BroadcastHub, ConsumerInfo, MergeHub, PartitionHub  # noqa: F401
from .framing import Framing, FramingException, JsonFraming  # noqa: F401
from .retry import RetryFlow  # noqa: F401
from .device import DevicePipeline  # noqa: F401
from .streamref import SinkRef, SourceRef, StreamRefs  # noqa: F401
from .attributes import Attributes, Supervision  # noqa: F401
from .context import FlowWithContext, SourceWithContext  # noqa: F401
from .restart import (RestartFlow, RestartSettings, RestartSink,  # noqa: F401
                      RestartSource)
from .ops import _QUEUE_END as QUEUE_END  # noqa: F401

__all__ = [
    "Source", "Flow", "Sink", "Keep", "RunnableGraph", "Materializer",
    "BidiFlow", "GraphDSL",
    "GraphStage", "GraphStageLogic", "InHandler", "OutHandler",
    "Inlet", "Outlet", "Shape", "SourceShape", "SinkShape", "FlowShape",
    "FanInShape", "FanOutShape", "make_in_handler", "make_out_handler",
    "GraphInterpreter", "ActorGraphInterpreter", "Connection",
    "IllegalStateException",
    "SourceQueue", "SinkQueue", "QUEUE_END", "TickCancellable",
    "NoSuchElementException", "BufferOverflowException",
    "KillSwitches", "UniqueKillSwitch", "SharedKillSwitch",
    "MergeHub", "BroadcastHub", "PartitionHub", "ConsumerInfo",
    "DevicePipeline", "Framing", "FramingException", "JsonFraming",
    "RetryFlow",
    "StreamRefs", "SourceRef", "SinkRef",
    "Attributes", "Supervision",
    "RestartSource", "RestartFlow", "RestartSink", "RestartSettings",
    "SourceWithContext", "FlowWithContext",
]
