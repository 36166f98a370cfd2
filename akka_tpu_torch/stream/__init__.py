"""Streams: backpressured processing pipelines.

Host path (ROADMAP A12.5, the core): the push/pull GraphInterpreter
port-state machine hosted in one actor per materialized graph, with the
Source/Flow/Sink DSL, the operator library (ops, ops2-ops4, sub-streams,
restart, kill switches) and the stream probes of `stream.testkit`; copies
of the reference package's host code. Device path: `DevicePipeline`, a
chain of per-chunk tensor ops run as one CUDA-graph replay per chunk on a
card, which `as_flow()` puts into a host stream. Hubs, framing, retry,
stream refs and the context flows are the rest of A12.5 and not ported
yet.
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
from .device import DevicePipeline  # noqa: F401
from .attributes import Attributes, Supervision  # noqa: F401
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
    "DevicePipeline",
    "Attributes", "Supervision",
    "RestartSource", "RestartFlow", "RestartSink", "RestartSettings",
]
