"""Streams. The port has the device pipelines so far (`DevicePipeline`:
a chain of per-chunk tensor ops over chunked tensors). The host stream
DSL of the reference package (stages, interpreter, Source/Flow/Sink and
the operator library) is not ported yet (ROADMAP A12.5)."""

from .device import DevicePipeline  # noqa: F401

__all__ = ["DevicePipeline"]
