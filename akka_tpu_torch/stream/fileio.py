"""File + compression stages.

A copy of `akka_tpu/stream/fileio.py` at commit 43876c4 (host code, no
jax; the port keeps its own copy of every module it needs).

Reference parity: akka-stream impl/io/FileSource/FileSink
(scaladsl/FileIO.scala — chunked file reads, appending/overwriting byte
sinks with an IOResult count) and scaladsl/Compression.scala
(gzip/gunzip/deflate/inflate flows). Host-side IO is the slow path here as
in the reference; the stages run inside the stream's interpreter actor."""

from __future__ import annotations

import os
import zlib
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Optional

from .ops import _LinearStage, _SinkStage, _SourceStage, make_in_handler, \
    make_out_handler
from .stage import GraphStageLogic


@dataclass
class IOResult:
    """(reference: stream/IOResult.scala)"""

    count: int
    error: Optional[BaseException] = None

    @property
    def was_successful(self) -> bool:
        return self.error is None


class FileSource(_SourceStage):
    def __init__(self, path: str, chunk_size: int = 8192):
        super().__init__("FileSource")
        self.path = path
        self.chunk_size = chunk_size

    def create_logic_and_mat(self):
        stage = self
        mat: Future = Future()
        logic = GraphStageLogic(self._shape)
        state = {"fh": None, "count": 0}

        def on_pull():
            if state["fh"] is None:
                try:
                    state["fh"] = open(stage.path, "rb")
                except OSError as e:
                    mat.set_result(IOResult(0, e))
                    logic.fail_stage(e)
                    return
            chunk = state["fh"].read(stage.chunk_size)
            if chunk:
                state["count"] += len(chunk)
                logic.push(stage.out, chunk)
            else:
                state["fh"].close()
                mat.set_result(IOResult(state["count"]))
                logic.complete(stage.out)

        def on_downstream_finish(cause=None):
            # cancellation mid-file still closes the handle and resolves
            # the IOResult with what was read (no fd leak, no hung mat)
            if state["fh"] is not None:
                try:
                    state["fh"].close()
                except OSError:
                    pass
            if not mat.done():
                mat.set_result(IOResult(state["count"]))
            logic.cancel_stage(cause)

        logic.set_handler(stage.out, make_out_handler(on_pull,
                                                      on_downstream_finish))
        return logic, mat


class FileSink(_SinkStage):
    def __init__(self, path: str, append: bool = False):
        super().__init__("FileSink")
        self.path = path
        self.append = append

    def create_logic_and_mat(self):
        from .ops import _sink_logic
        stage = self
        fut: Future = Future()
        state = {"fh": None, "count": 0}

        def write(data) -> None:
            if state["fh"] is None:
                state["fh"] = open(stage.path,
                                   "ab" if stage.append else "wb")
            state["fh"].write(data)
            state["count"] += len(data)

        def result() -> IOResult:
            if state["fh"] is None:  # empty stream still creates the file
                write(b"")
            state["fh"].close()
            return IOResult(state["count"])

        def cleanup() -> None:
            # upstream failed / write raised: flush + close what we have so
            # the fd never leaks and the tail bytes reach disk
            if state["fh"] is not None:
                state["fh"].close()
                state["fh"] = None

        return _sink_logic(stage, write, fut, result_fn=result,
                           cleanup_fn=cleanup), fut


class FileIO:
    """Factory namespace (scaladsl/FileIO.scala)."""

    @staticmethod
    def from_path(path: str, chunk_size: int = 8192):
        from .dsl import Source
        return Source.from_graph(lambda: FileSource(path, chunk_size))

    @staticmethod
    def to_path(path: str, append: bool = False):
        from .dsl import Sink
        return Sink.from_graph(lambda: FileSink(path, append))


class _Deflate(_LinearStage):
    def __init__(self, gzip: bool, level: int = 6):
        super().__init__("Gzip" if gzip else "Deflate")
        self.gzip = gzip
        self.level = level

    def create_logic(self):
        logic, in_, out = self._logic(), self.in_, self.out
        wbits = 16 + zlib.MAX_WBITS if self.gzip else zlib.MAX_WBITS
        comp = zlib.compressobj(self.level, zlib.DEFLATED, wbits)

        def on_push():
            data = comp.compress(logic.grab(in_))
            if data:
                logic.push(out, data)
            else:
                logic.pull(in_)

        def on_finish():
            tail = comp.flush()
            if tail:
                logic.emit(out, tail)
            logic.complete_stage()

        logic.set_handler(in_, make_in_handler(on_push, on_finish))
        logic.set_handler(out, make_out_handler(lambda: logic.pull(in_)))
        return logic


class _Inflate(_LinearStage):
    def __init__(self, gzip: bool):
        super().__init__("Gunzip" if gzip else "Inflate")
        self.gzip = gzip

    def create_logic(self):
        logic, in_, out = self._logic(), self.in_, self.out
        wbits = 16 + zlib.MAX_WBITS if self.gzip else zlib.MAX_WBITS
        decomp = zlib.decompressobj(wbits)

        def on_push():
            try:
                data = decomp.decompress(logic.grab(in_))
            except zlib.error as e:
                logic.fail_stage(e)
                return
            if data:
                logic.push(out, data)
            else:
                logic.pull(in_)

        def on_finish():
            try:
                tail = decomp.flush()
            except zlib.error as e:
                logic.fail_stage(e)
                return
            if tail:
                logic.emit(out, tail)
            logic.complete_stage()

        logic.set_handler(in_, make_in_handler(on_push, on_finish))
        logic.set_handler(out, make_out_handler(lambda: logic.pull(in_)))
        return logic


class Compression:
    """(reference: scaladsl/Compression.scala)"""

    @staticmethod
    def gzip(level: int = 6):
        from .dsl import Flow
        return Flow().via_stage(lambda: _Deflate(True, level))

    @staticmethod
    def gunzip():
        from .dsl import Flow
        return Flow().via_stage(lambda: _Inflate(True))

    @staticmethod
    def deflate(level: int = 6):
        from .dsl import Flow
        return Flow().via_stage(lambda: _Deflate(False, level))

    @staticmethod
    def inflate():
        from .dsl import Flow
        return Flow().via_stage(lambda: _Inflate(False))
