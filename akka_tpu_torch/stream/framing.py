"""Framing: delimiter- and length-field-based byte-stream framing.

A copy of `akka_tpu/stream/framing.py` at commit 43876c4 (host code, no
jax; the port keeps its own copy of every module it needs).

Reference parity: akka-stream scaladsl/Framing.scala — `delimiter`
(split on a byte marker, enforce max frame length), `lengthField`
(binary length-prefixed frames), and `simpleFramingProtocol` (the
encoder/decoder pair for symmetric length-prefixed wire protocols, as
used over TCP). Stages operate on bytes CHUNKS with arbitrary
boundaries — reassembly is the whole point.
"""

from __future__ import annotations

import struct
from typing import List

from .ops import _LinearStage, make_in_handler, make_out_handler


class FramingException(RuntimeError):
    pass


class DelimiterFraming(_LinearStage):
    def __init__(self, delimiter: bytes, maximum_frame_length: int = 1 << 20,
                 allow_truncation: bool = False):
        super().__init__("DelimiterFraming")
        if not delimiter:
            raise ValueError("empty delimiter")
        self.delimiter = bytes(delimiter)
        self.max_len = maximum_frame_length
        self.allow_truncation = allow_truncation

    def create_logic(self):
        logic, in_, out = self._logic(), self.in_, self.out
        stage = self
        buf = bytearray()
        pending: List[bytes] = []

        def split() -> None:
            while True:
                i = buf.find(stage.delimiter)
                if i < 0:
                    if len(buf) > stage.max_len:
                        raise FramingException(
                            f"frame exceeds {stage.max_len} bytes without "
                            f"delimiter")
                    return
                if i > stage.max_len:
                    raise FramingException(
                        f"frame of {i} bytes exceeds {stage.max_len}")
                pending.append(bytes(buf[:i]))
                del buf[:i + len(stage.delimiter)]

        def on_push():
            buf.extend(logic.grab(in_))
            try:
                split()
            except FramingException as e:
                logic.fail_stage(e)
                return
            if pending:
                logic.push(out, pending.pop(0))
            else:
                logic.pull(in_)

        def on_finish():
            if buf:
                if not stage.allow_truncation:
                    logic.fail_stage(FramingException(
                        "stream finished with truncated frame"))
                    return
                pending.append(bytes(buf))
                buf.clear()
            if pending:
                logic.emit_multiple(out, list(pending))
                pending.clear()
            logic.complete_stage()

        def on_pull():
            if pending:
                logic.push(out, pending.pop(0))
            else:
                logic.pull(in_)

        logic.set_handler(in_, make_in_handler(on_push, on_finish))
        logic.set_handler(out, make_out_handler(on_pull))
        return logic


class LengthFieldFraming(_LinearStage):
    """Frames = [length field][payload]; emits payload-only frames unless
    include_header. Big-endian unsigned length of field_length bytes."""

    def __init__(self, field_length: int, maximum_frame_length: int = 1 << 20,
                 field_offset: int = 0, include_header: bool = False):
        super().__init__("LengthFieldFraming")
        if field_length not in (1, 2, 4, 8):
            raise ValueError("field_length must be 1, 2, 4 or 8")
        self.field_length = field_length
        self.field_offset = field_offset
        self.max_len = maximum_frame_length
        self.include_header = include_header

    def _decode_len(self, data: bytes) -> int:
        return int.from_bytes(data, "big")

    def create_logic(self):
        logic, in_, out = self._logic(), self.in_, self.out
        stage = self
        buf = bytearray()
        pending: List[bytes] = []
        head = stage.field_offset + stage.field_length

        def split() -> None:
            while len(buf) >= head:
                n = stage._decode_len(
                    bytes(buf[stage.field_offset:head]))
                if n > stage.max_len:
                    raise FramingException(
                        f"frame of {n} bytes exceeds {stage.max_len}")
                total = head + n
                if len(buf) < total:
                    return
                frame = bytes(buf[:total]) if stage.include_header \
                    else bytes(buf[head:total])
                pending.append(frame)
                del buf[:total]

        def on_push():
            buf.extend(logic.grab(in_))
            try:
                split()
            except FramingException as e:
                logic.fail_stage(e)
                return
            if pending:
                logic.push(out, pending.pop(0))
            else:
                logic.pull(in_)

        def on_finish():
            if buf:
                logic.fail_stage(FramingException(
                    "stream finished with truncated frame"))
                return
            if pending:
                logic.emit_multiple(out, list(pending))
                pending.clear()
            logic.complete_stage()

        def on_pull():
            if pending:
                logic.push(out, pending.pop(0))
            else:
                logic.pull(in_)

        logic.set_handler(in_, make_in_handler(on_push, on_finish))
        logic.set_handler(out, make_out_handler(on_pull))
        return logic


class JsonObjectFraming(_LinearStage):
    """Bracket-counting JSON object scanner (reference: scaladsl/
    JsonFraming.scala:17 objectScanner + impl/JsonObjectParser.scala):
    emits one complete top-level `{...}` object per element from a chunked
    byte stream, skipping whitespace, commas and the enclosing brackets of
    an outer array, so both newline/comma-separated object streams and
    `[{...},{...}]` documents frame identically. String literals (with
    escapes) are opaque to the brace counter."""

    _SKIP = frozenset(b" \t\r\n,[]")

    def __init__(self, maximum_object_length: int = 1 << 20):
        super().__init__("JsonObjectFraming")
        self.max_len = maximum_object_length

    def create_logic(self):  # noqa: C901
        logic, in_, out = self._logic(), self.in_, self.out
        stage = self
        buf = bytearray()
        pending: List[bytes] = []
        # scan state survives chunk boundaries: pos = next unscanned byte,
        # start = object start (-1 outside an object)
        st = {"pos": 0, "start": -1, "depth": 0, "in_str": False,
              "esc": False}

        def scan() -> None:
            while st["pos"] < len(buf):
                b = buf[st["pos"]]
                if st["depth"] == 0:
                    if b == 0x7B:  # {
                        st["start"] = st["pos"]
                        st["depth"] = 1
                    elif b not in stage._SKIP:
                        raise FramingException(
                            f"invalid JSON input: unexpected byte "
                            f"0x{b:02x} outside an object")
                elif st["esc"]:
                    st["esc"] = False
                elif st["in_str"]:
                    if b == 0x5C:  # backslash
                        st["esc"] = True
                    elif b == 0x22:  # "
                        st["in_str"] = False
                elif b == 0x22:
                    st["in_str"] = True
                elif b == 0x7B:
                    st["depth"] += 1
                elif b == 0x7D:  # }
                    st["depth"] -= 1
                    if st["depth"] == 0:
                        if st["pos"] - st["start"] + 1 > stage.max_len:
                            raise FramingException(
                                f"JSON object exceeds {stage.max_len} bytes")
                        pending.append(bytes(buf[st["start"]:st["pos"] + 1]))
                        del buf[:st["pos"] + 1]
                        st["pos"] = -1
                        st["start"] = -1
                # in-progress length check: pos - start + 1 bytes consumed
                # by the open object so far (same formula as at emit, so an
                # exactly-max_len object passes and max_len+1 fails)
                if st["depth"] > 0 and \
                        st["pos"] - st["start"] + 1 > stage.max_len:
                    raise FramingException(
                        f"JSON object exceeds {stage.max_len} bytes")
                st["pos"] += 1
            # trim consumed bytes so memory stays bounded by max_len even
            # when the input is mostly separators/whitespace (outside an
            # object everything scanned is droppable; inside, everything
            # before the object start is)
            if st["start"] < 0:
                del buf[:st["pos"]]
                st["pos"] = 0
            elif st["start"] > 0:
                del buf[:st["start"]]
                st["pos"] -= st["start"]
                st["start"] = 0

        def on_push():
            buf.extend(logic.grab(in_))
            try:
                scan()
            except FramingException as e:
                logic.fail_stage(e)
                return
            if pending:
                logic.push(out, pending.pop(0))
            else:
                logic.pull(in_)

        def on_finish():
            if st["depth"] > 0:
                logic.fail_stage(FramingException(
                    "stream finished with truncated JSON object"))
                return
            if pending:
                logic.emit_multiple(out, list(pending))
                pending.clear()
            logic.complete_stage()

        def on_pull():
            if pending:
                logic.push(out, pending.pop(0))
            else:
                logic.pull(in_)

        logic.set_handler(in_, make_in_handler(on_push, on_finish))
        logic.set_handler(out, make_out_handler(on_pull))
        return logic


class JsonFraming:
    """Factory namespace (scaladsl/JsonFraming.scala)."""

    @staticmethod
    def object_scanner(maximum_object_length: int = 1 << 20):
        from .dsl import Flow
        return Flow().via_stage(lambda: JsonObjectFraming(
            maximum_object_length))


class Framing:
    """Factory namespace (scaladsl/Framing.scala)."""

    @staticmethod
    def delimiter(delimiter: bytes, maximum_frame_length: int = 1 << 20,
                  allow_truncation: bool = False):
        from .dsl import Flow
        return Flow().via_stage(lambda: DelimiterFraming(
            delimiter, maximum_frame_length, allow_truncation))

    @staticmethod
    def length_field(field_length: int, maximum_frame_length: int = 1 << 20,
                     field_offset: int = 0, include_header: bool = False):
        from .dsl import Flow
        return Flow().via_stage(lambda: LengthFieldFraming(
            field_length, maximum_frame_length, field_offset, include_header))

    @staticmethod
    def simple_framing_protocol_encoder(maximum_frame_length: int = 1 << 20):
        """bytes frame -> [u32 length][frame] (the symmetric encoder of
        simpleFramingProtocol)."""
        from .dsl import Flow

        def encode(frame: bytes) -> bytes:
            if len(frame) > maximum_frame_length:
                raise FramingException(
                    f"frame of {len(frame)} exceeds {maximum_frame_length}")
            return struct.pack(">I", len(frame)) + frame

        return Flow().map(encode)

    @staticmethod
    def simple_framing_protocol_decoder(maximum_frame_length: int = 1 << 20):
        return Framing.length_field(4, maximum_frame_length)
