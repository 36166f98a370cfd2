"""Wire-speed binary gateway frames: fixed-schema records, batch decode.

A copy of `akka_tpu/serialization/frames.py` (numpy only).

The gateway's JSON protocol (gateway/ingress.py) pays a Python
dict-construction round per request — `json.loads`, per-key coercion,
a dict built and torn down before anything touches the staging slab.
This module is the Artery/Aeron move applied to our front door: a
versioned fixed-schema binary layout whose payload is a packed array of
identical records, so a whole window of requests decodes in ONE
`np.frombuffer` into columns (id, op, tenant, entity, value) and a whole
wave of replies encodes in one structured-array assignment. Zero
per-request Python objects on either pass.

Frame body layout (the u32-BE length prefix is the transport's — the
same `simpleFramingProtocol` framing JSON rides, so both encodings
coexist on one connection, sniffed by the first body byte):

    offset  size  field
    0       1     magic     0xAB  (never a JSON first byte: '{' = 0x7B)
    1       1     version   1
    2       1     kind      0 = request batch, 1 = reply batch
    3       1     reserved  0
    4       4     count     u32 BE, number of records
    8       n*R   records   `count` packed records (R = record size)

Request record (57 bytes, big-endian numerics — the codec.py wire
convention):

    id i64 | op u8 (0=get, 1=add) | tenant S16 | entity S24 | value f64

Reply record (53 bytes):

    id i64 | status u8 (0=ok, 1=shed, 2=error) | reason S32
    | value f64 | retry_after_ms u32

Traced reply record (version 2, 61 bytes): the same fields
plus a trailing `trace u64`, the causal trace id minted at ingress, so a
client-reported failure is greppable in the span JSONL. Version 2 is
emitted ONLY when some record in the wave actually carries a nonzero
trace id (tracing enabled AND the request sampled) — an untraced wave's
bytes are bit-identical to version 1, and version-1 decoders never see a
frame they cannot parse unless tracing was deliberately turned on.
Request frames stay version 1.

Replica reply record (version 3, 65 bytes): version 2's
fields plus a trailing `step_lag i32` — ≥ 0 marks a replica-served read
(the value is its bounded staleness in device steps on the shared
ATT_STEP axis), −1 marks the authoritative wave path. Version 3 is
emitted ONLY when some record in the wave was actually replica-served,
mirroring the version-2 discipline: a gateway without a replica cache
(or a wave with no replica hits) never changes the wire.

Dedup reply record (version 4, 66 bytes): version 3's
fields plus a trailing `dedup u1` — 1 marks a reply served from the
journaled reply cache (a duplicate request id short-circuited before
the ask wave; the value/status are the FIRST attempt's, replayed
verbatim). Version 4 is emitted ONLY when some record in the wave was
actually dedup-served, same discipline as versions 2/3: a gateway
without a dedup table never changes the wire.

String fields are NUL-padded UTF-8; a reason longer than 32 bytes is
truncated (every typed gateway reason fits). A batch of one is the solo
ask — bit-identical semantics to its JSON twin, tested in
tests/test_gateway_binary.py. Admin ops stay JSON-only (the debuggable
channel; binary frames addressed to the admin tenant get a typed error).

Decoding is bounds-checked and type-safe by construction: records are
fixed-width scalars/bytes — there is no tag dispatch, no object graph,
nothing allowlisted to resolve (contrast the general object codec,
`serialization/codec.py`).
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Sequence

import numpy as np

# the length prefix (the general object codec's u32; the port keeps only
# this one primitive of it)
_U32 = struct.Struct(">I")

__all__ = ["MAGIC", "VERSION", "VERSION_TRACED", "VERSION_REPLICA",
           "VERSION_DEDUP",
           "KIND_REQUEST",
           "KIND_REPLY", "OP_GET", "OP_ADD", "OP_NAMES", "OP_CODES",
           "ST_OK", "ST_SHED", "ST_ERROR",
           "REQUEST_DTYPE", "REPLY_DTYPE", "REPLY_DTYPE_TRACED",
           "REPLY_DTYPE_REPLICA", "REPLY_DTYPE_DEDUP",
           "DEFAULT_MAX_FRAME",
           "FrameFormatError", "is_binary", "frame",
           "encode_request_batch", "decode_request_batch",
           "check_request_batch", "decode_request_batches",
           "encode_reply_batch", "decode_reply_batch", "reply_to_dict",
           "decode_replies"]

MAGIC = 0xAB
VERSION = 1
VERSION_TRACED = 2  # replies only: VERSION layout + trailing trace u64
VERSION_REPLICA = 3  # replies only: VERSION_TRACED layout + step_lag i32
VERSION_DEDUP = 4  # replies only: VERSION_REPLICA layout + dedup u1
KIND_REQUEST = 0
KIND_REPLY = 1

OP_GET = 0
OP_ADD = 1
OP_NAMES = {OP_GET: "get", OP_ADD: "add"}
OP_CODES = {"get": OP_GET, "add": OP_ADD}

ST_OK = 0
ST_SHED = 1
ST_ERROR = 2
_ST_NAMES = {ST_OK: "ok", ST_SHED: "shed", ST_ERROR: "error"}

# ONE frame-size limit for both ends of the wire (the
# client's reader and the server's framing stages used to disagree —
# 1<<20 vs 1<<16 — so a server-legal reply near the boundary could kill
# the client that asked for it).
DEFAULT_MAX_FRAME = 1 << 20

_HEADER = np.dtype([("magic", "u1"), ("version", "u1"), ("kind", "u1"),
                    ("reserved", "u1"), ("count", ">u4")])

TENANT_BYTES = 16
ENTITY_BYTES = 24
REASON_BYTES = 32

REQUEST_DTYPE = np.dtype([("id", ">i8"), ("op", "u1"),
                          ("tenant", f"S{TENANT_BYTES}"),
                          ("entity", f"S{ENTITY_BYTES}"),
                          ("value", ">f8")])

REPLY_DTYPE = np.dtype([("id", ">i8"), ("status", "u1"),
                        ("reason", f"S{REASON_BYTES}"),
                        ("value", ">f8"), ("retry_after_ms", ">u4")])

# version-2 reply record: version 1 + the causal trace id
REPLY_DTYPE_TRACED = np.dtype(REPLY_DTYPE.descr + [("trace", ">u8")])

# version-3 reply record: version 2 + the replica step-lag marker
# step_lag >= 0 <=> served from the read replica, that many
# device steps behind the authoritative state; -1 <=> wave path
REPLY_DTYPE_REPLICA = np.dtype(REPLY_DTYPE_TRACED.descr
                               + [("step_lag", ">i4")])

# version-4 reply record: version 3 + the reply-cache dedup marker
# dedup == 1 <=> this reply was replayed from the journaled
# reply cache (the request id was a duplicate; the effect applied once)
REPLY_DTYPE_DEDUP = np.dtype(REPLY_DTYPE_REPLICA.descr
                             + [("dedup", "u1")])


class FrameFormatError(ValueError):
    """Malformed binary frame. `code` is the short typed-reason slug the
    gateway surfaces as `bad_frame:<code>` — mirrors the JSON path's
    `bad_request:<ExcName>` discipline."""

    def __init__(self, code: str, detail: str = ""):
        super().__init__(f"{code}: {detail}" if detail else code)
        self.code = code


def is_binary(body: bytes) -> bool:
    """Frame sniffing: binary bodies start with MAGIC, JSON bodies with
    '{' (or whitespace) — the two encodings share a connection."""
    return len(body) >= 1 and body[0] == MAGIC


def frame(body: bytes) -> bytes:
    """Length-prefix a frame body (the shared server/client/binary
    encode helper — `simpleFramingProtocol`'s u32-BE convention)."""
    return _U32.pack(len(body)) + body


def _header(kind: int, count: int, version: int = VERSION) -> bytes:
    h = np.zeros((), _HEADER)
    h["magic"] = MAGIC
    h["version"] = version
    h["kind"] = kind
    h["count"] = count
    return h.tobytes()


def _encode_str_col(out: np.ndarray, field: str, values: Sequence[Any],
                    width: int, what: str) -> None:
    enc = [v if isinstance(v, bytes) else str(v).encode("utf-8")
           for v in values]
    for i, b in enumerate(enc):
        if len(b) > width:
            raise FrameFormatError(
                f"{what}_too_long", f"{b!r} exceeds {width} bytes")
    out[field] = enc


# ------------------------------------------------------------------ requests
def encode_request_batch(ids: Sequence[int], tenants: Sequence[Any],
                         entities: Sequence[Any], ops: Sequence[Any],
                         values: Sequence[float]) -> bytes:
    """Pack a request window into one binary frame body. `ops` accepts
    op names ("add"/"get") or raw codes; columns are assigned
    vectorized — no per-request dict ever exists."""
    n = len(ids)
    rec = np.zeros((n,), REQUEST_DTYPE)
    rec["id"] = np.asarray(ids, np.int64)
    rec["op"] = [OP_CODES[o] if isinstance(o, str) else int(o) for o in ops]
    _encode_str_col(rec, "tenant", tenants, TENANT_BYTES, "tenant")
    _encode_str_col(rec, "entity", entities, ENTITY_BYTES, "entity")
    rec["value"] = np.asarray(values, np.float64)
    return _header(KIND_REQUEST, n) + rec.tobytes()


def _check_records(body: bytes, kind: int, dtype: np.dtype,
                   max_frame: int, version: int = VERSION) -> int:
    """Validate one frame body's header/length; returns the record
    count. Split from the decode so a cross-connection window can
    validate EVERY body first and then reinterpret all record bytes in
    one pass (decode_request_batches)."""
    if len(body) > max_frame:
        raise FrameFormatError("oversize",
                               f"{len(body)} bytes exceeds {max_frame}")
    if len(body) < _HEADER.itemsize:
        raise FrameFormatError("truncated_header",
                               f"{len(body)} bytes < {_HEADER.itemsize}")
    h = np.frombuffer(body[:_HEADER.itemsize], _HEADER)[0]
    if int(h["magic"]) != MAGIC:
        raise FrameFormatError("bad_magic", hex(int(h["magic"])))
    if int(h["version"]) != version:
        raise FrameFormatError("unsupported_version", str(int(h["version"])))
    if int(h["kind"]) != kind:
        raise FrameFormatError("wrong_kind",
                               f"got {int(h['kind'])}, expected {kind}")
    n = int(h["count"])
    expect = _HEADER.itemsize + n * dtype.itemsize
    if len(body) != expect:
        raise FrameFormatError(
            "bad_length", f"{n} records need {expect} bytes, got {len(body)}")
    if n == 0:
        raise FrameFormatError("empty_batch")
    return n


def _decode_records(body: bytes, kind: int, dtype: np.dtype,
                    max_frame: int, version: int = VERSION) -> np.ndarray:
    n = _check_records(body, kind, dtype, max_frame, version)
    # THE batch decode: one zero-copy reinterpret of the whole window
    return np.frombuffer(body, dtype, count=n, offset=_HEADER.itemsize)


def decode_request_batch(body: bytes,
                         max_frame: int = DEFAULT_MAX_FRAME) -> np.ndarray:
    """Decode a request window into its column view (a structured array:
    rec["op"], rec["entity"], rec["value"], ... are numpy columns).
    Raises FrameFormatError with a typed code for malformed frames."""
    return _decode_records(body, KIND_REQUEST, REQUEST_DTYPE, max_frame)


def check_request_batch(body: bytes,
                        max_frame: int = DEFAULT_MAX_FRAME) -> int:
    """Validate a request body without decoding; returns its record
    count (the aggregator's window-close unit). Raises FrameFormatError
    with the same typed codes as decode_request_batch."""
    return _check_records(body, KIND_REQUEST, REQUEST_DTYPE, max_frame)


def decode_request_batches(bodies: Sequence[bytes],
                           max_frame: int = DEFAULT_MAX_FRAME):
    """Merged window decode: many frame bodies — from many
    connections — validated individually, then ALL their record bytes
    reinterpreted in ONE `np.frombuffer`. Returns `(rec, counts)` where
    `counts[i]` is body i's record count (the demux offsets). A single
    body keeps the zero-copy solo path; callers wanting per-body typed
    errors should pre-filter with check_request_batch."""
    counts = [_check_records(b, KIND_REQUEST, REQUEST_DTYPE, max_frame)
              for b in bodies]
    if len(bodies) == 1:
        return (np.frombuffer(bodies[0], REQUEST_DTYPE, count=counts[0],
                              offset=_HEADER.itemsize), counts)
    payload = b"".join(bytes(memoryview(b)[_HEADER.itemsize:])
                       for b in bodies)
    return np.frombuffer(payload, REQUEST_DTYPE), counts


# ------------------------------------------------------------------- replies
def encode_reply_batch(ids: np.ndarray, statuses: np.ndarray,
                       reasons: np.ndarray, values: np.ndarray,
                       retry_after_ms: np.ndarray,
                       traces: Any = None,
                       step_lags: Any = None,
                       dedups: Any = None) -> bytes:
    """Encode a whole reply wave in one vectorized pass (columns in,
    bytes out — the readback twin of decode_request_batch).

    `traces`: optional aligned u64 trace-id column. When any
    id is nonzero the wave is encoded as version 2 (trailing trace
    field); otherwise the output is bit-identical to the pre-tracing
    version-1 bytes — an untraced server never changes the wire.

    `step_lags`: optional aligned i32 replica-marker column
    (−1 = authoritative, ≥ 0 = replica-served at that step lag). When
    any row was replica-served the wave is version 3 (trace column
    included, zeros if untraced); otherwise the column is dropped and
    the version-2/1 rules above apply unchanged.

    `dedups`: optional aligned u1 dedup-marker column (1 =
    served from the reply cache). When any row was dedup-served the
    wave is version 4 (trace/step_lag columns included, zeros/−1 when
    inert); otherwise the column is dropped and the version-3/2/1 rules
    above apply unchanged."""
    n = len(ids)
    traced = traces is not None and bool(np.any(np.asarray(traces)))
    replica = step_lags is not None and \
        bool(np.any(np.asarray(step_lags) >= 0))
    deduped = dedups is not None and bool(np.any(np.asarray(dedups)))
    if deduped:
        rec = np.zeros((n,), REPLY_DTYPE_DEDUP)
    elif replica:
        rec = np.zeros((n,), REPLY_DTYPE_REPLICA)
    else:
        rec = np.zeros((n,), REPLY_DTYPE_TRACED if traced else REPLY_DTYPE)
    rec["id"] = ids
    rec["status"] = statuses
    rec["reason"] = reasons
    rec["value"] = values
    rec["retry_after_ms"] = retry_after_ms
    if deduped:
        if traced:
            rec["trace"] = np.asarray(traces, np.uint64)
        rec["step_lag"] = (np.asarray(step_lags, np.int32)
                           if step_lags is not None else -1)
        rec["dedup"] = np.asarray(dedups, np.uint8)
        return _header(KIND_REPLY, n, VERSION_DEDUP) + rec.tobytes()
    if replica:
        if traced:
            rec["trace"] = np.asarray(traces, np.uint64)
        rec["step_lag"] = np.asarray(step_lags, np.int32)
        return _header(KIND_REPLY, n, VERSION_REPLICA) + rec.tobytes()
    if traced:
        rec["trace"] = np.asarray(traces, np.uint64)
        return _header(KIND_REPLY, n, VERSION_TRACED) + rec.tobytes()
    return _header(KIND_REPLY, n) + rec.tobytes()


def decode_reply_batch(body: bytes,
                       max_frame: int = DEFAULT_MAX_FRAME) -> np.ndarray:
    """Decode a reply wave to its record columns (client half). Accepts
    both reply versions: 1 (53B records) and 2 (61B traced records) —
    the record array's dtype tells the caller which it got."""
    if len(body) >= 2 and body[1] == VERSION_DEDUP:
        return _decode_records(body, KIND_REPLY, REPLY_DTYPE_DEDUP,
                               max_frame, VERSION_DEDUP)
    if len(body) >= 2 and body[1] == VERSION_REPLICA:
        return _decode_records(body, KIND_REPLY, REPLY_DTYPE_REPLICA,
                               max_frame, VERSION_REPLICA)
    if len(body) >= 2 and body[1] == VERSION_TRACED:
        return _decode_records(body, KIND_REPLY, REPLY_DTYPE_TRACED,
                               max_frame, VERSION_TRACED)
    return _decode_records(body, KIND_REPLY, REPLY_DTYPE, max_frame)


def reply_to_dict(rec) -> Dict[str, Any]:
    """One reply record -> the exact dict the JSON protocol would have
    produced (key set depends on status — the equivalence contract the
    property test pins). A version-2 record's nonzero trace id maps to
    the "trace" key, exactly as the JSON path mirrors it."""
    status = _ST_NAMES.get(int(rec["status"]), "error")
    out: Dict[str, Any] = {"id": int(rec["id"]), "status": status}
    if status == "ok":
        out["value"] = float(rec["value"])
    elif status == "shed":
        out["reason"] = bytes(rec["reason"]).decode("utf-8", "replace")
        out["retry_after_ms"] = int(rec["retry_after_ms"])
    else:
        out["reason"] = bytes(rec["reason"]).decode("utf-8", "replace")
    if "trace" in (rec.dtype.names or ()) and int(rec["trace"]):
        out["trace"] = int(rec["trace"])
    if "step_lag" in (rec.dtype.names or ()) and int(rec["step_lag"]) >= 0:
        out["replica"] = True
        out["step_lag"] = int(rec["step_lag"])
    if "dedup" in (rec.dtype.names or ()) and int(rec["dedup"]):
        out["dedup"] = True
    return out


def decode_replies(body: bytes,
                   max_frame: int = DEFAULT_MAX_FRAME) -> List[Dict[str, Any]]:
    """Client convenience: reply wave -> list of JSON-twin dicts."""
    return [reply_to_dict(r) for r in decode_reply_batch(body, max_frame)]
