"""Fixed-schema wire codec: tag-based values + allowlisted object graphs.

A copy of `akka_tpu/serialization/codec.py` at commit 5d9b7cd (host code, no
jax; the port keeps its own copy of every module it needs).

Reference parity: akka-remote's protobuf serializers for internal messages
(remote/serialization/, the shaded akka-protobuf runtime) and the Artery
envelope layout discipline (remote/artery/Codecs.scala): a fixed binary
layout, integer serializer ids, string manifests — and NO arbitrary code
execution on the inbound path. Java serialization exists behind
`allow-java-serialization` (off in 2.6); our pickle fallback mirrors that:
explicit opt-in only (akka.remote.allow-pickle).

Decoding here can only ever:
- build primitives/containers (None/bool/int/float/str/bytes/list/tuple/
  set/frozenset/dict), numpy arrays from raw buffers,
- resolve ActorRefs through the provider (transport_information),
- instantiate ALLOWLISTED classes via cls.__new__ + object.__setattr__ of
  decoded fields — never __init__, never __reduce__, never a callable from
  the wire. Allowlisted = anything under the framework's own namespace
  (internal control-plane messages are framework dataclasses) plus classes
  registered explicitly with register_wire_class (the user's
  serialization-bindings analogue, Serialization.scala:45).
"""

from __future__ import annotations

import enum
import importlib
import io
import struct
import threading
from typing import Any, Callable, Dict, Optional, Set, Tuple

import numpy as np

_I64 = struct.Struct(">q")
_F64 = struct.Struct(">d")
_U32 = struct.Struct(">I")

# public aliases: the wire-integer primitives other fixed-schema layouts
# build on (serialization/frames.py — the gateway's binary frame format
# shares this module's big-endian convention)
I64, F64, U32 = _I64, _F64, _U32

_TRUSTED_PREFIX = "akka_tpu_torch."

_registry_lock = threading.Lock()
_registered: Dict[str, type] = {}        # "module:qualname" -> class
_registered_rev: Dict[type, str] = {}


class WireCodecError(Exception):
    pass


def register_wire_class(cls: type, key: Optional[str] = None) -> type:
    """Allow `cls` on the wire (usable as a decorator). Framework-internal
    classes (akka_tpu_torch.*) are implicitly trusted; user message classes must
    be registered on BOTH ends."""
    k = key or f"{cls.__module__}:{cls.__qualname__}"
    with _registry_lock:
        _registered[k] = cls
        _registered_rev[cls] = k
    return cls


def _class_key(cls: type) -> str:
    k = _registered_rev.get(cls)
    if k is not None:
        return k
    if "<locals>" in cls.__qualname__:
        raise WireCodecError(
            f"cannot wire-encode local class {cls.__qualname__}: register it "
            "with register_wire_class or define it at module scope")
    return f"{cls.__module__}:{cls.__qualname__}"


def _resolve_class(key: str) -> type:
    with _registry_lock:
        cls = _registered.get(key)
    if cls is not None:
        return cls
    module, _, qual = key.partition(":")
    if not module.startswith(_TRUSTED_PREFIX):
        raise WireCodecError(
            f"refusing to decode unregistered class {key!r}: call "
            "register_wire_class on both ends (or enable "
            "akka.remote.allow-pickle explicitly)")
    try:
        obj: Any = importlib.import_module(module)
        for part in qual.split("."):
            obj = getattr(obj, part)
    except (ImportError, AttributeError) as e:
        raise WireCodecError(f"cannot resolve wire class {key!r}: {e}") from e
    if not isinstance(obj, type):
        raise WireCodecError(f"wire class key {key!r} is not a class")
    with _registry_lock:
        _registered[key] = obj
        _registered_rev.setdefault(obj, key)
    return obj


# ---------------------------------------------------------------- primitives
def _w_bytes(out: io.BytesIO, b: bytes) -> None:
    out.write(_U32.pack(len(b)))
    out.write(b)


def _read_exact(inp: io.BytesIO, n: int) -> bytes:
    data = inp.read(n)
    if len(data) != n:
        raise WireCodecError("truncated frame")
    return data


def _r_bytes(inp: io.BytesIO) -> bytes:
    (n,) = _U32.unpack(_read_exact(inp, 4))
    return _read_exact(inp, n)


def _w_str(out: io.BytesIO, s: str) -> None:
    _w_bytes(out, s.encode("utf-8"))


def _r_str(inp: io.BytesIO) -> str:
    return _r_bytes(inp).decode("utf-8")


def _is_cycle_kind(obj: Any) -> bool:
    """True for kinds that get a memo slot (exact list/set/dict + O-coded
    objects) — encode and decode MUST register the same kinds in the same
    order or every later backref is misaligned (silent corruption). The
    isinstance checks therefore mirror the encode dispatch exactly:
    NamedTuples (tuple subclasses, 'n'-coded) and refused builtin
    subclasses never take a slot."""
    t = type(obj)
    if t in (list, set, dict):
        return True
    if obj is None or isinstance(
            obj, (bool, int, float, str, bytes, tuple, frozenset, list, set,
                  dict, np.ndarray, np.generic, enum.Enum)):
        return False
    if t.__name__ == "ArrayImpl" or _is_actor_ref(obj):
        return False
    return True


def encode_value(obj: Any, out: io.BytesIO,
                 memo: Optional[Dict[int, int]] = None,
                 keep: Optional[list] = None) -> None:
    """One-byte tag + payload, recursive. Raises WireCodecError for types
    with no fixed-schema representation.

    Cyclic graphs are legal for the cycle-capable kinds (list/set/dict/
    object — e.g. a delta-CRDT whose _delta is itself): each one gets a
    memo index on first encode and later occurrences emit an `R` backref —
    pickle's memoization discipline. Decode registers the same kinds in
    the same order, so indices line up by construction."""
    if memo is None:
        memo = {}
        keep = []
    if _is_cycle_kind(obj):
        idx = memo.get(id(obj))
        if idx is not None:
            out.write(b"R")
            out.write(_U32.pack(idx))
            return
        memo[id(obj)] = len(memo)
        keep.append(obj)  # pin: id() must stay unique for the whole encode
    if obj is None:
        out.write(b"N")
    elif obj is True:
        out.write(b"T")
    elif obj is False:
        out.write(b"F")
    elif type(obj) is int:
        if -(1 << 63) <= obj < (1 << 63):
            out.write(b"i")
            out.write(_I64.pack(obj))
        else:  # arbitrary-precision: sign byte + big-endian magnitude
            out.write(b"I")
            out.write(b"-" if obj < 0 else b"+")
            mag = abs(obj)
            _w_bytes(out, mag.to_bytes((mag.bit_length() + 7) // 8 or 1, "big"))
    elif type(obj) is float:
        out.write(b"f")
        out.write(_F64.pack(obj))
    elif type(obj) is str:
        out.write(b"s")
        _w_str(out, obj)
    elif type(obj) is bytes:
        out.write(b"b")
        _w_bytes(out, obj)
    elif type(obj) is list:
        out.write(b"l")
        out.write(_U32.pack(len(obj)))
        for x in obj:
            encode_value(x, out, memo, keep)
    elif type(obj) is tuple:
        out.write(b"t")
        out.write(_U32.pack(len(obj)))
        for x in obj:
            encode_value(x, out, memo, keep)
    elif type(obj) is set or type(obj) is frozenset:
        out.write(b"S" if type(obj) is set else b"Z")
        out.write(_U32.pack(len(obj)))
        for x in obj:
            encode_value(x, out, memo, keep)
    elif type(obj) is dict:
        out.write(b"d")
        out.write(_U32.pack(len(obj)))
        for k, v in obj.items():
            encode_value(k, out, memo, keep)
            encode_value(v, out, memo, keep)
    elif isinstance(obj, np.ndarray) or type(obj).__name__ == "ArrayImpl":
        arr = np.asarray(obj)
        out.write(b"a")
        _w_str(out, arr.dtype.str)
        out.write(_U32.pack(arr.ndim))
        for dim in arr.shape:
            out.write(_U32.pack(dim))
        _w_bytes(out, np.ascontiguousarray(arr).tobytes())
    elif isinstance(obj, np.generic):
        encode_value(obj.item(), out, memo, keep)
    elif isinstance(obj, enum.Enum):
        out.write(b"E")
        _w_str(out, _class_key(type(obj)))
        _w_str(out, obj.name)
    elif _is_actor_ref(obj):
        out.write(b"r")
        _w_str(out, ref_wire_path(obj))
    elif isinstance(obj, type):
        # class REFERENCE (not instance): e.g. the zero_tag a map delta op
        # carries so first-sight replicas reconstruct the right wrapper.
        # Decode goes through _resolve_class, so only trusted/registered
        # classes ever resolve.
        out.write(b"C")
        _w_str(out, _class_key(obj))
    elif isinstance(obj, tuple) and hasattr(type(obj), "_fields"):
        # NamedTuple: state lives in the tuple payload, not __dict__
        cls = type(obj)
        key = _class_key(cls)
        if not key.startswith(_TRUSTED_PREFIX) and cls not in _registered_rev:
            raise WireCodecError(
                f"no fixed-schema codec for NamedTuple {key!r}: register it "
                "with register_wire_class (both ends)")
        out.write(b"n")
        _w_str(out, key)
        out.write(_U32.pack(len(obj)))
        for x in obj:
            encode_value(x, out, memo, keep)
    elif isinstance(obj, (tuple, list, dict, set, frozenset, str, bytes,
                          int, float)):
        # builtin subclass (not a NamedTuple): the builtin payload would be
        # silently lost by attribute-walking — refuse loudly
        raise WireCodecError(
            f"no fixed-schema codec for builtin subclass "
            f"{type(obj).__qualname__}: its {type(obj).__mro__[-2].__name__} "
            "payload is not capturable as attributes")
    else:
        _encode_object(obj, out, memo, keep)


def ref_wire_path(ref) -> str:
    """Full-address serialization path when a transport context is
    installed; local-scope path otherwise (local-only digesting /
    persistence — decoding across systems requires the context)."""
    from .serialization import SerializationError, serialized_ref_path
    try:
        return serialized_ref_path(ref)
    except SerializationError:
        return ref.path.to_serialization_format()


def _is_actor_ref(obj: Any) -> bool:
    from ..actor.ref import ActorRef
    return isinstance(obj, ActorRef)


def _fields_of(obj: Any) -> Dict[str, Any]:
    """Instance state = __dict__ merged with slot attributes: a class whose
    base lacks __slots__ has BOTH (an often-empty __dict__ plus slots)."""
    fields: Dict[str, Any] = dict(getattr(obj, "__dict__", ()) or {})
    for klass in type(obj).__mro__:
        slots = getattr(klass, "__slots__", ())
        if isinstance(slots, str):
            slots = (slots,)
        for slot in slots:
            if slot not in fields and slot != "__dict__" and \
                    hasattr(obj, slot):
                fields[slot] = getattr(obj, slot)
    return fields


def _encode_object(obj: Any, out: io.BytesIO, memo: Dict[int, int],
                   keep: list) -> None:
    cls = type(obj)
    key = _class_key(cls)
    if not key.startswith(_TRUSTED_PREFIX) and cls not in _registered_rev:
        raise WireCodecError(
            f"no fixed-schema codec for {key!r}: register it with "
            "register_wire_class (both ends) or enable "
            "akka.remote.allow-pickle explicitly")
    fields = _fields_of(obj)
    try:
        out.write(b"O")
        _w_str(out, key)
        out.write(_U32.pack(len(fields)))
        for name, value in fields.items():
            _w_str(out, name)
            encode_value(value, out, memo, keep)
    except WireCodecError:
        raise
    except (struct.error, TypeError) as e:
        raise WireCodecError(f"field of {key!r} not wire-encodable: {e}") from e


def decode_value(inp: io.BytesIO, memo: Optional[list] = None) -> Any:
    if memo is None:
        memo = []
    tag = inp.read(1)
    if tag == b"N":
        return None
    if tag == b"T":
        return True
    if tag == b"F":
        return False
    if tag == b"i":
        return _I64.unpack(_read_exact(inp, 8))[0]
    if tag == b"I":
        sign = _read_exact(inp, 1)
        mag = int.from_bytes(_r_bytes(inp), "big")
        return -mag if sign == b"-" else mag
    if tag == b"f":
        return _F64.unpack(_read_exact(inp, 8))[0]
    if tag == b"s":
        return _r_str(inp)
    if tag == b"b":
        return _r_bytes(inp)
    if tag == b"R":
        (idx,) = _U32.unpack(_read_exact(inp, 4))
        try:
            return memo[idx]
        except IndexError:
            raise WireCodecError(f"dangling backref {idx}") from None
    if tag == b"l":
        (n,) = _U32.unpack(_read_exact(inp, 4))
        out: list = []
        memo.append(out)  # register BEFORE children: self-references resolve
        for _ in range(n):
            out.append(decode_value(inp, memo))
        return out
    if tag == b"S":
        (n,) = _U32.unpack(_read_exact(inp, 4))
        s: set = set()
        memo.append(s)
        for _ in range(n):
            s.add(decode_value(inp, memo))
        return s
    if tag == b"d":
        (n,) = _U32.unpack(_read_exact(inp, 4))
        d: dict = {}
        memo.append(d)
        for _ in range(n):
            k = decode_value(inp, memo)
            d[k] = decode_value(inp, memo)
        return d
    if tag in (b"t", b"Z"):
        (n,) = _U32.unpack(_read_exact(inp, 4))
        items = [decode_value(inp, memo) for _ in range(n)]
        return tuple(items) if tag == b"t" else frozenset(items)
    if tag == b"a":
        dtype_s = _r_str(inp)
        (ndim,) = _U32.unpack(_read_exact(inp, 4))
        shape = tuple(_U32.unpack(_read_exact(inp, 4))[0] for _ in range(ndim))
        buf = _r_bytes(inp)
        return np.frombuffer(buf, dtype=np.dtype(dtype_s)).reshape(shape).copy()
    if tag == b"E":
        cls = _resolve_class(_r_str(inp))
        if not issubclass(cls, enum.Enum):
            raise WireCodecError(f"{cls!r} is not an Enum")
        return cls[_r_str(inp)]
    if tag == b"r":
        from .serialization import resolve_ref
        return resolve_ref(_r_str(inp))
    if tag == b"C":
        return _resolve_class(_r_str(inp))
    if tag == b"n":
        cls = _resolve_class(_r_str(inp))
        (n,) = _U32.unpack(_read_exact(inp, 4))
        if not (issubclass(cls, tuple) and hasattr(cls, "_fields")):
            raise WireCodecError(f"{cls!r} is not a NamedTuple")
        items = [decode_value(inp, memo) for _ in range(n)]
        return cls(*items)
    if tag == b"O":
        cls = _resolve_class(_r_str(inp))
        (n,) = _U32.unpack(_read_exact(inp, 4))
        obj = cls.__new__(cls)
        memo.append(obj)  # register BEFORE fields: self-references resolve
        for _ in range(n):
            name = _r_str(inp)
            object.__setattr__(obj, name, decode_value(inp, memo))
        return obj
    raise WireCodecError(f"unknown wire tag {tag!r}")


def dumps(obj: Any) -> bytes:
    out = io.BytesIO()
    encode_value(obj, out)
    return out.getvalue()


def loads(data: bytes) -> Any:
    return decode_value(io.BytesIO(data))
