"""Serialization: id->serializer registry with class bindings + manifests.

A copy of `akka_tpu/serialization/serialization.py` at commit 5d9b7cd (host
code, no jax; the port keeps its own copy of every module it needs). Two
changes: `TensorSerializer` binds `torch.Tensor` where the reference binds
`jax.Array`; a tensor travels as its host copy (bf16, which numpy lacks,
as float32). `PickleSerializer` reads through `records.load_record`.

Reference parity: akka-actor/src/main/scala/akka/serialization/ —
`Serialization.findSerializerFor` walks class->serializer bindings (most
specific class wins, Serialization.scala:291), serializers carry integer ids
and optional string manifests (Serializer.scala SerializerWithStringManifest),
bindings come from config `serialization-bindings` (Serialization.scala:45)
plus runtime registration.

Tensor note: message payloads that are torch tensors or numpy arrays use the
tensor serializer (raw little-endian buffers + dtype/shape manifest) so
remote tells of tensor blocks don't round-trip through pickle.
"""

from __future__ import annotations

import io
import json
import pickle
import struct
import threading
from dataclasses import is_dataclass, asdict
from typing import Any, Dict, Optional, Tuple, Type

import numpy as np
import torch

from .records import load_record


class Serializer:
    identifier: int = 0
    include_manifest: bool = False

    def manifest(self, obj: Any) -> str:
        return ""

    def to_binary(self, obj: Any) -> bytes:
        raise NotImplementedError

    def from_binary(self, data: bytes, manifest: str = "") -> Any:
        raise NotImplementedError


class PickleSerializer(Serializer):
    """The reference's JavaSerializer analogue — and like it, OFF on the
    wire unless explicitly enabled (akka.remote.allow-pickle; reference:
    allow-java-serialization, off since 2.6). `enabled` is enforced on BOTH
    directions so a peer can't feed us pickles just because it built some.
    Reads go through records.load_record (the JAX package's class paths
    map onto the port's; jax is never imported)."""

    identifier = 1

    def __init__(self, enabled: bool = True):
        self.enabled = enabled

    def to_binary(self, obj: Any) -> bytes:
        if not self.enabled:
            raise SerializationError(
                f"pickle serialization of {type(obj).__name__} is disabled "
                "(set akka.remote.allow-pickle = true to opt in, or register "
                "the class with register_wire_class)")
        return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)

    def from_binary(self, data: bytes, manifest: str = "") -> Any:
        if not self.enabled:
            raise SerializationError(
                "inbound pickle payload refused (akka.remote.allow-pickle "
                "is off)")
        return load_record(data)


class StringSerializer(Serializer):
    identifier = 2

    def to_binary(self, obj: str) -> bytes:
        return obj.encode("utf-8")

    def from_binary(self, data: bytes, manifest: str = "") -> str:
        return data.decode("utf-8")


class BytesSerializer(Serializer):
    identifier = 3

    def to_binary(self, obj: bytes) -> bytes:
        return bytes(obj)

    def from_binary(self, data: bytes, manifest: str = "") -> bytes:
        return data


class JsonSerializer(Serializer):
    """Dict/list/primitive JSON (the reference's akka-serialization-jackson
    analogue for simple protocols)."""

    identifier = 4

    def to_binary(self, obj: Any) -> bytes:
        if is_dataclass(obj) and not isinstance(obj, type):
            obj = asdict(obj)
        return json.dumps(obj, separators=(",", ":")).encode("utf-8")

    def from_binary(self, data: bytes, manifest: str = "") -> Any:
        return json.loads(data.decode("utf-8"))


class TensorSerializer(Serializer):
    """numpy arrays and torch tensors as raw buffers; manifest =
    dtype|shape. A tensor is read back as a numpy array."""

    identifier = 5
    include_manifest = True

    def manifest(self, obj: Any) -> str:
        arr = _host_array(obj)
        return f"{arr.dtype.str}|{','.join(map(str, arr.shape))}"

    def to_binary(self, obj: Any) -> bytes:
        return np.ascontiguousarray(_host_array(obj)).tobytes()

    def from_binary(self, data: bytes, manifest: str = "") -> np.ndarray:
        dtype_s, _, shape_s = manifest.partition("|")
        shape = tuple(int(x) for x in shape_s.split(",") if x)
        return np.frombuffer(data, dtype=np.dtype(dtype_s)).reshape(shape).copy()


def _host_array(obj: Any) -> np.ndarray:
    """`obj` as a numpy array: a tensor's host copy (bf16 widened to
    float32, which numpy can hold), anything else through np.asarray."""
    if isinstance(obj, torch.Tensor):
        from ..persistence.slab_snapshot import host_array
        return host_array(obj)
    return np.asarray(obj)


class SerializationError(Exception):
    pass


class FieldSchemaSerializer(Serializer):
    """Fixed-schema object graphs (codec.py): tag-coded primitives and
    containers, raw tensor buffers, ActorRefs as resolved path strings, and
    allowlisted classes rebuilt via __new__ + setattr — no code execution
    on decode (the protobuf-internal-serializer analogue,
    remote/serialization/ + artery Codecs.scala layout discipline)."""

    identifier = 6

    def to_binary(self, obj: Any) -> bytes:
        from .codec import WireCodecError, dumps
        try:
            return dumps(obj)
        except WireCodecError as e:
            raise SerializationError(str(e)) from e

    def from_binary(self, data: bytes, manifest: str = "") -> Any:
        from .codec import WireCodecError, loads
        try:
            return loads(data)
        except WireCodecError as e:
            raise SerializationError(str(e)) from e
        except (struct.error, ValueError, TypeError, KeyError, EOFError,
                AttributeError) as e:
            # malformed frames must surface as serialization failures, not
            # leak implementation errors to the inbound path
            raise SerializationError(f"malformed wire frame: {e!r}") from e


# -- ActorRef transparency over the wire -------------------------------------
# (reference: Serialization.currentTransportInformation thread-local,
# Serialization.scala:93-136 — refs serialize as full-address path strings and
# resolve against the current system's provider on the receiving side)

_transport_info = threading.local()


class transport_information:
    """Context manager installing the provider used to (de)serialize ActorRefs
    embedded in message payloads."""

    def __init__(self, provider):
        self.provider = provider

    def __enter__(self):
        self._prev = getattr(_transport_info, "provider", None)
        _transport_info.provider = self.provider
        return self

    def __exit__(self, *exc):
        _transport_info.provider = self._prev


def serialized_ref_path(ref) -> str:
    """Full-address serialization path for a ref (local addresses get the
    provider's canonical host:port)."""
    provider = getattr(_transport_info, "provider", None)
    path = ref.path
    if provider is None:
        raise SerializationError(
            f"cannot serialize ActorRef {path}: no transport information set "
            "(refs only cross the wire inside remote-enabled systems)")
    local = getattr(provider, "local_address", None)
    if local is not None and path.address.has_local_scope:
        path = path.with_address(local)
    return path.to_serialization_format()


def resolve_ref(path: str):
    provider = getattr(_transport_info, "provider", None)
    if provider is None:
        raise SerializationError(
            f"cannot deserialize ActorRef {path}: no transport information set")
    return provider.resolve_actor_ref(path)


class Serialization:
    """Per-system registry (reference: Serialization.scala:138)."""

    def __init__(self, system=None, allow_pickle: bool = True):
        """allow_pickle=False is the wire posture (remote provider default):
        the object fallback becomes the fixed-schema codec, and pickle
        payloads are refused in both directions."""
        self.system = system
        self.allow_pickle = allow_pickle
        self._by_id: Dict[int, Serializer] = {}
        self._bindings: list[Tuple[type, Serializer]] = []
        self._cache: Dict[type, Serializer] = {}
        self._lock = threading.Lock()
        for s in (PickleSerializer(enabled=allow_pickle), StringSerializer(),
                  BytesSerializer(), JsonSerializer(), TensorSerializer(),
                  FieldSchemaSerializer()):
            self.register_serializer(s)
        self.add_binding(str, self._by_id[2])
        self.add_binding(bytes, self._by_id[3])
        self.add_binding(np.ndarray, self._by_id[5])
        # torch.Tensor is not an np.ndarray; bind it to the tensor path too
        self.add_binding(torch.Tensor, self._by_id[5])
        # fallback: pickle when explicitly allowed, fixed-schema otherwise
        self.add_binding(object, self._by_id[1 if allow_pickle else 6])

    def register_serializer(self, serializer: Serializer) -> None:
        with self._lock:
            existing = self._by_id.get(serializer.identifier)
            if existing is not None and type(existing) is not type(serializer):
                raise SerializationError(
                    f"serializer id {serializer.identifier} already bound to "
                    f"{type(existing).__name__}")
            self._by_id[serializer.identifier] = serializer

    def add_binding(self, cls: type, serializer: Serializer) -> None:
        self.register_serializer(serializer)
        with self._lock:
            self._bindings.append((cls, serializer))
            # most specific class first (reference: Serialization.bindings sort)
            self._bindings.sort(key=lambda kv: -_depth(kv[0]))
            self._cache.clear()

    def find_serializer_for(self, obj: Any) -> Serializer:
        cls = type(obj)
        s = self._cache.get(cls)
        if s is not None:
            return s
        with self._lock:
            for bound_cls, ser in self._bindings:
                if isinstance(obj, bound_cls):
                    self._cache[cls] = ser
                    return ser
        raise SerializationError(f"no serializer for {cls.__name__}")

    def serializer_by_id(self, id_: int) -> Serializer:
        s = self._by_id.get(id_)
        if s is None:
            raise SerializationError(f"unknown serializer id {id_}")
        return s

    # -- round trips ---------------------------------------------------------
    def serialize(self, obj: Any) -> Tuple[int, str, bytes]:
        s = self.find_serializer_for(obj)
        return s.identifier, s.manifest(obj), s.to_binary(obj)

    def deserialize(self, serializer_id: int, manifest: str, data: bytes) -> Any:
        return self.serializer_by_id(serializer_id).from_binary(data, manifest)

    def verify_round_trip(self, obj: Any) -> Any:
        """The serialize-messages guard rail (reference:
        actor/dungeon/Dispatch.scala:162-204)."""
        sid, manifest, data = self.serialize(obj)
        return self.deserialize(sid, manifest, data)


def _depth(cls: type) -> int:
    return len(cls.__mro__)
