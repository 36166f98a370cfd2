"""Schema-evolution serialization: versioned manifests + migrations.

A copy of `akka_tpu/serialization/versioned.py` at commit 1001e26 (host
code, no jax; the port keeps its own copy of every module it needs).

Reference parity: akka-serialization-jackson — JacksonMigration.scala:22
(`currentVersion`, `transform(fromVersion, json)`, `transformClassName`)
layered on the JsonSerializer seam: every payload is written with a
"TypeName#version" manifest; on read, a registered SchemaMigration
upgrades old-version payloads (and renamed types) BEFORE the object is
rebuilt, so journals and cluster peers written by older application
versions keep deserializing after a rolling upgrade.

Usage:

    ser = VersionedJsonSerializer()
    ser.register_type(ItemAdded)                      # dataclass: automatic
    ser.register_migration("ItemAdded", ItemAddedMigration())
    serialization.add_binding(ItemAdded, ser)

A migration for version N receives every payload written at versions
< N and must return the CURRENT shape. Renames go through
transform_class_name, exactly like the reference's transformClassName.
"""

from __future__ import annotations

import json
import threading
from dataclasses import fields, is_dataclass
from typing import Any, Callable, Dict, Optional, Tuple, Type

from .serialization import SerializationError, Serializer


class SchemaMigration:
    """(reference: JacksonMigration.scala:22)"""

    #: version this application writes NOW; payloads read at lower
    #: versions go through transform()
    current_version: int = 1

    def transform(self, from_version: int, payload: dict) -> dict:
        """Upgrade a payload written at `from_version` to the current
        shape. Called once per event (not per version step) — inspect
        from_version and apply whatever steps are needed."""
        return payload

    def transform_class_name(self, from_version: int, name: str) -> str:
        """Map a historical type name to the current one (renames)."""
        return name


class VersionedJsonSerializer(Serializer):
    """JSON with "TypeName#version" manifests and migration hooks."""

    identifier = 7
    include_manifest = True

    def __init__(self):
        self._lock = threading.Lock()
        # name -> (cls, to_dict, from_dict)
        self._types: Dict[str, Tuple[type, Callable, Callable]] = {}
        self._names: Dict[type, str] = {}
        self._migrations: Dict[str, SchemaMigration] = {}

    # -- registry -------------------------------------------------------------
    def register_type(self, cls: type, name: Optional[str] = None,
                      to_dict: Optional[Callable[[Any], dict]] = None,
                      from_dict: Optional[Callable[[dict], Any]] = None
                      ) -> "VersionedJsonSerializer":
        """Register a serializable type. Dataclasses work with no
        converters (shallow field dict; nested dataclasses need explicit
        converters). Returns self for chaining."""
        n = name or cls.__name__
        if to_dict is None:
            if not is_dataclass(cls):
                raise SerializationError(
                    f"{cls.__name__}: non-dataclass types need explicit "
                    f"to_dict/from_dict converters")
            flds = [f.name for f in fields(cls)]

            def to_dict(obj, _flds=flds):  # noqa: A001
                return {k: getattr(obj, k) for k in _flds}
        if from_dict is None:
            def from_dict(payload, _cls=cls):
                return _cls(**payload)
        with self._lock:
            self._types[n] = (cls, to_dict, from_dict)
            self._names[cls] = n
        return self

    def register_migration(self, name: str, migration: SchemaMigration
                           ) -> "VersionedJsonSerializer":
        with self._lock:
            self._migrations[name] = migration
        return self

    # -- Serializer SPI -------------------------------------------------------
    def _entry(self, obj: Any):
        name = self._names.get(type(obj))
        if name is None:
            raise SerializationError(
                f"{type(obj).__name__} is not registered with the "
                f"versioned serializer (register_type first)")
        return name

    def manifest(self, obj: Any) -> str:
        name = self._entry(obj)
        mig = self._migrations.get(name)
        version = mig.current_version if mig is not None else 1
        return f"{name}#{version}"

    def to_binary(self, obj: Any) -> bytes:
        name = self._entry(obj)
        _, to_dict, _ = self._types[name]
        try:
            return json.dumps(to_dict(obj),
                              separators=(",", ":")).encode("utf-8")
        except (TypeError, ValueError) as e:
            raise SerializationError(
                f"{name}: payload not JSON-serializable: {e}") from e

    def from_binary(self, data: bytes, manifest: str = "") -> Any:
        name, _, ver_s = manifest.partition("#")
        try:
            from_version = int(ver_s) if ver_s else 1
        except ValueError as e:
            raise SerializationError(
                f"malformed versioned manifest {manifest!r}") from e
        payload = json.loads(data.decode("utf-8"))
        # renames first (the historical name owns the migration), then the
        # payload transform — JacksonSerializer.fromBinary order
        mig = self._migrations.get(name)
        current_name = name
        if mig is not None:
            current_name = mig.transform_class_name(from_version, name)
            if current_name != name:
                mig = self._migrations.get(current_name, mig)
        entry = self._types.get(current_name)
        if entry is None:
            raise SerializationError(
                f"versioned payload of unregistered type {current_name!r} "
                f"(manifest {manifest!r})")
        cls, _, from_dict = entry
        current = mig.current_version if mig is not None else 1
        if mig is not None and from_version < current:
            payload = mig.transform(from_version, payload)
        elif from_version > current:
            raise SerializationError(
                f"{current_name}: payload version {from_version} is NEWER "
                f"than this node's {current} — cannot downgrade")
        return from_dict(payload)
