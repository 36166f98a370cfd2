"""Wire formats of the port: the serialization registry
(`serialization`, with its fixed-schema codec `codec`), the schema-evolution
serializer (`versioned`: versioned manifests + migrations) and the
gateway's binary frame format (`frames`)."""

from .serialization import (JsonSerializer, PickleSerializer,  # noqa: F401
                            SerializationError, Serialization, Serializer,
                            StringSerializer, TensorSerializer,
                            transport_information)
from .versioned import SchemaMigration, VersionedJsonSerializer  # noqa: F401
from . import frames  # noqa: F401

__all__ = ["Serialization", "Serializer", "SerializationError",
           "PickleSerializer", "StringSerializer", "JsonSerializer",
           "TensorSerializer", "transport_information",
           "SchemaMigration", "VersionedJsonSerializer", "frames"]
