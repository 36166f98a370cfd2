"""Wire formats of the port: the serialization registry
(`serialization`, with its fixed-schema codec `codec`) and the gateway's
binary frame format (`frames`)."""

from .serialization import (JsonSerializer, PickleSerializer,  # noqa: F401
                            SerializationError, Serialization, Serializer,
                            StringSerializer, TensorSerializer,
                            transport_information)
from . import frames  # noqa: F401

__all__ = ["Serialization", "Serializer", "SerializationError",
           "PickleSerializer", "StringSerializer", "JsonSerializer",
           "TensorSerializer", "transport_information", "frames"]
