"""Wire formats of the port: the gateway's binary frame format
(`frames`)."""

from . import frames  # noqa: F401

__all__ = ["frames"]
