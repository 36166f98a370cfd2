"""Replicated state (CRDTs). The port has the device data plane so far:
tensor CRDT banks whose merge is one elementwise op (`tensor`). The host
control plane of the reference package (`crdt`, `version_vector`,
`durable`, `replicator`) is not ported yet (ROADMAP A12.3)."""

from . import tensor  # noqa: F401

__all__ = ["tensor"]
