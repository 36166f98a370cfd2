"""Process-stable hashing.

A copy of `akka_tpu/utils/hashing.py` at commit 56e9e23 (host code, no jax;
the port keeps its own copy of every module it needs).

Python's builtin hash() is salted per process (PYTHONHASHSEED), so it must
never be used for cross-node placement decisions (shard ids, ring positions).
These helpers give every node the same answer for the same key — the moral
equivalent of the reference's MurmurHash (routing/MurmurHash.scala) used by
consistent-hashing routers.
"""

from __future__ import annotations

import hashlib
from typing import Any


def stable_hash(key: Any) -> int:
    """64-bit stable hash of repr(key)."""
    h = hashlib.md5(repr(key).encode()).digest()
    return int.from_bytes(h[:8], "little")


def stable_hash_str(s: str) -> int:
    h = hashlib.md5(s.encode()).digest()
    return int.from_bytes(h[:8], "little")
