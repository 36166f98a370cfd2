"""The whole-name check that no JAX module was loaded in this process.

A module counts by its top-level name, the part before the first dot,
compared whole: `akka_tpu_torch` is the port and passes, `akka_tpu` (the
JAX package) and `jax`, `jaxlib`, `flax` do not.
"""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "akka_tpu"})


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """Top-level names among `names` (default: `sys.modules`) that are
    forbidden."""
    if names is None:
        names = list(sys.modules)
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)
