"""The port's one way to read a pickle: `load_record`.

Every pickle the port loads (a record of the record log, a journal's
`_meta.pickle`, a snapshot file, a pickled message on the wire) goes
through `load_record`. Its unpickler maps a class path of the JAX package
(`akka_tpu.…`) onto the same path in the port (`akka_tpu_torch.…`), so a
file the JAX package wrote is read without importing that package. It
refuses a class whose module is jax or a library built on jax, and any
class whose import brought jax into a process that had not loaded it. A
refused or missing class raises `UnresolvedRecordClass`, an ImportError.

This module imports nothing of the port, so the serialization layer and
the persistence layer above it both use it.
"""

from __future__ import annotations

import io
import pickle
import sys
from typing import Any

# libraries that import jax when they are imported
_REFUSED_ROOTS = frozenset(("jax", "jaxlib", "flax", "optax", "orbax",
                            "chex"))


class UnresolvedRecordClass(ImportError):
    """A record names a class the port cannot resolve: a module of the JAX
    package with no counterpart in the port, or jax or a library built on
    it."""


class _PortUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        root = module.split(".")[0]
        if root == "akka_tpu":
            module = "akka_tpu_torch" + module[len("akka_tpu"):]
        elif root in _REFUSED_ROOTS:
            raise UnresolvedRecordClass(
                f"a record holds {module}.{name}: the port does not "
                f"import jax")
        had_jax = "jax" in sys.modules
        try:
            found = super().find_class(module, name)
        except (ImportError, AttributeError) as e:
            raise UnresolvedRecordClass(
                f"a record holds {module}.{name}, which the port does "
                f"not have: {e}") from e
        if not had_jax and "jax" in sys.modules:
            raise UnresolvedRecordClass(
                f"a record holds {module}.{name}, whose import loaded "
                f"jax: the port does not import jax")
        return found


def load_record(blob: bytes) -> Any:
    """Unpickle one record (or any pickle a journal or snapshot file
    holds) with the JAX package's class paths mapped onto the port's.
    Raises UnresolvedRecordClass for a class the port cannot resolve."""
    return _PortUnpickler(io.BytesIO(blob)).load()
