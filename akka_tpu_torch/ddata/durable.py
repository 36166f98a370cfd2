"""Durable store for ddata keys that must survive node restart.

A copy of `akka_tpu/ddata/durable.py` at commit c056b95 (host code, no
jax; the port keeps its own copy of every module it needs). One change:
`load_all` reads each file through `serialization/records.py`
`load_record`, as every pickle the port reads, so a directory the JAX
package wrote reads into equal port CRDTs; a file whose class does not
resolve raises `UnresolvedRecordClass` and is left as it is.

Reference parity: akka-distributed-data/src/main/scala/akka/cluster/ddata/
DurableStore.scala — the reference uses LMDB; here a write-behind pickle-per-
key directory (no LMDB in the image; the access pattern — whole-value
store/load keyed by string — is identical). File name is the hex SHA1 of the
key so arbitrary key ids are path-safe.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import tempfile
from typing import Any, Dict

from ..serialization.records import load_record


class DurableStore:
    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.dir, hashlib.sha1(key.encode()).hexdigest() + ".ddata")

    def store(self, key: str, data: Any) -> None:
        # atomic replace so a crash mid-write never corrupts the entry
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                pickle.dump((key, data), f, protocol=4)
            os.replace(tmp, self._path(key))
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def load_all(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for name in os.listdir(self.dir):
            if not name.endswith(".ddata"):
                continue
            try:
                with open(os.path.join(self.dir, name), "rb") as f:
                    key, data = load_record(f.read())
                out[key] = data
            except (OSError, pickle.PickleError, EOFError):
                continue
        return out

    def delete(self, key: str) -> None:
        try:
            os.unlink(self._path(key))
        except OSError:
            pass
