"""Carry a BatchedSystem's or a ShardedBatchedSystem's state across
packages, as numpy arrays.

The carry is everything a step reads and writes plus the host allocation
mirrors. Keys of a BatchedSystem:

  "state/<col>"       each state column
  "behavior_id", "alive", "inbox_dst", "inbox_type", "inbox_payload",
  "inbox_valid", "inbox_enq", "mail_dropped", "sup_counts", "metrics",
  "step_count"        the device carry
  "host/next_row", "host/free_rows", "host/generation", "host/step"
                      the host free-list, generation and step mirrors

Keys of a ShardedBatchedSystem (every field in the reference's flat
global layout, per-shard counters with a leading [n_shards] axis):

  "state/<col>", "behavior_id", "alive", "inbox_dst", "inbox_type",
  "inbox_payload", "inbox_valid", "inbox_enq", "dropped", "mail_dropped",
  "sup_counts", "metrics", "step_count", "attention", "host/next_row",
  "host/step"

The JAX reference's carry, fetched to numpy under the same keys, loads into
a port system with `load_numpy_carry`, so both packages can start from one
state and be compared field by field with `numpy_carry`.

A ShardedBatchedSystem over a ranked mesh holds one block of every field:
`numpy_carry` gathers the global carry (a collective: every rank calls it
alike) and `load_numpy_carry` writes each rank's block of a global one,
so one carry moves between a one-card system and W ranks either way.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

DEVICE_FIELDS = ("behavior_id", "alive", "inbox_dst", "inbox_type",
                 "inbox_payload", "inbox_valid", "inbox_enq", "mail_dropped",
                 "sup_counts", "metrics", "step_count")
SHARDED_FIELDS = ("behavior_id", "alive", "inbox_dst", "inbox_type",
                  "inbox_payload", "inbox_valid", "inbox_enq", "dropped",
                  "mail_dropped", "sup_counts", "metrics", "step_count",
                  "attention")


def _sharded(system) -> bool:
    return hasattr(system, "n_shards")


def numpy_carry(system) -> Dict[str, np.ndarray]:
    """The port system's carry as a dict of numpy arrays (copies: the
    carry is updated in place; bf16 fields widen to float32, which numpy
    has)."""
    sharded = _sharded(system)

    def host(t: torch.Tensor) -> np.ndarray:
        if t.dtype == torch.bfloat16:
            return t.to("cpu", torch.float32, copy=True).numpy()
        return t.to("cpu", copy=True).numpy()

    whole = system.global_tensor if sharded else (lambda t: t)
    out = {f"state/{c}": host(whole(v)) for c, v in system.state.items()}
    for f in SHARDED_FIELDS if sharded else DEVICE_FIELDS:
        out[f] = host(whole(getattr(system, f)))
    with system._lock:
        out["host/next_row"] = np.asarray(system._next_row, np.int64)
        if not sharded:
            out["host/free_rows"] = np.asarray(system._free_rows, np.int64)
            out["host/generation"] = system._generation.copy()
    out["host/step"] = np.asarray(system._host_step, np.int64)
    return out


def _check(current: torch.Tensor, value, key: str) -> np.ndarray:
    arr = np.array(value)  # a writable copy
    if tuple(arr.shape) != tuple(current.shape):
        raise ValueError(f"carry field {key!r}: shape {arr.shape} does not "
                         f"match the system's {tuple(current.shape)}")
    return arr


def load_numpy_carry(system, arrays: Dict[str, np.ndarray]) -> None:
    """Fill a port system's carry from `arrays` (every key of the module
    docstring for its kind; state columns must match the system's
    schema, and every field its shape). Values are cast to the system's
    dtypes and copied into its tensors in place (a captured step reads
    them at fixed addresses); nothing is written unless every key
    matches."""
    cols = {k[len("state/"):] for k in arrays if k.startswith("state/")}
    if cols != set(system.state):
        raise ValueError(f"carry state columns {sorted(cols)} do not match "
                         f"the system's {sorted(system.state)}")
    sharded = _sharded(system)
    block = system.local_block if sharded else (lambda a, t: a)
    pairs = [(v, _check(v, block(arrays[f"state/{c}"], v), f"state/{c}"))
             for c, v in system.state.items()]
    pairs += [(getattr(system, f), _check(
        getattr(system, f), block(arrays[f], getattr(system, f)), f))
              for f in (SHARDED_FIELDS if sharded else DEVICE_FIELDS)]
    if not sharded:
        generation = np.asarray(arrays["host/generation"], np.int64)
        if generation.shape != system._generation.shape:
            raise ValueError("carry field 'host/generation' does not match "
                             "the system's capacity")
    for cur, arr in pairs:
        cur.copy_(torch.from_numpy(arr))
    with system._lock:
        system._next_row = int(arrays["host/next_row"])
        if not sharded:
            system._free_rows = [int(i) for i in
                                 np.asarray(arrays["host/free_rows"]).ravel()]
            system._generation = generation.copy()
    system._host_step = int(arrays["host/step"])
