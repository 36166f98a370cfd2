"""Carry a BatchedSystem's state across packages, as numpy arrays.

The carry is everything a step reads and writes plus the host allocation
mirrors. Keys:

  "state/<col>"       each state column
  "behavior_id", "alive", "inbox_dst", "inbox_type", "inbox_payload",
  "inbox_valid", "inbox_enq", "mail_dropped", "sup_counts", "metrics",
  "step_count"        the device carry
  "host/next_row", "host/free_rows", "host/generation", "host/step"
                      the host free-list, generation and step mirrors

The JAX reference's carry, fetched to numpy under the same keys, loads into
a port system with `load_numpy_carry`, so both packages can start from one
state and be compared field by field with `numpy_carry`.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

DEVICE_FIELDS = ("behavior_id", "alive", "inbox_dst", "inbox_type",
                 "inbox_payload", "inbox_valid", "inbox_enq", "mail_dropped",
                 "sup_counts", "metrics", "step_count")


def numpy_carry(system) -> Dict[str, np.ndarray]:
    """The port system's carry as a dict of numpy arrays."""
    out = {f"state/{c}": v.cpu().numpy() for c, v in system.state.items()}
    for f in DEVICE_FIELDS:
        out[f] = getattr(system, f).cpu().numpy()
    with system._lock:
        out["host/next_row"] = np.asarray(system._next_row, np.int64)
        out["host/free_rows"] = np.asarray(system._free_rows, np.int64)
        out["host/generation"] = system._generation.copy()
    out["host/step"] = np.asarray(system._host_step, np.int64)
    return out


def _load(current: torch.Tensor, value, key: str) -> torch.Tensor:
    arr = np.array(value)  # a writable copy
    if tuple(arr.shape) != tuple(current.shape):
        raise ValueError(f"carry field {key!r}: shape {arr.shape} does not "
                         f"match the system's {tuple(current.shape)}")
    return torch.as_tensor(arr).to(device=current.device,
                                   dtype=current.dtype).clone()


def load_numpy_carry(system, arrays: Dict[str, np.ndarray]) -> None:
    """Fill a port BatchedSystem's carry from `arrays` (every key of the
    module docstring; state columns must match the system's schema).
    Values are cast to the system's dtypes and copied to its device."""
    cols = {k[len("state/"):] for k in arrays if k.startswith("state/")}
    if cols != set(system.state):
        raise ValueError(f"carry state columns {sorted(cols)} do not match "
                         f"the system's {sorted(system.state)}")
    system.state = {c: _load(v, arrays[f"state/{c}"], f"state/{c}")
                    for c, v in system.state.items()}
    for f in DEVICE_FIELDS:
        setattr(system, f, _load(getattr(system, f), arrays[f], f))
    generation = np.asarray(arrays["host/generation"], np.int64)
    if generation.shape != system._generation.shape:
        raise ValueError("carry field 'host/generation' does not match the "
                         "system's capacity")
    with system._lock:
        system._next_row = int(arrays["host/next_row"])
        system._free_rows = [int(i) for i in
                             np.asarray(arrays["host/free_rows"]).ravel()]
        system._generation = generation.copy()
    system._host_step = int(arrays["host/step"])
