"""Checkpoint/resume of the batched runtime: snapshot the SoA slabs.

Port of `akka_tpu/persistence/slab_snapshot.py`, in its flat `.npz` layout
at schema v3, so either package loads the other's snapshot:

    schema_version          int64 scalar (absent = v1)
    state.<col>             every state column, [capacity, ...]
    behavior_id, alive, step_count, inbox_dst, inbox_type,
    inbox_payload, inbox_valid                        (v1)
    mail_dropped, sup_counts, attention, dropped      (v2; `dropped` on the
                                                       sharded system only)
    metrics, inbox_enq                                (v3; a zero-size
                                                       inbox_enq is omitted)

The loader accepts v1/v2 snapshots and zero-fills (state columns: with
`reserved_fill`) every live slab the snapshot does not carry, so the
restored state is a function of the snapshot alone, never of the target's
pre-restore values; the derived telemetry (`attention`, `metrics`,
`inbox_enq`) zero-fills on a shape mismatch too. A snapshot newer than v3
is refused.

The reference writes an orbax directory whenever orbax imports (a JAX
library); the port writes and reads `.npz` only. A save writes tmp +
fsync + os.replace, so a crash mid-save leaves the previous snapshot
intact. Restore writes each slab into the system's existing tensor
(`copy_`) wherever the shapes match, so whatever holds those tensors
keeps reading the live state; bfloat16 slabs are stored as float32
(numpy has no bfloat16).
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..batched.supervision import reserved_fill

SCHEMA_VERSION = 3

# v1: the core actor/inbox tensors
_SLAB_KEYS_V1 = ("behavior_id", "alive", "step_count", "inbox_dst",
                 "inbox_type", "inbox_payload", "inbox_valid")
# v2: supervision aggregates and the attention word; `dropped` exists on
# ShardedBatchedSystem only (getattr None skips it elsewhere)
_SLAB_KEYS_V2 = ("mail_dropped", "sup_counts", "attention", "dropped")
# v3: the telemetry plane (metric slab, per-row enqueue step)
_SLAB_KEYS_V3 = ("metrics", "inbox_enq")
_SLAB_KEYS = _SLAB_KEYS_V1 + _SLAB_KEYS_V2 + _SLAB_KEYS_V3

# derived telemetry, not source state: a layout change zero-fills instead
# of raising, and the next step repopulates it
_ZERO_FILL_ON_MISMATCH = ("attention", "metrics", "inbox_enq")

__all__ = ["SCHEMA_VERSION", "slab_pytree", "restore_slab_pytree",
           "restore_state_columns", "check_schema", "save_slabs",
           "save_slab_tree", "slab_path", "load_slab_tree",
           "restore_slabs",
           "latest_slab_path", "gc_slabs", "host_array", "write_slab"]


def host_array(t: torch.Tensor) -> np.ndarray:
    """Host numpy copy of a device tensor (bfloat16 as float32), never a
    view of it (the carry is updated in place)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.to("cpu", copy=True).numpy()


def write_slab(cur: torch.Tensor, arr) -> torch.Tensor:
    """Write host array `arr` into `cur` in place when the shapes match
    (returns `cur`); otherwise return a new tensor of cur's dtype and
    device (the caller rebinds)."""
    src = torch.from_numpy(np.require(np.asarray(arr),
                                      requirements=["C", "W"]))
    if tuple(src.shape) == tuple(cur.shape):
        cur.copy_(src)
        return cur
    return src.to(device=cur.device, dtype=cur.dtype)


def check_schema(tree: Dict[str, Any]) -> int:
    """The snapshot's schema version; raises on one newer than v3."""
    version = int(np.asarray(tree.get("schema_version", 1)))
    if version > SCHEMA_VERSION:
        raise ValueError(
            f"snapshot schema v{version} is newer than this runtime's "
            f"v{SCHEMA_VERSION}; upgrade the runtime to restore it")
    return version


def slab_pytree(system, gather=None) -> Dict[str, Any]:
    """The full device state of a BatchedSystem or ShardedBatchedSystem as
    a tree of host copies. Callers quiesce first (`block_until_ready()`);
    the systems' `checkpoint()` does. `gather` (a port addition) maps each
    slab to the one copied, before the copy: a ranked system's
    `global_tensor`, which gathers every rank's block."""
    g = gather if gather is not None else (lambda t: t)
    tree: Dict[str, Any] = {
        "schema_version": np.int64(SCHEMA_VERSION),
        "state": {k: host_array(g(v)) for k, v in system.state.items()}}
    for k in _SLAB_KEYS:
        v = getattr(system, k, None)
        # a zero-size slab (inbox_enq with metrics off) is omitted; the
        # restore path zero-fills an absent v3 key
        if v is not None and v.numel() != 0:
            tree[k] = host_array(g(v))
    return tree


def restore_state_columns(system, tree: Dict[str, Any]) -> None:
    """Write the snapshot's state columns into the system's, in place
    (shapes must match); a live column the snapshot lacks is re-armed
    with its `reserved_fill` (the v1 upgrade), and a snapshot column the
    target does not declare is skipped."""
    for col, arr in tree["state"].items():
        cur = system.state.get(col)
        if cur is None:
            continue  # column no longer in the target's schema
        if tuple(cur.shape) != tuple(np.shape(arr)):
            raise ValueError(
                f"slab shape mismatch for state[{col!r}]: "
                f"{tuple(np.shape(arr))} vs {tuple(cur.shape)}")
        write_slab(cur, arr)
    for col, cur in system.state.items():
        if col not in tree["state"]:
            cur.fill_(reserved_fill(col))


def restore_slab_pytree(system, tree: Dict[str, Any]) -> None:
    """Load a tree produced by slab_pytree back into `system` (shapes must
    match: same capacity, out_degree, payload schema and inbox layout).

    Snapshots without `schema_version` are v1. A live state column or
    v2/v3 slab the snapshot lacks is reset to its fill (`reserved_fill`
    for state columns, zeros otherwise). Snapshot columns the target does
    not declare are skipped."""
    check_schema(tree)
    restore_state_columns(system, tree)
    for k in _SLAB_KEYS:
        cur = getattr(system, k, None)
        if cur is None:
            continue  # a slab the target does not have (`dropped`)
        if k in tree:
            arr = tree[k]
            if tuple(cur.shape) != tuple(np.shape(arr)):
                if k in _ZERO_FILL_ON_MISMATCH:
                    # derived telemetry from another layout: zero it, the
                    # first restored step repacks it
                    cur.zero_()
                    continue
                raise ValueError(
                    f"slab shape mismatch for {k}: "
                    f"{tuple(np.shape(arr))} vs {tuple(cur.shape)}")
            write_slab(cur, arr)
        elif k in _SLAB_KEYS_V2 or k in _SLAB_KEYS_V3:
            cur.zero_()  # older snapshot: the aggregate never existed


def save_slabs(system, directory: str, step: Optional[int] = None) -> str:
    """Snapshot `system` under `directory`; returns the snapshot's path."""
    return save_slab_tree(slab_pytree(system), directory, step)


def slab_path(directory: str, step: int) -> str:
    """The path `save_slab_tree` writes the snapshot of `step` to."""
    return os.path.join(os.path.abspath(directory), f"slab-{int(step)}.npz")


def save_slab_tree(tree: Dict[str, Any], directory: str,
                   step: Optional[int] = None) -> str:
    """Write a host slab tree (`slab_pytree` output) as
    `<directory>/slab-<step>.npz`: tmp + fsync + os.replace."""
    final = slab_path(directory, step if step is not None
                      else int(tree["step_count"]))
    os.makedirs(directory, exist_ok=True)
    flat = {"schema_version": np.asarray(tree["schema_version"])}
    for col, arr in tree["state"].items():
        flat[f"state.{col}"] = np.asarray(arr)
    for k in _SLAB_KEYS:
        if k in tree:
            flat[k] = np.asarray(tree[k])
    tmp = final + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)
    return final


def load_slab_tree(path: str) -> Dict[str, Any]:
    """Read a `.npz` snapshot back as the host tree (no system needed; the
    re-sharding restore inspects shapes before placement)."""
    if not path.endswith(".npz"):
        raise ValueError(
            f"{path}: the port reads .npz snapshots only (an orbax "
            "directory is the JAX package's format)")
    with np.load(path) as data:
        tree: Dict[str, Any] = {"state": {}}
        for k in data.files:
            if k.startswith("state."):
                tree["state"][k[len("state."):]] = data[k]
            else:
                tree[k] = data[k]
    return tree


def restore_slabs(system, path: str) -> None:
    """Restore a snapshot written by save_slabs into `system`."""
    restore_slab_pytree(system, load_slab_tree(path))


def _slab_step(name: str) -> Optional[int]:
    if not name.startswith("slab-"):
        return None
    stem = name[len("slab-"):]
    stem = stem[:-4] if stem.endswith(".npz") else stem
    try:
        return int(stem)
    except ValueError:
        return None


def latest_slab_path(directory: str) -> Optional[str]:
    """The newest `slab-<step>` snapshot under `directory`, or None."""
    if not os.path.isdir(directory):
        return None
    best, best_step = None, -1
    for name in os.listdir(directory):
        step = _slab_step(name)
        if step is not None and step > best_step:
            best, best_step = os.path.join(directory, name), step
    return best


def gc_slabs(directory: str, keep: int) -> int:
    """Delete all but the `keep` newest snapshots in `directory` (files,
    or the reference's orbax directories). Returns how many were removed."""
    if keep <= 0 or not os.path.isdir(directory):
        return 0
    entries = []
    for name in os.listdir(directory):
        step = _slab_step(name)
        if step is not None:
            entries.append((step, name))
    entries.sort(reverse=True)
    removed = 0
    for _step, name in entries[keep:]:
        full = os.path.join(directory, name)
        try:
            if os.path.isdir(full):
                shutil.rmtree(full)
            else:
                os.remove(full)
            removed += 1
        except OSError:
            pass  # concurrent GC / permissions: the stale snapshot stays
    return removed
