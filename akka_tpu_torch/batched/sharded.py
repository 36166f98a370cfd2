"""ShardedBatchedSystem: the actor space split into shards on one card,
or over the ranks of a process group.

Port of `akka_tpu/batched/sharded.py`. The reference shards the actor rows
over a device mesh (`shard_map`) and moves every cross-shard tell through a
per-step `lax.all_to_all` of a [D, C] exchange buffer. Here the D shards
are a leading axis of the same tensors on one card, and each step runs over
all shards at once (one launch per op, not one per shard):

1. Deliver: ONE `deliver`/`deliver_slots` call over the flat
   [D * m_local] inbox with global recipient ids. Rows addressed outside
   their own shard's id range are masked invalid first: the reference's
   per-shard call ignores (and does not count) such rows, and every row for
   a recipient lies in its own shard's block in the same relative order, so
   arrival order and every integer output equal those of D local calls.
   This call launches the ring-mailbox kernels (K1 in reduce mode, K2 with
   bounded slots). Spill is compacted per shard (`spill_cap` rows each).
2. Behaviors run over all rows with global actor ids (`StepCore`); the
   counters the step keeps (mailbox drops, supervision counts, the metric
   slab, the attention word) are per shard.
3. Bucketing: one stable rank (`stable_ranks`; `exchange_uses_ranked`)
   over src_shard * (D + 1) + dest_shard, invalid rows at dest = D, so each
   (source, destination) pair keeps its rows in emission order; rows past
   the per-pair capacity C are dropped and counted per source shard.
4. Exchange: scatter into buf[D_src, D_dst, C]; `buf.transpose(0, 1)`
   hands each destination its chunks in source-shard order, as
   `lax.all_to_all(..., tiled=False)` does, landing at offset spill_cap of
   the destination's inbox block. Per-sender FIFO survives.

Every carry field keeps the reference's flat global layout, so one numpy
carry loads into either package (`utils/carry.py`): state columns
[capacity, ...]; the inbox [D * m_local] with each shard's block laid out
[spill | D * pair_cap | host]; dropped and mail_dropped [D]; sup_counts
[D, N_COUNTERS]; metrics [D, N_HIST, N_BUCKETS]; attention [D, ATT_WORDS].

Every carried tensor keeps its storage across steps (the reference
donates its carry to its jitted program): the step writes the new inbox,
state columns, counters and attention words into them, and the host-side
mutators write in place too. The inbox has one set of tensors per pair
capacity (the steady one and the hand-off window's wider one): entering
and leaving stray mode copies the in-flight rows from one set into the
other.

On a card `run(n)` flushes the staged tells and replays the step's CUDA
graph n times (batched/graphs.py; the reference's `multi_step` scan). The
graphs are keyed on what the reference's jit is keyed on, the pair
capacity and stray mode: the steady graph is captured at the first `run`
(or by `warmup()`), the stray graph at the first run of a hand-off window,
and both are kept, so a later rebalance captures nothing; a re-sharded
restore drops both. On the CPU the same in-place step runs eagerly.

Durability is the reference's: a `tell_journal` WAL, `checkpoint`, and
`restore`/`restore_tree`, which write a snapshot of the same layout into
the live tensors and re-shard one taken at another shard count (or in the
hand-off window's wider inbox) through `_restore_resharded`; both
re-arm the metrics epoch (the slab's running sum, a carried int32 scalar
every step writes in place) from the restored slab, so
`drain_metrics()` hands the restored slab over once.

`mesh=` takes a mesh of shard slots (parallel/mesh.py): the shard count
is its size. Failover and re-sharding (batched/sentinel.py, the region's
`failover`) rebuild a system on fewer or more slots of one card.

Ranks. Over a mesh that carries a process group of W ranks, the system is
the reference's SPMD program: each rank allocates only its own block of
L = D / W shards (rows [r * L * local_n, (r + 1) * L * local_n), inbox
and per-shard counters likewise), and every rank makes the same calls:
spawns, tells and `set_tables` write only the rows of the rank's block.
The step is the one above over the rank's L shards, with global actor
ids; the bucketing stays global (`dest` is a global shard), and the
exchange is one `all_to_all_single` over the group per column: the
rank's buffer [L_src, D_dst, C] is scattered in [W, L_src, L_dst, C]
order, exchanged, and the received [W_src, L_src, L_dst, C] lands as the
exchange rows [L_dst, D_src, C], in the source order of the transpose
above, so every integer output is bit-identical to the one-card
system's. On a ranked mesh the exchange always goes through the
collective, even at W = 1. Every host read is a collective and gives the
global answer on every rank (`read_state`, the counters, the attention
words, the metric slab, `exit_stray_mode`'s test); `checkpoint` gathers
the global tree and rank 0 writes it, and `restore` reads it on every
rank, each keeping its own block, from any shard count or world size.
Over NCCL the step, collectives included, is captured as a CUDA graph
as above (a failed capture raises); a gloo group cannot be captured, so
there `run()` takes eager steps.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..event.flight_recorder import trace_span
from ..ops.segment import exchange_uses_ranked, stable_ranks
from ..parallel.mesh import make_mesh, mesh_of
from ..utils.device import resolve_device
from . import graphs
from .behavior import BatchedBehavior
from .core import _numpy_dtype, drive_pipelined, host_to_device
from .metrics_slab import (ASK_ARM_COL, ASK_ARM_SPEC, accumulate_step,
                           empty_slab, slab_dict, slab_epoch)
from .step import (StepCore, fault_clear_failed, fault_restart_rows,
                   write_back)
from .supervision import (ATT_WORDS, N_COUNTERS, SUP_COLUMNS, counts_dict,
                          decode_attention, reserved_fill)

# the inbox tensors (one set per pair capacity) and their empty-row fill
INBOX_FILL = {"inbox_dst": -1, "inbox_type": 0, "inbox_payload": 0,
              "inbox_valid": False, "inbox_enq": 0}
# the carried tensors besides the state columns (graphs.shadow_of clones
# them for the warm-up)
CARRY = ("behavior_id", "alive", "step_count", "dropped", "mail_dropped",
         "sup_counts", "metrics", "metrics_epoch", "attention", *INBOX_FILL)


def _mesh_layout(mesh, axis_name: str, n_devices, device):
    """The shard count and card of a system built on `mesh`: a 1-D mesh
    over `axis_name`, whose slots of this rank lie on one card
    (Mesh.device raises otherwise); `n_devices` and `device`, if given,
    must agree with it."""
    if tuple(mesh.axis_names) != (axis_name,):
        raise ValueError(f"the system shards over a 1-D mesh with axis "
                         f"{axis_name!r}, got axes {mesh.axis_names}")
    card = mesh.device
    d = mesh.shape[axis_name]
    if n_devices is not None and int(n_devices) != d:
        raise ValueError(f"n_devices={n_devices} but the mesh has {d} "
                         f"slots")
    if device is not None:
        asked = torch.device(device)
        if asked.type != card.type or (asked.index is not None
                                       and asked.index != card.index):
            raise ValueError(f"device={asked} but the mesh lies on {card}")
    return d, card


class ShardedBatchedSystem:
    """Batched actor space over `n_devices` shards on one card, or over a
    process group's ranks.

    capacity rounds up to a multiple of the shard count; shard s owns rows
    [s * local_n, (s + 1) * local_n). remote_capacity_per_pair C bounds
    the rows one shard sends another per step (default: lossless,
    local_n * out_degree); host_inbox_per_shard rows per shard take host
    tells. mailbox_slots, spill_capacity, delivery, delivery_backend,
    attention_latch_col and metrics_enabled are BatchedSystem's.
    reroute_strays allows the hand-off step (`enter_stray_mode`), which
    forwards inbox rows addressed outside their shard one more hop.
    n_devices keeps the reference's name: it is the shard count (default
    1, or the mesh's size). mesh is a mesh of shard slots
    (parallel/mesh.py) or a placement on one: of one card, or over a
    process group's ranks (the module docstring's "Ranks"; each rank
    holds `local_shards` of the shards). device defaults to the mesh's
    card (this rank's), else CUDA, and raises without a card unless
    device="cpu" is passed. On a card every step is a replay of the
    step's CUDA graph, except over a gloo group, where steps are eager.
    """

    def __init__(self, capacity: int, behaviors: Sequence[BatchedBehavior],
                 mesh: Any = None, n_devices: Optional[int] = None,
                 payload_width: int = 4, out_degree: int = 1,
                 host_inbox_per_shard: int = 256,
                 remote_capacity_per_pair: Optional[int] = None,
                 payload_dtype=torch.float32, axis_name: str = "shards",
                 mailbox_slots: int = 0, reroute_strays: bool = False,
                 spill_capacity: Optional[int] = None,
                 delivery: str = "auto",
                 delivery_backend: Optional[str] = None,
                 attention_latch_col: Optional[str] = None,
                 metrics_enabled: bool = False, device=None):
        if mesh is not None:
            mesh = mesh_of(mesh)
            n_devices, device = _mesh_layout(mesh, axis_name, n_devices,
                                             device)
        self.device = dev = resolve_device(device)
        exchange_uses_ranked(dev.type, delivery_backend)  # validates it
        self.axis = axis_name
        self.n_shards = d = int(n_devices) if n_devices is not None else 1
        if d < 1:
            raise ValueError(f"n_devices must be >= 1, got {n_devices}")
        self.mesh = mesh if mesh is not None else \
            make_mesh(d, axis_name, device=dev)
        # this rank's block of the shard axis (all of it without a group)
        self.ranks = self.mesh.ranks
        self.local_shards = ls = d // self.mesh.world_size
        self.shard0 = self.mesh.rank * ls
        if capacity % d != 0:
            capacity += d - capacity % d
        self.capacity = n = int(capacity)
        self.local_n = n // d
        self.row_lo = self.shard0 * self.local_n
        self.n_rows = nr = ls * self.local_n   # rows of this rank's block
        self.behaviors = list(behaviors)
        self.payload_width = int(payload_width)
        self.out_degree = int(out_degree)
        self.host_inbox = int(host_inbox_per_shard)
        self.payload_dtype = payload_dtype
        self.mailbox_slots = int(mailbox_slots)
        if self.mailbox_slots == 0 and any(b.inbox == "slots"
                                           for b in behaviors):
            self.mailbox_slots = max(2, self.out_degree)
        # per-shard spill region (slots mode): overflow and suspended-row
        # mail are retained and redelivered ahead of fresh traffic
        if self.mailbox_slots > 0:
            self.spill_cap = (int(spill_capacity)
                              if spill_capacity is not None
                              else max(self.host_inbox,
                                       4 * self.mailbox_slots))
        else:
            self.spill_cap = 0
        self.reroute_strays = bool(reroute_strays)
        self.stray_mode = False
        self.delivery_backend = delivery_backend
        # lossless by default; stray mode doubles the pair capacity unless
        # the caller fixed it (overflow is counted in `dropped` either way)
        if remote_capacity_per_pair:
            self.pair_cap_base = int(remote_capacity_per_pair)
            self.pair_cap_stray = int(remote_capacity_per_pair)
        else:
            self.pair_cap_base = self.local_n * self.out_degree
            self.pair_cap_stray = 2 * self.pair_cap_base
        self.pair_cap = self.pair_cap_base

        self.state_spec: Dict[str, Tuple[Tuple[int, ...], Any]] = {}
        for b in self.behaviors:
            for col, spec in b.state_spec.items():
                spec = (tuple(spec[0]), spec[1])
                if col in self.state_spec and self.state_spec[col] != spec:
                    raise ValueError(f"conflicting column {col!r}")
                self.state_spec[col] = spec
        if any(getattr(b, "supervisor", None) is not None for b in behaviors):
            for col, spec in SUP_COLUMNS.items():
                self.state_spec.setdefault(col, spec)
        elif any(getattr(b, "nonfinite_guard", False) for b in behaviors):
            self.state_spec.setdefault("_failed", SUP_COLUMNS["_failed"])
        self.metrics_on = bool(metrics_enabled)
        if self.metrics_on and attention_latch_col is not None:
            self.state_spec.setdefault(ASK_ARM_COL, ASK_ARM_SPEC)

        i32 = torch.int32
        self.state: Dict[str, torch.Tensor] = {
            k: torch.full((nr,) + shape, reserved_fill(k), dtype=dtype,
                          device=dev)
            for k, (shape, dtype) in self.state_spec.items()}
        self.behavior_id = torch.zeros((nr,), dtype=i32, device=dev)
        self.alive = torch.zeros((nr,), dtype=torch.bool, device=dev)
        self.step_count = torch.zeros((), dtype=i32, device=dev)

        # inbox per shard: spill first (older mail outranks fresh in the
        # stable delivery), then D * C exchange rows, then host rows; one
        # set of tensors per pair capacity, kept (the graphs hold them)
        self.m_local = self.spill_cap + d * self.pair_cap + self.host_inbox
        self._inboxes: Dict[int, Dict[str, torch.Tensor]] = {}
        for name, t in self._inbox_set(self.pair_cap).items():
            setattr(self, name, t)
        self.dropped = torch.zeros((ls,), dtype=i32, device=dev)
        self.mail_dropped = torch.zeros((ls,), dtype=i32, device=dev)
        self.sup_counts = torch.zeros((ls, N_COUNTERS), dtype=i32,
                                      device=dev)
        self.metrics = empty_slab(ls, device=dev)
        # the metrics epoch: the slab's running sum over every shard,
        # written in place by every run (0 while metrics are off)
        self.metrics_epoch = torch.zeros((), dtype=i32, device=dev)
        self._metrics_seen_epoch = 0
        self.attention = torch.zeros((ls, ATT_WORDS), dtype=i32, device=dev)
        # cumulative per-shard overflow already reported through the
        # flight recorder's shard_overflow warning (read_attention)
        self._overflow_reported = np.zeros((d, 2), np.int64)
        # optional flight recorder (event/flight_recorder.py SPI):
        # device_flush/device_step from run() and shard_overflow from
        # read_attention; None = no cost
        self.flight_recorder = None

        self._next_row = 0
        self._lock = threading.Lock()
        self._host_staged: List[Tuple[int, int, np.ndarray]] = []
        # host rows the staged tells take in the next flush, by shard
        self._host_rows: Dict[int, int] = {}
        self._host_step = 0
        # the step's CUDA graphs on a card, keyed (pair_cap, stray_mode);
        # the eager step on the CPU, over a gloo group (which a graph
        # cannot capture), and in a comparison's eager twin, which sets
        # _eager itself
        self._eager = dev.type != "cuda" or (
            self.ranks is not None and self.ranks.backend != "nccl")
        self._graphs = graphs.GraphSet(dev, "ShardedBatchedSystem")
        # write-ahead tell journal (persistence/tell_journal.py); None = off
        self.tell_journal = None
        self._np_payload_dtype = _numpy_dtype(payload_dtype)
        # small lookup tables behaviors see as ctx.tables
        self.tables: Dict[str, torch.Tensor] = {}

        self._core = StepCore(self.behaviors, n_local=nr,
                              payload_width=self.payload_width,
                              out_degree=self.out_degree,
                              payload_dtype=payload_dtype,
                              slots=self.mailbox_slots, n_global=n,
                              delivery=delivery,
                              delivery_backend=delivery_backend,
                              spill_cap=self.spill_cap,
                              attention_latch_col=attention_latch_col,
                              device=dev, n_shards=ls)
        local = torch.arange(ls, dtype=i32, device=dev)[:, None]
        self._bases = (local + self.shard0) * self.local_n  # [L, 1] ids
        self._src_key = local * (d + 1)                 # [L, 1] rank keys
        self._src_local = local.long()                  # [L, 1]
        self._src_pair = self._src_local * d            # [L, 1] buf rows

    def _inbox_set(self, pair_cap: int) -> Dict[str, torch.Tensor]:
        """The inbox tensors of the layout with per-pair capacity
        `pair_cap`, allocated (empty) at first use and kept."""
        got = self._inboxes.get(pair_cap)
        if got is None:
            d, dev = self.n_shards, self.device
            m = self.local_shards * (self.spill_cap + d * pair_cap
                                     + self.host_inbox)
            got = self._inboxes[pair_cap] = {
                "inbox_dst": torch.full((m,), -1, dtype=torch.int32,
                                        device=dev),
                "inbox_type": torch.zeros((m,), dtype=torch.int32,
                                          device=dev),
                "inbox_payload": torch.zeros((m, self.payload_width),
                                             dtype=self.payload_dtype,
                                             device=dev),
                "inbox_valid": torch.zeros((m,), dtype=torch.bool,
                                           device=dev),
                "inbox_enq": torch.zeros((m,) if self.metrics_on else (0,),
                                         dtype=torch.int32, device=dev)}
        return got

    # ------------------------------------------------------------- lifecycle
    def spawn_block(self, behavior: BatchedBehavior | int, n: int,
                    init_state: Optional[Dict[str, Any]] = None
                    ) -> np.ndarray:
        """Allocate n contiguous rows with the given behavior (no free
        list: rebalancing owns row placement). init_state values are
        per-row ([n, ...]) or broadcast. Returns the global ids."""
        b_idx = behavior if isinstance(behavior, int) \
            else self.behaviors.index(behavior)
        with self._lock:
            start = self._next_row
            if start + n > self.capacity:
                raise RuntimeError("actor capacity exhausted")
            self._next_row = start + n
        rows = slice(start, start + n)
        self.set_rows(self.behavior_id, rows, b_idx)
        self.set_rows(self.alive, rows, True)
        for col, value in (init_state or {}).items():
            self.set_rows(self.state[col], rows, value)
        return np.arange(start, start + n, dtype=np.int32)

    # ------------------------------------------------------- rows and ranks
    def _own(self, rows) -> Tuple[Any, Any]:
        """This rank's part of global rows `rows` (a slice or ids): the
        local index (a slice, or an int64 array) and, for ids, the mask
        of the ids kept (None for a slice)."""
        lo, hi = self.row_lo, self.row_lo + self.n_rows
        if isinstance(rows, slice):
            start, stop, _ = rows.indices(self.capacity)
            a, b = max(start, lo), min(stop, hi)
            return slice(a - lo, max(a, b) - lo), slice(a - start,
                                                        max(a, b) - start)
        ids = np.atleast_1d(np.asarray(rows, np.int64))
        keep = (ids >= lo) & (ids < hi)
        return ids[keep] - lo, keep

    def set_rows(self, t: torch.Tensor, rows, value) -> None:
        """`t[rows] = value` for global rows `rows` (a slice or ids) of a
        row tensor (a state column, `behavior_id`, `alive`): `value` is
        broadcast, or one per row when it has `t`'s number of dimensions.
        On a ranked mesh only the rows of this rank's block are written."""
        v = torch.as_tensor(value, dtype=t.dtype, device=t.device)
        if self.ranks is None:
            t[rows if isinstance(rows, slice) else torch.as_tensor(
                np.asarray(rows, np.int64), device=t.device)] = v
            return
        local, keep = self._own(rows)
        per_row = v.dim() == t.dim()
        if isinstance(local, slice):
            t[local] = v[keep] if per_row else v
        elif local.size:
            t[torch.as_tensor(local, device=t.device)] = \
                v[torch.as_tensor(keep, device=t.device)] if per_row else v

    def global_tensor(self, t: torch.Tensor) -> torch.Tensor:
        """The global tensor of one of this system's carried tensors: on
        a ranked mesh every rank's block concatenated (a collective:
        every rank calls it alike), else `t`. Scalars are replicated."""
        if self.ranks is None or t.dim() == 0 or t.numel() == 0:
            return t
        return self.ranks.all_gather(t)

    def local_block(self, arr, t: torch.Tensor):
        """This rank's block of a global array for carried tensor `t`
        (its rows r * len(t) .. (r + 1) * len(t)), or `arr` itself without
        a group, for a scalar, or when `arr` is not W blocks of `t`."""
        arr = np.asarray(arr)
        w = self.mesh.world_size
        if self.ranks is None or t.dim() == 0 or arr.ndim == 0 or \
                arr.shape[0] != w * t.shape[0]:
            return arr
        k = t.shape[0]
        return arr[self.mesh.rank * k:(self.mesh.rank + 1) * k]

    def rows_of(self, t: torch.Tensor, rows) -> torch.Tensor:
        """Global rows `rows` (a slice or ids) of a row tensor, on the
        device. On a ranked mesh (a collective) each rank fills the rows
        it holds into zeros and one all_reduce sums the bytes: exactly one
        rank's bytes are not zero, so the sum is that rank's value, bit
        for bit, in any dtype."""
        if self.ranks is None:
            return t[rows if isinstance(rows, slice) else torch.as_tensor(
                np.asarray(rows, np.int64), device=t.device)]
        local, keep = self._own(rows)
        if isinstance(rows, slice):
            n = len(range(*rows.indices(self.capacity)))
        else:
            n = keep.shape[0]
            local = torch.as_tensor(local, device=t.device)
            keep = torch.as_tensor(keep, device=t.device)
        out = torch.zeros((n,) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        out[keep] = t[local]
        if out.numel():
            self.ranks.all_reduce(out.view(-1).view(torch.uint8), "sum")
        return out

    def read_promise_block(self, base: int, n: int, replied_col: str,
                           reply_col: Optional[str] = None):
        """bridge.read_promise_block over this system's global rows
        [base, base + n): `(replied, replies)` host copies."""
        from ..persistence.slab_snapshot import host_array
        rows = slice(base, base + n)
        replied = host_array(self.rows_of(self.state[replied_col], rows))
        if reply_col is None:
            return replied, None
        return replied, host_array(self.rows_of(self.state[reply_col], rows))

    def barrier(self) -> None:
        """Return once every rank has reached this call (a no-op without
        a group)."""
        if self.ranks is not None:
            self.ranks.barrier(self.device)

    def move_rows(self, src: slice, dst: slice) -> None:
        """Copy the rows `src` (state columns, behavior ids, alive flags)
        to the rows `dst` of the same length, across ranks on a ranked
        mesh (a collective)."""
        for t in (*self.state.values(), self.behavior_id, self.alive):
            self.set_rows(t, dst, self.rows_of(t, src))

    def tell(self, dst: int, payload, mtype: int = 0) -> None:
        """Host-side tell to one actor: staged, flushed into its shard's
        host rows by the next run()."""
        self._stage(dst, payload, mtype, bounded=False)

    def try_tell(self, dst: int, payload, mtype: int = 0) -> bool:
        """tell(), unless the next flush has no host row left in `dst`'s
        shard (it holds `host_inbox` of them and skips tells past that):
        then nothing is staged or journaled, and False. The room is
        checked, journaled and taken under the staging lock."""
        return self._stage(dst, payload, mtype, bounded=True)

    def _stage(self, dst, payload, mtype, bounded: bool) -> bool:
        pl = np.zeros(self.payload_width, dtype=self._np_payload_dtype)
        arr = np.asarray(payload).reshape(-1)
        pl[: arr.shape[0]] = arr
        # an int, or the one-row array a replayed WAL record holds
        dst, mtype = int(np.asarray(dst).item()), int(np.asarray(mtype).item())
        # the shard whose host row the tell takes in the flush, if any
        s = dst // self.local_n if 0 <= dst < self.capacity else None
        journal = self.tell_journal
        if journal is not None and not bounded:
            # WAL: the normalized row, before it is staged
            journal.append(self._host_step, "tell", dst, pl, mtype)
            journal = None
        with self._lock:
            if bounded and s is not None \
                    and self._host_rows.get(s, 0) >= self.host_inbox:
                return False
            if journal is not None:  # try_tell: once the row is taken
                journal.append(self._host_step, "tell", dst, pl, mtype)
            self._host_staged.append((dst, mtype, pl))
            if s is not None:
                self._host_rows[s] = self._host_rows.get(s, 0) + 1
        return True

    def _flush_staged(self) -> None:
        """Write staged tells into each destination shard's host rows, in
        staging order. Tells past a shard's host_inbox are skipped (not
        counted), as in the reference; so are tells addressed outside
        [0, capacity)."""
        with self._lock:
            staged, self._host_staged = self._host_staged, []
            self._host_rows = {}
        if not staged:
            return
        used: Dict[int, int] = {}
        host0 = self.spill_cap + self.n_shards * self.pair_cap
        idxs, dsts, mts, pls = [], [], [], []
        for d, t, p in staged:
            if not 0 <= d < self.capacity:
                continue
            s = d // self.local_n
            u = used.get(s, 0)
            if u >= self.host_inbox:
                continue
            used[s] = u + 1
            s -= self.shard0
            if not 0 <= s < self.local_shards:
                continue  # another rank's shard: that rank writes it
            idxs.append(s * self.m_local + host0 + u)
            dsts.append(d)
            mts.append(t)
            pls.append(p)
        if not idxs:
            return
        if self.flight_recorder is not None:
            self.flight_recorder.device_flush("sharded", len(idxs))
        # through fresh pinned blocks: no wait for the steps in flight
        dev = self.device
        idx = host_to_device(np.asarray(idxs, np.int64), dev)
        self.inbox_dst[idx] = host_to_device(np.asarray(dsts, np.int32), dev)
        self.inbox_type[idx] = host_to_device(np.asarray(mts, np.int32), dev)
        self.inbox_payload[idx] = host_to_device(np.stack(pls), dev).to(
            self.payload_dtype)
        self.inbox_valid[idx] = True
        if self.metrics_on:
            # stamped with the dispatched-step mirror: the next step
            # delivers them (sojourn age 0)
            self.inbox_enq[idx] = self._host_step

    def set_tables(self, tables: Dict[str, Any]) -> None:
        """Install or replace the lookup tables behaviors see via
        ctx.tables. Tables of the installed names, shapes and dtypes are
        written in place (the step's graphs read them); any other set
        replaces them, and the graphs with them."""
        new = {k: torch.as_tensor(v, device=self.device)
               for k, v in tables.items()}
        cur = self.tables
        if new.keys() == cur.keys() and all(
                v.shape == cur[k].shape and v.dtype == cur[k].dtype
                for k, v in new.items()):
            for k, v in new.items():
                cur[k].copy_(v)
            return
        self.tables = new
        self._graphs.clear()

    # ------------------------------------------------------- stray handoff
    def _relayout_inbox(self, new_pair_cap: int) -> None:
        """Move the inbox into the tensors of another per-pair capacity.
        Each shard's block is [spill | D * pair_cap | host]; received rows
        sit packed at the start of their pair chunk, so growing pads each
        chunk's tail and shrinking slices it (the caller has checked the
        tail is empty)."""
        if new_pair_cap == self.pair_cap:
            return
        d, ls, sc = self.n_shards, self.local_shards, self.spill_cap
        old_pc, old_ml = self.pair_cap, self.m_local
        new_ml = sc + d * new_pair_cap + self.host_inbox

        def regrid(arr, fill):
            tail = tuple(arr.shape[1:])
            v = arr.reshape((ls, old_ml) + tail)
            pairs = v[:, sc:sc + d * old_pc].reshape((ls, d, old_pc) + tail)
            if new_pair_cap > old_pc:
                pad = torch.full((ls, d, new_pair_cap - old_pc) + tail, fill,
                                 dtype=arr.dtype, device=arr.device)
                pairs = torch.cat([pairs, pad], 2)
            else:
                pairs = pairs[:, :, :new_pair_cap]
            out = torch.cat([v[:, :sc],
                             pairs.reshape((ls, d * new_pair_cap) + tail),
                             v[:, sc + d * old_pc:]], 1)
            return out.reshape((ls * new_ml,) + tail).contiguous()

        target = self._inbox_set(new_pair_cap)
        for name, fill in INBOX_FILL.items():
            cur = getattr(self, name)
            if cur.numel():  # inbox_enq is empty with metrics off
                target[name].copy_(regrid(cur, fill))
            setattr(self, name, target[name])
        self.pair_cap = new_pair_cap
        self.m_local = new_ml

    def enter_stray_mode(self) -> None:
        """Switch to the hand-off step: the stray-pair capacity, and inbox
        rows addressed outside their shard ride the next exchange. Call at
        rebalance; exit once drained. On a ranked mesh every rank calls it
        alike."""
        if not self.reroute_strays:
            raise RuntimeError(
                "system built with reroute_strays=False has no stray step")
        if self.stray_mode:
            return
        self._relayout_inbox(self.pair_cap_stray)
        self.stray_mode = True

    def exit_stray_mode(self) -> bool:
        """Back to the steady-state step once it is safe: no stray row is
        left in the inbox, and no pair chunk holds rows past the base
        capacity. Both reduce on the device; two booleans come back (on a
        ranked mesh OR-ed over every rank by one all_reduce, so every rank
        takes the same branch). Returns False, staying in stray mode,
        while either holds."""
        if not self.stray_mode:
            return True
        d, ls = self.n_shards, self.local_shards
        sc, pc = self.spill_cap, self.pair_cap
        valid = self.inbox_valid.reshape(ls, self.m_local)
        dst = self.inbox_dst.reshape(ls, self.m_local)
        has_stray = (valid & ((dst < self._bases)
                              | (dst >= self._bases + self.local_n))).any()
        tail = valid[:, sc:sc + d * pc].reshape(ls, d, pc)[
            :, :, self.pair_cap_base:].any()
        has_stray, tail = self._any(torch.stack([has_stray, tail])).tolist()
        if has_stray or tail:
            return False
        self._relayout_inbox(self.pair_cap_base)
        self.stray_mode = False
        return True

    # ------------------------------------------------------------------ step
    def _step_impl(self) -> None:
        """One step over this rank's shards (every shard without a
        group): deliver, behaviors, bucket, exchange, and the new carry
        written in place (the body of the step's CUDA graph, with
        `_attend`)."""
        d, ls, ln = self.n_shards, self.local_shards, self.local_n
        sc, c, ml = self.spill_cap, self.pair_cap, self.m_local
        p = self.payload_width
        core = self._core
        state, old_alive, step = self.state, self.alive, self.step_count
        ib_dst = self.inbox_dst.view(ls, ml)
        ib_valid = self.inbox_valid.view(ls, ml)
        home = (ib_dst >= self._bases) & (ib_dst < self._bases + ln)
        own = (ib_valid & home).reshape(-1)
        lo = self.row_lo or None  # global ids <-> this rank's rows
        (new_state, behavior_id, alive, emits, mdrop, spill, sup_delta,
         dcount) = core.run_local(
            state, self.behavior_id, self.alive, self.inbox_dst,
            self.inbox_type, self.inbox_payload, own, step,
            dst_offset=lo, id_base=self.row_lo, tables=self.tables)
        if self.metrics_on:
            # this step's inputs: the inbox just delivered (strays
            # included) and its enqueue stamps
            self.metrics.copy_(accumulate_step(
                self.metrics, state, new_state, old_alive, dcount,
                self.inbox_valid, self.inbox_enq, step,
                latch_col=core.attention_latch_col, n_shards=ls))

        # ---- bucket by destination shard, per source shard -------------
        out_dst = emits.dst.reshape(ls, -1)
        out_pl = emits.payload.reshape(ls, -1, p).to(self.payload_dtype)
        out_type = emits.type.reshape(ls, -1)
        out_valid = emits.valid.reshape(ls, -1) & (out_dst >= 0) \
            & (out_dst < self.capacity)
        if self.stray_mode:
            # inbox rows addressed outside their shard ride first (they
            # are older; the rank is stable)
            stray = ib_valid & (ib_dst >= 0) & ~home
            out_dst = torch.cat([torch.where(stray, ib_dst, -1), out_dst], 1)
            out_pl = torch.cat([self.inbox_payload.view(ls, ml, p), out_pl],
                               1)
            out_type = torch.cat([self.inbox_type.view(ls, ml), out_type], 1)
            out_valid = torch.cat([stray, out_valid], 1)
        dest = torch.where(
            out_valid, torch.div(out_dst, ln, rounding_mode="floor")
            .clamp(max=d), d)
        rank, _ = stable_ranks((self._src_key + dest).reshape(-1),
                               ls * (d + 1))
        rank = rank.reshape(dest.shape)
        in_cap = out_valid & (rank < c) & (dest < d)
        total = ls * d * c
        if self.ranks is None:
            pair = self._src_pair + dest                # [D_src, D_dst]
        else:
            # the send buffer's [W, L_src, L_dst] order: chunk w is rank
            # w's, without a copy before the collective
            pair = (torch.div(dest, ls, rounding_mode="floor") * ls
                    + self._src_local) * ls + dest % ls
        slot = torch.where(in_cap, pair * c + rank,
                           total).reshape(-1)   # overflow -> the dump row
        self.dropped.add_((out_valid & ~in_cap).sum(1, dtype=torch.int32))

        def exchange(target, fill, rows) -> None:
            """Scatter into the exchange buffer, then the all_to_all into
            target [L_dst, D_src, C] (its exchange rows), chunks in
            source-shard order. One card: buf[D_src, D_dst, C] and its
            transpose. Ranks: buf[W, L_src, L_dst, C] through one
            all_to_all_single; the received [W_src, L_src, L_dst, C] is
            permuted into place."""
            tail = tuple(rows.shape[2:])
            buf = torch.full((total + 1,) + tail, fill, dtype=target.dtype,
                             device=self.device)
            buf[slot] = rows.reshape((-1,) + tail)
            if self.ranks is None:
                target.copy_(buf[:total].view((d, d, c) + tail)
                             .transpose(0, 1))
                return
            w = self.mesh.world_size
            recv = torch.empty((total,) + tail, dtype=target.dtype,
                               device=self.device)
            self.ranks.all_to_all(recv, buf[:total])
            moved = recv.view((w, ls, ls, c) + tail).permute(
                2, 0, 1, *range(3, 4 + len(tail)))
            target.view((ls, w, ls, c) + tail).copy_(moved)

        r = d * c
        ib_pl = self.inbox_payload.view(ls, ml, p)
        ib_type = self.inbox_type.view(ls, ml)
        exchange(ib_dst[:, sc:sc + r].view(ls, d, c), -1,
                 torch.where(in_cap, out_dst, -1))
        exchange(ib_pl[:, sc:sc + r].view(ls, d, c, p), 0,
                 torch.where(in_cap[..., None], out_pl, 0))
        exchange(ib_valid[:, sc:sc + r].view(ls, d, c), False, in_cap)
        ib_dst[:, sc + r:] = -1
        ib_pl[:, sc + r:] = 0
        ib_valid[:, sc + r:] = False
        if self.mailbox_slots > 0:  # the type column is read in slots only
            exchange(ib_type[:, sc:sc + r].view(ls, d, c), 0,
                     torch.where(in_cap, out_type, 0))
            ib_type[:, sc + r:] = 0
        if spill is not None:  # spill is None iff sc == 0
            sp_dst, sp_type, sp_pl, sp_v = spill
            ib_dst[:, :sc] = sp_dst.view(ls, sc)
            ib_type[:, :sc] = sp_type.view(ls, sc)
            ib_pl[:, :sc] = sp_pl.view(ls, sc, p)
            ib_valid[:, :sc] = sp_v.view(ls, sc)
        if self.metrics_on:
            # received rows are re-stamped with this step's counter, and
            # so is retained spill
            enq = self.inbox_enq.view(ls, ml)
            enq[:, :sc + r] = step
            enq[:, sc + r:] = 0
        write_back(self.state, self.behavior_id, self.alive, new_state,
                   behavior_id, alive)
        self.mail_dropped.add_(mdrop)
        self.sup_counts.add_(sup_delta)
        self.step_count.add_(1)

    def _attend(self) -> None:
        """The words the host reads after a run, from the final carry: the
        attention words and, with metrics on, the metrics epoch."""
        self.attention.copy_(self._core.attention_word(
            self.state, self.mail_dropped, self.sup_counts, self.step_count,
            exch_dropped=self.dropped))
        if self.metrics_on:
            self.metrics_epoch.copy_(slab_epoch(self.metrics))

    def _graph_step(self) -> None:
        self._step_impl()
        self._attend()

    def _warm(self) -> None:
        """Eager warm-up steps over clones of the carry (the live carry is
        untouched): the current mode's step and, with reroute_strays, one
        step of the other mode, so that the stray graph's capture at the
        first rebalance finds every kernel loaded."""
        shadow = graphs.shadow_of(self, CARRY)
        shadow._inboxes = {self.pair_cap: {n: getattr(shadow, n)
                                           for n in INBOX_FILL}}
        graphs.warm(shadow._step_impl, self.device)
        if self.reroute_strays:
            other = not self.stray_mode
            shadow._relayout_inbox(self.pair_cap_stray if other
                                   else self.pair_cap_base)
            shadow.stray_mode = other
            graphs.warm(shadow._step_impl, self.device, steps=1)

    def _graph(self) -> graphs.StepGraph:
        return self._graphs.get((self.pair_cap, self.stray_mode),
                                self._graph_step, self._warm)

    def warmup(self) -> None:
        """Capture the current mode's step graph ahead of the first run:
        eager warm-up steps on a side stream over clones of the carry,
        then the capture (the live carry is untouched). A no-op on the CPU
        and once captured. Raises GraphCaptureError, naming the behavior,
        if a behavior cannot run inside the graph."""
        if not self._eager:
            self._graph()

    def run(self, n_steps: int = 1) -> None:
        """Flush staged tells, then n steps on the device without host
        syncs: n replays of the step's graph on a card, the eager step on
        the CPU; the attention words come from the final carry. With a
        flight recorder, the flush and the run emit device_flush and
        device_step (dispatch time), as BatchedSystem's do (the
        reference's sharded run emits neither)."""
        self._flush_staged()
        t0 = time.perf_counter()
        with trace_span(f"akka.device.sharded.run[{n_steps}]"):
            if not self._eager and n_steps > 0:
                self._graph().replay(n_steps)
            else:
                for _ in range(n_steps):
                    self._step_impl()
                self._attend()
        self._host_step += int(n_steps)
        fr = self.flight_recorder
        if fr is not None:
            fr.device_step("sharded", n_steps, time.perf_counter() - t0)

    step = run

    def run_pipelined(self, n_steps: int, depth: int = 2,
                      on_attention=None) -> None:
        """Single-step runs with up to `depth` in flight, synchronising on
        the attention words; with `on_attention`, every retired step's
        decoded words are delivered in order and the tail is drained."""
        cb = None
        if on_attention is not None:
            cb = lambda w: on_attention(decode_attention(w))  # noqa: E731
        drive_pipelined(lambda: self.run(1), self.attention_words,
                        n_steps, depth, on_drain=cb)

    def attention_words(self) -> torch.Tensor:
        """The newest attention words of every shard, [D, ATT_WORDS], on
        the device (on a ranked mesh gathered from every rank)."""
        return self.global_tensor(self.attention)

    def read_attention(self) -> Dict[str, Any]:
        """Decode the newest attention words (one small read that syncs the
        newest run), with per-shard columns (`*_per_shard`). A shard whose
        overflow counters grew since the last read raises one
        shard_overflow warning on the flight recorder, if one is set."""
        word = decode_attention(self.attention_words())
        self._note_shard_overflow(word)
        return word

    def _note_shard_overflow(self, word: Dict[str, Any]) -> None:
        fr = self.flight_recorder
        if fr is None:
            return
        mail = np.asarray(word.get("mail_dropped_per_shard", ()), np.int64)
        exch = np.asarray(word.get("dropped_per_shard", ()), np.int64)
        if mail.shape[0] != self.n_shards:
            return
        for s in range(self.n_shards):
            seen_mail, seen_exch = self._overflow_reported[s]
            if mail[s] > seen_mail or exch[s] > seen_exch:
                fr.shard_overflow("sharded", shard=s,
                                  mailbox_overflow=int(mail[s]),
                                  dropped=int(exch[s]))
                self._overflow_reported[s] = (int(mail[s]), int(exch[s]))

    # ------------------------------------------------------------------ read
    # On a ranked mesh every read below is a collective: every rank calls
    # it alike and gets the global answer.
    def read_state(self, col: str, ids=None) -> np.ndarray:
        """Host copy of one state column (rows `ids`, or all)."""
        self.block_until_ready()
        arr = self.state[col]
        arr = self.global_tensor(arr) if ids is None else \
            self.rows_of(arr, np.asarray(ids, np.int64))
        return arr.to("cpu", copy=True).numpy()  # not a view of the carry

    def _any(self, flags: torch.Tensor) -> torch.Tensor:
        """`flags` OR-ed over every rank (a collective), or as they are
        without a group."""
        return flags if self.ranks is None else self.ranks.any(flags)

    def any_failed(self) -> bool:
        return "_failed" in self.state and bool(
            self._any(self.state["_failed"].any()).item())

    def failed_rows(self) -> np.ndarray:
        """Rows whose behavior raised the `_failed` flag."""
        self.block_until_ready()
        return self._flagged_rows("_failed")

    def _flagged_rows(self, col: str) -> np.ndarray:
        if col not in self.state:
            return np.empty((0,), np.int32)
        flags = self.global_tensor(self.state[col]).cpu().numpy()
        return np.nonzero(flags)[0].astype(np.int32)

    def restart_rows(self, ids,
                     init_state: Optional[Dict[str, Any]] = None) -> None:
        """Host-mediated restart-with-reset-state (see BatchedSystem); on
        a ranked mesh each rank restarts the rows of its own block."""
        local, keep = self._own(ids)
        per_row = {}
        for col, value in (init_state or {}).items():
            v = np.asarray(value)
            per_row[col] = v[keep] if v.ndim == self.state[col].dim() \
                else value
        if local.size:
            fault_restart_rows(self.state, local, per_row)

    def clear_failed(self, ids) -> None:
        local, _ = self._own(ids)
        if np.size(local):
            fault_clear_failed(self.state, local)

    @property
    def supervision_counts(self) -> Dict[str, int]:
        """In-step supervision counters summed over shards."""
        return counts_dict(self.global_tensor(self.sup_counts))

    def any_escalated(self) -> bool:
        return "_escalated" in self.state and bool(
            self._any(self.state["_escalated"].any()).item())

    def escalated_rows(self) -> np.ndarray:
        """Global ids of escalated rows awaiting host resolution."""
        return self._flagged_rows("_escalated")

    def stop_block(self, ids) -> None:
        """Mark rows dead (no free list on the sharded runtime)."""
        self.set_rows(self.alive, np.unique(np.atleast_1d(
            np.asarray(ids, np.int64))), False)

    @property
    def total_dropped(self) -> int:
        """Exchange-overflow drops, all shards."""
        return int(self.dropped_per_shard.sum())

    @property
    def mailbox_overflow(self) -> int:
        return int(self.mailbox_overflow_per_shard.sum())

    @property
    def dropped_per_shard(self) -> np.ndarray:
        """[n_shards] cumulative exchange-overflow counts."""
        return self.global_tensor(self.dropped).cpu().numpy() \
            .astype(np.int64)

    @property
    def mailbox_overflow_per_shard(self) -> np.ndarray:
        """[n_shards] cumulative mailbox-overflow counts."""
        return self.global_tensor(self.mail_dropped).cpu().numpy() \
            .astype(np.int64)

    def block_until_ready(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def read_metrics(self) -> Dict[str, np.ndarray]:
        """The metric slab as named lanes, shards summed."""
        self.block_until_ready()
        return slab_dict(self.global_tensor(self.metrics))

    def metrics_epoch_value(self) -> int:
        """One scalar read of the metrics epoch (the slab's running sum
        over every shard; 0 while metrics are off); it syncs the newest
        run."""
        epoch = self.metrics_epoch
        if self.ranks is not None:  # each rank's sum over its shards
            epoch = self.ranks.all_reduce(epoch.clone(), "sum")
        return int(epoch.item())

    def drain_metrics(self):
        """`(step, lanes)` when the slab changed since the last drain,
        else None (and None while metrics are off); the quiet path costs
        one scalar read."""
        if not self.metrics_on:
            return None
        epoch = self.metrics_epoch_value()
        if epoch == self._metrics_seen_epoch:
            return None
        self._metrics_seen_epoch = epoch
        return int(self.step_count.item()), slab_dict(
            self.global_tensor(self.metrics))

    # ------------------------------------------------- checkpoint / recovery
    def checkpoint(self, directory: str, keep: Optional[int] = None,
                   compact: bool = True) -> str:
        """Checkpoint barrier (see BatchedSystem.checkpoint): synchronize
        the card, snapshot the schema-v3 slab tree, compact the attached
        tell journal (unless `compact=False`), remove snapshots past the
        `keep` newest. Returns the snapshot's path. On a ranked mesh every
        rank gathers the global tree (the one-card layout), rank 0 writes
        it and removes old snapshots, and every rank returns once it is
        written."""
        from ..persistence.slab_snapshot import (gc_slabs, save_slab_tree,
                                                 slab_path, slab_pytree)
        self.block_until_ready()
        tree = slab_pytree(self, gather=self.global_tensor)
        if self.mesh.rank == 0:
            save_slab_tree(tree, directory)
        if self.tell_journal is not None and compact:
            self.tell_journal.compact(self._host_step)
        if keep is not None and self.mesh.rank == 0:
            gc_slabs(directory, keep)
        self.barrier()
        return slab_path(directory, int(tree["step_count"]))

    def restore(self, path: str, journal=None) -> int:
        """Crash recovery, also across shard counts: a snapshot of this
        system's layout restores in place; one taken at another shard
        count, or in the hand-off window's wider inbox, is re-sharded
        (`_restore_resharded`). The caller builds a same-capacity system
        and re-runs its spawns first. With `journal`, the journaled
        batches past the snapshot's step replay to the crash frontier.
        Returns the restored host step counter."""
        from ..persistence.slab_snapshot import load_slab_tree
        return self.restore_tree(load_slab_tree(path), journal=journal)

    def restore_tree(self, tree: Dict[str, Any], journal=None) -> int:
        """Restore from an already-loaded slab tree (`slab_pytree` host
        copies). The host staging list is dropped (its tells replay from
        the journal). The metrics epoch is re-armed from the restored slab
        (either path) and the drained value reset, so the next
        drain_metrics() hands the restored slab over."""
        from ..persistence.slab_snapshot import restore_slab_pytree
        from ..persistence.tell_journal import replay_journal
        snap_rows = int(np.shape(tree["behavior_id"])[0])
        if snap_rows != self.capacity:
            raise ValueError(f"snapshot capacity {snap_rows} != "
                             f"system capacity {self.capacity}")
        self.block_until_ready()
        if tuple(np.shape(tree["inbox_dst"])) == \
                (self.n_shards * self.m_local,):
            restore_slab_pytree(self, self._own_tree(tree))
        else:
            self._restore_resharded(tree)
        if self.metrics_on:
            self.metrics_epoch.copy_(slab_epoch(self.metrics))
        self._metrics_seen_epoch = 0
        self._host_step = int(self.step_count.item())
        with self._lock:
            self._host_staged, self._host_rows = [], {}
        if journal is not None:
            replay_journal(self, journal)
        return self._host_step

    def _own_tree(self, tree: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's block of a global slab tree (`tree` itself without
        a group)."""
        if self.ranks is None:
            return tree
        out = {k: self.local_block(v, getattr(self, k))
               if isinstance(getattr(self, k, None), torch.Tensor) else v
               for k, v in tree.items() if k != "state"}
        out["state"] = {k: self.local_block(v, self.state[k])
                        if k in self.state else v
                        for k, v in tree["state"].items()}
        return out

    def _restore_resharded(self, tree: Dict[str, Any]) -> None:
        """Re-shard a snapshot whose inbox layout differs from this
        system's: another shard count, or a pair capacity of the hand-off
        window. Row slabs ([capacity, ...]) are layout independent and are
        written in place. Per-shard aggregates ([old D, ...]) are
        conserved by summing into shard 0 (only totals are read); the
        attention words keep their flags (OR), counters (sum) and step
        (max) in row 0. In-flight inbox rows are gathered and re-placed
        into their destination shard's block from the exchange region on,
        in their original order, so the stable delivery delivers them in
        that order on the first restored step. Every slab is written in
        place, and the step's graphs are dropped: the first restored run
        captures again (the reference's jit retraces a re-sharded
        carry). On a ranked mesh the global arrays are built alike on
        every rank, and each writes its own block."""
        from ..persistence.slab_snapshot import (check_schema,
                                                 restore_state_columns)
        from ..persistence.slab_snapshot import write_slab as write_global

        def write_slab(cur, arr):
            return write_global(cur, self.local_block(arr, cur))

        check_schema(tree)
        self._graphs.clear()
        restore_state_columns(self, self._own_tree(
            {"state": tree["state"]}))
        write_slab(self.behavior_id,
                   np.asarray(tree["behavior_id"], np.int32))
        write_slab(self.alive, np.asarray(tree["alive"], np.bool_))
        restored = int(np.asarray(tree["step_count"]).max())
        self.step_count.fill_(restored)
        ns = self.n_shards
        att_rows = np.zeros((ns, ATT_WORDS), np.int32)
        self._overflow_reported = np.zeros((ns, 2), np.int64)
        att = tree.get("attention")
        if att is not None:
            old = decode_attention(np.asarray(att))
            att_rows[0] = (old["flags"], old["mail_dropped"],
                           old["dead_letters"], old["step"],
                           old["exchange_dropped"], old["step"])
            self._overflow_reported[0] = (old["mail_dropped"],
                                          old["exchange_dropped"])
        self.attention = write_slab(self.attention, att_rows)

        def conserved(key, shape):
            out = np.zeros((ns,) + shape, np.int32)
            if key in tree:
                out[0] = np.asarray(tree[key]).reshape(
                    (-1,) + shape).sum(axis=0)
            return out

        self.dropped = write_slab(self.dropped, conserved("dropped", ()))
        self.mail_dropped = write_slab(self.mail_dropped,
                                       conserved("mail_dropped", ()))
        self.sup_counts = write_slab(self.sup_counts,
                                     conserved("sup_counts", (N_COUNTERS,)))
        self.metrics = write_slab(self.metrics, conserved(
            "metrics", tuple(self.metrics.shape[1:])))

        # in-flight mail: the valid rows in order, re-placed by
        # destination shard
        dst = np.asarray(tree["inbox_dst"])
        typ = np.asarray(tree["inbox_type"])
        pl = np.asarray(tree["inbox_payload"])
        val = np.asarray(tree["inbox_valid"]).astype(bool)
        if pl.shape[1] != self.payload_width:
            raise ValueError(f"snapshot payload width {pl.shape[1]} != "
                             f"system payload width {self.payload_width}")
        m_global = self.m_local * ns
        new_dst = np.full((m_global,), -1, np.int32)
        new_typ = np.zeros((m_global,), np.int32)
        new_pl = np.zeros((m_global, self.payload_width),
                          self._np_payload_dtype)
        new_val = np.zeros((m_global,), np.bool_)
        rows = np.nonzero(val)[0]
        shard = np.clip(dst[rows], 0, self.capacity - 1) // self.local_n
        order = np.argsort(shard, kind="stable")  # keeps the global order
        rows, shard = rows[order], shard[order]
        counts = np.bincount(shard, minlength=ns)
        region = self.m_local - self.spill_cap
        if counts.size and int(counts.max()) > region:
            s = int(np.argmax(counts))
            raise RuntimeError(
                f"in-flight mail for shard {s} ({int(counts[s])} rows) "
                f"exceeds its inbox block on the {ns}-shard system")
        first = np.concatenate([[0], np.cumsum(counts)[:-1]])
        rank = np.arange(rows.shape[0]) - first[shard]
        slot = shard * self.m_local + self.spill_cap + rank
        new_dst[slot] = dst[rows]
        new_typ[slot] = typ[rows]
        new_pl[slot] = pl[rows]
        new_val[slot] = True
        self.inbox_dst = write_slab(self.inbox_dst, new_dst)
        self.inbox_type = write_slab(self.inbox_type, new_typ)
        self.inbox_payload = write_slab(self.inbox_payload, new_pl)
        self.inbox_valid = write_slab(self.inbox_valid, new_val)
        if self.metrics_on:
            # enqueue stamps do not survive re-placement: every re-placed
            # row is stamped with the restored step
            self.inbox_enq = write_slab(
                self.inbox_enq,
                np.where(new_val, restored, 0).astype(np.int32))
