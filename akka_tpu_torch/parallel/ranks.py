"""The collectives one rank of a ranked mesh runs over its process group.

A port module (the reference's collectives are XLA's, inside `shard_map`):
`RankGroup` wraps a torch.distributed process group, either a
`ProcessGroup` (`dist.group.WORLD` after `initialize_distributed`) or a
backend object a caller built (`dist.ProcessGroupGloo(store, rank, size,
timeout)`, as the tests' thread ranks are), and calls the group's own
methods, which both kinds have: `alltoall_base` (all_to_all_single's even
split), `allreduce` and `_allgather_base`. Every call waits for
its work, which on NCCL makes the current stream wait for the collective,
so a CUDA graph captured around it replays it in order.

Every rank must issue the same collectives in the same order: a rank that
skips one leaves the others waiting until the group's timeout.

Wire dtypes: gloo refuses uint32 (and int16), so uint32 tensors travel
as their int32 bits and bool as uint8 bytes in the all_to_all and the
all_gather; `all_reduce` takes a caller's int64 copy where values are
uint32 (ddata/tensor.py). int32, int64, float32 and bf16 travel as they
are. Gloo takes CUDA tensors as they are (it stages them through the
host itself), so the port hands every backend the tensors it has.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["RankGroup"]


_WIRE = {torch.uint32: torch.int32, torch.bool: torch.uint8}


def _wire(t: torch.Tensor) -> torch.Tensor:
    """The tensor a collective sends: uint32 as its int32 bits, bool as
    its bytes."""
    return t.view(_WIRE[t.dtype]) if t.dtype in _WIRE else t


class RankGroup:
    """One rank's view of a process group: `rank`, `size`, `backend`
    ("nccl" or "gloo") and the collectives the ranked runtime uses."""

    def __init__(self, group):
        self.group = group
        self.rank = int(group.rank())
        self.size = int(group.size())
        self.backend = str(group.name())

    def all_to_all(self, out: torch.Tensor, inp: torch.Tensor) -> None:
        """all_to_all_single with an even split: chunk w of `inp`'s
        leading axis goes to rank w, and `out`'s chunk w comes from rank
        w. Both are contiguous, of one shape and dtype."""
        self.group.alltoall_base(_wire(out), _wire(inp), [], [],
                                 dist.AllToAllOptions()).wait()

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's `t`, concatenated along the leading axis in rank
        order (a 0-d tensor gathers to [size])."""
        src = _wire(t.contiguous().reshape((-1,) + tuple(t.shape[1:]))
                    if t.dim() else t.reshape(1))
        out = torch.empty((self.size * src.shape[0],) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        self.group._allgather_base(out, src).wait()
        return out.view(t.dtype) if t.dtype in _WIRE else out

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """`t` reduced over every rank in place ("sum" or "max"), and
        returned. uint32 is refused: reduce an int64 copy."""
        if t.dtype == torch.uint32:
            raise TypeError("all_reduce of uint32: reduce an int64 copy")
        opts = dist.AllreduceOptions()
        opts.reduceOp = {"sum": dist.ReduceOp.SUM,
                         "max": dist.ReduceOp.MAX}[op]
        self.group.allreduce([t], opts).wait()
        return t

    def any(self, flags: torch.Tensor) -> torch.Tensor:
        """Elementwise OR of a bool tensor over every rank (one MAX of an
        int32 copy); the answer is the same on every rank."""
        return self.all_reduce(flags.to(torch.int32), "max").bool()

    def barrier(self, device: torch.device) -> None:
        """Return once every rank has reached this call: one all_reduce
        of a scalar on `device`, read on the host."""
        self.all_reduce(torch.zeros((1,), dtype=torch.int32,
                                    device=device)).item()
