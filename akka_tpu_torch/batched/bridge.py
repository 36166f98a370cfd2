"""The ask convention of the batched runtime: promise rows.

Port of the part of `akka_tpu/batched/bridge.py` the sharded region's ask
path needs (`AskPoolExhausted`, `reply_dst`, `max_exact_row_id`,
`read_promise_block`). An ask reserves a promise row, writes that row's id
into the last payload column of its request, and the entity's behavior
answers with `Emit.single(reply_dst(inbox.sum), ...)`; the promise row
latches the reply, and the host reads the whole promise block in one fetch.

The rest of the bridge (`BatchedRuntimeHandle`, device actor refs, the
dispatcher and provider hooks) is not ported yet (ROADMAP A6).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch


class AskPoolExhausted(RuntimeError):
    """Every promise row is claimed by an in-flight (or quarantined) ask:
    the ask fails fast and typed instead of queueing or burning its
    timeout. Admission layers catch it to shed load: it is the ask pool's
    backpressure signal, as mailbox_overflow is for tells."""


def reply_dst(payload: torch.Tensor) -> torch.Tensor:
    """For behaviors: the reply-to row ids encoded in the payloads' last
    column ([n, P] -> [n] int32; the ask convention)."""
    return payload[..., -1].to(torch.int32)


def max_exact_row_id(dtype: torch.dtype) -> int:
    """Largest row id a value cast into `dtype` round-trips exactly.

    Integers: the dtype's max. Floats: every integer up to
    2^(mantissa bits + 1) is exact (float32 -> 2^24, float16 -> 2^11,
    bfloat16 -> 2^8)."""
    if dtype.is_floating_point:
        return int(round(2.0 / torch.finfo(dtype).eps))
    return int(torch.iinfo(dtype).max)


def read_promise_block(state: Dict[str, torch.Tensor], base: int, n: int,
                       replied_col: str, reply_col: Optional[str] = None
                       ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """One host fetch of a promise block's latch (and, optionally, reply)
    columns, rows [base, base + n). Returns `(replied, replies)` numpy
    arrays (`replies` is None unless `reply_col` is given), copies that
    later steps do not change; the copy waits for every step already
    enqueued."""
    replied = state[replied_col][base:base + n].to("cpu", copy=True).numpy()
    if reply_col is None:
        return replied, None
    return replied, state[reply_col][base:base + n].to(
        "cpu", copy=True).numpy()
