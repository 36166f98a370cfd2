"""The gateway's serving entity.

Port of `counter_behavior` from `akka_tpu/gateway/ingress.py`, written over
the batch. The framed-TCP front door, `RegionBackend` and the rest of that
module are not ported yet (ROADMAP A7).
"""

from __future__ import annotations

import torch

from ..batched import Emit, behavior
from ..batched.bridge import reply_dst


def counter_behavior(payload_width: int, out_degree: int = 1):
    """The serving entity: an additive counter. Payload
    [value, ..., reply_row]; the reduction sums concurrent adds (the dense
    inbox's commutative contract), and the reply, [new_total, 0, ...], goes
    to the reply-to row (the ask convention of batched/bridge.py)."""
    P, k = payload_width, out_degree

    @behavior("gw_counter", {"total": ((), torch.float32)})
    def counter(state, inbox, ctx):
        got = inbox.count > 0
        new_total = state["total"] + inbox.sum[:, 0]
        reply = torch.zeros((got.shape[0], P), dtype=torch.float32,
                            device=got.device)
        reply[:, 0] = new_total
        return ({"total": torch.where(got, new_total, state["total"])},
                Emit.single(reply_dst(inbox.sum), reply, k, P, when=got))

    return counter
