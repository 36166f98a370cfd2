"""uint32 arithmetic on int64 tensors.

torch has no general uint32 arithmetic (`maximum`, `>>`, `%` and
accumulating `index_put_` raise on a `torch.uint32` tensor on the CPU), so
the port keeps 32-bit unsigned values in int64 tensors, in [0, 2^32):
`u32` takes any integer tensor or host value to that form (a negative
int32 wraps, as the reference's `astype(uint32)` does), and `mul32`
multiplies modulo 2^32 without passing 2^48. The chaos hash
(testkit/chaos.py), the routing hashes (routing/batched.py) and the CRDT
banks (ddata/tensor.py) share these helpers, so their hashes and wraps
cannot drift apart.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF


def u32(x, device=None) -> torch.Tensor:
    """int64 tensor of x's values taken as uint32 (a negative int32 wraps,
    as jnp's astype(uint32) does)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.uint32:
            x = x.to(torch.int64)
        t = x.to(device=device or x.device, dtype=torch.int64)
    else:
        t = torch.as_tensor(np.asarray(x).astype(np.int64), device=device)
    return t & MASK32


def mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for h in [0, 2^32) and a constant c < 2^32, in
    int64 without overflow: c splits into 16-bit halves, so h * c_lo stays
    below 2^48, and of h * c_hi only the low 16 bits matter."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & MASK32


def to_uint32(h: torch.Tensor) -> torch.Tensor:
    """An int64 tensor of values in [0, 2^32) as a torch.uint32 tensor
    (through int32, whose bits it keeps)."""
    return (h - ((h >> 31) << 32)).to(torch.int32).view(torch.uint32)


def to_int32(h: torch.Tensor) -> torch.Tensor:
    """An int64 tensor of values in [0, 2^32) as the int32 of the same
    bits (the reference's `astype(int32)` of a uint32)."""
    return (h - ((h >> 31) << 32)).to(torch.int32)
