"""akka_tpu_torch: the PyTorch/CUDA port of the akka_tpu batched runtime.

A second package beside `akka_tpu` (the JAX reference). It mirrors the
reference's module layout (`akka_tpu/batched/step.py` <->
`akka_tpu_torch/batched/step.py`) and imports `torch` only: never `jax`,
and nothing of `akka_tpu`. What it needs from the reference it keeps as its
own copy.

Entry points take `device=` and default to `torch.device("cuda")`; without a
card they raise unless the caller passes `device="cpu"`
(`akka_tpu_torch.utils.device`). The ring mailbox, the reference's one
Pallas kernel, is a hand-written CUDA kernel here
(`akka_tpu_torch/csrc/ring_mailbox.cu`, bound in `ops/cuda_mailbox.py`).
"""

from .batched import (BatchedBehavior, BatchedSystem, Ctx, Emit, Inbox,
                      Mailbox, behavior)

__all__ = ["BatchedBehavior", "BatchedSystem", "Ctx", "Emit", "Inbox",
           "Mailbox", "behavior"]
