"""Device resolution for the port's entry points.

Entry points default to `torch.device("cuda")`. With no card present they
raise instead of carrying on quietly on the CPU; the CPU is used only when
the caller asks for it (`device="cpu"`, as the tests do).
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: `device` if given, else CUDA.
    Raises RuntimeError for a CUDA device when no card is present."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "akka_tpu_torch: no CUDA device is available; pass device='cpu' "
            "to run on the CPU explicitly")
    return dev


def platform_of(x: torch.Tensor) -> str:
    """'cuda' or 'cpu': the platform a tensor's computation runs on (the
    port's counterpart of segment._resolve_platform in the reference)."""
    return "cuda" if x.is_cuda else "cpu"

