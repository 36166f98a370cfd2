"""Native (C++) runtime substrate.

Port of `akka_tpu/native/` (commit 001ef4f): a small C++ library bound via
ctypes: lock-free MPSC mailbox queues, a hashed-wheel timer with a native
tick thread, and a preallocated message stager feeding the batched device
runtime. It is built with g++ at first use (native/lib.py: under a lock,
into `akka_tpu_torch/_build/native/`), never at import. Unlike the
reference, nothing falls back to Python silently: a consumer that asks
for the library raises when it cannot be built; `available()` asks.
"""

from .lib import available  # noqa: F401
from .integration import (NativeScheduler, NativeUnboundedMailbox,  # noqa: F401
                          register_native_mailbox)

__all__ = ["available", "NativeScheduler", "NativeUnboundedMailbox",
           "register_native_mailbox"]


def __getattr__(name):
    if name in ("NativeMpscQueue", "NativeWheelTimer", "NativeStager"):
        from . import queues
        return getattr(queues, name)
    raise AttributeError(name)
