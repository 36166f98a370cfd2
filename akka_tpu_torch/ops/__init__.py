"""Delivery primitives (ops/segment.py) and the ring-mailbox CUDA kernels
(ops/cuda_mailbox.py)."""
