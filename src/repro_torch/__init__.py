"""PyTorch and CUDA port of the batched SORT tracker for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its
module names and lane layout and imports nothing of it (nor JAX).  Entry
points run on the card unless the caller passes ``device="cpu"``; kernels
run the plain PyTorch version only for tensors that lie on the CPU.
"""
from .core.sort import SortConfig, SortEngine
from .serve.scheduler import StreamScheduler

__all__ = ["SortConfig", "SortEngine", "StreamScheduler"]
