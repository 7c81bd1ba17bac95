"""Hand-written CUDA kernels for Hopper, one package each, with their plain
PyTorch versions (``ref.py``) and public wrappers (``ops.py``)."""
from .flash_attention import flash_attention
from .queue_matmul import queue_matmul

#: every kernel this package builds, by source name
KERNELS = ("queue_matmul", "flash_attention")

__all__ = ["KERNELS", "flash_attention", "queue_matmul"]
