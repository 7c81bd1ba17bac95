"""Hand-written CUDA kernels for Hopper, one package each, with their plain
PyTorch versions (``ref.py``) and public wrappers (``ops.py``)."""
from .flash_attention import flash_attention
from .moe_gemm import moe_gemm
from .queue_matmul import queue_matmul
from .rglru_scan import rglru_scan
from .ssm_scan import ssm_scan

#: every kernel this package builds, by source name
KERNELS = ("queue_matmul", "flash_attention", "flash_attention_bwd",
           "moe_gemm", "ssm_scan", "ssm_scan_bwd", "rglru_scan")

__all__ = ["KERNELS", "flash_attention", "moe_gemm", "queue_matmul",
           "rglru_scan", "ssm_scan"]
