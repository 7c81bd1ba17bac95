"""Hand-written CUDA kernels for Hopper, one package each, with their plain
PyTorch versions (``ref.py``) and public wrappers (``ops.py``)."""
from .decode_attention import decode_attention
from .flash_attention import flash_attention
from .latent_attention import latent_attention
from .moe_gemm import moe_gemm
from .queue_matmul import queue_matmul
from .rglru_scan import rglru_scan
from .rms_norm import rms_norm
from .ssm_scan import ssm_scan

#: every kernel this package builds, by source name
KERNELS = ("queue_matmul", "flash_attention", "flash_attention_bwd",
           "moe_gemm", "ssm_scan", "ssm_scan_bwd", "rglru_scan", "rms_norm",
           "decode_attention", "latent_attention")


def launch_counters():
    """Every wrapper that counts its launches (``fn.launches``), by kernel
    name: the forward wrappers and the backward ones."""
    from .flash_attention import flash_attention_bwd
    from .moe_gemm import moe_gemm_bwd
    from .rglru_scan import rglru_scan_bwd
    from .ssm_scan import ssm_scan_bwd
    return {"queue_matmul": queue_matmul, "flash_attention": flash_attention,
            "flash_attention_bwd": flash_attention_bwd,
            "moe_gemm": moe_gemm, "moe_gemm_bwd": moe_gemm_bwd,
            "ssm_scan": ssm_scan, "ssm_scan_bwd": ssm_scan_bwd,
            "rglru_scan": rglru_scan, "rglru_scan_bwd": rglru_scan_bwd,
            "rms_norm": rms_norm, "decode_attention": decode_attention,
            "latent_attention": latent_attention}


__all__ = ["KERNELS", "decode_attention", "flash_attention",
           "latent_attention", "launch_counters", "moe_gemm", "queue_matmul",
           "rglru_scan", "rms_norm", "ssm_scan"]
