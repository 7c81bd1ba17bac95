from .ops import moe_gemm

__all__ = ["moe_gemm"]
