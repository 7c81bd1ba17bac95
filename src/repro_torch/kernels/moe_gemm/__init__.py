from .ops import moe_gemm, moe_gemm_bwd

__all__ = ["moe_gemm", "moe_gemm_bwd"]
