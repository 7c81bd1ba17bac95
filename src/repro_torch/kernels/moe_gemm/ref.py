"""Plain PyTorch version of the expert GEMM kernel."""
import torch

from ...device import upcast


def moe_gemm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (E, C, d); w: (E, d, f) -> (E, C, f) fp32, both operands upcast
    to fp32 (fp64 stays fp64; one einsum per expert)."""
    return torch.einsum("ecd,edf->ecf", upcast(x), upcast(w))
