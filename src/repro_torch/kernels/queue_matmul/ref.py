"""Plain PyTorch version of the queue matmul kernel."""
import torch

from ...device import upcast


def matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with both operands upcast to fp32 (fp64 stays fp64);
    returns fp32."""
    return torch.matmul(upcast(x), upcast(w))
