"""Plain PyTorch version of the queue matmul kernel."""
import torch


def matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with both operands upcast to fp32; returns fp32."""
    return torch.matmul(x.float(), w.float())
