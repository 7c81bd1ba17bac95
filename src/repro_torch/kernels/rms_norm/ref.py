"""Plain PyTorch version of the row-wise RMS norm kernel: the model's norm
(``models.layers.rms_norm`` is this function)."""
import torch

from ...device import upcast


def rms_norm_ref(x: torch.Tensor, gamma: torch.Tensor,
                 eps: float = 1e-5) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + gamma)`` over the last axis, in
    fp32 (fp64 for fp64), returned in ``x.dtype``."""
    dt = x.dtype
    x32 = upcast(x)
    x32 = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * (1.0 + gamma.to(x32.dtype))).to(dt)
