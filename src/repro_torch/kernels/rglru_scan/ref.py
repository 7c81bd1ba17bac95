"""Plain PyTorch version of the RG-LRU scan kernel: the sequential
recurrence, one time step at a time."""
import torch

from ...device import wide_dtype


def rglru_scan_ref(a: torch.Tensor, bx: torch.Tensor) -> torch.Tensor:
    """a/bx: (B, T, w) -> h: (B, T, w) fp32.

    ``h_t = a_t * h_{t-1} + bx_t`` from ``h_0 = 0``, both inputs cast to
    fp32 first (fp64 stays fp64), one multiply and one add a step, each
    rounded, in sequence.  The CUDA kernel composes chunks of the sequence
    instead, so it rounds differently and is held to this within the
    kernel tolerance."""
    acc = wide_dtype(a.dtype)
    a, bx = a.to(acc), bx.to(acc)
    h = torch.zeros_like(a[:, 0])
    out = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h + bx[:, t]
        out[:, t] = h
    return out
