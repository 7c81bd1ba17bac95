"""Plain PyTorch version of the selective-scan kernel: the sequential
recurrence, one time step at a time."""
import torch

from ...device import upcast, wide_dtype


def ssm_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """x/dt: (B, T, d); A: (d, N); Bm/C: (B, T, N) -> y: (B, T, d) fp32.

    ``h_t = exp(dt_t A) * h_{t-1} + (dt_t x_t) B_t``, ``y_t = h_t . C_t``
    from ``h_0 = 0``, every input cast to fp32 first (as the kernels do;
    fp64 stays fp64).
    The state is one (B, d, N) tensor; the (B, T, d, N) decay and input
    tensors are never built."""
    acc = wide_dtype(x.dtype)
    x, dt, A, Bm, C = (t.to(acc) for t in (x, dt, A, Bm, C))
    B, T, d = x.shape
    h = torch.zeros((B, d, A.shape[1]), dtype=acc, device=x.device)
    y = torch.empty((B, T, d), dtype=acc, device=x.device)
    for t in range(T):
        h = torch.exp(dt[:, t, :, None] * A) * h \
            + (dt[:, t] * x[:, t])[..., None] * Bm[:, t, None, :]
        y[:, t] = torch.einsum("bdn,bn->bd", h, C[:, t])
    return y
