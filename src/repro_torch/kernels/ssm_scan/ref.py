"""Plain PyTorch versions of the selective-scan kernel and of its
backward: the sequential recurrence, one time step at a time, forward and
in reverse."""
from typing import Tuple

import torch

from ...device import wide_dtype


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


def _states_meta(x, dt, A, Bm):
    """A (B, T, d, N) tensor of the states' shape built from every input
    without a loop (no product): shapes only, for the meta device."""
    return torch.exp(dt[..., None] * A) * (dt * x)[..., None] \
        * Bm[:, :, None, :]


def ssm_scan_meta(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  Bm: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """:func:`ssm_scan_ref`'s result shape and dtype for the meta device,
    with the same products and no loop over T: one (B T) x d x N product,
    as the plain version's T per-step ones (2 B T d N FLOPs), and under
    autograd the same backward products (4 B T d N)."""
    acc = wide_dtype(x.dtype)
    x, dt, A, Bm, C = (t.to(acc) for t in (x, dt, A, Bm, C))
    return torch.einsum("btdn,btn->btd", _states_meta(x, dt, A, Bm), C)


def ssm_scan_bwd_meta(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                      Bm: torch.Tensor, C: torch.Tensor, dy: torch.Tensor
                      ) -> Tuple[torch.Tensor, ...]:
    """:func:`ssm_scan_bwd_ref`'s result shapes and dtypes for the meta
    device, with its three per-step products (dC, dB and the sum over N
    behind dx and ddt; 6 B T d N FLOPs) as three products over all T."""
    acc = wide_dtype(x.dtype)
    x, dt, A, Bm, C, dy = (t.to(acc) for t in (x, dt, A, Bm, C, dy))
    h = _states_meta(x, dt, A, Bm)
    dC = torch.einsum("btd,btdn->btn", dy, h)
    dB = torch.einsum("btdn,btd->btn", h, dt * x)
    sdb = torch.einsum("btdn,btn->btd", h, Bm)
    return (dt * sdb, x * sdb, (h * A).sum((0, 1)), dB, dC)


def ssm_scan_bwd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     Bm: torch.Tensor, C: torch.Tensor, dy: torch.Tensor
                     ) -> Tuple[torch.Tensor, ...]:
    """The gradient of :func:`ssm_scan_ref` from its inputs and the
    gradient ``dy`` (B, T, d) on y: returns (dx, ddt, dA, dB, dC) in the
    shapes of x, dt, A, Bm and C, fp32 (fp64 for fp64).

    The states h_t are recomputed forward first (kept one (B, d, N)
    tensor a step: the plain version's memory, not the kernel's), then the
    reverse scan ``dh_t = C_t dy_t + exp(dt_{t+1} A) dh_{t+1}``, one step
    at a time, gives each step's terms::

        dC_t = sum_d dy_t h_t            dB_t = sum_d dh_t dt_t x_t
        dx_t = dt_t sum_n dh_t B_t       dA  += sum_b dh_t dt_t e_t h_{t-1}
        ddt_t = x_t sum_n dh_t B_t + sum_n dh_t A e_t h_{t-1}

    with ``e_t = exp(dt_t A)`` and ``h_0 = 0``."""
    acc = wide_dtype(x.dtype)
    x, dt, A, Bm, C, dy = (t.to(acc) for t in (x, dt, A, Bm, C, dy))
    B, T, d = x.shape
    hs = [torch.zeros((B, d, A.shape[1]), dtype=acc, device=x.device)]
    for t in range(T):
        hs.append(torch.exp(dt[:, t, :, None] * A) * hs[-1]
                  + (dt[:, t] * x[:, t])[..., None] * Bm[:, t, None, :])
    dx, ddt = torch.empty_like(x), torch.empty_like(x)
    dB, dC = torch.empty_like(Bm), torch.empty_like(C)
    dA = torch.zeros_like(A)
    g = torch.zeros_like(hs[0])
    for t in range(T - 1, -1, -1):
        e = torch.exp(dt[:, t, :, None] * A)
        dh = C[:, t, None, :] * dy[:, t, :, None] + g
        dC[:, t] = torch.einsum("bd,bdn->bn", dy[:, t], hs[t + 1])
        dB[:, t] = torch.einsum("bdn,bd->bn", dh, dt[:, t] * x[:, t])
        sdb = torch.einsum("bdn,bn->bd", dh, Bm[:, t])
        q = dh * e * hs[t]
        dx[:, t] = dt[:, t] * sdb
        ddt[:, t] = x[:, t] * sdb + (q * A).sum(-1)
        dA += (q * dt[:, t, :, None]).sum(0)
        g = e * dh
    return dx, ddt, dA, dB, dC
