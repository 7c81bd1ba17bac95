"""Plain PyTorch versions of the RG-LRU scan kernel and of its backward:
the sequential recurrence, one time step at a time, forward and in
reverse."""
from typing import Tuple

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


def rglru_scan_meta(a: torch.Tensor, bx: torch.Tensor) -> torch.Tensor:
    """:func:`rglru_scan_ref`'s result shape and dtype for the meta device,
    from both inputs, without a loop: the plain version has no product to
    count, and neither has this."""
    acc = wide_dtype(a.dtype)
    return a.to(acc) * bx.to(acc) + bx.to(acc)


def rglru_scan_bwd_ref(a: torch.Tensor, h: torch.Tensor,
                       g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradient of :func:`rglru_scan_ref` from its input ``a``, its
    output ``h`` and the gradient ``g`` on h, all (B, T, w): returns
    (da, dbx), fp32 (fp64 for fp64).

    The recurrence run in reverse, one step at a time:
    ``dh_t = g_t + a_{t+1} dh_{t+1}`` from ``dh_T = 0``; then
    ``dbx_t = dh_t`` and ``da_t = dh_t h_{t-1}`` with ``h_{-1} = 0``."""
    acc = wide_dtype(a.dtype)
    a, h, g = a.to(acc), h.to(acc), g.to(acc)
    dh = torch.empty_like(g)
    run = torch.zeros_like(g[:, 0])
    for t in range(g.shape[1] - 1, -1, -1):
        run = g[:, t] + (a[:, t + 1] * run if t + 1 < g.shape[1] else 0.0)
        dh[:, t] = run
    da = torch.zeros_like(dh)
    da[:, 1:] = dh[:, 1:] * h[:, :-1]
    return da, dh
