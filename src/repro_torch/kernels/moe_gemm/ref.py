"""Plain PyTorch versions of the expert GEMM kernel and of its backward."""
from typing import Optional, Tuple

import torch

from ...device import upcast


def _mask(y: torch.Tensor, active: Optional[torch.Tensor]) -> torch.Tensor:
    """``y`` (E, ., .) with an inactive expert's block set to zeros."""
    if active is None:
        return y
    return y * (active != 0).to(y.dtype)[:, None, None]


def moe_gemm_ref(x: torch.Tensor, w: torch.Tensor,
                 active: Optional[torch.Tensor] = None,
                 slab: Optional[int] = None) -> torch.Tensor:
    """x: (E, C, d), or (C, d) seen by every expert; w: (E, d, f) ->
    (E, C, f) fp32, both operands upcast to fp32 (fp64 stays fp64; one
    einsum per expert).  ``active`` ((E,), nonzero = active): the result
    is multiplied by it, so an inactive expert's block is zeros; ``None``
    keeps every expert.  ``slab``: one einsum for each slab of that many
    consecutive rows of C, so a row gets the bits of a call over its slab
    alone (a library product's row bits may depend on its row count)."""
    C = x.shape[-2]
    if slab is not None and slab < C:
        return torch.cat([moe_gemm_ref(x[..., i:i + slab, :], w, active)
                          for i in range(0, C, slab)], dim=1)
    if x.ndim == 2:
        x = x.expand(w.shape[0], *x.shape)
    return _mask(torch.einsum("ecd,edf->ecf", upcast(x), upcast(w)), active)


def moe_gemm_bwd_ref(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                     active: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradient of :func:`moe_gemm_ref` from its operands and the
    gradient ``dy`` (E, C, f) on its output: returns (dx, dw) in fp32 (fp64
    for fp64), dx of x's shape.

    An inactive expert's output is zeros whatever its operands, so its
    ``dy`` is dropped first; then ``dx[e] = dy[e] w[e]^T`` (summed over
    the experts when x is one (C, d) matrix seen by all) and
    ``dw[e] = x[e]^T dy[e]``."""
    g = _mask(upcast(dy), active)
    xf, wf = upcast(x), upcast(w)
    if x.ndim == 2:
        dx = torch.einsum("ecf,edf->cd", g, wf)
        dw = torch.einsum("cd,ecf->edf", xf, g)
    else:
        dx = torch.einsum("ecf,edf->ecd", g, wf)
        dw = torch.einsum("ecd,ecf->edf", xf, g)
    return dx, dw
