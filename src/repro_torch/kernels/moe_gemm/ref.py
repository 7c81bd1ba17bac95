"""Plain PyTorch version of the expert GEMM kernel."""
from typing import Optional

import torch

from ...device import upcast


def moe_gemm_ref(x: torch.Tensor, w: torch.Tensor,
                 active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (E, C, d); w: (E, d, f) -> (E, C, f) fp32, both operands upcast
    to fp32 (fp64 stays fp64; one einsum per expert).  ``active`` ((E,),
    nonzero = active): the result is multiplied by it, so an inactive
    expert's block is zeros; ``None`` keeps every expert."""
    y = torch.einsum("ecd,edf->ecf", upcast(x), upcast(w))
    if active is None:
        return y
    return y * (active != 0).to(y.dtype)[:, None, None]
