"""Plain PyTorch version of the flash attention kernel: naive attention
with explicit masks (small shapes only)."""
import math
from typing import Optional

import torch

from ...device import upcast


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  q_offset: int = 0) -> torch.Tensor:
    """q: (BH, Sq, D); k/v: (BH, Sk, D) -> (BH, Sq, D) in ``v.dtype``.
    Query ``i`` sits at position ``q_offset + i``; scores are fp32 (fp64 for fp64)."""
    sq, sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", upcast(q), upcast(k)) / math.sqrt(
        q.shape[-1])
    i = q_offset + torch.arange(sq, device=q.device)[:, None]
    j = torch.arange(sk, device=q.device)[None]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= j <= i
    if window is not None:
        mask &= j > i - window
    s = torch.where(mask, s, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, upcast(v)).to(v.dtype)
