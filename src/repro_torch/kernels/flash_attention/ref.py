"""Plain PyTorch versions of the flash attention kernels: naive attention
with explicit masks, its log-sum-exp, and its gradient (small shapes
only)."""
import math
from typing import Optional, Tuple

import torch

from ...device import upcast


def _mask(sq: int, sk: int, causal: bool, window: Optional[int],
          q_offset: int, device) -> torch.Tensor:
    """(sq, sk) bool: the keys each query sees (query ``i`` at position
    ``q_offset + i``)."""
    i = q_offset + torch.arange(sq, device=device)[:, None]
    j = torch.arange(sk, device=device)[None]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= j <= i
    if window is not None:
        mask &= j > i - window
    return mask


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bqd,bkd->bqk", upcast(q), upcast(k)) / math.sqrt(
        q.shape[-1])


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  q_offset: int = 0) -> torch.Tensor:
    """q/k: (BH, Sq|Sk, D); v: (BH, Sk, Dv) -> (BH, Sq, Dv) in ``v.dtype``.
    Query ``i`` sits at position ``q_offset + i``; scores are fp32 (fp64 for fp64)."""
    s = _scores(q, k)
    mask = _mask(q.shape[1], k.shape[1], causal, window, q_offset, q.device)
    s = torch.where(mask, s, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, upcast(v)).to(v.dtype)


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      q_offset: int = 0) -> torch.Tensor:
    """Each row's log-sum-exp of its scaled scores over the keys it sees,
    (BH, Sq) in fp32 (fp64 for fp64); ``+inf`` for a row that sees no key,
    as the forward kernel writes it."""
    s = _scores(q, k)
    mask = _mask(q.shape[1], k.shape[1], causal, window, q_offset, q.device)
    lse = torch.logsumexp(s.masked_fill(~mask, -math.inf), dim=-1)
    return lse.masked_fill(~mask.any(-1), math.inf)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                      *, causal: bool = True, window: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of attention that ``flash_attention_bwd.cu`` computes,
    from the same inputs: q/k (BH, Sq|Sk, D), v (BH, Sk, Dv), the forward's
    output o and the upstream gradient do (BH, Sq, Dv), and the forward's
    log-sum-exp (BH, Sq).  Probabilities are recomputed from lse, masked
    entries 0, so a row that sees no key (lse = +inf) has zero gradients
    (the forward kernel returns 0 there):

        P = exp(S scale - lse), dV = P^T dO, dP = dO V^T,
        dS = P (dP - rowsum(dO o)), dQ = scale dS K, dK = scale dS^T Q.

    Returns (dq, dk, dv) in fp32 (fp64 for fp64)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    q32, k32, v32, do32 = upcast(q), upcast(k), upcast(v), upcast(do)
    mask = _mask(q.shape[1], k.shape[1], causal, window, 0, q.device)
    p = torch.exp(_scores(q, k) - upcast(lse)[..., None])
    p = torch.where(mask, p, torch.zeros((), dtype=p.dtype, device=p.device))
    delta = (do32 * upcast(o)).sum(-1, keepdim=True)
    dv = torch.einsum("bqk,bqd->bkd", p, do32)
    ds = p * (torch.einsum("bqd,bkd->bqk", do32, v32) - delta)
    dq = torch.einsum("bqk,bkd->bqd", ds, k32) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds, q32) * scale
    return dq, dk, dv
