"""Plain PyTorch version of MLA's absorbed decode attention over C columns
of B slots (:func:`latent_attention_ref`): the attention of every MLA
layer's decode and chunk bodies on the CPU, and what the kernel is held to
on the card."""
import torch

from ...device import upcast
from ..decode_attention.ref import NEG_INF


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(a * b).sum(-1)``: an elementwise product reduced over its own
    innermost axis, so each output's bits come from its own elements."""
    return (a * b).sum(-1)


def latent_attention_ref(q_eff: torch.Tensor, q_rope: torch.Tensor,
                         latent: torch.Tensor, rope: torch.Tensor,
                         rows: torch.Tensor, self_lat: torch.Tensor,
                         self_rope: torch.Tensor,
                         scale: float) -> torch.Tensor:
    """q_eff (C, B, H, r): column c's queries of slot b through W_uk
    (q_nope W_uk); q_rope (C, B, H, dr); the slots' caches ``latent``
    (B, T, r) and ``rope`` (B, T, dr); rows (C, B) int: the cache rows
    [0, rows) each query reads; self_lat (C, B, r) and self_rope (C, B, dr):
    the query column's own new row, attended as the last position.
    Returns o_lat (C, B, H, r) in the caches' dtype.

    The JAX package's absorbed attention (``src/repro/models/attention.py``,
    ``mla_decode``) in fp32: the latent and the rope scores summed
    separately and then added, times ``scale`` (1 / sqrt(qk_nope +
    qk_rope)), positions past ``rows`` masked to NEG_INF, a softmax, the
    weighted sum of the latent.  Each sum is an elementwise product reduced
    over its own innermost axis, never a batched matmul, so a query's bits
    do not depend on how many columns or slots run with it."""
    C, B, H, r = q_eff.shape
    T = latent.shape[1]
    q, qr = upcast(q_eff), upcast(q_rope)
    lat, own = upcast(latent), upcast(self_lat)
    s_lat = torch.cat([_dot(q[:, :, :, None], lat[None, :, None]),
                       _dot(q, own[:, :, None])[..., None]], dim=-1)
    s_rope = torch.cat([_dot(qr[:, :, :, None], upcast(rope)[None, :, None]),
                        _dot(qr, upcast(self_rope)[:, :, None])[..., None]],
                       dim=-1)
    s = (s_lat + s_rope) * scale                        # (C, B, H, T + 1)
    pos = torch.arange(T + 1, device=q.device)
    seen = (pos < torch.as_tensor(rows, device=q.device)[..., None]) | (
        pos == T)
    s = torch.where(seen[:, :, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    # the values: the cache rows, then the column's own row, (C, B, r, T+1)
    vals = torch.cat([lat[None].expand(C, B, T, r), own[:, :, None]], dim=2)
    vt = vals.transpose(-1, -2).contiguous()
    out = (p[:, :, :, None] * vt[:, :, None]).sum(-1)
    return out.to(latent.dtype)
