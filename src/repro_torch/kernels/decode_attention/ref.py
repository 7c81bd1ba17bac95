"""Plain PyTorch versions of decode attention: the kernel's C columns of
queries (:func:`decode_attention_rows_ref`, the decode attention of every
GQA layer on the CPU), and the same arithmetic for one column through
batched matmuls (:func:`decode_attention_ref`, the JAX package's form),
which the tests and ``repro_torch.benchmarks.row_bits`` hold the rows
version to."""
import math
from typing import Optional

import torch

from ...device import upcast

#: the score of a masked position (the reference's)
NEG_INF = -1e30


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, length: torch.Tensor, *,
                         window: Optional[int] = None) -> torch.Tensor:
    """Single-token attention: q (B, Hq, 1, D); caches (B, Hkv, T, D).
    ``length`` (scalar, or per-sequence (B,)) = number of valid cache
    entries per sequence."""
    B, Hq, _, D = q.shape
    _, Hkv, T, Dv = v_cache.shape
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bhtd->bhgt", upcast(qg), upcast(k_cache)) * scale
    pos = torch.arange(T, device=q.device)
    lv = torch.as_tensor(length, device=q.device).reshape(-1, 1)
    mask = pos[None] < lv
    if window is not None:
        mask = mask & (pos[None] >= lv - window)
    s = torch.where(mask[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgt,bhtd->bhgd", p, upcast(v_cache))
    return out.reshape(B, Hq, 1, Dv).to(v_cache.dtype)


def decode_attention_rows_ref(q: torch.Tensor, k_cache: torch.Tensor,
                              v_cache: torch.Tensor,
                              valid: torch.Tensor) -> torch.Tensor:
    """q (C, B, Hq, D): column c's query of slot b; caches (B, Hkv, T, D);
    valid (C, B): the cache rows [0, valid) each query sees.  Returns
    (C, B, Hq, D) in the caches' dtype.

    :func:`decode_attention_ref`'s arithmetic — scores scaled, masked to
    NEG_INF, softmax, the weighted sum of V, in fp32 — with each sum an
    elementwise product reduced over its own innermost axis, where the
    one-column function multiplies batched matrices.  A reduction computes
    each output from its own elements, so a query's bits do not depend on
    how many columns run with it (a batched product's do: the CPU's
    rounds a one-column query 1.2e-6 away from the same query among eight,
    ``repro_torch.benchmarks.row_bits``), and a chunk's C columns take one
    call, not C."""
    C, B, Hq, D = q.shape
    _, Hkv, T, _ = v_cache.shape
    G = Hq // Hkv
    qg = upcast(q).reshape(C, B, Hkv, G, 1, D)
    s = (qg * upcast(k_cache)[None, :, :, None]).sum(-1) * (1.0 / math.sqrt(D))
    pos = torch.arange(T, device=q.device)
    mask = pos < torch.as_tensor(valid, device=q.device)[..., None]
    s = torch.where(mask[:, :, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)                          # (C, B, Hkv, G, T)
    vt = upcast(v_cache).transpose(-1, -2)                # (B, Hkv, D, T)
    out = (p[:, :, :, :, None] * vt[None, :, :, None]).sum(-1)
    return out.reshape(C, B, Hq, D).to(v_cache.dtype)
