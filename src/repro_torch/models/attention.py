"""Attention layers, dense GQA part: full/causal/local-window attention and
the decode path.

Sequence-level attention (:func:`gqa_apply`) runs the port's
``flash_attention`` op: the CUDA kernel on the card, its plain version on
the CPU.  :func:`flash_attention_ref` is the model-level plain version, a
blockwise online softmax in PyTorch, ported from the JAX package's reference
of the same name.  Decode attention (:func:`decode_attention_ref`) stays
plain PyTorch, as the JAX package computes it outside any kernel.  MLA comes
with its family in a later slice.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..config import ModelConfig
from ..core.policy import ExecutionPolicy
from ..device import upcast, wide_dtype
from ..kernels.flash_attention import flash_attention
from .layers import ParamSpec, apply_rope, matmul, rope_angles

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# blockwise attention reference (flash-style, plain PyTorch)
# ---------------------------------------------------------------------------

def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        block_q: int = 512, block_k: int = 1024,
                        q_offset: int = 0) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Sk, D[v]); GQA via head grouping.
    ``q_offset`` is the absolute position of q[0].  Returns (B, Hq, Sq, Dv)
    in ``v.dtype``.  Every k block runs (no skipping), as the reference's
    default path does."""
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, Dv = v.shape
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    orig_sq = Sq
    dev = q.device

    pad_q = (-Sq) % block_q
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, pad_q))
        Sq = q.shape[2]
    pad_k = (-Sk) % block_k
    if pad_k:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad_k))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad_k))
    Sk_p = k.shape[2]
    nq, nk = Sq // block_q, Sk_p // block_k

    qb = q.reshape(B, Hkv, G, nq, block_q, D).float()
    kb = k.reshape(B, Hkv, nk, block_k, D).float()
    vb = v.reshape(B, Hkv, nk, block_k, Dv).float()
    q_pos = (q_offset + torch.arange(Sq, device=dev)).reshape(nq, block_q)
    k_pos = torch.arange(Sk_p, device=dev).reshape(nk, block_k)
    neg = torch.tensor(NEG_INF, device=dev)

    outs = []
    for qi in range(nq):
        q_i = qb[:, :, :, qi]
        m = torch.full((B, Hkv, G, block_q), NEG_INF, device=dev)
        l = torch.zeros((B, Hkv, G, block_q), device=dev)
        acc = torch.zeros((B, Hkv, G, block_q, Dv), device=dev)
        for ki in range(nk):
            s = torch.einsum("bhgqd,bhkd->bhgqk", q_i, kb[:, :, ki]) * scale
            mask = (k_pos[ki][None, :] <= Sk - 1).expand(block_q, block_k)
            if causal:
                mask = mask & (k_pos[ki][None, :] <= q_pos[qi][:, None])
            if window is not None:
                mask = mask & (k_pos[ki][None, :]
                               > q_pos[qi][:, None] - window)
            s = torch.where(mask, s, neg)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p, vb[:, :, ki])
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    # (nq, B, Hkv, G, block_q, Dv) -> (B, Hq, Sq, Dv)
    out = torch.stack(outs).permute(1, 2, 3, 0, 4, 5)
    out = out.reshape(B, Hq, Sq, Dv)[:, :, :orig_sq]
    return out.to(v.dtype)


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
    s = torch.where(mask[:, None, None], s,
                    torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgt,bhtd->bhgd", p, upcast(v_cache))
    return out.reshape(B, Hq, 1, Dv).to(v_cache.dtype)


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------

def gqa_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {
        "wq": ParamSpec((d, cfg.n_heads, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, cfg.n_kv_heads, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, cfg.n_kv_heads, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((cfg.n_heads, hd, d), ("heads", "head_dim", "embed")),
    }


def _project(x: torch.Tensor, w: torch.Tensor,
             policy: Optional[ExecutionPolicy]) -> torch.Tensor:
    """einsum("bsd,dhk->bhsk"): w (d, H, hd) flattened to (d, H*hd)."""
    B, S, _ = x.shape
    _, H, hd = w.shape
    y = matmul(x, w.reshape(w.shape[0], H * hd), policy)
    return y.reshape(B, S, H, hd).transpose(1, 2)


def _out_project(o: torch.Tensor, wo: torch.Tensor,
                 policy: Optional[ExecutionPolicy]) -> torch.Tensor:
    """einsum("bhsk,hkd->bsd"): wo (H, hd, d) flattened to (H*hd, d)."""
    B, H, S, hd = o.shape
    o = o.transpose(1, 2).reshape(B, S, H * hd)
    return matmul(o, wo.reshape(H * hd, wo.shape[2]), policy)


def gqa_apply(p, x: torch.Tensor, cfg: ModelConfig, *,
              window: Optional[int] = None, q_offset: int = 0,
              policy: Optional[ExecutionPolicy] = None) -> torch.Tensor:
    """Full-sequence GQA attention through ``flash_attention``.
    x: (B, S, d)."""
    S = x.shape[1]
    q = _project(x, p["wq"], policy)
    k = _project(x, p["wk"], policy)
    v = _project(x, p["wv"], policy)
    if cfg.rope:
        pos = q_offset + torch.arange(S, device=x.device)
        cos, sin = rope_angles(pos, cfg.resolved_head_dim, cfg.rope_theta,
                               wide_dtype(x.dtype))
        q = apply_rope(q, cos[None, None], sin[None, None])
        k = apply_rope(k, cos[None, None], sin[None, None])
    o = flash_attention(q, k, v, causal=cfg.causal, window=window,
                        q_offset=q_offset)
    return _out_project(o, p["wo"], policy)


def gqa_decode(p, x: torch.Tensor, cfg: ModelConfig, k_cache: torch.Tensor,
               v_cache: torch.Tensor, length: torch.Tensor, *,
               window: Optional[int] = None,
               rows: Optional[torch.Tensor] = None,
               policy: Optional[ExecutionPolicy] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token step.  x: (B, 1, d); caches (B, Hkv, T, hd); ``length``
    per-sequence (B,).  Returns (out (B,1,d), k_cache, v_cache).

    The caches are written in place (the JAX step returns new arrays): each
    slot's new K/V row lands at ``length % T`` (a ring for windowed
    layers).  ``rows`` (indices into the batch, default all) selects the
    slots whose rows are written — a masked scatter, so any other slot's
    rows stay untouched, which is what the JAX chunked prefill's per-slot
    merge leaves."""
    B = x.shape[0]
    length = torch.as_tensor(length, dtype=torch.int64,
                             device=x.device).expand(B)
    q = _project(x, p["wq"], policy)
    k = _project(x, p["wk"], policy)
    v = _project(x, p["wv"], policy)
    if cfg.rope:
        cos, sin = rope_angles(length, cfg.resolved_head_dim, cfg.rope_theta,
                               wide_dtype(x.dtype))
        q = apply_rope(q, cos[:, None, None], sin[:, None, None])
        k = apply_rope(k, cos[:, None, None], sin[:, None, None])
    T = k_cache.shape[2]
    slot = length % T
    if rows is None:
        rows = torch.arange(B, device=x.device)
    k_cache[rows, :, slot[rows]] = k[rows, :, 0].to(k_cache.dtype)
    v_cache[rows, :, slot[rows]] = v[rows, :, 0].to(v_cache.dtype)
    if window is None:
        o = decode_attention_ref(q, k_cache, v_cache, length + 1)
    else:
        # ring cache: all T slots valid once full; positions are implicit
        valid = torch.clamp(length + 1, max=T)
        o = decode_attention_ref(q, k_cache, v_cache, valid)
    return _out_project(o, p["wo"], policy), k_cache, v_cache
