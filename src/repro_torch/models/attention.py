"""Attention layers: GQA (full/causal/local-window), MLA, and their decode
paths.

Sequence-level attention (:func:`gqa_apply`, :func:`mla_apply`) runs the
port's ``flash_attention`` op: the CUDA kernel on the card, its plain
version on the CPU.  :func:`flash_attention_ref` is the model-level plain
version, a blockwise online softmax in PyTorch, ported from the JAX
package's reference of the same name.  GQA decode, one column or a
chunk's columns at once (:func:`gqa_columns`), attends through the port's
``decode_attention`` kernel, whose query rows keep their bits whatever
rows run with them; MLA's absorbed scores over the latent cache
(:func:`mla_decode`) stay plain PyTorch, as the JAX package computes them
outside any kernel.  Every 2-D projection runs through ``queue_matmul``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..config import ModelConfig
from ..core.policy import ExecutionPolicy
from ..device import upcast, wide_dtype
from ..kernels.decode_attention import decode_attention
from ..kernels.decode_attention.ref import NEG_INF
from ..kernels.flash_attention import flash_attention
from .layers import ParamSpec, apply_rope, matmul, rms_norm, rope_angles


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


def _write_slot_rows(cache: torch.Tensor, slot: torch.Tensor,
                     new: torch.Tensor,
                     active: Optional[torch.Tensor]) -> None:
    """``cache[b, ..., slot[b], :] = new[b]`` in place for every slot b of
    the (B,) mask ``active`` (all when None), the others' rows written back
    as they were: a gather, a select and a scatter of B rows, nothing that
    depends on the data.  ``cache`` is (B, T, D) or (B, H, T, D), ``new``
    (B, D) or (B, H, D)."""
    b = torch.arange(cache.shape[0], device=cache.device)
    at = (b, slot) if cache.ndim == 3 else (b, slice(None), slot)
    new = new.to(cache.dtype)
    if active is not None:
        new = torch.where(active.reshape((-1,) + (1,) * (new.ndim - 1)),
                          new, cache[at])
    cache[at] = new


def _write_column_rows(cache: torch.Tensor, slot: torch.Tensor,
                       new: torch.Tensor,
                       active: Optional[torch.Tensor]) -> None:
    """``cache[b, :, slot[c, b]] = new[c, b]`` in place for every (column,
    slot) of the (C, B) mask ``active`` (all when None), the other rows
    written back as they were: a gather, a select and a scatter of C x B
    rows, nothing that depends on the data.  ``cache`` is (B, H, T, D),
    ``new`` (C, B, H, D), ``slot`` (C, B) with no row twice."""
    C, B = slot.shape
    b = torch.arange(B, device=cache.device).expand(C, B)
    new = new.to(cache.dtype)
    if active is not None:
        new = torch.where(active[:, :, None, None], new, cache[b, :, slot])
    cache[b, :, slot] = new


def column_positions(length: torch.Tensor, C: int, T: int, cfg: ModelConfig,
                     dtype: torch.dtype):
    """Where C columns of B slots at lengths ``length`` (B,) go, column c of
    slot b at position ``len[b] + c``: the cache row each writes
    (``slot``, (C, B): the position modulo T, a ring for a windowed layer,
    whose T is its window), the rows each attends (``valid``, (C, B):
    [0, min(position + 1, T))) and the RoPE angles of the positions (cos,
    sin (C, B, hd/2) in ``dtype``'s wide dtype; None without RoPE).
    Returns (cos, sin, slot, valid), :func:`gqa_columns`'s order."""
    cols = torch.arange(C, device=length.device)
    pos = length.to(torch.int64)[None] + cols[:, None]
    cos = sin = None
    if cfg.rope:
        cos, sin = rope_angles(pos, cfg.resolved_head_dim, cfg.rope_theta,
                               wide_dtype(dtype))
    return cos, sin, pos % T, torch.clamp(pos + 1, max=T)


def gqa_columns(p, x: torch.Tensor, cfg: ModelConfig, k_cache: torch.Tensor,
                v_cache: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                slot: torch.Tensor, valid: torch.Tensor,
                active: Optional[torch.Tensor] = None,
                policy: Optional[ExecutionPolicy] = None) -> torch.Tensor:
    """C columns of single-token steps of B slots at once (the decode step
    at C = 1).  x: (C, B, d), column c of slot b at position ``len[b] + c``;
    caches (B, Hkv, T, hd), written in place; ``cos``, ``sin``, ``slot``
    and ``valid`` from :func:`column_positions`; ``active`` (C, B) the rows
    whose K/V are written (default all; the others' rows are written back
    as they were, which is what the JAX chunked prefill's per-slot merge
    leaves).  Returns (C, B, d).

    Every K/V row of the columns is written before any query attends, and a
    query's later columns lie at or past its ``valid``, where decode's stale
    rows lie: the mask selects NEG_INF there, so each query attends exactly
    what its own decode step would, unless a later column's row wraps onto
    one it reads (a ring shorter than the chunk's reach: C must be 1 for a
    windowed layer).  Each op runs row by row (products in slabs of B rows,
    the ``decode_attention`` kernel), so every row gets the bits of the
    one-column step."""
    C, B, _ = x.shape
    hd, Hq, Hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads

    def project(w):
        return matmul(x, w.reshape(w.shape[0], -1), policy,
                      slab=B).reshape(C, B, -1, hd)

    q, k, v = project(p["wq"]), project(p["wk"]), project(p["wv"])
    if cfg.rope:
        q = apply_rope(q, cos[:, :, None], sin[:, :, None])
        k = apply_rope(k, cos[:, :, None], sin[:, :, None])
    _write_column_rows(k_cache, slot, k, active)
    _write_column_rows(v_cache, slot, v, active)
    o = decode_attention(q, k_cache, v_cache, valid)
    wo = p["wo"]
    return matmul(o.reshape(C, B, Hq * hd), wo.reshape(Hq * hd, wo.shape[2]),
                  policy, slab=B)


# ---------------------------------------------------------------------------
# MLA (Multi-head Latent Attention, MiniCPM3/DeepSeek-style)
# ---------------------------------------------------------------------------

def mla_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, m, H = cfg.d_model, cfg.mla, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wdq": ParamSpec((d, m.q_lora_rank), ("embed", "lora")),
        "q_norm": ParamSpec((m.q_lora_rank,), ("lora",), init="zeros"),
        "wuq": ParamSpec((m.q_lora_rank, H, qk), ("lora", "heads", "head_dim")),
        "wdkv": ParamSpec((d, m.kv_lora_rank + m.qk_rope_head_dim),
                          ("embed", "lora")),
        "kv_norm": ParamSpec((m.kv_lora_rank,), ("lora",), init="zeros"),
        "wuk": ParamSpec((m.kv_lora_rank, H, m.qk_nope_head_dim),
                         ("lora", "heads", "head_dim")),
        "wuv": ParamSpec((m.kv_lora_rank, H, m.v_head_dim),
                         ("lora", "heads", "head_dim")),
        "wo": ParamSpec((H, m.v_head_dim, d), ("heads", "head_dim", "embed")),
    }


def _mla_qkv(p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
             policy: Optional[ExecutionPolicy]):
    """The query heads' nope and rope parts (B, H, S, .), the normed latent
    (B, S, r) and the shared rope key (B, S, rope_dim); RoPE at
    ``positions``, (B, S) or (1, S)."""
    m = cfg.mla
    cq = rms_norm(matmul(x, p["wdq"], policy), p["q_norm"], cfg.norm_eps)
    q = _project(cq, p["wuq"], policy)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    ckv = matmul(x, p["wdkv"], policy)
    latent = rms_norm(ckv[..., :m.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    cos, sin = rope_angles(positions, m.qk_rope_head_dim, cfg.rope_theta,
                           wide_dtype(x.dtype))
    return (q_nope, apply_rope(q_rope, cos[:, None], sin[:, None]), latent,
            apply_rope(ckv[..., m.kv_lora_rank:], cos, sin))


def mla_apply(p, x: torch.Tensor, cfg: ModelConfig, *, q_offset: int = 0,
              policy: Optional[ExecutionPolicy] = None) -> torch.Tensor:
    """The expanded form, for ``forward``: the latent is projected to every
    head's k (nope part, with the shared rope key appended) and v, and the
    heads run causal ``flash_attention`` with q/k head dim
    ``nope + rope`` and v head dim ``v_head_dim``.  x: (B, S, d)."""
    m = cfg.mla
    B, S, _ = x.shape
    pos = q_offset + torch.arange(S, device=x.device)
    q_nope, q_rope, latent, k_rope = _mla_qkv(p, x, cfg, pos[None], policy)
    k_nope = _project(latent, p["wuk"], policy)
    v = _project(latent, p["wuv"], policy)
    k = torch.cat([k_nope, k_rope[:, None].expand(
        B, cfg.n_heads, S, m.qk_rope_head_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    o = flash_attention(q, k, v, causal=True, q_offset=q_offset)
    return _out_project(o, p["wo"], policy)


def mla_decode(p, x: torch.Tensor, cfg: ModelConfig,
               latent_cache: torch.Tensor, rope_cache: torch.Tensor,
               length: torch.Tensor, *,
               active: Optional[torch.Tensor] = None,
               policy: Optional[ExecutionPolicy] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The absorbed form, for decode: the caches hold only the latent
    (B, T, r) and the rope key (B, T, rope_dim); the score of position t
    is ``q_nope W_uk . latent_t + q_rope . k_rope_t``.  x: (B, 1, d);
    ``length`` per-sequence (B,).  Returns (out (B, 1, d), latent_cache,
    rope_cache).

    The caches are written in place, the slots of the (B,) mask
    ``active`` only (default all; the others' rows are written back
    unchanged), at ``min(length, T - 1)``: the reference writes with
    ``dynamic_update_slice`` at ``length``, which JAX clamps to the last
    row once a slot's length reaches T (the engine advances free slots'
    lengths too), where GQA's ring writes at ``length % T``.  Every
    position up to ``length`` is attended, so past T all T rows are."""
    m = cfg.mla
    B = x.shape[0]
    length = torch.as_tensor(length, dtype=torch.int64,
                             device=x.device).expand(B)
    q_nope, q_rope, lat_t, k_rope_t = _mla_qkv(p, x, cfg, length[:, None],
                                               policy)
    T = latent_cache.shape[1]
    slot = torch.clamp(length, max=T - 1)
    _write_slot_rows(latent_cache, slot, lat_t[:, 0], active)
    _write_slot_rows(rope_cache, slot, k_rope_t[:, 0], active)

    q_eff = torch.einsum("bhsk,rhk->bhsr", q_nope, p["wuk"])   # (B,H,1,r)
    lat = upcast(latent_cache)
    s = (torch.einsum("bhsr,btr->bhst", upcast(q_eff), lat)
         + torch.einsum("bhsk,btk->bhst", upcast(q_rope),
                        upcast(rope_cache)))
    s = s / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    mask = torch.arange(T, device=x.device)[None] <= length[:, None]
    s = torch.where(mask[:, None, None], s, NEG_INF)
    o_lat = torch.einsum("bhst,btr->bhsr", torch.softmax(s, dim=-1), lat)
    o = torch.einsum("bhsr,rhk->bhsk", o_lat.to(x.dtype), p["wuv"])
    return _out_project(o, p["wo"], policy), latent_cache, rope_cache
