"""Attention layers: GQA (full/causal/local-window), MLA, and their decode
paths.

Sequence-level attention (:func:`gqa_apply`, :func:`mla_apply`) runs the
port's ``flash_attention`` op: the CUDA kernel on the card, its plain
version on the CPU.  :func:`flash_attention_ref` is the model-level plain
version, a blockwise online softmax in PyTorch, ported from the JAX
package's reference of the same name.  Decode, one column or a chunk's
columns at once, attends through kernels whose query rows keep their bits
whatever rows run with them: GQA (:func:`gqa_columns`) through
``decode_attention``, MLA's absorbed form over the latent cache
(:func:`mla_columns`) through ``latent_attention``, its per-head absorb
products through ``moe_gemm`` with the heads as experts.  Every 2-D
projection runs through ``queue_matmul``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..config import ModelConfig
from ..core.policy import ExecutionPolicy
from ..device import wide_dtype
from ..kernels.decode_attention import decode_attention
from ..kernels.decode_attention.ref import NEG_INF
from ..kernels.flash_attention import flash_attention
from ..kernels.latent_attention import latent_attention
from ..kernels.rms_norm import rms_norm as norm_rows
from .layers import ParamSpec, apply_rope, matmul, rms_norm, rope_angles
from .moe import expert_gemm


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


def head_major(p) -> Dict[str, torch.Tensor]:
    """W_uk and W_uv of MLA layers held head-major, as the absorbed form's
    per-head products take them: ``wuk_h`` (..., H, nope, r) and ``wuv_h``
    (..., H, r, v) from ``wuk`` (..., r, H, nope) and ``wuv`` (..., r, H,
    v), stacked over layers or not; contiguous copies, made once at load
    (:func:`~repro_torch.models.model.prepare_params`)."""
    return {"wuk_h": p["wuk"].movedim(-3, -1).contiguous(),
            "wuv_h": p["wuv"].movedim(-2, -3).contiguous()}


def _per_head(x: torch.Tensor, w: torch.Tensor,
              policy: Optional[ExecutionPolicy], slab: int) -> torch.Tensor:
    """einsum("cbhk,hkn->cbhn"): x (C, B, H, k) through each head's own
    (k, n) matrix of the head-major w (H, k, n), in x's dtype.  The heads
    are ``moe_gemm``'s experts, each product row by row in slabs of
    ``slab`` rows, so a row keeps the bits of its slab alone."""
    C, B, H, k = x.shape
    y = expert_gemm(x.permute(2, 0, 1, 3).reshape(H, C * B, k), w, policy,
                    None, slab)
    return y.reshape(H, C, B, -1).permute(1, 2, 0, 3).contiguous()


def _write_clamped_rows(cache: torch.Tensor, pos: torch.Tensor,
                        new: torch.Tensor,
                        active: Optional[torch.Tensor]) -> None:
    """The rows C columns of B slots leave in ``cache`` (B, T, D), in place,
    as their one-column steps in order leave it: column c of slot b, at
    position ``pos[c, b]``, writes row ``min(pos, T - 1)`` where the (C, B)
    mask ``active`` (None: all) takes it.  ``new`` is (C, B, D).

    A row below T - 1 is written by one column at most (a scatter whose
    other entries, the columns at or past T - 1, write that row's value
    back, so no index gets two values); row T - 1 then takes, by a (B,)
    select, the last active column's row where that column's position
    reaches it, and keeps its value otherwise.  Nothing depends on the
    data."""
    C, B = pos.shape
    last = cache.shape[1] - 1
    b = torch.arange(B, device=cache.device)
    slot = torch.clamp(pos, max=last)
    keep = pos < last
    if active is not None:
        keep = keep & active
    at = (b.expand(C, B), slot)
    cache[at] = torch.where(keep[..., None], new, cache[at])
    n = (torch.full((B,), C, device=cache.device) if active is None
         else active.sum(0))
    j = torch.clamp(n - 1, min=0)
    reach = (n > 0) & (pos[j, b] >= last)
    cache[:, last] = torch.where(reach[:, None], new[j, b], cache[:, last])


def mla_columns(p, x: torch.Tensor, cfg: ModelConfig,
                latent_cache: torch.Tensor, rope_cache: torch.Tensor,
                length: torch.Tensor, active: Optional[torch.Tensor] = None,
                policy: Optional[ExecutionPolicy] = None) -> torch.Tensor:
    """C columns of single-token steps of B slots at once, in MLA's
    absorbed form (the decode step at C = 1): x (C, B, d), column c of slot
    b at position ``len[b] + c`` (``length`` (B,)); the caches hold only
    the latent (B, T, r) and the rope key (B, T, rope_dim), written in
    place (:func:`_write_clamped_rows`: at ``min(position, T - 1)``, the
    row the reference's ``dynamic_update_slice`` clamps to, for the
    columns of the (C, B) mask ``active``, default all).  Returns
    (C, B, d).

    The score of position t is ``q_nope W_uk . latent_t + q_rope .
    k_rope_t``: column c reads the cache rows [0, min(position, T - 1)) and
    then its own new row, which is what its decode step reads after
    writing that row (the rows below T - 1 that earlier columns of the
    chunk write are written before the attention).  Each op runs row by
    row (the products
    in slabs of B rows, the norms through ``rms_norm``, the per-head
    absorb products through ``moe_gemm``, the attention through
    ``latent_attention``), so every row gets the bits of the one-column
    step; RoPE at each column's true position."""
    m = cfg.mla
    C, B, _ = x.shape
    H, nope, r = cfg.n_heads, m.qk_nope_head_dim, m.kv_lora_rank
    T = latent_cache.shape[1]
    pos = (length.to(torch.int64)[None]
           + torch.arange(C, device=x.device)[:, None])
    cq = norm_rows(matmul(x, p["wdq"], policy, slab=B), p["q_norm"],
                   cfg.norm_eps)
    wuq = p["wuq"]
    q = matmul(cq, wuq.reshape(wuq.shape[0], -1), policy,
               slab=B).reshape(C, B, H, -1)
    ckv = matmul(x, p["wdkv"], policy, slab=B)
    cos, sin = rope_angles(pos, m.qk_rope_head_dim, cfg.rope_theta,
                           wide_dtype(x.dtype))
    q_rope = apply_rope(q[..., nope:], cos[:, :, None], sin[:, :, None])
    lat = norm_rows(ckv[..., :r], p["kv_norm"],
                    cfg.norm_eps).to(latent_cache.dtype)
    k_rope = apply_rope(ckv[..., r:], cos, sin).to(rope_cache.dtype)
    _write_clamped_rows(latent_cache, pos, lat, active)
    _write_clamped_rows(rope_cache, pos, k_rope, active)
    w = p if "wuk_h" in p else head_major(p)
    q_eff = _per_head(q[..., :nope], w["wuk_h"], policy, B)
    o_lat = latent_attention(q_eff, q_rope, latent_cache, rope_cache,
                             torch.clamp(pos, max=T - 1), lat, k_rope,
                             1.0 / math.sqrt(nope + m.qk_rope_head_dim))
    o = _per_head(o_lat.to(x.dtype), w["wuv_h"], policy, B)
    wo = p["wo"]
    return matmul(o.reshape(C, B, -1), wo.reshape(-1, wo.shape[2]), policy,
                  slab=B)


def mla_decode(p, x: torch.Tensor, cfg: ModelConfig,
               latent_cache: torch.Tensor, rope_cache: torch.Tensor,
               length: torch.Tensor, *,
               active: Optional[torch.Tensor] = None,
               policy: Optional[ExecutionPolicy] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The absorbed form for one token a slot: :func:`mla_columns` at
    C = 1.  x: (B, 1, d); ``length`` per-sequence (B,) or a scalar;
    ``active`` (B,) the slots whose rows are written (default all).
    Returns (out (B, 1, d), latent_cache, rope_cache), the caches written
    in place at ``min(length, T - 1)``: the reference writes with
    ``dynamic_update_slice`` at ``length``, which JAX clamps to the last
    row once a slot's length reaches T (the engine advances free slots'
    lengths too), where GQA's ring writes at ``length % T``.  Every
    position up to ``length`` is attended, so past T all T rows are."""
    B = x.shape[0]
    length = torch.as_tensor(length, dtype=torch.int64,
                             device=x.device).expand(B)
    out = mla_columns(p, x.transpose(0, 1), cfg, latent_cache, rope_cache,
                      length, None if active is None else active[None],
                      policy)
    return out.transpose(0, 1), latent_cache, rope_cache
