"""Model assembly for every family of the registry: dense (GQA or MLA),
MoE, SSM, hybrid, and the dense stack behind a vision frontend (vlm) or
an audio one: parameter trees, forward pass, KV, latent and state caches,
decode step and chunked prefill, and the shapes of every parameter and
input (:func:`param_shapes`, :func:`input_specs`).

Parameters and caches keep the JAX package's pytree layout — nested dicts,
per-layer leaves stacked on axis 0, batch on axis 1 of every stacked cache
leaf and axis 0 of ``len`` — so :mod:`repro_torch.bridge` carries them
across as a plain tree map.  A Python loop over the layer index takes the
place of ``lax.scan``.  Every matrix product runs through ``queue_matmul``,
the full-sequence attention through ``flash_attention``, every expert
product of an MoE layer through ``moe_gemm``, the full-sequence SSM scan
through ``ssm_scan`` and the full-sequence RG-LRU recurrence through
``rglru_scan``, each under the run's execution policy.  The hybrid family
(recurrentgemma) keeps the reference's tree: its repeating (rec, rec, attn)
macro block stacked over ``n_full`` under ``"macros"`` and the unstacked
tail layers as ``tail_{j}_{kind}``.  An MLA model (minicpm3) runs its
attention expanded in ``forward`` (through ``flash_attention`` with a v
head dim below q's) and absorbed in decode and chunks (through
``latent_attention``), over a cache of latent and rope-key rows.  The frontends are stubs, as in the reference: the vision
family (pixtral) takes precomputed patch embeddings in place of its first
``n_frontend_tokens`` token embeddings, the audio family (hubert, an
encoder: ``causal=False``) precomputed frame embeddings in place of
tokens (:func:`embed_inputs`); decode embeds tokens only, as there.

``forward`` honours ``rc.remat`` as the reference's ``_stack_scan`` does
with ``jax.checkpoint``: when a gradient is taken (grad mode on and a
parameter requiring grad), each layer (each macro block of the hybrid
family) runs under ``torch.utils.checkpoint``, so its activations are
recomputed in the backward instead of kept.  A stacked leaf is taken
apart once per ``forward`` with ``unbind(0)``, whose backward is one
``stack``, where indexing it layer by layer would give every layer a
full-size zero gradient to add into.

Two departures from the functional JAX code, both invisible in the
numbers:

* :func:`prepare_params` casts the weights to the compute dtype once, at
  load, where the JAX step casts fp32 leaves inside every jitted call (the
  values are the same), holds the head transposed and contiguous
  (``head_t``, (d, vocab)) so the logits are one ``x @ head_t``, and an
  MLA layer's W_uk and W_uv head-major beside them (``wuk_h``, ``wuv_h``)
  for the absorbed form's per-head products;
* :func:`decode_step` and :func:`prefill_step` update the cache in place
  and return the same dict.

Where the reference's chunked prefill scans its decode body over a chunk's
columns, every decoder family (:func:`batches_columns`) runs the columns as
one body over C x B rows (:func:`_columns_body`), and its decode step is
that body at C = 1; each op runs row by row and only the SSM and RG-LRU
recurrences walk the columns, so the result is the reference's, bit for
bit the token-by-token path's.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..config import ModelConfig, RunConfig, ShapeConfig
from ..device import (DeviceLike, resolve_device, torch_dtype, upcast,
                      wide_dtype)
from . import attention as attn
from . import moe as moe_mod
from . import rglru as rglru_mod
from . import ssm as ssm_mod
from ..kernels.rms_norm import rms_norm as norm_rows
from .layers import (ParamSpec, column_mask, ffn_apply, ffn_specs,
                     init_params, matmul, rms_norm, tree_leaves, tree_map)

Pytree = Any


def _check_family(cfg: ModelConfig) -> None:
    """The family must name the layer stack its config carries (vlm and
    audio run the dense one), and a frontend be vision or audio."""
    stack = ("moe" if cfg.moe else "ssm" if cfg.ssm else
             "hybrid" if cfg.rglru else "dense")
    want = "dense" if cfg.family in ("vlm", "audio") else cfg.family
    if stack != want or cfg.frontend not in (None, "vision", "audio"):
        raise NotImplementedError(
            f"{cfg.name}: family={cfg.family!r} over a {stack} stack with "
            f"frontend={cfg.frontend!r} is no architecture of the registry")


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------

def _stack_specs(specs: Pytree, n: int) -> Pytree:
    if isinstance(specs, ParamSpec):
        return ParamSpec((n, *specs.shape), ("layers", *specs.axes),
                         specs.init, specs.scale)
    return {k: _stack_specs(v, n) for k, v in specs.items()}


def _dense_block_specs(cfg: ModelConfig) -> Dict[str, Pytree]:
    d = cfg.d_model
    return {"ln1": ParamSpec((d,), ("embed",), init="zeros"),
            "ln2": ParamSpec((d,), ("embed",), init="zeros"),
            "attn": attn.mla_specs(cfg) if cfg.mla else attn.gqa_specs(cfg),
            "ffn": (moe_mod.moe_specs(cfg) if cfg.moe
                    else ffn_specs(d, cfg.d_ff, cfg.ffn_act))}


def _rec_block_specs(cfg: ModelConfig) -> Dict[str, Pytree]:
    d = cfg.d_model
    return {"ln1": ParamSpec((d,), ("embed",), init="zeros"),
            "ln2": ParamSpec((d,), ("embed",), init="zeros"),
            "rglru": rglru_mod.rglru_specs(cfg),
            "ffn": ffn_specs(d, cfg.d_ff, cfg.ffn_act)}


def _hybrid_layout(cfg: ModelConfig) -> Tuple[int, Tuple[str, ...]]:
    """(number of whole macro blocks, kinds of the tail layers)."""
    pat = cfg.rglru.pattern
    n_full = cfg.n_layers // len(pat)
    tail = tuple(pat[:cfg.n_layers % len(pat)])
    return n_full, tail


def _is_blocks(key: str) -> bool:
    """Whether a top-level key of the parameter tree holds layer weights."""
    return key in ("blocks", "macros") or key.startswith("tail_")


def param_specs(cfg: ModelConfig) -> Pytree:
    _check_family(cfg)
    d = cfg.d_model
    tree: Dict[str, Pytree] = {
        "embed": ParamSpec((cfg.vocab, d), ("vocab", "embed"),
                           init="embed", scale=0.02),
        "final_norm": ParamSpec((d,), ("embed",), init="zeros"),
    }
    if not cfg.tie_embeddings:
        tree["head"] = ParamSpec((cfg.vocab, d), ("vocab", "embed"),
                                 init="embed", scale=0.02)
    if cfg.family == "hybrid":
        kind_specs = {"rec": _rec_block_specs, "attn": _dense_block_specs}
        n_full, tail = _hybrid_layout(cfg)
        tree["macros"] = _stack_specs(
            {f"{j}_{kind}": kind_specs[kind](cfg)
             for j, kind in enumerate(cfg.rglru.pattern)}, n_full)
        for j, kind in enumerate(tail):
            tree[f"tail_{j}_{kind}"] = kind_specs[kind](cfg)
        return tree
    if cfg.family == "ssm":
        block = {"ln1": ParamSpec((d,), ("embed",), init="zeros"),
                 "mamba": ssm_mod.mamba_specs(cfg)}
    else:
        block = _dense_block_specs(cfg)
    tree["blocks"] = _stack_specs(block, cfg.n_layers)
    return tree


def param_shapes(cfg: ModelConfig, dtype) -> Pytree:
    """The parameter tree as ``(shape, torch dtype)`` pairs (the convention
    of :func:`cache_spec`), every leaf in ``dtype``; nothing is
    allocated."""
    dt = torch_dtype(dtype)
    return tree_map(lambda s: (s.shape, dt), param_specs(cfg))


def init_model_params(gen: "torch.Generator | int", cfg: ModelConfig,
                      dtype: torch.dtype = torch.float32,
                      device: DeviceLike = None) -> Pytree:
    """Random weights for ``cfg`` on ``device`` (``None`` = the card).
    ``gen`` is a ``torch.Generator`` on that device, or an int seed for
    one."""
    dev = resolve_device(device)
    if isinstance(gen, int):
        gen = torch.Generator(device=dev).manual_seed(gen)
    return init_params(gen, param_specs(cfg), dtype, dev)


def prepare_params(params: Pytree, cfg: ModelConfig, rc: RunConfig) -> Pytree:
    """The weights as the step functions want them, made once at load:
    fp32 layer leaves (``blocks``, or the hybrid ``macros`` and ``tail_*``),
    ``embed`` and the head cast to ``rc.dtype`` (the cast the JAX step
    applies inside every call; ``final_norm`` stays as given, as there),
    the head held transposed and contiguous as ``head_t`` (d, vocab) in
    place of ``head``, and an MLA model's W_uk and W_uv also head-major
    (:func:`~repro_torch.models.attention.head_major`)."""
    dtype = torch_dtype(rc.dtype)
    out = {k: (_cast(v, dtype) if _is_blocks(k) else v)
           for k, v in params.items() if k != "head"}
    out["embed"] = params["embed"].to(dtype)
    out["head_t"] = _head_t(params, cfg, dtype)
    if cfg.mla:
        out["blocks"]["attn"].update(attn.head_major(out["blocks"]["attn"]))
    return out


def _head_t(params: Pytree, cfg: ModelConfig,
            dtype: torch.dtype) -> torch.Tensor:
    if "head_t" in params:
        return params["head_t"].to(dtype)
    head = params["embed"] if cfg.tie_embeddings else params["head"]
    return head.to(dtype).t().contiguous()


def _cast(tree: Pytree, dtype: torch.dtype) -> Pytree:
    """fp32 leaves cast to the compute dtype (a no-op on prepared
    weights)."""
    return tree_map(lambda a: a.to(dtype) if a.dtype == torch.float32
                    else a, tree)


def _layer(blocks: Pytree, i: int, dtype: torch.dtype) -> Pytree:
    """Layer ``i``'s leaves of a stacked tree, cast as by :func:`_cast`."""
    return _cast(tree_map(lambda a: a[i], blocks), dtype)


def _layers(params: Pytree, cfg: ModelConfig,
            dtype: torch.dtype) -> Iterator[Tuple[str, Pytree]]:
    """``(kind, leaves)`` of every layer in the order the model runs them:
    kind ``"attn"`` (a GQA or MLA block with its FFN), ``"ssm"`` (a Mamba
    block) or ``"rec"`` (an RG-LRU block with its FFN).  The hybrid family runs its
    macro blocks, ``pattern * n_full``, then its tail."""
    if cfg.family != "hybrid":
        kind = "ssm" if cfg.family == "ssm" else "attn"
        for i in range(cfg.n_layers):
            yield kind, _layer(params["blocks"], i, dtype)
        return
    n_full, tail = _hybrid_layout(cfg)
    for i in range(n_full):
        for j, kind in enumerate(cfg.rglru.pattern):
            yield kind, _layer(params["macros"][f"{j}_{kind}"], i, dtype)
    for j, kind in enumerate(tail):
        yield kind, _cast(params[f"tail_{j}_{kind}"], dtype)


def _unstack(tree: Pytree) -> List[Pytree]:
    """A stacked tree as one uncast tree per layer, every leaf taken apart
    once with ``unbind(0)``."""
    parts = tree_map(lambda a: a.unbind(0), tree)
    first = parts
    while isinstance(first, dict):
        first = next(iter(first.values()))
    return [tree_map(lambda t: t[i], parts) for i in range(len(first))]


def _window(cfg: ModelConfig) -> Optional[int]:
    """The attention layers' local window: the hybrid family's, else
    none."""
    return cfg.rglru.window if cfg.family == "hybrid" else None


# ---------------------------------------------------------------------------
# forward (prefill / scoring)
# ---------------------------------------------------------------------------

def embed_inputs(params: Pytree, batch: Dict[str, torch.Tensor],
                 cfg: ModelConfig, dtype: torch.dtype) -> torch.Tensor:
    """The first layer's input: the audio frontend's ``frames`` (B, S, d)
    as given; else the token embeddings, the vision frontend's ``patches``
    (B, n_frontend_tokens, d) in front of those of positions
    ``n_frontend_tokens`` on.  As in the reference, S is neither cut nor
    padded: at S <= n_frontend_tokens the result has the patches' rows."""
    if cfg.frontend == "audio":
        return batch["frames"].to(dtype)
    x = params["embed"][batch["tokens"]].to(dtype)
    if cfg.frontend == "vision":
        n = cfg.n_frontend_tokens
        x = torch.cat([batch["patches"].to(dtype), x[:, n:]], dim=1)
    return x


def _dense_block_apply(p, x, cfg: ModelConfig, rc: RunConfig,
                       q_offset: int = 0, window: Optional[int] = None):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.mla:
        h = attn.mla_apply(p["attn"], h, cfg, q_offset=q_offset,
                           policy=rc.policy)
    else:
        h = attn.gqa_apply(p["attn"], h, cfg, window=window,
                           q_offset=q_offset, policy=rc.policy)
    x = x + h
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + _ffn(p["ffn"], h, cfg, rc)


def _ffn(p, h, cfg: ModelConfig, rc: RunConfig) -> torch.Tensor:
    """The block's FFN: dense, or MoE with the run's dispatch (the decode
    step always takes the dense dispatch, as the reference's does)."""
    if not cfg.moe:
        return ffn_apply(p, h, cfg.ffn_act, rc.policy)
    if rc.moe_dispatch == "grouped":
        return moe_mod.moe_apply_grouped(p, h, cfg, policy=rc.policy)
    return moe_mod.moe_apply(p, h, cfg, policy=rc.policy)


def _rec_block_apply(p, x, cfg: ModelConfig, rc: RunConfig):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + rglru_mod.rglru_apply(p["rglru"], h, cfg, rc.policy)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + ffn_apply(p["ffn"], h, cfg.ffn_act, rc.policy)


def _ssm_block_apply(p, x, cfg: ModelConfig, rc: RunConfig):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    return x + ssm_mod.mamba_apply(p["mamba"], h, cfg, rc.policy)


def _block_apply(kind: str, p, x, cfg: ModelConfig, rc: RunConfig):
    if kind == "ssm":
        return _ssm_block_apply(p, x, cfg, rc)
    if kind == "rec":
        return _rec_block_apply(p, x, cfg, rc)
    return _dense_block_apply(p, x, cfg, rc, window=_window(cfg))


def forward(params: Pytree, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            rc: RunConfig) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, vocab) in the compute dtype.
    Attention runs through ``flash_attention`` (with the hybrid family's
    local window; MLA's expanded form with its v head dim), the SSM scan
    through ``ssm_scan``, the RG-LRU recurrence through ``rglru_scan``.
    With ``rc.remat``, when a gradient is taken (grad mode on and a
    parameter requiring grad), each stacked layer (each hybrid macro
    block; not the hybrid tail, as in the reference) is checkpointed."""
    _check_family(cfg)
    dtype = torch_dtype(rc.dtype)
    x = embed_inputs(params, batch, cfg, dtype)
    # only when a gradient is taken: serving never checkpoints
    remat = rc.remat and torch.is_grad_enabled() and any(
        p.requires_grad for p in tree_leaves(params))

    def run(fn, *args):
        return (checkpoint(fn, *args, use_reentrant=False) if remat
                else fn(*args))

    if cfg.family == "hybrid":
        def macro(h, mp):
            mp = _cast(mp, dtype)
            for j, kind in enumerate(cfg.rglru.pattern):
                h = _block_apply(kind, mp[f"{j}_{kind}"], h, cfg, rc)
            return h
        for mp in _unstack(params["macros"]):
            x = run(macro, x, mp)
        for j, kind in enumerate(_hybrid_layout(cfg)[1]):
            x = _block_apply(kind, _cast(params[f"tail_{j}_{kind}"], dtype),
                             x, cfg, rc)
    else:
        kind = "ssm" if cfg.family == "ssm" else "attn"
        for bp in _unstack(params["blocks"]):
            x = run(lambda h, p: _block_apply(kind, _cast(p, dtype), h, cfg,
                                              rc), x, bp)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return matmul(x, _head_t(params, cfg, dtype), rc.policy)


# ---------------------------------------------------------------------------
# decode caches + step
# ---------------------------------------------------------------------------

def cache_spec(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype) -> Dict[str, Tuple[Tuple[int, ...],
                                                       torch.dtype]]:
    """Shape and dtype of every cache leaf.  ``len`` is per-sequence: each
    slot of a continuously batched engine carries its own position.  The
    SSM family keeps an fp32 state (L, B, d_in, N) and the last K-1 conv
    inputs (L, B, K-1, d_in) in the compute dtype instead of K/V.  The
    hybrid family keeps, over its recurrent layers, an fp32 h (n_rec, B, w)
    and the conv inputs (n_rec, B, K-1, w), and over its attention layers a
    K/V ring (n_attn, B, Hkv, W, hd) of ``W = min(window, max_len)``.  MLA
    keeps the latent (L, B, max_len, kv_lora_rank) and the rope key
    (L, B, max_len, qk_rope_head_dim) in the compute dtype instead of
    K/V."""
    _check_family(cfg)
    L, hd = cfg.n_layers, cfg.resolved_head_dim
    out = {"len": ((batch,), torch.int32)}
    if cfg.family == "hybrid":
        n_full, tail = _hybrid_layout(cfg)
        kinds = list(cfg.rglru.pattern) * n_full + list(tail)
        n_rec = kinds.count("rec")
        w = cfg.rglru.lru_width or cfg.d_model
        ring = min(cfg.rglru.window, max_len)
        kv = ((len(kinds) - n_rec, batch, cfg.n_kv_heads, ring, hd), dtype)
        return {**out, "h": ((n_rec, batch, w), wide_dtype(dtype)),
                "conv": ((n_rec, batch, cfg.rglru.conv_width - 1, w), dtype),
                "k": kv, "v": kv}
    if cfg.family == "ssm":
        d_in, _, d_state = ssm_mod.ssm_dims(cfg)
        out["ssm"] = ((L, batch, d_in, d_state), wide_dtype(dtype))
        out["conv"] = ((L, batch, cfg.ssm.d_conv - 1, d_in), dtype)
        return out
    if cfg.mla:
        m = cfg.mla
        return {**out,
                "latent": ((L, batch, max_len, m.kv_lora_rank), dtype),
                "rope": ((L, batch, max_len, m.qk_rope_head_dim), dtype)}
    kv = ((L, batch, cfg.n_kv_heads, max_len, hd), dtype)
    return {**out, "k": kv, "v": kv}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
               device: DeviceLike = None) -> Pytree:
    dev = resolve_device(device)
    return {k: torch.zeros(shape, dtype=dt, device=dev)
            for k, (shape, dt) in cache_spec(cfg, batch, max_len,
                                             torch_dtype(dtype)).items()}


def batches_columns(cfg: ModelConfig) -> bool:
    """Whether a chunk runs its columns as one batched body
    (:func:`_columns_body`): every decoder family, MLA's (minicpm3)
    included.  The encoder has no decode step."""
    return cfg.family in ("dense", "vlm", "moe", "ssm", "hybrid")


def _attends_by_column(cfg: ModelConfig, cache: Pytree) -> bool:
    """Whether a chunk's attention layers must run one column at a time: a
    windowed layer whose ring is its window (``W = min(window, max_len)``
    rows, so ``max_len`` may pass it), where a later column's row may wrap
    onto one an earlier column attends.  A ring shorter than the window is
    the whole cache, as a dense layer's is.  Static: the config and the
    cache's shape."""
    return cfg.family == "hybrid" and cache["k"].shape[3] >= cfg.rglru.window


def _attention_columns(p, x: torch.Tensor, cfg: ModelConfig,
                       k_cache: torch.Tensor, v_cache: torch.Tensor,
                       where: tuple, active: Optional[torch.Tensor],
                       by_column: bool, policy) -> torch.Tensor:
    """:func:`~repro_torch.models.attention.gqa_columns` over x (C, B, d),
    at once or (``by_column``) one column at a time."""
    if not by_column:
        return attn.gqa_columns(p, x, cfg, k_cache, v_cache, *where, active,
                                policy)
    return torch.cat([attn.gqa_columns(
        p, x[j:j + 1], cfg, k_cache, v_cache,
        *(None if t is None else t[j:j + 1] for t in where),
        None if active is None else active[j:j + 1], policy)
        for j in range(x.shape[0])])


def _columns_body(params: Pytree, cache: Pytree, tokens: torch.Tensor,
                  cfg: ModelConfig, rc: RunConfig,
                  n_tokens: Optional[torch.Tensor]) -> torch.Tensor:
    """C columns of B slots as one body: tokens (B, C), column j of slot b
    at position ``len[b] + j``; ``n_tokens`` (B,) the columns each slot
    takes (None: every column of every slot, the decode step).  Writes the
    taken columns' K/V rows and each slot's SSM, RG-LRU and conv states
    after its last taken column in place and returns the fp32 logits
    (B, vocab) after each slot's last taken column (a slot with none gets
    its first column's, for the caller to drop); ``len`` is left to the
    caller.  Where the cache holds K/V, C must not pass its T rows, or a
    masked column could wrap onto a row an active one writes; MLA's latent
    rows clamp at T - 1 and never wrap, so its C is free.

    The activations are (C, B, d), so column j's rows are the j-th slab of
    B: every product (an MoE layer's router and experts, a Mamba or RG-LRU
    block's, an MLA layer's per-head absorb products included) runs in
    slabs of B rows and every norm, attention
    (:func:`~repro_torch.models.attention.gqa_columns`, one column at a
    time where a windowed ring may wrap, :func:`_attends_by_column`;
    :func:`~repro_torch.models.attention.mla_columns`),
    expert combine (:func:`~repro_torch.models.moe.combine_rows`), conv
    and coefficient row by row, so a row's bits are those the one-column
    body (the decode step) gives it.  Only the SSM and RG-LRU recurrences
    walk the columns, at B rows.  The final norm and the vocabulary-wide
    head run on B rows only, each slot's last active column gathered on
    the device."""
    dtype = torch_dtype(rc.dtype)
    B, C = tokens.shape
    dev = tokens.device
    x = params["embed"][tokens.t()].to(dtype)                  # (C, B, d)
    active = column_mask(C, n_tokens)
    if "k" in cache:         # the GQA layers' rows
        where = attn.column_positions(cache["len"], C, cache["k"].shape[3],
                                      cfg, dtype)
        by_column = _attends_by_column(cfg, cache)
    seen = {"attn": 0, "rec": 0, "ssm": 0}
    for kind, bp in _layers(params, cfg, dtype):
        i = seen[kind]
        seen[kind] += 1
        hn = norm_rows(x, bp["ln1"], cfg.norm_eps)
        if kind == "ssm":
            y, ssm_s, conv_s = ssm_mod.mamba_columns(
                bp["mamba"], hn, cfg, cache["ssm"][i], cache["conv"][i],
                n_tokens, rc.policy)
            cache["ssm"][i], cache["conv"][i] = ssm_s, conv_s
            x = x + y
            continue
        if kind == "rec":
            y, h_s, conv_s = rglru_mod.rglru_columns(
                bp["rglru"], hn, cfg, cache["h"][i], cache["conv"][i],
                n_tokens, rc.policy)
            cache["h"][i], cache["conv"][i] = h_s, conv_s
        elif cfg.mla:
            y = attn.mla_columns(bp["attn"], hn, cfg, cache["latent"][i],
                                 cache["rope"][i], cache["len"], active,
                                 rc.policy)
        else:
            y = _attention_columns(bp["attn"], hn, cfg, cache["k"][i],
                                   cache["v"][i], where, active, by_column,
                                   rc.policy)
        x = x + y
        hn = norm_rows(x, bp["ln2"], cfg.norm_eps)
        x = x + (moe_mod.moe_apply(bp["ffn"], hn, cfg, rc.policy, slab=B)
                 if cfg.moe else
                 ffn_apply(bp["ffn"], hn, cfg.ffn_act, rc.policy, slab=B))
    if n_tokens is None:
        last = x[-1]
    else:
        at = torch.clamp(n_tokens.to(torch.int64) - 1, min=0)
        last = x[at, torch.arange(B, device=dev)]
    last = norm_rows(last, params["final_norm"], cfg.norm_eps)
    return upcast(matmul(last, _head_t(params, cfg, dtype), rc.policy,
                         slab=B))


def decode_step(params: Pytree, cache: Pytree,
                batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                rc: RunConfig) -> Tuple[torch.Tensor, Pytree]:
    """One token for every sequence in the batch.
    batch = {"tokens": (B, 1)} -> (logits (B, vocab) fp32, cache).
    The cache is updated in place; ``len`` advances for every slot, free
    ones included, as in the JAX step.  It is the batched body at one
    column (:func:`_columns_body`), so a chunk and its columns' decode
    steps give each row the same bits."""
    _check_family(cfg)
    logits = _columns_body(params, cache, batch["tokens"], cfg, rc, None)
    cache["len"] += 1
    return logits, cache


# ---------------------------------------------------------------------------
# chunked prefill: C prompt tokens per slot per call
# ---------------------------------------------------------------------------

def prefill_step(params: Pytree, cache: Pytree,
                 batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                 rc: RunConfig) -> Tuple[torch.Tensor, Pytree]:
    """Ingest a chunk of up to C prompt tokens per slot in one call.

    ``batch = {"tokens": (B, C), "n_tokens": (B,)}``: slot ``i`` consumes
    its first ``n_tokens[i]`` columns from its own position
    ``cache["len"][i]``; ``0`` leaves the slot untouched.  Returns
    ``(logits, cache)`` with ``logits[i]`` the fp32 next-token logits after
    slot ``i``'s last valid column.

    The reference runs ``lax.scan`` over its decode body, one column at a
    time under the mask ``active = j < n_tokens``.  The port runs the C
    columns as one body over C x B rows (:func:`_columns_body`; where the
    cache holds K/V, a chunk wider than its rows in runs of at most that
    many columns; an SSM or MLA chunk of any width in one: neither wraps),
    every op row by row and only the recurrences walking the columns, so a
    row gets the bits its decode step gives it and a chunk reads each
    weight once, not once a column.  The chunked path is bit-exact with
    token-by-token prefill, nothing is read back to the host and no shape
    depends on the data, so one call is one CUDA graph
    (:mod:`repro_torch.serve.graphs`), and a column whose mask is empty is
    a no-op.
    """
    _check_family(cfg)
    tokens = batch["tokens"]
    n_tokens = torch.as_tensor(batch["n_tokens"], device=tokens.device)
    B, C = tokens.shape
    logits = torch.zeros((B, cfg.vocab), dtype=torch.float32,
                         device=tokens.device)
    # where there are K/V rows, one body a run of at most T columns (the
    # cache's rows), so that no masked column wraps onto a row an active
    # one writes
    T = cache["k"].shape[3] if "k" in cache else max(C, 1)
    for start in range(0, C, T):
        n = torch.clamp(n_tokens - start, 0, T).to(cache["len"].dtype)
        step_logits = _columns_body(params, cache,
                                    tokens[:, start:start + T], cfg, rc, n)
        cache["len"] += n
        logits = torch.where((n > 0)[:, None], step_logits, logits)
    return logits, cache


# ---------------------------------------------------------------------------
# the inputs of every (arch x shape) cell
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                rc: RunConfig) -> Dict[str, Any]:
    """Shape and dtype of every model input of a cell, as ``(shape, torch
    dtype)`` pairs (the convention of :func:`cache_spec`); nothing is
    allocated.  Decode takes a token per sequence and the cache; the other
    modes tokens (with the vision frontend's patches) or the audio
    frontend's frames, and training the labels."""
    B, S = shape.global_batch, shape.seq_len
    dtype = torch_dtype(rc.dtype)
    if shape.mode == "decode":
        return {"tokens": ((B, 1), torch.int32),
                "cache": cache_spec(cfg, B, S, dtype)}
    batch: Dict[str, Any] = {}
    if cfg.frontend == "audio":
        batch["frames"] = ((B, S, cfg.d_model), dtype)
    else:
        batch["tokens"] = ((B, S), torch.int32)
        if cfg.frontend == "vision":
            batch["patches"] = ((B, cfg.n_frontend_tokens, cfg.d_model),
                                dtype)
    if shape.mode == "train":
        batch["labels"] = ((B, S), torch.int32)
    return batch
