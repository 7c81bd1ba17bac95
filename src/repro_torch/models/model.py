"""Model assembly for the dense GQA, MoE and SSM families: parameter trees,
forward pass, KV and state caches, decode step and chunked prefill.

Parameters and caches keep the JAX package's pytree layout — nested dicts,
per-layer leaves stacked on axis 0, batch on axis 1 of every stacked cache
leaf and axis 0 of ``len`` — so :mod:`repro_torch.bridge` carries them
across as a plain tree map.  A Python loop over the layer index takes the
place of ``lax.scan``.  Every matrix product runs through ``queue_matmul``,
the full-sequence attention through ``flash_attention``, every expert
product of an MoE layer through ``moe_gemm`` and the full-sequence SSM scan
through ``ssm_scan``, each under the run's execution policy.

Two departures from the functional JAX code, both invisible in the
numbers:

* :func:`prepare_params` casts the weights to the compute dtype once, at
  load, where the JAX step casts fp32 leaves inside every jitted call (the
  values are the same), and holds the head transposed and contiguous
  (``head_t``, (d, vocab)) so the logits are one ``x @ head_t``;
* :func:`decode_step` and :func:`prefill_step` update the cache in place
  and return the same dict.

The hybrid family, MLA and the frontends raise ``NotImplementedError``:
they come with their families in later slices.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..config import ModelConfig, RunConfig
from ..device import (DeviceLike, resolve_device, torch_dtype, upcast,
                      wide_dtype)
from . import attention as attn
from . import moe as moe_mod
from . import ssm as ssm_mod
from .layers import (ParamSpec, ffn_apply, ffn_specs, init_params, matmul,
                     rms_norm, tree_map)

Pytree = Any


def _check_family(cfg: ModelConfig) -> None:
    ported = ((cfg.family == "dense" and not cfg.moe)
              or (cfg.family == "moe" and cfg.moe is not None)
              or (cfg.family == "ssm" and cfg.ssm is not None))
    if not ported or cfg.mla or cfg.rglru or cfg.frontend:
        raise NotImplementedError(
            f"{cfg.name}: the port serves the dense GQA, MoE and SSM "
            f"families so far; family={cfg.family!r} comes in a later slice")


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
            "attn": attn.gqa_specs(cfg),
            "ffn": (moe_mod.moe_specs(cfg) if cfg.moe
                    else ffn_specs(d, cfg.d_ff, cfg.ffn_act))}


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
    if cfg.family == "ssm":
        block = {"ln1": ParamSpec((d,), ("embed",), init="zeros"),
                 "mamba": ssm_mod.mamba_specs(cfg)}
    else:
        block = _dense_block_specs(cfg)
    tree["blocks"] = _stack_specs(block, cfg.n_layers)
    return tree


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
    fp32 block leaves, ``embed`` and the head cast to ``rc.dtype`` (the cast
    the JAX step applies inside every call; ``final_norm`` stays as given,
    as there), and the head held transposed and contiguous as ``head_t``
    (d, vocab) in place of ``head``."""
    dtype = torch_dtype(rc.dtype)
    cast = lambda a: a.to(dtype) if a.dtype == torch.float32 else a
    out = {k: v for k, v in params.items() if k != "head"}
    out["blocks"] = tree_map(cast, params["blocks"])
    out["embed"] = params["embed"].to(dtype)
    out["head_t"] = _head_t(params, cfg, dtype)
    return out


def _head_t(params: Pytree, cfg: ModelConfig,
            dtype: torch.dtype) -> torch.Tensor:
    if "head_t" in params:
        return params["head_t"].to(dtype)
    head = params["embed"] if cfg.tie_embeddings else params["head"]
    return head.to(dtype).t().contiguous()


def _layer(blocks: Pytree, i: int, dtype: torch.dtype) -> Pytree:
    """Layer ``i``'s leaves, fp32 leaves cast to the compute dtype (a no-op
    on prepared weights)."""
    return tree_map(lambda a: a[i].to(dtype) if a.dtype == torch.float32
                    else a[i], blocks)


# ---------------------------------------------------------------------------
# forward (prefill / scoring)
# ---------------------------------------------------------------------------

def embed_inputs(params: Pytree, batch: Dict[str, torch.Tensor],
                 cfg: ModelConfig, dtype: torch.dtype) -> torch.Tensor:
    """Token embeddings (the vision and audio frontends come with their
    families)."""
    return params["embed"][batch["tokens"]].to(dtype)


def _dense_block_apply(p, x, cfg: ModelConfig, rc: RunConfig,
                       q_offset: int = 0, window: Optional[int] = None):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    h = attn.gqa_apply(p["attn"], h, cfg, window=window, q_offset=q_offset,
                       policy=rc.policy)
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


def _ssm_block_apply(p, x, cfg: ModelConfig, rc: RunConfig):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    return x + ssm_mod.mamba_apply(p["mamba"], h, cfg, rc.policy)


def forward(params: Pytree, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            rc: RunConfig) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, vocab) in the compute dtype.
    Attention runs through ``flash_attention``, the SSM scan through
    ``ssm_scan``."""
    _check_family(cfg)
    dtype = torch_dtype(rc.dtype)
    x = embed_inputs(params, batch, cfg, dtype)
    block = _ssm_block_apply if cfg.family == "ssm" else _dense_block_apply
    for i in range(cfg.n_layers):
        x = block(_layer(params["blocks"], i, dtype), x, cfg, rc)
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
    inputs (L, B, K-1, d_in) in the compute dtype instead of K/V."""
    _check_family(cfg)
    L, hd = cfg.n_layers, cfg.resolved_head_dim
    out = {"len": ((batch,), torch.int32)}
    if cfg.family == "ssm":
        d_in, _, d_state = ssm_mod.ssm_dims(cfg)
        out["ssm"] = ((L, batch, d_in, d_state), wide_dtype(dtype))
        out["conv"] = ((L, batch, cfg.ssm.d_conv - 1, d_in), dtype)
        return out
    kv = ((L, batch, cfg.n_kv_heads, max_len, hd), dtype)
    return {**out, "k": kv, "v": kv}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
               device: DeviceLike = None) -> Pytree:
    dev = resolve_device(device)
    return {k: torch.zeros(shape, dtype=dt, device=dev)
            for k, (shape, dt) in cache_spec(cfg, batch, max_len,
                                             torch_dtype(dtype)).items()}


def _decode_body(params: Pytree, cache: Pytree, tokens: torch.Tensor,
                 cfg: ModelConfig, rc: RunConfig,
                 rows: Optional[torch.Tensor]) -> torch.Tensor:
    """One token for every slot; writes the K/V rows or SSM states of
    ``rows`` (all slots when None) in place and returns fp32 logits
    (B, vocab).  ``len`` is left to the caller."""
    dtype = torch_dtype(rc.dtype)
    x = params["embed"][tokens].to(dtype)
    length = cache["len"]
    for i in range(cfg.n_layers):
        bp = _layer(params["blocks"], i, dtype)
        hn = rms_norm(x, bp["ln1"], cfg.norm_eps)
        if cfg.family == "ssm":
            y, ssm_s, conv_s = ssm_mod.mamba_decode(
                bp["mamba"], hn, cfg, cache["ssm"][i], cache["conv"][i],
                rc.policy)
            if rows is None:
                cache["ssm"][i] = ssm_s
                cache["conv"][i] = conv_s
            else:
                cache["ssm"][i, rows] = ssm_s[rows]
                cache["conv"][i, rows] = conv_s[rows].to(cache["conv"].dtype)
            x = x + y
            continue
        y, _, _ = attn.gqa_decode(bp["attn"], hn, cfg, cache["k"][i],
                                  cache["v"][i], length, rows=rows,
                                  policy=rc.policy)
        x = x + y
        hn = rms_norm(x, bp["ln2"], cfg.norm_eps)
        y = (moe_mod.moe_apply(bp["ffn"], hn, cfg, rc.policy) if cfg.moe
             else ffn_apply(bp["ffn"], hn, cfg.ffn_act, rc.policy))
        x = x + y
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return upcast(matmul(x[:, 0], _head_t(params, cfg, dtype), rc.policy))


def decode_step(params: Pytree, cache: Pytree,
                batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                rc: RunConfig) -> Tuple[torch.Tensor, Pytree]:
    """One token for every sequence in the batch.
    batch = {"tokens": (B, 1)} -> (logits (B, vocab) fp32, cache).
    The cache is updated in place; ``len`` advances for every slot, free
    ones included, as in the JAX step."""
    _check_family(cfg)
    logits = _decode_body(params, cache, batch["tokens"], cfg, rc, None)
    cache["len"] += 1
    return logits, cache


# ---------------------------------------------------------------------------
# chunked prefill: C prompt tokens per slot per call
# ---------------------------------------------------------------------------

def _merge_masked(active: torch.Tensor, new: torch.Tensor,
                  old: torch.Tensor) -> torch.Tensor:
    """Per-slot select between two cache leaves: batch is axis 0 of the
    per-sequence ``len`` vector and axis 1 of every stacked leaf."""
    if new.ndim == 0:
        return new
    if new.ndim == 1:
        return torch.where(active, new, old)
    shape = (1, active.shape[0]) + (1,) * (new.ndim - 2)
    return torch.where(active.reshape(shape), new, old)


def prefill_step(params: Pytree, cache: Pytree,
                 batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                 rc: RunConfig) -> Tuple[torch.Tensor, Pytree]:
    """Ingest a chunk of up to C prompt tokens per slot in one call.

    ``batch = {"tokens": (B, C), "n_tokens": (B,)}``: slot ``i`` consumes
    its first ``n_tokens[i]`` columns from its own position
    ``cache["len"][i]``; ``0`` leaves the slot untouched.  Returns
    ``(logits, cache)`` with ``logits[i]`` the fp32 next-token logits after
    slot ``i``'s last valid column.

    Each column runs the same body as :func:`decode_step` over the whole
    batch, so the chunked path is bit-exact with token-by-token prefill.
    The per-slot merge of the JAX step is done without copies: the K/V and
    SSM state writes of a column go to its active slots only (a masked
    scatter), an inactive slot's ``len`` stays put (:func:`_merge_masked`),
    and its logits keep their previous value.
    """
    _check_family(cfg)
    tokens, n_tokens = batch["tokens"], batch["n_tokens"]
    B, C = tokens.shape
    n_host = n_tokens.cpu()
    logits = torch.zeros((B, cfg.vocab), dtype=torch.float32,
                         device=tokens.device)
    for j in range(C):
        active_host = n_host > j
        if not bool(active_host.any()):
            break
        active = active_host.to(tokens.device)
        rows = torch.from_numpy(np.flatnonzero(active_host.numpy())).to(
            tokens.device)
        step_logits = _decode_body(params, cache, tokens[:, j:j + 1], cfg,
                                   rc, rows)
        cache["len"] = _merge_masked(active, cache["len"] + 1, cache["len"])
        logits = torch.where(active[:, None], step_logits, logits)
    return logits, cache
