"""RG-LRU recurrent block (RecurrentGemma's temporal mixer).

The port of ``repro.models.rglru``:
``h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)`` with
``a_t = exp(-c * softplus(lam) * r_t)``.  The full-sequence forward
(:func:`rglru_apply`) hands the whole sequence to the port's
``rglru_scan`` op in one call from ``h = 0``, in place of the reference's
chunked associative scan: the CUDA kernel on the card is itself a chunked
scan, which composes the chunks' decays inside a block.  The reference's
``chunk`` and ``unroll`` change no number beyond rounding, so the port has
neither.  The serve path runs :func:`rglru_columns`: C columns of
one-token steps of B slots, the decode step at C = 1
(:func:`rglru_decode`).  Its products run over the C x B rows in slabs of
B and its gates over all rows at once; only the O(1) update, in plain
PyTorch as the reference computes it outside any kernel, walks the
columns.  Every projection runs through ``queue_matmul``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..core.policy import ExecutionPolicy
from ..device import upcast
from ..kernels.rglru_scan import rglru_scan
from .layers import (ParamSpec, causal_conv1d, column_mask, conv_columns,
                     matmul, walk_columns)

_C = 8.0


def rglru_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    w = cfg.rglru.lru_width or d
    conv = cfg.rglru.conv_width
    return {
        "in_proj": ParamSpec((d, w), ("embed", "inner")),
        "gate_proj": ParamSpec((d, w), ("embed", "inner")),
        "conv_w": ParamSpec((conv, w), (None, "inner")),
        "conv_b": ParamSpec((w,), ("inner",), init="zeros"),
        "rg_w": ParamSpec((w, w), ("inner", None)),       # recurrence gate
        "rg_b": ParamSpec((w,), ("inner",), init="zeros"),
        "ig_w": ParamSpec((w, w), ("inner", None)),       # input gate
        "ig_b": ParamSpec((w,), ("inner",), init="zeros"),
        "lam": ParamSpec((w,), ("inner",), init="ones"),  # Λ
        "out_proj": ParamSpec((w, d), ("inner", "embed")),
    }


def _gates(p, u: torch.Tensor, policy: Optional[ExecutionPolicy] = None,
           slab: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """u: (..., w) post-conv -> (a, bx), both (..., w) fp32 (fp64 for
    fp64); ``slab`` as ``matmul``'s."""
    return gate_coeffs(p, u, matmul(u, p["rg_w"], policy, slab),
                       matmul(u, p["ig_w"], policy, slab))


def gate_coeffs(p, u: torch.Tensor, rg: torch.Tensor, ig: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a, bx) from u and the gates' products ``u @ rg_w`` and
    ``u @ ig_w``.  As the reference: the sigmoids in u's dtype, then cast;
    softplus(lam) in fp32; ``exp(2 log_a)``, not ``a * a``, under the
    ``1e-6`` clamp.  Each element's arithmetic is its own, so a row keeps
    its bits over any rows."""
    r = upcast(torch.sigmoid(rg + p["rg_b"]))
    i = upcast(torch.sigmoid(ig + p["ig_b"]))
    log_a = -_C * F.softplus(upcast(p["lam"])) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6))
    return a, beta * i * upcast(u)


def rglru_step(h: torch.Tensor, a: torch.Tensor, bx: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token of B slots: ``h = a * h + bx``, (B, w) fp32, as both the
    new state and the output."""
    h = a * h + bx
    return h, h


def rglru_apply(p, x: torch.Tensor, cfg: ModelConfig,
                policy: Optional[ExecutionPolicy] = None) -> torch.Tensor:
    """Full-sequence forward.  x: (B, S, d) -> (B, S, d); the recurrence is
    one ``rglru_scan`` call over the whole sequence.  h is cast to x's
    dtype before the gate, as in the reference."""
    u = matmul(x, p["in_proj"], policy)
    u, _ = causal_conv1d(p, u)
    gate = F.gelu(matmul(x, p["gate_proj"], policy), approximate="tanh")
    a, bx = _gates(p, u, policy)
    h = rglru_scan(a, bx)
    return matmul(h.to(x.dtype) * gate, p["out_proj"], policy)


def rglru_columns(p, x: torch.Tensor, cfg: ModelConfig, h: torch.Tensor,
                  conv_state: torch.Tensor,
                  n_tokens: Optional[torch.Tensor] = None,
                  policy: Optional[ExecutionPolicy] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """C columns of one-token steps of B slots.  x: (C, B, d), column j of
    slot b its (j+1)-th token; h (B, w) fp32; conv_state (B, K-1, w);
    ``n_tokens`` (B,) the columns each slot takes (None: all).  Returns
    (out (C, B, d), new h, new conv_state), each slot's states those after
    its last column it takes; the states given are not modified.

    Every product runs over the C x B rows in slabs of B, the conv over
    the columns (:func:`~repro_torch.models.layers.conv_columns`) and the
    gates over all rows at once, each row with the bits of its one-column
    step; only ``h = a * h + bx`` (:func:`rglru_step`) walks the columns,
    at B rows."""
    C, B, _ = x.shape
    u = matmul(x, p["in_proj"], policy, slab=B)
    u, conv_state = conv_columns(p, u, conv_state, n_tokens)
    gate = F.gelu(matmul(x, p["gate_proj"], policy, slab=B),
                  approximate="tanh")
    a, bx = _gates(p, u, policy, slab=B)
    hs, h = walk_columns(rglru_step, h, column_mask(C, n_tokens), a, bx)
    out = matmul(hs.to(x.dtype) * gate, p["out_proj"], policy, slab=B)
    return out, h, conv_state


def rglru_decode(p, x: torch.Tensor, cfg: ModelConfig, h: torch.Tensor,
                 conv_state: torch.Tensor,
                 policy: Optional[ExecutionPolicy] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token step: :func:`rglru_columns` at C = 1.  x: (B, 1, d); h:
    (B, w) fp32; conv_state: (B, K-1, w).  Returns (out (B, 1, d), new h,
    new conv_state); the states given are not modified."""
    out, h, conv_state = rglru_columns(p, x.transpose(0, 1), cfg, h,
                                       conv_state, policy=policy)
    return out.transpose(0, 1), h, conv_state
