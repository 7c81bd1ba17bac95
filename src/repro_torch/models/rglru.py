"""RG-LRU recurrent block (RecurrentGemma's temporal mixer).

The port of ``repro.models.rglru``:
``h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)`` with
``a_t = exp(-c * softplus(lam) * r_t)``.  The full-sequence forward
(:func:`rglru_apply`) hands the whole sequence to the port's
``rglru_scan`` op in one call from ``h = 0``, in place of the reference's
chunked associative scan: the CUDA kernel on the card is itself a chunked
scan, which composes the chunks' decays inside a block.  The reference's
``chunk`` and ``unroll`` change no number beyond rounding, so the port has
neither.  Decode
(:func:`rglru_decode`) is the O(1) update in plain PyTorch, as the
reference computes it outside any kernel.  Every projection runs through
``queue_matmul``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..core.policy import ExecutionPolicy
from ..device import upcast
from ..kernels.rglru_scan import rglru_scan
from .layers import ParamSpec, causal_conv1d, matmul

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


def _gates(p, u: torch.Tensor, policy: Optional[ExecutionPolicy] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u: (B, T, w) post-conv -> (a, bx), both (B, T, w) fp32 (fp64 for
    fp64).  As the reference: the sigmoids in u's dtype, then cast;
    softplus(lam) in fp32; ``exp(2 log_a)``, not ``a * a``, under the
    ``1e-6`` clamp."""
    r = upcast(torch.sigmoid(matmul(u, p["rg_w"], policy) + p["rg_b"]))
    i = upcast(torch.sigmoid(matmul(u, p["ig_w"], policy) + p["ig_b"]))
    log_a = -_C * F.softplus(upcast(p["lam"])) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6))
    return a, beta * i * upcast(u)


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


def rglru_decode(p, x: torch.Tensor, cfg: ModelConfig, h: torch.Tensor,
                 conv_state: torch.Tensor,
                 policy: Optional[ExecutionPolicy] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token step.  x: (B, 1, d); h: (B, w) fp32; conv_state:
    (B, K-1, w).  Returns (out, new h, new conv_state); the states given
    are not modified."""
    u = matmul(x, p["in_proj"], policy)
    u, conv_state = causal_conv1d(p, u, conv_state)
    gate = F.gelu(matmul(x, p["gate_proj"], policy), approximate="tanh")
    a, bx = _gates(p, u, policy)
    h = a[:, 0] * h + bx[:, 0]
    out = matmul(h[:, None].to(x.dtype) * gate, p["out_proj"], policy)
    return out, h, conv_state
