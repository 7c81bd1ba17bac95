"""Mamba-1 selective-state-space block (falcon-mamba family).

The port of ``repro.models.ssm``.  The full-sequence forward
(:func:`mamba_apply`) hands the whole sequence to the port's ``ssm_scan``
op in one call: the CUDA kernel on the card keeps the (d_in, N) state in
registers and never builds the (B, T, d_in, N) decay and input tensors
that the reference's chunked associative scan materialises chunk by chunk.
The reference's ``chunk`` argument changes no number (its scan is exact
whatever the chunk), so the port has none.  Decode (:func:`mamba_decode`)
is the O(1) recurrent update in plain PyTorch, as the reference computes
it outside any kernel.  Every projection runs through ``queue_matmul``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..core.policy import ExecutionPolicy
from ..device import upcast
from ..kernels.ssm_scan import ssm_scan
from .layers import ParamSpec, matmul


def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    dt_rank = s.dt_rank or -(-cfg.d_model // 16)
    return d_in, dt_rank, s.d_state


def mamba_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    d_in, dt_rank, d_state = ssm_dims(cfg)
    conv = cfg.ssm.d_conv
    return {
        "in_proj": ParamSpec((d, 2 * d_in), ("embed", "inner2")),
        "conv_w": ParamSpec((conv, d_in), (None, "inner")),
        "conv_b": ParamSpec((d_in,), ("inner",), init="zeros"),
        "x_proj": ParamSpec((d_in, dt_rank + 2 * d_state), ("inner", None)),
        "dt_proj": ParamSpec((dt_rank, d_in), (None, "inner")),
        "dt_bias": ParamSpec((d_in,), ("inner",), init="zeros"),
        "A_log": ParamSpec((d_in, d_state), ("inner", None), init="ones"),
        "D": ParamSpec((d_in,), ("inner",), init="ones"),
        "out_proj": ParamSpec((d_in, d), ("inner", "embed")),
    }


def _scan_inputs(p, x_in: torch.Tensor, cfg: ModelConfig,
                 policy: Optional[ExecutionPolicy]):
    """x_in: (B, T, d_in) post-conv activations -> (dt, A, B, C): dt
    (B, T, d_in) after softplus, in x's dtype; A = -exp(A_log) (d_in, N)
    fp32; B and C (B, T, N) in x's dtype."""
    _, dt_rank, d_state = ssm_dims(cfg)
    proj = matmul(x_in, p["x_proj"], policy)
    dt, Bc, C = torch.split(proj, [dt_rank, d_state, d_state], dim=-1)
    dt = F.softplus(matmul(dt, p["dt_proj"], policy) + p["dt_bias"])
    A = -torch.exp(upcast(p["A_log"]))
    return dt, A, Bc, C


def _ssm_coeffs(p, x_in: torch.Tensor, cfg: ModelConfig,
                policy: Optional[ExecutionPolicy] = None):
    """x_in: (B, T, d_in) -> (dA, dBx, C), as the reference's: dA and dBx
    (B, T, d_in, N) fp32, C (B, T, N).  Built for the one-token decode
    step only; the full sequence goes to ``ssm_scan`` instead."""
    dt, A, Bc, C = _scan_inputs(p, x_in, cfg, policy)
    dA = torch.exp(upcast(dt)[..., None] * A)
    dBx = upcast(dt * x_in)[..., None] * upcast(Bc)[:, :, None, :]
    return dA, dBx, C


def _conv1d(p, x: torch.Tensor, conv_state: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal depthwise conv.  x: (B, T, d_in); conv_state: (B, K-1, d_in).
    The reference's K shifted multiply-adds in x's dtype (not a cuDNN
    convolution, which takes fp32 to TF32 on the card).  Returns the
    output and the new state (the last K-1 inputs)."""
    w = p["conv_w"]
    K, T = w.shape[0], x.shape[1]
    if conv_state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = xp[:, 0:T] * w[0]
    for k in range(1, K):
        out = out + xp[:, k:k + T] * w[k]
    return out + p["conv_b"], xp[:, -(K - 1):]


def mamba_apply(p, x: torch.Tensor, cfg: ModelConfig,
                policy: Optional[ExecutionPolicy] = None) -> torch.Tensor:
    """Full-sequence forward.  x: (B, S, d) -> (B, S, d); the scan is one
    ``ssm_scan`` call over the whole sequence."""
    xz = matmul(x, p["in_proj"], policy)
    xi, z = xz.chunk(2, dim=-1)
    xi, _ = _conv1d(p, xi)
    xi = F.silu(xi)
    dt, A, Bc, C = _scan_inputs(p, xi, cfg, policy)
    y = ssm_scan(xi, dt, A, Bc, C).to(x.dtype)
    y = y + xi * p["D"]
    y = y * F.silu(z)
    return matmul(y, p["out_proj"], policy)


def mamba_decode(p, x: torch.Tensor, cfg: ModelConfig,
                 ssm_state: torch.Tensor, conv_state: torch.Tensor,
                 policy: Optional[ExecutionPolicy] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token step.  x: (B, 1, d); ssm_state: (B, d_in, N) fp32;
    conv_state: (B, K-1, d_in).  Returns (out, new ssm_state, new
    conv_state); the states given are not modified."""
    xz = matmul(x, p["in_proj"], policy)
    xi, z = xz.chunk(2, dim=-1)
    xi, conv_state = _conv1d(p, xi, conv_state)
    xi = F.silu(xi)
    dA, dBx, C = _ssm_coeffs(p, xi, cfg, policy)
    ssm_state = dA[:, 0] * ssm_state + dBx[:, 0]
    y = torch.einsum("bdn,bn->bd", ssm_state, upcast(C[:, 0]))
    y = y[:, None].to(x.dtype) + xi * p["D"]
    y = y * F.silu(z)
    return matmul(y, p["out_proj"], policy), ssm_state, conv_state
