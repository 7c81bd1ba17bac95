"""Mamba-1 selective-state-space block (falcon-mamba family).

The port of ``repro.models.ssm``.  The full-sequence forward
(:func:`mamba_apply`) hands the whole sequence to the port's ``ssm_scan``
op in one call: the CUDA kernel on the card keeps the (d_in, N) state in
registers and never builds the (B, T, d_in, N) decay and input tensors
that the reference's chunked associative scan materialises chunk by chunk.
The reference's ``chunk`` argument changes no number (its scan is exact
whatever the chunk), so the port has none.  The serve path runs
:func:`mamba_columns`: C columns of one-token steps of B slots, the decode
step at C = 1 (:func:`mamba_decode`).  Its products run over the C x B
rows in slabs of B and its coefficients over all rows at once; only the
O(1) recurrent update, in plain PyTorch as the reference computes it
outside any kernel, walks the columns.  Every projection runs through
``queue_matmul``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..core.policy import ExecutionPolicy
from ..device import upcast
from ..kernels.ssm_scan import ssm_scan
from .layers import (ParamSpec, causal_conv1d, column_mask, conv_columns,
                     matmul, walk_columns)


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
                 policy: Optional[ExecutionPolicy],
                 slab: Optional[int] = None):
    """x_in: (..., d_in) post-conv activations -> (dt, A, B, C): dt
    (..., d_in) after softplus, in x's dtype; A = -exp(A_log) (d_in, N)
    fp32; B and C (..., N) in x's dtype.  ``slab`` as ``matmul``'s."""
    _, dt_rank, d_state = ssm_dims(cfg)
    proj = matmul(x_in, p["x_proj"], policy, slab)
    dt, Bc, C = torch.split(proj, [dt_rank, d_state, d_state], dim=-1)
    dt = F.softplus(matmul(dt, p["dt_proj"], policy, slab) + p["dt_bias"])
    A = -torch.exp(upcast(p["A_log"]))
    return dt, A, Bc, C


def ssm_coeffs(dt: torch.Tensor, A: torch.Tensor, Bc: torch.Tensor,
               x_in: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence's coefficients, as the reference's: dA and dBx
    (..., d_in, N) fp32 from dt, x_in (..., d_in) and B (..., N); each
    element's arithmetic is its own, so a row keeps its bits over any
    rows."""
    dA = torch.exp(upcast(dt)[..., None] * A)
    dBx = upcast(dt * x_in)[..., None] * upcast(Bc)[..., None, :]
    return dA, dBx


def ssm_step(state: torch.Tensor, dA: torch.Tensor, dBx: torch.Tensor,
             C: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token of B slots: ``state = dA * state + dBx`` (B, d_in, N)
    fp32 and its readout against C (B, N), (B, d_in) fp32."""
    state = dA * state + dBx
    return state, torch.einsum("bdn,bn->bd", state, upcast(C))


def mamba_apply(p, x: torch.Tensor, cfg: ModelConfig,
                policy: Optional[ExecutionPolicy] = None) -> torch.Tensor:
    """Full-sequence forward.  x: (B, S, d) -> (B, S, d); the scan is one
    ``ssm_scan`` call over the whole sequence."""
    xz = matmul(x, p["in_proj"], policy)
    xi, z = xz.chunk(2, dim=-1)
    xi, _ = causal_conv1d(p, xi)
    xi = F.silu(xi)
    dt, A, Bc, C = _scan_inputs(p, xi, cfg, policy)
    y = ssm_scan(xi, dt, A, Bc, C).to(x.dtype)
    y = y + xi * p["D"]
    y = y * F.silu(z)
    return matmul(y, p["out_proj"], policy)


def mamba_columns(p, x: torch.Tensor, cfg: ModelConfig,
                  ssm_state: torch.Tensor, conv_state: torch.Tensor,
                  n_tokens: Optional[torch.Tensor] = None,
                  policy: Optional[ExecutionPolicy] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """C columns of one-token steps of B slots.  x: (C, B, d), column j of
    slot b its (j+1)-th token; ssm_state (B, d_in, N) fp32; conv_state
    (B, K-1, d_in); ``n_tokens`` (B,) the columns each slot takes (None:
    all).  Returns (out (C, B, d), new ssm_state, new conv_state), each
    slot's states those after its last column it takes; the states given
    are not modified.

    Every product runs over the C x B rows in slabs of B, the conv over
    the columns (:func:`~repro_torch.models.layers.conv_columns`) and the
    coefficients over all rows at once, each row with the bits of its
    one-column step; only the state update and its readout
    (:func:`ssm_step`) walk the columns, at B rows."""
    C, B, _ = x.shape
    xz = matmul(x, p["in_proj"], policy, slab=B)
    xi, z = xz.chunk(2, dim=-1)
    xi, conv_state = conv_columns(p, xi, conv_state, n_tokens)
    xi = F.silu(xi)
    dt, A, Bc, Cc = _scan_inputs(p, xi, cfg, policy, slab=B)
    dA, dBx = ssm_coeffs(dt, A, Bc, xi)
    y, ssm_state = walk_columns(ssm_step, ssm_state,
                                column_mask(C, n_tokens), dA, dBx, Cc)
    y = y.to(x.dtype) + xi * p["D"]
    y = y * F.silu(z)
    return matmul(y, p["out_proj"], policy, slab=B), ssm_state, conv_state


def mamba_decode(p, x: torch.Tensor, cfg: ModelConfig,
                 ssm_state: torch.Tensor, conv_state: torch.Tensor,
                 policy: Optional[ExecutionPolicy] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token step: :func:`mamba_columns` at C = 1.  x: (B, 1, d);
    ssm_state: (B, d_in, N) fp32; conv_state: (B, K-1, d_in).  Returns
    (out (B, 1, d), new ssm_state, new conv_state); the states given are
    not modified."""
    out, ssm_state, conv_state = mamba_columns(
        p, x.transpose(0, 1), cfg, ssm_state, conv_state, policy=policy)
    return out.transpose(0, 1), ssm_state, conv_state
