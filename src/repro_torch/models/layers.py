"""Shared layers: param-spec trees, norms, RoPE, FFN variants.

Parameters are declared as :class:`ParamSpec` trees (shape + logical axis
names + initializer), as in the JAX package; :func:`init_params`
materializes them with a ``torch.Generator``.  Shapes, axes and init scales
are the reference's; the numbers differ (``torch`` and ``jax.random`` draw
differently), so parity tests carry weights across with
:mod:`repro_torch.bridge`.

Every matrix product goes through the port's ``queue_matmul`` op, so on the
card it runs the CUDA kernel under the run's execution policy.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.policy import ExecutionPolicy
from ..device import upcast
from ..kernels.queue_matmul import queue_matmul

Pytree = Any


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]      # logical axis names
    init: str = "normal"                 # normal | zeros | ones | embed
    scale: float = 1.0

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def _init_leaf(gen: torch.Generator, spec: ParamSpec, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    z = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                    device=device)
    if spec.init == "embed":
        return (z * spec.scale).to(dtype)
    fan_in = spec.shape[0] if len(spec.shape) > 1 else 1
    return (z * (spec.scale / math.sqrt(max(fan_in, 1)))).to(dtype)


def init_params(gen: torch.Generator, tree: Pytree,
                dtype: torch.dtype = torch.float32,
                device: Optional[torch.device] = None) -> Pytree:
    """Materialize a spec tree, leaf by leaf in the tree's key order, with
    draws from ``gen`` (which must live on ``device``).  Each leaf is drawn
    in fp32 and cast, so a bf16 tree keeps one fp32 leaf alive at a time."""
    device = gen.device if device is None else device
    if isinstance(tree, ParamSpec):
        return _init_leaf(gen, tree, dtype, device)
    return {k: init_params(gen, v, dtype, device) for k, v in tree.items()}


def tree_map(fn, tree: Pytree) -> Pytree:
    """Apply ``fn`` to every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------

def matmul(x: torch.Tensor, w: torch.Tensor,
           policy: Optional[ExecutionPolicy] = None) -> torch.Tensor:
    """``x @ w`` over the last axis of ``x`` through ``queue_matmul``."""
    y = queue_matmul(x.reshape(-1, x.shape[-1]), w, policy=policy)
    return y.reshape(*x.shape[:-1], w.shape[1])


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = upcast(x)
    x32 = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * (1.0 + gamma.to(x32.dtype))).to(dt)


def rope_angles(positions: torch.Tensor, dim: int, theta: float,
                dtype: torch.dtype = torch.float32
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (...,) int -> cos/sin of shape (..., dim//2), in
    ``dtype`` (fp32, or fp64 for an fp64 run)."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=dtype,
                                        device=positions.device) / dim))
    ang = positions.to(dtype)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., dim); cos/sin broadcastable to (..., dim//2)."""
    dt = x.dtype
    x1, x2 = upcast(x).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(dt)


def ffn_specs(d_model: int, d_ff: int, act: str) -> Dict[str, ParamSpec]:
    if act == "swiglu":
        return {
            "wi": ParamSpec((d_model, d_ff), ("embed", "ff")),
            "wg": ParamSpec((d_model, d_ff), ("embed", "ff")),
            "wo": ParamSpec((d_ff, d_model), ("ff", "embed")),
        }
    return {
        "wi": ParamSpec((d_model, d_ff), ("embed", "ff")),
        "wo": ParamSpec((d_ff, d_model), ("ff", "embed")),
    }


def ffn_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, act: str,
              policy: Optional[ExecutionPolicy] = None) -> torch.Tensor:
    """swiglu, relu2 or gelu (the tanh form, as ``jax.nn.gelu``)."""
    if act == "swiglu":
        h = F.silu(matmul(x, p["wg"], policy)) * matmul(x, p["wi"], policy)
    elif act == "relu2":
        h = torch.square(F.relu(matmul(x, p["wi"], policy)))
    else:
        h = F.gelu(matmul(x, p["wi"], policy), approximate="tanh")
    return matmul(h, p["wo"], policy)
