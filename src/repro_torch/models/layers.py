"""Shared layers: param-spec trees, norms, RoPE, the causal conv, FFN
variants.

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
from ..kernels.rms_norm.ref import rms_norm_ref

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
    # scaled in place: the largest leaves (a 256000 x 18432 embedding) are
    # tens of GB in fp32
    if spec.init == "embed":
        return z.mul_(spec.scale).to(dtype)
    fan_in = spec.shape[0] if len(spec.shape) > 1 else 1
    return z.mul_(spec.scale / math.sqrt(max(fan_in, 1))).to(dtype)


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


def logical_axes_tree(tree: Pytree) -> Pytree:
    """Each :class:`ParamSpec` leaf's logical axis names, in the tree's
    shape: what :mod:`repro_torch.distributed.sharding` resolves to mesh
    axes."""
    if isinstance(tree, ParamSpec):
        return tree.axes
    return {k: logical_axes_tree(v) for k, v in tree.items()}


def tree_map(fn, tree: Pytree) -> Pytree:
    """Apply ``fn`` to every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree: Pytree) -> list:
    """The leaves in ``jax.tree_util.tree_flatten``'s order: dicts by sorted
    key, tuples, lists and ``NamedTuple`` s by position, ``None`` holding no
    leaf.  The optimizers walk parameters, moments and gradients in this
    order, and checkpoints store leaves in it."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_unflatten(like: Pytree, leaves: list) -> Pytree:
    """``like``'s structure (its dicts' key order kept) holding ``leaves``,
    given in :func:`tree_leaves`'s order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(x) for x in t))
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        return next(it)
    return build(like)


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------

def matmul(x: torch.Tensor, w: torch.Tensor,
           policy: Optional[ExecutionPolicy] = None,
           slab: Optional[int] = None) -> torch.Tensor:
    """``x @ w`` over the last axis of ``x`` through ``queue_matmul``;
    ``slab`` runs it row by row, each row with the bits of a product over
    its slab of that many rows (``queue_matmul``'s ``slab``)."""
    y = queue_matmul(x.reshape(-1, x.shape[-1]), w, policy=policy, slab=slab)
    return y.reshape(*x.shape[:-1], w.shape[1])


#: the model's norm, in plain PyTorch: the plain version of the
#: ``rms_norm`` kernel the serve bodies run
rms_norm = rms_norm_ref


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


def causal_conv1d(p: Dict[str, torch.Tensor], x: torch.Tensor,
                  conv_state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal depthwise conv of the Mamba and RG-LRU blocks (the
    reference's ``ssm._conv1d`` and ``rglru._conv1d``, which are the same).
    x: (B, T, C); conv_state: (B, K-1, C).  The reference's K shifted
    multiply-adds in x's dtype (not a cuDNN convolution, which takes fp32
    to TF32 on the card).  Returns the output and the new state (the last
    K-1 inputs)."""
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


def column_mask(C: int, n_tokens: Optional[torch.Tensor]
                ) -> Optional[torch.Tensor]:
    """(C, B): whether slot b takes column j (``j < n_tokens[b]``); None
    (every column of every slot) where ``n_tokens`` is None."""
    if n_tokens is None:
        return None
    return torch.arange(C, device=n_tokens.device)[:, None] < n_tokens[None]


def conv_columns(p: Dict[str, torch.Tensor], x: torch.Tensor,
                 conv_state: torch.Tensor,
                 n_tokens: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`causal_conv1d` over C columns of one-token steps of B slots:
    x (C, B, w), column j of slot b after the slot's state (B, K-1, w) and
    its columns before j, each element through the decode step's K
    multiply-adds in their order, so it keeps that step's bits.  Returns
    the output (C, B, w) and the new state (B, K-1, w): the K-1 inputs that
    end at slot b's last column of the ``n_tokens`` (B,) it takes (None:
    all C), gathered on the device, so a slot that takes none keeps its
    state."""
    w = p["conv_w"]
    K, C, B = w.shape[0], x.shape[0], x.shape[1]
    xp = torch.cat([conv_state.to(x.dtype).transpose(0, 1), x])
    out = xp[0:C] * w[0]
    for k in range(1, K):
        out = out + xp[k:k + C] * w[k]
    if n_tokens is None:
        state = xp[C:]
    else:
        at = (n_tokens.to(torch.int64)[None]
              + torch.arange(K - 1, device=x.device)[:, None])
        state = xp.gather(0, at[:, :, None].expand(K - 1, B, x.shape[2]))
    return out + p["conv_b"], state.transpose(0, 1)


def walk_columns(step, state: torch.Tensor, active: Optional[torch.Tensor],
                 *cols: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A recurrence over C columns in order, at the decode step's B rows
    with its ops: ``new, out = step(state, *(c[j] for c in cols))`` for
    each column j.  A slot keeps its state through a column the (C, B)
    mask ``active`` (None: all) says it does not take (a select).  Returns
    the outputs stacked (C, B, ...) and the last state."""
    outs = []
    for j in range(cols[0].shape[0]):
        new, out = step(state, *(c[j] for c in cols))
        if active is not None:
            new = torch.where(
                active[j].reshape((-1,) + (1,) * (new.ndim - 1)), new, state)
        state = new
        outs.append(out)
    return torch.stack(outs), state


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
              policy: Optional[ExecutionPolicy] = None,
              slab: Optional[int] = None) -> torch.Tensor:
    """swiglu, relu2 or gelu (the tanh form, as ``jax.nn.gelu``); ``slab``
    as :func:`matmul`'s."""
    if act == "swiglu":
        h = (F.silu(matmul(x, p["wg"], policy, slab))
             * matmul(x, p["wi"], policy, slab))
    elif act == "relu2":
        h = torch.square(F.relu(matmul(x, p["wi"], policy, slab)))
    else:
        h = F.gelu(matmul(x, p["wi"], policy, slab), approximate="tanh")
    return matmul(h, p["wo"], policy, slab)
