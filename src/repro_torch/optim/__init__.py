"""Optimizers: AdamW (decoupled weight decay) + Lion, warmup-cosine schedule,
global-norm gradient clipping, over the port's parameter trees (nested
dicts of tensors).

The JAX package's ``optim/__init__.py`` rule for rule, with one departure:
its updates are pure functions that return new trees, which at
phi3-mini-3.8b's width would hold two copies of 57 GiB of state on one
card.  Here the updates run in place, under ``torch.no_grad()``, leaf by
leaf and, within a leaf, chunk by chunk (so the temporaries stay a few
hundred MB whatever the leaf: phi3's stacked ``ffn/wi`` is 3.2 GB in
fp32): the gradients are scaled in place by the clip, and ``mu``, ``nu``
and the parameters are overwritten.  The returned trees are the ones
passed in.  Weight decay applies to every leaf, norms included, as in
the reference.  The arithmetic is the reference's in fp32, so a step
agrees with JAX's to fp32 rounding (the port folds a scale into an add,
``add_(x, alpha=a)``, where the reference rounds ``a * x`` first)."""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator, NamedTuple, Tuple

import torch

from ..config import RunConfig
from ..models.layers import tree_leaves, tree_map

Pytree = Any

#: elements of a leaf updated at once (256 MB of fp32)
_CHUNK = 1 << 26


class OptState(NamedTuple):
    """The reference's field order, so a checkpoint flattens alike."""
    step: torch.Tensor      # int32 scalar
    mu: Pytree
    nu: Pytree              # zeros-like scalars for lion (unused)


def init_opt_state(params: Pytree, kind: str = "adamw") -> OptState:
    """Zero moments in fp32 beside each parameter; lion keeps scalar
    ``nu`` leaves, as the reference does."""
    def zeros(shape_of):
        return tree_map(lambda p: torch.zeros(shape_of(p),
                                              dtype=torch.float32,
                                              device=p.device), params)
    mu = zeros(lambda p: p.shape)
    nu = zeros(lambda p: p.shape if kind == "adamw" else ())
    dev = tree_leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    mu=mu, nu=nu)


def opt_state_shapes(param_shapes: Pytree, kind: str = "adamw") -> OptState:
    """The state :func:`init_opt_state` makes for parameters of
    ``param_shapes`` (``(shape, dtype)`` leaves, as
    :func:`~repro_torch.models.param_shapes` gives them), as ``(shape,
    torch dtype)`` pairs; nothing is allocated."""
    mu = tree_map(lambda p: (tuple(p[0]), torch.float32), param_shapes)
    nu = mu if kind == "adamw" else tree_map(lambda p: ((), torch.float32),
                                             param_shapes)
    return OptState(step=((), torch.int32), mu=mu, nu=nu)


def lr_schedule(step: int, rc: RunConfig) -> float:
    """Linear warmup to ``rc.lr`` over ``warmup_steps``, then a cosine to a
    tenth of it at ``total_steps``."""
    warm = min(step / max(rc.warmup_steps, 1), 1.0)
    t = min(max((step - rc.warmup_steps)
                / max(rc.total_steps - rc.warmup_steps, 1), 0.0), 1.0)
    cos = 0.5 * (1.0 + math.cos(math.pi * t))
    return rc.lr * warm * (0.1 + 0.9 * cos)


@torch.no_grad()
def clip_by_global_norm(grads: Pytree, max_norm: float
                        ) -> Tuple[Pytree, torch.Tensor]:
    """Scale every gradient in place by ``min(1, max_norm / norm)``;
    returns the same tree and the norm before clipping (fp32)."""
    gs = tree_leaves(grads)
    # each leaf's norm in one pass, no squared copy of the leaf
    norm = torch.sqrt(sum(torch.square(torch.linalg.vector_norm(
        g, dtype=torch.float32)) for g in gs))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for g in gs:
        g.mul_(scale.to(g.dtype))
    return grads, norm


def _chunks(*ts: torch.Tensor) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Matching flat chunks of same-shaped tensors (views, so an in-place
    op on a chunk writes the leaf)."""
    flat = [t.view(-1) for t in ts]
    return zip(*(f.split(_CHUNK) for f in flat))


def _counts(state: OptState, rc: RunConfig, b1: float, b2: float):
    step = int(state.step) + 1
    return step, lr_schedule(step, rc), 1.0 - b1 ** step, 1.0 - b2 ** step


@torch.no_grad()
def adamw_update(params: Pytree, state: OptState, grads: Pytree,
                 rc: RunConfig, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8
                 ) -> Tuple[Pytree, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step in place: clip, moments, bias correction, decoupled
    weight decay.  Returns (params, state, {"lr", "grad_norm"})."""
    grads, gnorm = clip_by_global_norm(grads, rc.grad_clip)
    step, lr, c1, c2 = _counts(state, rc, b1, b2)
    for p, m, v, g in zip(tree_leaves(params), tree_leaves(state.mu),
                          tree_leaves(state.nu), tree_leaves(grads)):
        for pc, mc, vc, gc in _chunks(p, m, v, g):
            # 11 passes over the chunk, the fewest the reference's formula
            # takes in separate PyTorch ops (a fused kernel is later work)
            g32 = gc.float()
            mc.mul_(b1).add_(g32, alpha=1 - b1)
            vc.mul_(b2).addcmul_(g32, g32, value=1 - b2)
            u = (mc / c1).div_(torch.sqrt(vc / c2).add_(eps))
            u.add_(pc.float(), alpha=rc.weight_decay)
            pc.sub_(u, alpha=lr)
    new = OptState(state.step + 1, state.mu, state.nu)
    return params, new, {"lr": torch.tensor(lr, dtype=torch.float32),
                         "grad_norm": gnorm}


@torch.no_grad()
def lion_update(params: Pytree, state: OptState, grads: Pytree,
                rc: RunConfig, b1: float = 0.9, b2: float = 0.99
                ) -> Tuple[Pytree, OptState, Dict[str, torch.Tensor]]:
    """One Lion step in place (``nu`` unused); its learning rate is 0.3 of
    the schedule's, as in the reference."""
    grads, gnorm = clip_by_global_norm(grads, rc.grad_clip)
    step, lr, _, _ = _counts(state, rc, b1, b2)
    lr *= 0.3
    for p, m, g in zip(tree_leaves(params), tree_leaves(state.mu), tree_leaves(grads)):
        for pc, mc, gc in _chunks(p, m, g):
            g32 = gc.float()
            u = torch.sign(mc * b1 + g32 * (1 - b1))
            u.add_(pc.float(), alpha=rc.weight_decay)
            mc.mul_(b2).add_(g32, alpha=1 - b2)
            pc.sub_(u, alpha=lr)
    new = OptState(state.step + 1, state.mu, state.nu)
    return params, new, {"lr": torch.tensor(lr, dtype=torch.float32),
                         "grad_norm": gnorm}


__all__ = ["OptState", "adamw_update", "clip_by_global_norm",
           "init_opt_state", "lion_update", "lr_schedule", "opt_state_shapes"]
