"""Gradient compression: int8 quantization with stochastic rounding.

The JAX package's wire codec (``distributed/compression.py``): a
per-tensor absmax scale and stochastic rounding, so the quantizer is
unbiased (E[deq(q(g))] = g) and one round trip is within one quantization
step.  The uniform draws come from a ``torch.Generator`` in place of
``jax.random``, so the bits differ from the reference's; the tests hold
the codec to those two properties, and to exact dequantization of a
fixed ``q``."""
from __future__ import annotations

from typing import Any, Tuple

import torch

from ..models.layers import tree_leaves

Pytree = Any


def quantize_int8(gen: torch.Generator, g: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale fp32 scalar) with ``g ~ q * scale``; ``gen`` lives on
    ``g``'s device."""
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    x = g / scale
    lo = torch.floor(x)
    up = torch.rand(g.shape, generator=gen, device=g.device) < (x - lo)
    q = (lo + up.to(lo.dtype)).clamp(-127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


@torch.no_grad()
def compress_grads(gen: torch.Generator, grads: Pytree) -> Pytree:
    """Round-trip every gradient leaf through the int8 wire format, in
    place (leaf order as ``jax.tree_util`` flattens the tree)."""
    for g in tree_leaves(grads):
        g.copy_(dequantize_int8(*quantize_int8(gen, g)).to(g.dtype))
    return grads


__all__ = ["compress_grads", "dequantize_int8", "quantize_int8"]
