"""The harness's weights, drawn on the device from the seed in the port's
parameter layout, and handed unchanged to the program and the reference.

Every matrix is N(0, 1/fan_in), so each product keeps its input's scale
at any width and depth (the softmax never saturates); the embedding is
N(0, 1); every norm gain is N(0, 0.1), so a norm that dropped its gain
would show.  Each leaf is one ``randn`` call on the card, in the serving
dtype, from one ``torch.Generator`` there.

The layout is stated by the family's reference module from the
configuration file, not taken from the program; :func:`check_layout`
holds it to the program's own shapes.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator, Tuple

import torch

from portbench.reference import family
from portbench.reference.dense import Leaf

GAIN_STD = 0.1


def layout(cfg: Dict[str, Any]) -> Iterator[Leaf]:
    """``(path, shape, kind, fan_in)`` of every leaf, in draw order, as the
    configuration's family states it (``portbench/reference/<family>.py``)."""
    return family(cfg).layout(cfg)


def draw(cfg: Dict[str, Any], seed: int, device,
         dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    """The weights of ``seed`` as a nested dict of ``dtype`` tensors on
    ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    tree: Dict[str, Any] = {}
    for path, shape, kind, fan_in in layout(cfg):
        t = torch.randn(shape, generator=gen, device=device, dtype=dtype)
        scale = {"embed": 1.0, "gain": GAIN_STD,
                 "matrix": 1.0 / math.sqrt(fan_in)}[kind]
        t.mul_(scale)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    return tree


def leaves(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()
           ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def check_layout(cfg: Dict[str, Any], program_shapes: Dict[str, Any]) -> None:
    """Raise unless the program's parameter tree (``(shape, dtype)``
    leaves) has exactly this layout's paths and shapes."""
    want = {p: tuple(s) for p, s, _, _ in layout(cfg)}
    have = {p: tuple(v[0]) for p, v in leaves(program_shapes)}
    if want != have:
        raise SystemExit(f"the program's parameter layout departs from the "
                         f"harness's: only the program's "
                         f"{sorted(set(have.items()) - set(want.items()))}, "
                         f"only the harness's "
                         f"{sorted(set(want.items()) - set(have.items()))}")
