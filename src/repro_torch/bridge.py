"""Carry parameter and cache trees between the JAX package and the port.

Both packages keep the same pytree layout (nested dicts of arrays), so the
bridge is a tree map over numpy arrays.  Gradient trees have the
parameters' layout and cross the same way; an optimizer state crosses as
its three fields, ``(step, mu, nu)``, in the field order both packages'
``OptState`` share.  The JAX side converts its arrays to
numpy itself (``jax.tree_util.tree_map(np.asarray, tree)``) — this module
imports no JAX.  bfloat16 arrays travel bit for bit: numpy's ``bfloat16``
dtype (registered by ``ml_dtypes``, which JAX imports) is reinterpreted as
16-bit integers on the way in and back on the way out.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from .device import DeviceLike, resolve_device

Pytree = Any


def _to_tensor(a: np.ndarray, device: torch.device,
               dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a, copy=True).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def from_numpy_tree(tree: Pytree, device: DeviceLike = None,
                    dtype: Optional[torch.dtype] = None) -> Pytree:
    """numpy tree -> tensor tree on ``device`` (``None`` = the card);
    ``dtype`` recasts floating leaves, integer leaves keep theirs."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: from_numpy_tree(v, dev, dtype) for k, v in tree.items()}
    return _to_tensor(tree, dev, dtype)


def to_numpy_tree(tree: Pytree) -> Pytree:
    """tensor tree -> numpy tree on the host, dtypes kept (bfloat16 needs
    numpy's ``bfloat16`` dtype, which ``ml_dtypes`` registers)."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("bfloat16"))
    return t.numpy()


def opt_state_from_numpy(opt: Any, device: DeviceLike = None):
    """An ``OptState`` (the JAX package's, with numpy leaves, or any
    ``(step, mu, nu)`` triple) -> the port's
    :class:`~repro_torch.optim.OptState` on ``device``."""
    from .optim import OptState
    step, mu, nu = opt
    dev = resolve_device(device)
    return OptState(_to_tensor(step, dev, None), from_numpy_tree(mu, dev),
                    from_numpy_tree(nu, dev))


def opt_state_to_numpy(opt: Any) -> Tuple[np.ndarray, Pytree, Pytree]:
    """The port's ``OptState`` -> ``(step, mu, nu)`` numpy trees, ready for
    the JAX package's ``OptState(*...)``."""
    return tuple(to_numpy_tree(x) for x in opt)
