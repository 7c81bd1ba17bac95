"""Device and dtype resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: a
``device`` of ``None`` means ``"cuda"``, and asking for CUDA where no CUDA
device exists raises instead of carrying on on the CPU."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float64": torch.float64}


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device must exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


def torch_dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    """``RunConfig.dtype`` name (``"bfloat16"``, ``"float32"``,
    ``"float64"``) -> dtype.  The kernels take fp32 and bf16; fp64 runs
    only on the CPU's plain versions, as an exact witness for fp32."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; expected one of "
                         f"{sorted(_DTYPES)}") from None


def wide_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype the plain versions and the model's fp32 islands (norms,
    RoPE, scores, router, SSM state) compute in for ``dtype``: fp32, or
    fp64 for fp64, so that an fp64 run stays fp64 throughout."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def upcast(x: torch.Tensor) -> torch.Tensor:
    """``x`` in :func:`wide_dtype` of its dtype (``x.float()`` but for
    fp64)."""
    return x.to(wide_dtype(x.dtype))
