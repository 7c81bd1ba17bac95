"""Public wrapper of the CUDA row-wise RMS norm.

The norm of the serve path's decode and chunk bodies
(:func:`repro_torch.models.model.decode_step`, ``prefill_step``): each row
read once in 16-byte vectors by a number of threads fixed by (d, dtype)
(``plan.py``), and one fixed sum order, so a row's bits never depend on how
many rows are normed with it (``csrc/rms_norm.cu``).  Its plain version is
the model's norm, :func:`.ref.rms_norm_ref`.

Where it runs: a CPU or meta tensor goes to the plain version (on the CPU
its row bits do not depend on the row count either: each row is reduced
whole by one thread); a CUDA tensor launches the kernel on the current
stream, or raises.  ``rms_norm.launches`` counts its launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ...device import PLAIN_DEVICES
from .. import _build
from . import plan
from .ref import rms_norm_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library, its C functions typed (pointers and the
    stream as ``c_void_p``, so ctypes never cuts them to 32 bits)."""
    lib = _build.load("rms_norm")
    lib.rms_norm_launch.argtypes = ([ctypes.c_void_p] * 3
                                    + [ctypes.c_int] * 4
                                    + [ctypes.c_float, ctypes.c_void_p])
    lib.rms_norm_launch.restype = ctypes.c_int
    lib.rms_norm_error_string.argtypes = [ctypes.c_int]
    lib.rms_norm_error_string.restype = ctypes.c_char_p
    return lib


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte address (the kernel's loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % plan.LOAD_BYTES == 0 else t.clone()


def _launch(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    if x.dtype not in _DTYPE_CODES or gamma.dtype not in _DTYPE_CODES:
        raise TypeError(f"rms_norm kernel takes float32 or bfloat16, got x "
                        f"{x.dtype} and gamma {gamma.dtype}")
    if gamma.device != x.device:
        raise ValueError(f"operands on {x.device} and {gamma.device}")
    d = x.shape[-1]
    plan.threads_a_row(d, x.element_size())   # raises past the longest row
    xc, g = _aligned(x), _aligned(gamma)
    out = torch.empty_like(xc)
    rows = xc.numel() // d
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.rms_norm_launch(
            xc.data_ptr(), g.data_ptr(), out.data_ptr(), rows, d,
            _DTYPE_CODES[x.dtype], _DTYPE_CODES[g.dtype], float(eps),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("rms_norm kernel launch failed: "
                           + lib.rms_norm_error_string(err).decode())
    rms_norm.launches += 1
    return out


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """x (..., d), gamma (d,) -> ``x * rsqrt(mean(x^2) + eps) * (1 +
    gamma)`` in ``x.dtype``, each row's bits whatever the other rows."""
    if gamma.shape != x.shape[-1:]:
        raise ValueError(f"rms_norm takes x (..., d) and gamma (d,), got "
                         f"{tuple(x.shape)} and {tuple(gamma.shape)}")
    if x.device.type in PLAIN_DEVICES:
        return rms_norm_ref(x, gamma, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm runs on CUDA, CPU or meta tensors, got "
                         f"{x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad):
        raise RuntimeError("the rms_norm kernel has no backward: it serves "
                           "the decode and chunk bodies, under no_grad")
    if x.numel() == 0:
        return torch.empty_like(x)
    return _launch(x, gamma, eps)


#: kernel launches since the count was last set to 0
rms_norm.launches = 0
