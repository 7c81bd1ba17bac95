"""Public wrapper of the CUDA expert GEMM: ``y[e] = x[e] @ w[e]`` in fp32.

The signature is the JAX wrapper's, ``moe_gemm(x, w, *, bc, bf, bk,
depth=2)``, plus the port's ``policy``.  ``bc``/``bf``/``bk`` are the
Pallas kernel's tiles; the CUDA kernel's tiles are compiled in (16 or 64
rows by 64 columns, 32 deep), so on the card they change nothing, and they
are kept so that callers stay the same as the reference's.

Where it runs: a CPU tensor goes to the plain version (:func:`moe_gemm_ref`);
a CUDA tensor launches the kernel in ``csrc/moe_gemm.cu`` on the current
stream, except under ``ExecutionPolicy.BASELINE``, which is the plain
version on any device and launches nothing.  COPIFT forces the ring to
depth 1.  ``moe_gemm.launches`` counts kernel launches.

``x`` may be a broadcast view whose expert stride is 0 (``x2d.expand(E, C,
d)``, the dense dispatch): the kernel then reads the one (C, d) matrix for
every expert and nothing is copied E times.  Only what the kernel needs is
padded: d and f up to 16 bytes' worth of elements (never on the model
path's shapes); ragged C and f tiles are masked inside the kernel.

:func:`operating_point` is the policy table's ``moe_gemm`` point, whose
depth the model path passes (:mod:`repro_torch.models.moe`).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from ...core.policy import ExecutionPolicy, OperatingPoint, default_table
from .. import _build
from .ref import moe_gemm_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_DEPTH = 16


def operating_point() -> OperatingPoint:
    """The policy table's point for the ``moe_gemm`` workload."""
    return default_table().resolve("moe_gemm")


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library, its C functions typed (pointers and the
    stream as ``c_void_p``, the expert stride as ``c_longlong``)."""
    lib = _build.load("moe_gemm")
    lib.moe_gemm_launch.argtypes = ([ctypes.c_void_p] * 3
                                    + [ctypes.c_int] * 4
                                    + [ctypes.c_longlong]
                                    + [ctypes.c_int] * 2
                                    + [ctypes.c_void_p])
    lib.moe_gemm_launch.restype = ctypes.c_int
    lib.moe_gemm_error_string.argtypes = [ctypes.c_int]
    lib.moe_gemm_error_string.restype = ctypes.c_char_p
    return lib


def _launch(x: torch.Tensor, w: torch.Tensor, depth: int) -> torch.Tensor:
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"moe_gemm kernel takes float32 or bfloat16 operands "
                        f"of one dtype, got {x.dtype} and {w.dtype}")
    if w.device != x.device:
        raise ValueError(f"operands on {x.device} and {w.device}")
    if not 1 <= depth <= _MAX_DEPTH:
        raise ValueError(f"ring depth must lie in [1, {_MAX_DEPTH}], got "
                         f"{depth}")
    E, C, d = x.shape
    f = w.shape[2]
    vec = 16 // x.element_size()
    pk, pf = (-d) % vec, (-f) % vec
    if x.stride(0) == 0:                 # one matrix seen by every expert
        xp = (F.pad(x[0], (0, pk)) if pk else x[0]).contiguous()
        x_stride = 0
    else:
        xp = (F.pad(x, (0, pk)) if pk else x).contiguous()
        x_stride = C * (d + pk)
    wp = (F.pad(w, (0, pf, 0, pk)) if pk or pf else w).contiguous()
    for t in (xp, wp):
        if t.data_ptr() % 16:
            raise ValueError("moe_gemm kernel needs 16-byte aligned operands")
    out = torch.empty((E, C, f + pf), dtype=torch.float32, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.moe_gemm_launch(
            xp.data_ptr(), wp.data_ptr(), out.data_ptr(), E, C, f + pf,
            d + pk, x_stride, depth, _DTYPE_CODES[x.dtype], stream)
    if err != 0:
        raise RuntimeError("moe_gemm kernel launch failed: "
                           + lib.moe_gemm_error_string(err).decode())
    moe_gemm.launches += 1
    return out[..., :f] if pf else out


def moe_gemm(x: torch.Tensor, w: torch.Tensor, *, bc: int = 128,
             bf: int = 128, bk: int = 128, depth: int = 2,
             policy: Optional[ExecutionPolicy] = None) -> torch.Tensor:
    """x: (E, C, d); w: (E, d, f) -> (E, C, f) fp32.

    ``policy``: BASELINE is the plain version, COPIFT forces depth 1,
    COPIFTV2 (and ``None``) keep ``depth``."""
    if x.ndim != 3 or w.ndim != 3 or x.shape[0] != w.shape[0] or \
            x.shape[2] != w.shape[1]:
        raise ValueError(f"moe_gemm takes x (E, C, d) and w (E, d, f), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if policy is ExecutionPolicy.BASELINE or x.device.type == "cpu":
        return moe_gemm_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"moe_gemm runs on CUDA or CPU tensors, got "
                         f"{x.device}")
    if policy is ExecutionPolicy.COPIFT:
        depth = 1
    return _launch(x, w, depth)


#: kernel launches since the count was last set to 0
moe_gemm.launches = 0
