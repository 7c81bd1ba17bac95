"""Public wrapper of the CUDA RG-LRU scan, h in fp32.

The operands are the JAX wrapper's, ``rglru_scan(a, bx)``; its time and
channel tiles (``bt``, ``bw``) have no counterpart: the CUDA kernel is a
single-pass chunked scan, one block per (batch row, 16 channels) holding
up to 16 chunks of 16 steps at a time, their start states carried across
the chunks inside the block and the sequence walked in segments of 256
steps, in one launch a call; nothing is padded.  Its rounding differs from
the plain version's sequential walk (composed decays, one FMA a step).

Where it runs: a CPU tensor goes to the plain version
(:func:`rglru_scan_ref`); a CUDA tensor launches the kernel in
``csrc/rglru_scan.cu`` on the current stream.  ``rglru_scan.launches``
counts kernel launches.  It has no backward kernel yet: a CUDA launch
whose operands require grad raises ``NotImplementedError``
(:func:`.._grad.refuse_grad`).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .._grad import refuse_grad
from .ref import rglru_scan_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library, its C functions typed (pointers and the
    stream as ``c_void_p``, so ctypes never cuts them to 32 bits)."""
    lib = _build.load("rglru_scan")
    lib.rglru_scan_launch.argtypes = ([ctypes.c_void_p] * 3
                                      + [ctypes.c_int] * 4
                                      + [ctypes.c_void_p])
    lib.rglru_scan_launch.restype = ctypes.c_int
    lib.rglru_scan_error_string.argtypes = [ctypes.c_int]
    lib.rglru_scan_error_string.restype = ctypes.c_char_p
    return lib


def _launch(a, bx) -> torch.Tensor:
    if a.dtype not in _DTYPE_CODES or bx.dtype != a.dtype:
        raise TypeError(f"rglru_scan kernel takes a and bx of one dtype, "
                        f"float32 or bfloat16, got {a.dtype}, {bx.dtype}")
    if bx.device != a.device:
        raise ValueError("rglru_scan operands must lie on one device")
    B, T, w = a.shape
    a, bx = a.contiguous(), bx.contiguous()
    h = torch.empty((B, T, w), dtype=torch.float32, device=a.device)
    lib = _library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rglru_scan_launch(a.data_ptr(), bx.data_ptr(), h.data_ptr(),
                                    B, T, w, _DTYPE_CODES[a.dtype], stream)
    if err != 0:
        raise RuntimeError("rglru_scan kernel launch failed: "
                           + lib.rglru_scan_error_string(err).decode())
    rglru_scan.launches += 1
    return h


def rglru_scan(a: torch.Tensor, bx: torch.Tensor) -> torch.Tensor:
    """a/bx: (B, T, w) -> h: (B, T, w) fp32, ``h_t = a_t h_{t-1} + bx_t``
    from ``h_0 = 0``."""
    if a.ndim != 3 or bx.shape != a.shape:
        raise ValueError(f"rglru_scan takes a and bx of one shape (B, T, w), "
                         f"got {tuple(a.shape)}, {tuple(bx.shape)}")
    if a.device.type == "cpu":
        return rglru_scan_ref(a, bx)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan runs on CUDA or CPU tensors, got "
                         f"{a.device}")
    refuse_grad("rglru_scan", "hybrid training", a, bx)
    return _launch(a, bx)


#: kernel launches since the count was last set to 0
rglru_scan.launches = 0
