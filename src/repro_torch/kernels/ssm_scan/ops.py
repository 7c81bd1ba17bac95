"""Public wrapper of the CUDA selective scan (Mamba-1), y in fp32.

The operands are the JAX wrapper's, ``ssm_scan(x, dt, A, Bm, C)``; its
time and channel tiles (``bt``, ``bd``) have no counterpart: the CUDA
kernel is a chunked scan, one block per (batch row, 32 channels) holding
up to 8 chunks of the sequence (at least 32 steps each), their start
states carried across the chunks inside the block, in one launch a call;
nothing is padded.

Where it runs: a CPU tensor goes to the plain version (:func:`ssm_scan_ref`);
a CUDA tensor launches the kernel in ``csrc/ssm_scan.cu`` on the current
stream.  ``ssm_scan.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .ref import ssm_scan_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 32


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library, its C functions typed (pointers and the
    stream as ``c_void_p``, so ctypes never cuts them to 32 bits)."""
    lib = _build.load("ssm_scan")
    lib.ssm_scan_launch.argtypes = ([ctypes.c_void_p] * 6
                                    + [ctypes.c_int] * 5
                                    + [ctypes.c_void_p])
    lib.ssm_scan_launch.restype = ctypes.c_int
    lib.ssm_scan_error_string.argtypes = [ctypes.c_int]
    lib.ssm_scan_error_string.restype = ctypes.c_char_p
    return lib


def _launch(x, dt, A, Bm, C) -> torch.Tensor:
    if x.dtype not in _DTYPE_CODES or any(t.dtype != x.dtype
                                          for t in (dt, Bm, C)):
        raise TypeError(f"ssm_scan kernel takes x, dt, B and C of one dtype, "
                        f"float32 or bfloat16, got {x.dtype}, {dt.dtype}, "
                        f"{Bm.dtype}, {C.dtype}")
    if any(t.device != x.device for t in (dt, A, Bm, C)):
        raise ValueError("ssm_scan operands must lie on one device")
    B, T, d = x.shape
    N = A.shape[1]
    if N > MAX_STATE:
        raise ValueError(f"state size {N} > {MAX_STATE}")
    x, dt, Bm, C = (t.contiguous() for t in (x, dt, Bm, C))
    A = A.float().contiguous()
    y = torch.empty((B, T, d), dtype=torch.float32, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssm_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            C.data_ptr(), y.data_ptr(), B, T, d, N, _DTYPE_CODES[x.dtype],
            stream)
    if err != 0:
        raise RuntimeError("ssm_scan kernel launch failed: "
                           + lib.ssm_scan_error_string(err).decode())
    ssm_scan.launches += 1
    return y


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """x/dt: (B, T, d); A: (d, N); Bm/C: (B, T, N) -> y: (B, T, d) fp32."""
    if x.ndim != 3 or dt.shape != x.shape or A.ndim != 2 or \
            A.shape[0] != x.shape[2] or Bm.shape != C.shape or \
            Bm.shape != (*x.shape[:2], A.shape[1]):
        raise ValueError(f"ssm_scan takes x/dt (B, T, d), A (d, N) and B/C "
                         f"(B, T, N), got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(C.shape)}")
    if x.device.type == "cpu":
        return ssm_scan_ref(x, dt, A, Bm, C)
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan runs on CUDA or CPU tensors, got "
                         f"{x.device}")
    return _launch(x, dt, A, Bm, C)


#: kernel launches since the count was last set to 0
ssm_scan.launches = 0
