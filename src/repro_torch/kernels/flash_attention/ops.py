"""Public wrapper of the CUDA flash attention: (B, H, S, D) in and out.

A CPU tensor goes to the plain version (:func:`attention_ref`, with KV heads
repeated for GQA); a CUDA tensor launches the kernel in
``csrc/flash_attention.cu`` on the current stream, which expands GQA by
index and needs no padding of S.  bf16 runs on the tensor cores, fp32 on
FMAs.  A bf16 head dim that is not a multiple of 8 is padded with zero
columns here (never on the served models' shapes), so every row is a
16-byte copy.  A v head dim ``Dv`` below q's and k's ``D`` (MLA: 96 for q
and k, 64 for v) is padded with zero columns to ``D`` on the card, and the
output sliced back: zero columns of v give zero columns of the output, and
the scale 1/sqrt(D) is q's either way, so the padding is exact; the kernel
keeps one head dim for its tiles.  ``flash_attention.launches`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from .. import _build
from .ref import attention_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library, its C functions typed (pointers and the
    stream as ``c_void_p``, so ctypes never cuts them to 32 bits)."""
    lib = _build.load("flash_attention")
    lib.flash_attention_launch.argtypes = ([ctypes.c_void_p] * 4
                                           + [ctypes.c_int] * 12
                                           + [ctypes.c_void_p])
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _plain(q, k, v, causal, window, q_offset) -> torch.Tensor:
    B, Hq, Sq, D = q.shape
    Hkv, Sk, Dv = k.shape[1], k.shape[2], v.shape[3]
    k = k.repeat_interleave(Hq // Hkv, dim=1)
    v = v.repeat_interleave(Hq // Hkv, dim=1)
    out = attention_ref(q.reshape(B * Hq, Sq, D), k.reshape(B * Hq, Sk, D),
                        v.reshape(B * Hq, Sk, Dv), causal=causal,
                        window=window, q_offset=q_offset)
    return out.reshape(B, Hq, Sq, Dv).to(q.dtype)


def _launch(q, k, v, causal, window, q_offset) -> torch.Tensor:
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16 "
                        f"q/k/v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (k.device == v.device == q.device):
        raise ValueError("q, k and v must lie on one device")
    B, Hq, Sq, D = q.shape
    Hkv, Sk, Dv = k.shape[1], k.shape[2], v.shape[3]
    if D > MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} > {MAX_HEAD_DIM}")
    if Dv < D:
        v = F.pad(v, (0, D - Dv))
    ld = D
    if q.dtype == torch.bfloat16 and D % 8:
        ld = D + (-D) % 8
        q, k, v = (F.pad(t, (0, ld - D)) for t in (q, k, v))
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the bf16 flash_attention kernel needs 16-byte "
                         "aligned q, k and v")
    out = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq,
            Hkv, Sq, Sk, D, ld, int(causal), int(window is not None),
            0 if window is None else int(window), int(q_offset),
            _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError("flash_attention kernel launch failed: "
                           + lib.flash_attention_error_string(err).decode())
    flash_attention.launches += 1
    return out[..., :Dv] if ld != Dv else out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k: (B, Hkv, Sk, D); v: (B, Hkv, Sk, Dv) with
    Dv <= D; Hq a multiple of Hkv.  Query ``i`` sits at position
    ``q_offset + i``.  Returns (B, Hq, Sq, Dv) in ``q.dtype``."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4 or \
            v.shape[:3] != k.shape[:3] or k.shape[0] != q.shape[0] or \
            k.shape[3] != q.shape[3] or v.shape[3] > q.shape[3] or \
            q.shape[1] % k.shape[1]:
        raise ValueError(f"flash_attention takes q (B, Hq, Sq, D), k "
                         f"(B, Hkv, Sk, D) and v (B, Hkv, Sk, Dv <= D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.device.type == "cpu":
        return _plain(q, k, v, causal, window, q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got "
                         f"{q.device}")
    return _launch(q, k, v, causal, window, q_offset)


#: kernel launches since the count was last set to 0
flash_attention.launches = 0
