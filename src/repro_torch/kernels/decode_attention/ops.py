"""Public wrapper of the CUDA decode attention.

The attention of the serve path's decode and chunk bodies
(:func:`repro_torch.models.model.decode_step`, ``prefill_step``): C columns
of queries over B slots, each query against the first ``valid`` rows of its
slot's K/V cache, split over the cache length in spans whose partials are
folded in span order (``csrc/decode_attention.cu``; a second, merge launch
when the cache is longer than one 256-position group).  A row's decomposition is fixed by
(D, dtype) alone (``plan.py``), so a query's bits never depend on how many
columns, heads or slots run with it.  Its plain version is
:func:`.ref.decode_attention_rows_ref`, the model's one-column attention
(:func:`.ref.decode_attention_ref`) over each column.

Where it runs: a CPU or meta tensor goes to the plain version; a CUDA
tensor launches the kernel on the current stream, or raises.
``decode_attention.launches`` counts its calls on the card: one a call,
which launches the split kernel and, where T is over 256, the merge after
it.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ...device import PLAIN_DEVICES
from .. import _build
from . import plan
from .ref import decode_attention_rows_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library, its C functions typed (pointers and the
    stream as ``c_void_p``, so ctypes never cuts them to 32 bits)."""
    lib = _build.load("decode_attention")
    lib.decode_attention_launch.argtypes = ([ctypes.c_void_p] * 6
                                            + [ctypes.c_int] * 8
                                            + [ctypes.c_float,
                                               ctypes.c_void_p])
    lib.decode_attention_launch.restype = ctypes.c_int
    lib.decode_attention_error_string.argtypes = [ctypes.c_int]
    lib.decode_attention_error_string.restype = ctypes.c_char_p
    return lib


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte address (the kernel's copies)."""
    t = t.contiguous()
    return t if t.data_ptr() % plan.COPY_BYTES == 0 else t.clone()


def _launch(q, k_cache, v_cache, valid) -> torch.Tensor:
    if q.dtype not in _DTYPE_CODES or {k_cache.dtype, v_cache.dtype} != {
            q.dtype}:
        raise TypeError(f"decode_attention kernel takes q and the caches in "
                        f"one dtype, float32 or bfloat16, got {q.dtype}, "
                        f"{k_cache.dtype}, {v_cache.dtype}")
    C, B, Hq, D = q.shape
    _, Hkv, T, _ = k_cache.shape
    if not plan.takes(D, q.element_size()):
        raise ValueError(f"decode_attention kernel takes head dims up to "
                         f"{plan.MAX_D} in whole 16-byte vectors, got {D} "
                         f"in {q.dtype}")
    geo = plan.geometry(B, C, Hq, Hkv, T, D, q.element_size())
    qc, kc, vc = _aligned(q), _aligned(k_cache), _aligned(v_cache)
    lens = valid.to(torch.int32).contiguous()
    out = torch.empty_like(qc)
    # the span partials (max, sum, weighted V), fp32; from the graph's pool
    # under capture
    work = (torch.empty(geo.work_floats, dtype=torch.float32,
                        device=q.device) if geo.merges else None)
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.decode_attention_launch(
            qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), lens.data_ptr(),
            out.data_ptr(), None if work is None else work.data_ptr(), B,
            C * B, Hq, Hkv, T, D, _DTYPE_CODES[q.dtype], geo.rows,
            1.0 / math.sqrt(D), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("decode_attention kernel launch failed: "
                           + lib.decode_attention_error_string(err).decode())
    decode_attention.launches += 1
    return out


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, valid: torch.Tensor
                     ) -> torch.Tensor:
    """q (C, B, Hq, D): column c's query heads of slot b; k/v caches
    (B, Hkv, T, D) with Hq a multiple of Hkv (GQA); valid (C, B) int: the
    cache rows [0, valid) each query sees (all T past T).  Returns
    (C, B, Hq, D) in the caches' dtype."""
    if q.ndim != 4 or k_cache.ndim != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_attention takes q (C, B, Hq, D) and caches "
                         f"(B, Hkv, T, D) of one shape, got {tuple(q.shape)},"
                         f" {tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    C, B, Hq, D = q.shape
    if (k_cache.shape[0] != B or k_cache.shape[3] != D
            or Hq % k_cache.shape[1] or valid.shape != (C, B)):
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)}, valid "
                         f"{tuple(valid.shape)} do not agree")
    if q.device.type in PLAIN_DEVICES:
        return decode_attention_rows_ref(q, k_cache, v_cache, valid)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on CUDA, CPU or meta "
                         f"tensors, got {q.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k_cache, v_cache)):
        raise RuntimeError("the decode_attention kernel has no backward: it "
                           "serves the decode and chunk bodies, under "
                           "no_grad")
    return _launch(q, k_cache, v_cache, valid)


#: calls on the card (each one split launch, and a merge where T > 256)
#: since the count was last set to 0
decode_attention.launches = 0
