"""Public wrapper of the CUDA latent attention.

MLA's absorbed attention in the serve path's decode and chunk bodies
(:func:`repro_torch.models.attention.mla_columns`): C columns of queries
over B slots, each query's H heads against the first ``rows`` rows of its
slot's latent and rope caches and then its column's own new row
(``csrc/latent_attention.cu``: bf16 on the tensor cores, a block's query
rows in 16-row tiles over [latent | rope] tiles they share; fp32 on CUDA
cores; a second, merge launch when the cache is longer than one
256-position group).  A row's decomposition is fixed by (r, dr, dtype)
alone (``plan.py``), so a query's bits never depend on how many columns,
heads or slots run with it.  Its plain version is
:func:`.ref.latent_attention_ref`.

Where it runs: a CPU or meta tensor goes to the plain version; a CUDA
tensor launches the kernel on the current stream, or raises.
``latent_attention.launches`` counts its calls on the card: one a call,
which launches the split kernel and, where T is over 256, the merge after
it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ...device import PLAIN_DEVICES
from .. import _build
from . import plan
from .ref import latent_attention_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library, its C functions typed (pointers and the
    stream as ``c_void_p``, so ctypes never cuts them to 32 bits)."""
    lib = _build.load("latent_attention")
    lib.latent_attention_launch.argtypes = ([ctypes.c_void_p] * 9
                                            + [ctypes.c_int] * 8
                                            + [ctypes.c_float,
                                               ctypes.c_void_p])
    lib.latent_attention_launch.restype = ctypes.c_int
    lib.latent_attention_error_string.argtypes = [ctypes.c_int]
    lib.latent_attention_error_string.restype = ctypes.c_char_p
    return lib


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte address (the kernel's copies)."""
    t = t.contiguous()
    return t if t.data_ptr() % plan.COPY_BYTES == 0 else t.clone()


def _launch(q_eff, q_rope, latent, rope, rows, self_lat, self_rope,
            scale) -> torch.Tensor:
    ops = (q_eff, q_rope, latent, rope, self_lat, self_rope)
    if latent.dtype not in _DTYPE_CODES or {t.dtype for t in ops} != {
            latent.dtype}:
        raise TypeError(f"latent_attention kernel takes its operands in one "
                        f"dtype, float32 or bfloat16, got "
                        f"{[t.dtype for t in ops]}")
    C, B, H, r = q_eff.shape
    T, dr = latent.shape[1], rope.shape[2]
    if not plan.takes(r, dr, latent.element_size()):
        raise ValueError(f"latent_attention kernel takes a latent of up to "
                         f"{plan.MAX_R} elements in whole 16-byte vectors "
                         f"and a rope key of up to {plan.MAX_ROPE} in whole "
                         f"4-byte words, got r={r}, dr={dr} in "
                         f"{latent.dtype}")
    geo = plan.geometry(B, C, H, T, r, dr, latent.element_size())
    qe, qr, lat, rp, sl, sr = map(_aligned, ops)
    n = rows.to(torch.int32).contiguous()
    out = torch.empty_like(qe)
    # the group partials (max, sum, weighted latent), fp32; from the
    # graph's pool under capture
    work = (torch.empty(geo.work_floats, dtype=torch.float32,
                        device=latent.device) if geo.merges else None)
    lib = _library()
    with torch.cuda.device(latent.device):
        err = lib.latent_attention_launch(
            qe.data_ptr(), qr.data_ptr(), lat.data_ptr(), rp.data_ptr(),
            n.data_ptr(), sl.data_ptr(), sr.data_ptr(), out.data_ptr(),
            None if work is None else work.data_ptr(), B, C * B, H, T, r, dr,
            _DTYPE_CODES[latent.dtype], geo.rows, float(scale),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("latent_attention kernel launch failed: "
                           + lib.latent_attention_error_string(err).decode())
    latent_attention.launches += 1
    return out


def latent_attention(q_eff: torch.Tensor, q_rope: torch.Tensor,
                     latent: torch.Tensor, rope: torch.Tensor,
                     rows: torch.Tensor, self_lat: torch.Tensor,
                     self_rope: torch.Tensor, scale: float) -> torch.Tensor:
    """q_eff (C, B, H, r) and q_rope (C, B, H, dr): column c's query heads
    of slot b; caches ``latent`` (B, T, r) and ``rope`` (B, T, dr); rows
    (C, B) int: the cache rows [0, rows) each query reads; self_lat
    (C, B, r) and self_rope (C, B, dr): the column's own new row, attended
    last; ``scale`` the scores' factor.  Returns (C, B, H, r) in the
    caches' dtype (see :func:`.ref.latent_attention_ref`)."""
    if q_eff.ndim != 4 or latent.ndim != 3 or rope.ndim != 3:
        raise ValueError(f"latent_attention takes q_eff (C, B, H, r) and "
                         f"caches (B, T, r), (B, T, dr), got "
                         f"{tuple(q_eff.shape)}, {tuple(latent.shape)}, "
                         f"{tuple(rope.shape)}")
    C, B, H, r = q_eff.shape
    T, dr = latent.shape[1], rope.shape[2]
    if (latent.shape != (B, T, r) or rope.shape[:2] != (B, T)
            or q_rope.shape != (C, B, H, dr) or rows.shape != (C, B)
            or self_lat.shape != (C, B, r) or self_rope.shape != (C, B, dr)):
        raise ValueError(f"latent_attention: q_eff {tuple(q_eff.shape)}, "
                         f"q_rope {tuple(q_rope.shape)}, caches "
                         f"{tuple(latent.shape)} {tuple(rope.shape)}, rows "
                         f"{tuple(rows.shape)}, self rows "
                         f"{tuple(self_lat.shape)} {tuple(self_rope.shape)} "
                         f"do not agree")
    if latent.device.type in PLAIN_DEVICES:
        return latent_attention_ref(q_eff, q_rope, latent, rope, rows,
                                    self_lat, self_rope, scale)
    if latent.device.type != "cuda":
        raise ValueError(f"latent_attention runs on CUDA, CPU or meta "
                         f"tensors, got {latent.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q_eff, q_rope, latent, rope, self_lat,
                                      self_rope)):
        raise RuntimeError("the latent_attention kernel has no backward: it "
                           "serves the decode and chunk bodies, under "
                           "no_grad")
    return _launch(q_eff, q_rope, latent, rope, rows, self_lat, self_rope,
                   scale)


#: calls on the card (each one split launch, and a merge where T > 256)
#: since the count was last set to 0
latent_attention.launches = 0
