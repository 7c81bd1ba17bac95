"""Public wrapper of the CUDA RG-LRU scan, h in fp32, and its backward.

The operands are the JAX wrapper's, ``rglru_scan(a, bx)``; its time and
channel tiles (``bt``, ``bw``) have no counterpart: the CUDA kernel is a
single-pass chunked scan, one block per (batch row, 16 channels) holding
up to 16 chunks of 16 steps at a time, their start states carried across
the chunks inside the block and the sequence walked in segments of 256
steps, in one launch a call; nothing is padded.  Its rounding differs from
the plain version's sequential walk (composed decays, one FMA a step).

Where it runs: a CPU tensor goes to the plain version (:func:`rglru_scan_ref`),
which autograd differentiates; a meta tensor (shapes only) to
:func:`rglru_scan_meta`, without the plain version's loop over T (neither
has a product to count); a CUDA tensor launches the kernel in
``csrc/rglru_scan.cu`` on the current stream.  ``rglru_scan.launches``
counts its forward launches.

Gradients: on the card, when a or bx requires grad (and grad mode is on),
the scan goes through :class:`_RglruScanFn`, whose forward is the same
launch (the same bits) and saves a and h; its backward is
:func:`rglru_scan_bwd`, the reverse walk (``dh_t = g_t + a_{t+1} dh_{t+1}``,
then ``dbx = dh`` and ``da_t = dh_t h_{t-1}``), a kernel of its own in the
same source (``rglru_scan_bwd_kernel``): a chunked scan sized to fill the
card in one wave (:mod:`.plan`; :func:`bwd_geometry` reports the launch),
a, g and h of a segment loaded together, the chunks' start states
composed by a shuffle scan.  One launch a call, counted by
``rglru_scan_bwd.launches``.  Its plain version is
:func:`rglru_scan_bwd_ref`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from .. import _build
from . import plan
from .ref import rglru_scan_bwd_ref, rglru_scan_meta, rglru_scan_ref

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
    lib.rglru_scan_bwd_launch.argtypes = ([ctypes.c_void_p] * 5
                                          + [ctypes.c_int] * 4
                                          + [ctypes.c_void_p])
    lib.rglru_scan_bwd_launch.restype = ctypes.c_int
    lib.rglru_scan_bwd_geometry.argtypes = ([ctypes.c_int] * 4
                                            + [ctypes.c_void_p])
    lib.rglru_scan_bwd_geometry.restype = ctypes.c_int
    lib.rglru_scan_bwd_residency.argtypes = [ctypes.c_int] * 2
    lib.rglru_scan_bwd_residency.restype = ctypes.c_int
    lib.rglru_scan_error_string.argtypes = [ctypes.c_int]
    lib.rglru_scan_error_string.restype = ctypes.c_char_p
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + _library().rglru_scan_error_string(err).decode())


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
    _check(err, "rglru_scan")
    rglru_scan.launches += 1
    return h


def _launch_bwd(a, h, g) -> Tuple[torch.Tensor, torch.Tensor]:
    if a.dtype not in _DTYPE_CODES:
        raise TypeError(f"rglru_scan_bwd kernel takes a in float32 or "
                        f"bfloat16, got {a.dtype}")
    if h.device != a.device or g.device != a.device:
        raise ValueError("rglru_scan_bwd operands must lie on one device")
    B, T, w = a.shape
    a = a.contiguous()
    h, g = h.float().contiguous(), g.float().contiguous()
    dh = torch.empty((B, T, w), dtype=torch.float32, device=a.device)
    da = torch.empty_like(dh)
    lib = _library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rglru_scan_bwd_launch(
            a.data_ptr(), g.data_ptr(), h.data_ptr(), dh.data_ptr(),
            da.data_ptr(), B, T, w, _DTYPE_CODES[a.dtype], stream)
    _check(err, "rglru_scan_bwd")
    rglru_scan_bwd.launches += 1
    return da, dh


def bwd_geometry(B: int, T: int, w: int, dtype: torch.dtype,
                 device=None) -> plan.Geometry:
    """The launch :func:`rglru_scan_bwd` makes for (B, T, w) with ``a`` of
    ``dtype`` on a CUDA device (the current one by default), as the
    kernel's library computes it."""
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        err = _library().rglru_scan_bwd_geometry(B, T, w,
                                                 _DTYPE_CODES[dtype], out)
    _check(err, "rglru_scan_bwd geometry")
    tile, chunks, tiles, resident, sms = out
    return plan.Geometry(B, T, w, tile, chunks, tiles, resident, sms)


def bwd_residency(dtype: torch.dtype, threads: int, device=None) -> int:
    """Blocks of ``threads`` threads (a power of two up to 512, the sizes
    the launch makes) of the reverse walk (``a`` of ``dtype``) that fit one
    SM of a CUDA device, by the occupancy query."""
    with torch.cuda.device(device):
        r = _library().rglru_scan_bwd_residency(_DTYPE_CODES[dtype], threads)
    if r < 0:
        raise RuntimeError(f"rglru_scan_bwd residency query failed for "
                           f"{threads} threads (a power of two up to 512)")
    return r


def rglru_scan_bwd(a: torch.Tensor, h: torch.Tensor,
                   g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradient of :func:`rglru_scan` from its input ``a``, its output
    ``h`` and the gradient ``g`` on h, all (B, T, w): returns (da, dbx) in
    fp32.  A CPU tensor takes the plain version; a CUDA tensor launches
    the reverse walk's kernel."""
    if a.ndim != 3 or h.shape != a.shape or g.shape != a.shape:
        raise ValueError(f"rglru_scan_bwd takes a, h and g of one shape "
                         f"(B, T, w), got {tuple(a.shape)}, "
                         f"{tuple(h.shape)}, {tuple(g.shape)}")
    if a.device.type == "cpu":
        return rglru_scan_bwd_ref(a, h, g)
    if a.device.type == "meta":
        # shapes only: the plain reverse walk has no product to count
        return torch.empty_like(a, dtype=torch.float32), \
            torch.empty_like(a, dtype=torch.float32)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan_bwd runs on CUDA or CPU tensors, got "
                         f"{a.device}")
    return _launch_bwd(a, h, g)


class _RglruScanFn(torch.autograd.Function):
    """rglru_scan with a gradient: the forward saves a and h; the backward
    is :func:`rglru_scan_bwd`."""

    @staticmethod
    def forward(ctx, a, bx):
        h = rglru_scan_ref(a, bx) if a.device.type == "cpu" else \
            _launch(a, bx)
        ctx.save_for_backward(a, h)
        ctx.dtypes = (a.dtype, bx.dtype)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        da, dbx = rglru_scan_bwd(a, h, g)
        return da.to(ctx.dtypes[0]), dbx.to(ctx.dtypes[1])


def rglru_scan(a: torch.Tensor, bx: torch.Tensor) -> torch.Tensor:
    """a/bx: (B, T, w) -> h: (B, T, w) fp32, ``h_t = a_t h_{t-1} + bx_t``
    from ``h_0 = 0``."""
    if a.ndim != 3 or bx.shape != a.shape:
        raise ValueError(f"rglru_scan takes a and bx of one shape (B, T, w), "
                         f"got {tuple(a.shape)}, {tuple(bx.shape)}")
    if a.device.type == "cpu":
        return rglru_scan_ref(a, bx)
    if a.device.type == "meta":
        return rglru_scan_meta(a, bx)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan runs on CUDA or CPU tensors, got "
                         f"{a.device}")
    if torch.is_grad_enabled() and (a.requires_grad or bx.requires_grad):
        return _RglruScanFn.apply(a, bx)
    return _launch(a, bx)


#: kernel launches since the count was last set to 0
rglru_scan.launches = 0
#: backward launches (the reverse walk's kernel) since the count was last
#: set to 0
rglru_scan_bwd.launches = 0
