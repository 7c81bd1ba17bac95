"""Public wrapper of the CUDA selective scan (Mamba-1), y in fp32, and of
its backward kernel.

The operands are the JAX wrapper's, ``ssm_scan(x, dt, A, Bm, C)``; its
time and channel tiles (``bt``, ``bd``) have no counterpart: the CUDA
kernel is a chunked scan, one block per (batch row, 32 channels) holding
up to 8 chunks of the sequence (at least 32 steps each), their start
states carried across the chunks inside the block, in one launch a call;
nothing is padded.

Where it runs: a CPU tensor goes to the plain version (:func:`ssm_scan_ref`),
which autograd differentiates; a meta tensor (shapes only) to
:func:`ssm_scan_meta`, which has the plain version's products without its
loop over T, so ``FlopCounterMode`` counts what it counts on the plain
version; a CUDA tensor launches the kernel in
``csrc/ssm_scan.cu`` on the current stream.  ``ssm_scan.launches`` counts
its launches.

Gradients: on the card, when an operand requires grad (and grad mode is
on), the scan goes through :class:`_SsmScanFn`.  Its forward is the same
launch (y keeps its bits) with each chunk's start state also written
((B, nch, N, d) fp32, :func:`ssm_scan_states`), as the attention forward
writes its log-sum-exp; its backward is :func:`ssm_scan_bwd`, the kernel
of ``csrc/ssm_scan_bwd.cu``, which recomputes the states inside each chunk
from those while it walks the chunk in reverse and never builds the
(B, T, d, N) states.  It returns every gradient in fp32, the partial sums
of dA, dB and dC added in a fixed order (no atomics), so two calls give
the same bits; ``ssm_scan_bwd.launches`` counts its calls.  Its plain
version is :func:`ssm_scan_bwd_ref`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from .. import _build
from .ref import (ssm_scan_bwd_meta, ssm_scan_bwd_ref, ssm_scan_meta,
                  ssm_scan_ref)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 32
#: channels a block of either kernel holds
_LANES = 32


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library, its C functions typed (pointers and the
    stream as ``c_void_p``, so ctypes never cuts them to 32 bits)."""
    lib = _build.load("ssm_scan")
    lib.ssm_scan_launch.argtypes = ([ctypes.c_void_p] * 7
                                    + [ctypes.c_int] * 5
                                    + [ctypes.c_void_p])
    lib.ssm_scan_launch.restype = ctypes.c_int
    lib.ssm_scan_chunks.argtypes = [ctypes.c_int]
    lib.ssm_scan_chunks.restype = ctypes.c_int
    lib.ssm_scan_error_string.argtypes = [ctypes.c_int]
    lib.ssm_scan_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    lib = _build.load("ssm_scan_bwd")
    lib.ssm_scan_bwd_launch.argtypes = ([ctypes.c_void_p] * 16
                                        + [ctypes.c_int] * 6
                                        + [ctypes.c_void_p])
    lib.ssm_scan_bwd_launch.restype = ctypes.c_int
    lib.ssm_scan_bwd_scratch_floats.argtypes = [ctypes.c_int] * 5
    lib.ssm_scan_bwd_scratch_floats.restype = ctypes.c_longlong
    lib.ssm_scan_bwd_error_string.argtypes = [ctypes.c_int]
    lib.ssm_scan_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _operands(x, dt, A, Bm, C, what: str):
    if x.dtype not in _DTYPE_CODES or any(t.dtype != x.dtype
                                          for t in (dt, Bm, C)):
        raise TypeError(f"{what} kernel takes x, dt, B and C of one dtype, "
                        f"float32 or bfloat16, got {x.dtype}, {dt.dtype}, "
                        f"{Bm.dtype}, {C.dtype}")
    if any(t.device != x.device for t in (dt, A, Bm, C)):
        raise ValueError(f"{what} operands must lie on one device")
    if A.shape[1] > MAX_STATE:
        raise ValueError(f"state size {A.shape[1]} > {MAX_STATE}")
    return (*(t.contiguous() for t in (x, dt)), A.float().contiguous(),
            *(t.contiguous() for t in (Bm, C)))


def _launch(x, dt, A, Bm, C, states: bool = False):
    x, dt, A, Bm, C = _operands(x, dt, A, Bm, C, "ssm_scan")
    B, T, d = x.shape
    N = A.shape[1]
    lib = _library()
    y = torch.empty((B, T, d), dtype=torch.float32, device=x.device)
    hs = (torch.empty((B, lib.ssm_scan_chunks(T), N, d), dtype=torch.float32,
                      device=x.device) if states else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssm_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            C.data_ptr(), y.data_ptr(), None if hs is None else hs.data_ptr(),
            B, T, d, N, _DTYPE_CODES[x.dtype], stream)
    if err != 0:
        raise RuntimeError("ssm_scan kernel launch failed: "
                           + lib.ssm_scan_error_string(err).decode())
    ssm_scan.launches += 1
    return (y, hs) if states else y


def _launch_bwd(x, dt, A, Bm, C, dy, hs):
    x, dt, A, Bm, C = _operands(x, dt, A, Bm, C, "ssm_scan_bwd")
    B, T, d = x.shape
    N = A.shape[1]
    nch = hs.shape[1]
    if hs.shape != (B, nch, N, d) or hs.dtype != torch.float32 or \
            nch != _library().ssm_scan_chunks(T):
        raise ValueError(f"ssm_scan_bwd needs the forward's chunk states "
                         f"(B, {_library().ssm_scan_chunks(T)}, N, d) fp32, "
                         f"got {tuple(hs.shape)} {hs.dtype}")
    dy, hs = dy.float().contiguous(), hs.contiguous()
    lib = _bwd_library()
    dev = x.device

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)
    nblk = -(-d // _LANES)
    scratch = f32(lib.ssm_scan_bwd_scratch_floats(B, T, d, N, nch))
    dx, ddt = f32(B, T, d), f32(B, T, d)
    dA_p, dB_p, dC_p = f32(B, d, N), f32(nblk, B, T, N), f32(nblk, B, T, N)
    dA, dB, dC = f32(d, N), f32(B, T, N), f32(B, T, N)
    ptrs = (x, dt, A, Bm, C, dy, hs, scratch, dx, ddt, dA_p, dB_p, dC_p, dA,
            dB, dC)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssm_scan_bwd_launch(*(t.data_ptr() for t in ptrs), B, T, d,
                                      N, nch, _DTYPE_CODES[x.dtype], stream)
    if err != 0:
        raise RuntimeError("ssm_scan_bwd kernel launch failed: "
                           + lib.ssm_scan_bwd_error_string(err).decode())
    ssm_scan_bwd.launches += 1
    return dx, ddt, dA, dB, dC


def _check_shapes(x, dt, A, Bm, C) -> None:
    if x.ndim != 3 or dt.shape != x.shape or A.ndim != 2 or \
            A.shape[0] != x.shape[2] or Bm.shape != C.shape or \
            Bm.shape != (*x.shape[:2], A.shape[1]):
        raise ValueError(f"ssm_scan takes x/dt (B, T, d), A (d, N) and B/C "
                         f"(B, T, N), got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(C.shape)}")


def _cuda_only(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or CPU tensors, got "
                         f"{x.device}")


def ssm_scan_states(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    Bm: torch.Tensor, C: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel with each chunk's start state written: returns
    (y, states), y with the bits of :func:`ssm_scan` and states
    (B, nch, N, d) fp32, what :func:`ssm_scan_bwd` takes.  CUDA only."""
    _check_shapes(x, dt, A, Bm, C)
    _cuda_only(x, "ssm_scan_states")
    return _launch(x, dt, A, Bm, C, states=True)


def ssm_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, C: torch.Tensor, dy: torch.Tensor,
                 states: Optional[torch.Tensor] = None):
    """The gradient of :func:`ssm_scan` from its inputs and the gradient
    ``dy`` (B, T, d) on y: returns (dx, ddt, dA, dB, dC) in fp32, in the
    shapes of x, dt, A, Bm and C.  A CPU tensor takes the plain version
    (``states`` unused); a CUDA tensor launches the backward kernel on the
    forward's ``states`` (:func:`ssm_scan_states`)."""
    _check_shapes(x, dt, A, Bm, C)
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} is not y's {tuple(x.shape)}")
    if x.device.type == "cpu":
        return ssm_scan_bwd_ref(x, dt, A, Bm, C, dy)
    if x.device.type == "meta":
        return ssm_scan_bwd_meta(x, dt, A, Bm, C, dy)
    _cuda_only(x, "ssm_scan_bwd")
    if states is None:
        raise ValueError("ssm_scan_bwd on the card takes the forward's chunk "
                         "states (ssm_scan_states)")
    return _launch_bwd(x, dt, A, Bm, C, dy, states)


class _SsmScanFn(torch.autograd.Function):
    """ssm_scan with a gradient: the forward also writes the chunk start
    states and saves them with its inputs; the backward is
    :func:`ssm_scan_bwd`."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, C):
        if x.device.type == "cpu":
            y, hs = ssm_scan_ref(x, dt, A, Bm, C), None
        else:
            y, hs = _launch(x, dt, A, Bm, C, states=True)
        ctx.save_for_backward(x, dt, A, Bm, C, hs)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, dt, A, Bm, C, hs = ctx.saved_tensors
        grads = ssm_scan_bwd(x, dt, A, Bm, C, dy, hs)
        return tuple(g.to(t.dtype) for g, t in zip(grads, (x, dt, A, Bm, C)))


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """x/dt: (B, T, d); A: (d, N); Bm/C: (B, T, N) -> y: (B, T, d) fp32."""
    _check_shapes(x, dt, A, Bm, C)
    if x.device.type == "cpu":
        return ssm_scan_ref(x, dt, A, Bm, C)
    if x.device.type == "meta":
        return ssm_scan_meta(x, dt, A, Bm, C)
    _cuda_only(x, "ssm_scan")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, dt, A, Bm, C)):
        return _SsmScanFn.apply(x, dt, A, Bm, C)
    return _launch(x, dt, A, Bm, C)


#: kernel launches since the count was last set to 0
ssm_scan.launches = 0
#: backward kernel calls (the scan and its three ordered sums) since the
#: count was last set to 0
ssm_scan_bwd.launches = 0
