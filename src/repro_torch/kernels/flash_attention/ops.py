"""Public wrapper of the CUDA flash attention: (B, H, S, D) in and out.

A CPU tensor goes to the plain version (:func:`attention_ref`, with KV heads
repeated for GQA), and so does a meta tensor (shapes only; ``FlopCounterMode``
counts the plain version's products, every score of the Sq x Sk block
computed, masked ones too); a CUDA tensor launches the kernel in
``csrc/flash_attention.cu`` on the current stream, which expands GQA by
index and needs no padding of S.  bf16 runs on the tensor cores, fp32 on
register-tiled FMAs in the tiles :func:`fp32_geometry` gives.  A bf16 head
dim that is not a multiple of 8 is padded with zero columns here (never on the served models' shapes), so every row is a
16-byte copy.  A v head dim ``Dv`` below q's and k's ``D`` (MLA: 96 for q
and k, 64 for v) is padded with zero columns to ``D`` on the card, and the
output sliced back: zero columns of v give zero columns of the output, and
the scale 1/sqrt(D) is q's either way, so the padding is exact; the kernel
keeps one head dim for its tiles.  ``flash_attention.launches`` counts
kernel launches.

Gradients: when q, k or v requires grad (and grad mode is on), the call
goes through :class:`_FlashAttentionFn`.  Its forward is the same launch,
which then also writes each row's log-sum-exp; its backward is
:func:`flash_attention_bwd`, the hand-written kernel in
``csrc/flash_attention_bwd.cu`` on the card (a prologue, then a dK/dV
pass and a dQ pass in bf16, one pass in fp32; counted once in
``flash_attention_bwd.launches``), whose counters and fp32 sums are sized
by :mod:`.plan`, and :func:`~.ref.attention_bwd_ref` on the CPU.  Training
never passes a ``q_offset``; the backward raises for one.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ...device import PLAIN_DEVICES
from .. import _build
from . import plan
from .ref import attention_bwd_ref, attention_lse_ref, attention_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
#: the most shared memory a block may use on an H100 (227 KB)
MAX_SMEM = 232448


def fp32_geometry(D: int) -> Tuple[int, int, int]:
    """(query rows a block, keys a tile, shared memory bytes) of the fp32
    forward kernel for head dim ``D``, as ``csrc/flash_attention.cu`` lays
    it out: the kernel is compiled for D up to 64, 128 or 256, with query
    tiles of 64, 64 and 32 rows and key tiles of 64, 32 and 32 keys; rows
    of Q, K and V padded to that width + 4 floats, P's to the key tile +
    16; 128 bytes of barriers, Q, two stages of K and V, then P."""
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} outside [1, {MAX_HEAD_DIM}]")
    width = 64 if D <= 64 else (128 if D <= 128 else 256)
    bq = 32 if width > 128 else 64
    bk = 32 if width > 64 else 64
    ld = width + 4
    return bq, bk, 128 + 4 * (bq * ld + 2 * 2 * bk * ld + bq * (bk + 16))


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library, its C functions typed (pointers and the
    stream as ``c_void_p``, so ctypes never cuts them to 32 bits)."""
    lib = _build.load("flash_attention")
    lib.flash_attention_launch.argtypes = ([ctypes.c_void_p] * 5
                                           + [ctypes.c_int] * 12
                                           + [ctypes.c_void_p])
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.flash_attention_smem_bytes.restype = ctypes.c_longlong
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    """The backward kernel's library, typed as :func:`_library`."""
    lib = _build.load("flash_attention_bwd")
    lib.flash_attention_bwd_launch.argtypes = ([ctypes.c_void_p] * 12
                                               + [ctypes.c_longlong] * 2
                                               + [ctypes.c_int] * 11
                                               + [ctypes.c_void_p])
    lib.flash_attention_bwd_launch.restype = ctypes.c_int
    lib.flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _heads(t: torch.Tensor) -> torch.Tensor:
    """(B, H, S, D) -> (B * H, S, D)."""
    return t.reshape(-1, *t.shape[2:])


def _plain(q, k, v, causal, window, q_offset) -> torch.Tensor:
    B, Hq, Sq, D = q.shape
    Dv = v.shape[3]
    k = k.repeat_interleave(Hq // k.shape[1], dim=1)
    v = v.repeat_interleave(Hq // v.shape[1], dim=1)
    out = attention_ref(_heads(q), _heads(k), _heads(v), causal=causal,
                        window=window, q_offset=q_offset)
    return out.reshape(B, Hq, Sq, Dv).to(q.dtype)


def _plain_lse(q, k, causal, window, q_offset) -> torch.Tensor:
    B, Hq, Sq, _ = q.shape
    k = k.repeat_interleave(Hq // k.shape[1], dim=1)
    return attention_lse_ref(_heads(q), _heads(k), causal=causal,
                             window=window,
                             q_offset=q_offset).reshape(B, Hq, Sq)


def _plain_bwd(q, k, v, o, lse, do, causal, window):
    """:func:`~.ref.attention_bwd_ref` over (B, H, S, D) with GQA: K and V
    repeated over the group, their gradients summed back over it."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = Hq // Hkv
    dq, dk, dv = attention_bwd_ref(
        _heads(q), _heads(k.repeat_interleave(G, dim=1)),
        _heads(v.repeat_interleave(G, dim=1)), _heads(o),
        lse.reshape(B * Hq, Sq), _heads(do), causal=causal, window=window)
    dk = dk.reshape(B, Hkv, G, Sk, D).sum(2)
    dv = dv.reshape(B, Hkv, G, Sk, Dv).sum(2)
    return (dq.reshape(B, Hq, Sq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _check_operands(q, k, v) -> None:
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16 "
                        f"q/k/v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (k.device == v.device == q.device):
        raise ValueError("q, k and v must lie on one device")
    if q.shape[3] > MAX_HEAD_DIM:
        raise ValueError(f"head dim {q.shape[3]} > {MAX_HEAD_DIM}")


def _row_len(D: int, dtype: torch.dtype) -> int:
    """The kernels' row length for head dim D: D, or for bf16 D rounded up
    to 8 (16-byte rows)."""
    return D + (-D) % 8 if dtype == torch.bfloat16 else D


def _padded(ts, ld: int):
    """Each tensor zero-padded to ``ld`` columns (v, o and do from a
    narrower head dim too), contiguous and, for bf16, 16-byte aligned."""
    out = tuple((F.pad(t, (0, ld - t.shape[3])) if t.shape[3] != ld else t
                 ).contiguous() for t in ts)
    if out[0].dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in out):
        raise ValueError("the bf16 flash_attention kernels need 16-byte "
                         "aligned operands")
    return out


def _launch(q, k, v, causal, window, q_offset, with_lse: bool = False):
    """Run the forward kernel; returns (out (B, Hq, Sq, Dv), lse
    (B, Hq, Sq) fp32 or None)."""
    _check_operands(q, k, v)
    B, Hq, Sq, D = q.shape
    Hkv, Sk, Dv = k.shape[1], k.shape[2], v.shape[3]
    ld = _row_len(D, q.dtype)
    q, k, v = _padded((q, k, v), ld)
    out = torch.empty_like(q)
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), B, Hq,
            Hkv, Sq, Sk, D, ld, int(causal), int(window is not None),
            0 if window is None else int(window), int(q_offset),
            _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError("flash_attention kernel launch failed: "
                           + lib.flash_attention_error_string(err).decode())
    flash_attention.launches += 1
    return (out[..., :Dv] if ld != Dv else out), lse


def _launch_bwd(q, k, v, o, lse, do, causal, window):
    _check_operands(q, k, v)
    B, Hq, Sq, D = q.shape
    Hkv, Sk, Dv = k.shape[1], k.shape[2], v.shape[3]
    ld = _row_len(D, q.dtype)
    q, k, v, o, do = _padded((q, k, v, o, do.to(q.dtype)), ld)
    lse = lse.to(torch.float32).contiguous()
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    n_counters, n_scratch = plan.workspace(B, Hq, Hkv, Sq, Sk, D, ld,
                                           q.dtype == torch.bfloat16)
    counters = torch.empty(n_counters, dtype=torch.int32, device=q.device)
    scratch = torch.empty(max(n_scratch, 1), dtype=torch.float32,
                          device=q.device)
    lib = _bwd_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), counters.data_ptr(),
            scratch.data_ptr(), n_counters, n_scratch, B, Hq, Hkv, Sq, Sk,
            D, ld, int(causal), int(window is not None),
            0 if window is None else int(window), _DTYPE_CODES[q.dtype],
            stream)
    if err != 0:
        raise RuntimeError(
            "flash_attention_bwd kernel launch failed: "
            + lib.flash_attention_bwd_error_string(err).decode())
    flash_attention_bwd.launches += 1
    return dq[..., :D], dk[..., :D], dv[..., :Dv]


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None):
    """The gradient of :func:`flash_attention` (``q_offset`` 0) from its
    inputs, its output ``o`` (B, Hq, Sq, Dv), its log-sum-exp ``lse``
    (B, Hq, Sq) and the upstream gradient ``do``: returns (dq, dk, dv) in
    the shapes and dtypes of q, k and v.  A CPU tensor takes the plain
    version; a CUDA tensor launches the backward kernel."""
    if q.device.type in PLAIN_DEVICES:
        return _plain_bwd(q, k, v, o, lse, do, causal, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on CUDA or CPU tensors, "
                         f"got {q.device}")
    return _launch_bwd(q, k, v, o, lse, do, causal, window)


class _FlashAttentionFn(torch.autograd.Function):
    """flash_attention with a gradient: the forward saves its inputs, its
    output and each row's log-sum-exp; the backward is
    :func:`flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        if q.device.type in PLAIN_DEVICES:
            out = _plain(q, k, v, causal, window, q_offset)
            lse = _plain_lse(q, k, causal, window, q_offset)
        else:
            out, lse = _launch(q, k, v, causal, window, q_offset,
                               with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.attrs = (causal, window, q_offset)
        return out

    @staticmethod
    def backward(ctx, do):
        causal, window, q_offset = ctx.attrs
        if q_offset:
            raise NotImplementedError(
                "flash_attention's backward takes q_offset = 0 only "
                "(training never passes one)")
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do,
                                         causal=causal, window=window)
        return dq, dk, dv, None, None, None


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
    if q.device.type not in ("cuda", *PLAIN_DEVICES):
        raise ValueError(f"flash_attention runs on CUDA, CPU or meta "
                         f"tensors, got {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttentionFn.apply(q, k, v, causal, window, q_offset)
    if q.device.type in PLAIN_DEVICES:
        return _plain(q, k, v, causal, window, q_offset)
    return _launch(q, k, v, causal, window, q_offset)[0]


#: kernel launches since the count was last set to 0
flash_attention.launches = 0
#: backward launches (one a call: its prologue and passes) since last set
#: to 0
flash_attention_bwd.launches = 0
