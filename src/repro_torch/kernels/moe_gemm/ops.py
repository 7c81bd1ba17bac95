"""Public wrapper of the CUDA expert GEMM: ``y[e] = x[e] @ w[e]`` in fp32.

The signature is the JAX wrapper's, ``moe_gemm(x, w, *, bc, bf, bk,
depth=2)``, plus the port's ``policy``, ``active`` and ``slab``.
``bc``/``bf``/``bk`` are the Pallas kernel's tiles; the CUDA kernels' tiles
are compiled in, so on the card they change nothing, and they are kept so
that callers stay the same as the reference's.

``active`` is an optional ``(E,)`` bool or int8 tensor on x's device: an
expert whose entry is 0 gets an output block of exact zeros and its weights
are never read; ``None`` means every expert (the Pallas kernel's own
semantics).  The kernel reads the mask itself, so nothing is copied to the
host and the caller stays free of synchronisation.

Where it runs: a CPU tensor goes to the plain version (:func:`moe_gemm_ref`),
which autograd differentiates, and so does a meta tensor (shapes only;
``FlopCounterMode`` counts its products); a CUDA tensor launches a kernel of
``csrc/moe_gemm.cu`` on the current stream, except under
``ExecutionPolicy.BASELINE``, which is the plain version on any device and
launches nothing.  COPIFT forces the ring to depth 1.
``moe_gemm.launches`` counts kernel launches, the backward's included.

Gradients: on the card, when x or w requires grad (and grad mode is on),
the product goes through :class:`_MoeGemmFn`, whose forward is the same
launch (the same bits) and whose backward, :func:`moe_gemm_bwd`, is two
more grouped products through the same kernels at the same depth and
mask: ``dX[e] = dY[e] W[e]^T`` and ``dW[e] = X[e]^T dY[e]``, the
transposes copied contiguous.  For a shared x (the dense dispatch) dW is
one launch with Xᵀ (d, C) seen by every expert, and dX is the (E, C, d)
per-expert products summed over the experts in a fixed order (no
atomics).  An expert outside ``active`` gets a dW block of exact zeros
and adds nothing to dX, and its weights are not read by the kernels (the
Wᵀ copy reads every expert).  dX's rows are the forward's C and dW's rows
its d, so at training shapes (1024 tokens, or the grouped dispatch's
capacity, and d of 1024 or more) bf16 takes the wide kernel for both.
``moe_gemm_bwd.launches`` counts backward calls (two launches each, one
when only one operand needs a gradient).  Its plain version is
:func:`moe_gemm_bwd_ref`.

Three kernels, chosen here by C and the dtype (:func:`regime`; each is the
kernel for its shapes, not a fallback).  bf16 with C <= 16 (``THIN_MAX_C``,
decode over the slots) takes the thin kernel, bound by the active experts'
weight bytes: queue_matmul's thin block with K split into :func:`split_k`
parts, a function of (E, K, N) alone, summed in rank order in a cluster.
A product run row by row (``slab`` given: the decode body and a chunk's
batched body) takes the thin kernel at any C, a block taking up to four of
an expert's 16-row tiles (:func:`thin_tiles`), so each w stage it loads
serves all of them.  Other bf16 products with C > 16 take the wide
kernel, a grouped GEMM on TMA and ``wgmma`` in 128 x 256 tiles, bound by
operations.  fp32 takes queue_matmul's register-tiled FMA block at any C
(128 x 128 tiles, smaller where those would leave SMs idle, 16 x 64 at
C <= 16), each element's sum in one fixed order whatever the tile.
Within a kernel every depth gives the same bits and a row's result does
not depend on the other rows or on the mask; a bf16 row's bits do depend
on the regime.

``slab``: the product row by row, every row with the bits that a call over
its slab of ``slab`` consecutive rows (of C) alone gives, as
``queue_matmul``'s ``slab``: a chunk's C x B rows, C slabs of B, get the
decode body's bits.  On the card that is one launch, bf16 on the thin
kernel whatever C (``rowwise``), fp32 on the FMA block, whose row bits
depend on neither C nor the row's place; the plain version (and BASELINE)
makes one product a slab, since a library product's row bits may depend on
its row count.  A product with a gradient (training) ignores it.

The depth contract: ``depth`` is a real stage count in [1, 16] for both
operand rings; a depth whose rings need more than 227 KB of shared memory
(``MAX_SMEM``, :func:`smem_bytes`) raises ``ValueError`` naming the bytes
it needed, before anything launches.

``x`` may be one (C, d) matrix seen by every expert (the dense dispatch),
given as it is or as a broadcast view whose expert stride is 0
(``x2d.expand(E, C, d)``): the kernels then read the one matrix for every
expert and nothing is copied E times.  Only what the kernels need is
padded: d and f up to 16 bytes' worth of elements (never on the model
path's shapes); ragged C and f tiles are masked inside the kernels.

:func:`operating_point` is the policy table's ``moe_gemm`` point, whose
depth the model path passes (:mod:`repro_torch.models.moe`).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ...core.policy import ExecutionPolicy, OperatingPoint, default_table
from ...device import PLAIN_DEVICES
from .. import _build
from ..queue_matmul.ops import thin_smem_bytes
from ..queue_matmul.ops import thin_tiles as _thin_tiles
from .ref import moe_gemm_bwd_ref, moe_gemm_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MASK_DTYPES = (torch.bool, torch.int8, torch.uint8)
_MAX_DEPTH = 16
#: the most shared memory a block may use on an H100 (227 KB)
MAX_SMEM = 232448
#: bf16 products with at most this many rows an expert take the thin kernel
THIN_MAX_C = 16
#: the thin kernel's column tile and stage depth; the most K parts (a
#: portable cluster)
_THIN_BN, _THIN_BK, _MAX_SPLIT = 64, 128, 8


def regime(c: int, dtype: torch.dtype, rowwise: bool = False) -> str:
    """Which kernel ``c`` rows an expert run on the card: "fp32", "thin"
    (bf16, c <= ``THIN_MAX_C`` or run row by row) or "wide" (bf16)."""
    if dtype == torch.float32:
        return "fp32"
    return "thin" if c <= THIN_MAX_C or rowwise else "wide"


@functools.lru_cache(maxsize=None)
def split_k(e: int, k: int, n: int) -> int:
    """The thin kernel's number of K parts for E experts of (K, N), summed
    in rank order: doubled from 1 while the parts fit one cluster (8), the
    blocks (E x column tiles x parts) stay under 160 and every part keeps
    at least four 128-deep stages, as queue_matmul's thin rule.  A function
    of (E, K, N) only, never of C, the depth or the mask, so a row's bits
    depend on none of them (olmoe's 64 experts give 1)."""
    blocks, nk = e * -(-n // _THIN_BN), -(-k // _THIN_BK)
    s = 1
    while s < _MAX_SPLIT and blocks * s < 160 and nk >= 8 * s:
        s *= 2
    return s


def _wide_smem(depth: int, bk: int) -> int:
    # 1 KB to align the swizzled stages, x 128 x bk and w bk x 256 a stage,
    # full and empty barriers
    return 1024 + 2 * bk * (128 + 256) * depth + 32 * depth


def thin_tiles(c: int, depth: int) -> int:
    """The 16-row tiles a block of the thin kernel takes for ``c`` rows an
    expert at ring depth ``depth``: queue_matmul's rule for its block
    (``queue_matmul.ops.thin_tiles``), both rings at that depth."""
    return _thin_tiles(c, depth, depth)


def smem_bytes(c: int, depth: int, dtype: torch.dtype,
               rowwise: bool = False) -> int:
    """Shared memory one block of the kernel for ``c`` rows an expert needs
    at this depth, as ``csrc/moe_gemm.cu`` lays it out (the thin kernel's
    at the tiles a block takes, :func:`thin_tiles`).  The wide kernel's
    stages are 64 deep where the rings fit at that depth, else 32; every
    k16 step is the same either way, so the bits are too."""
    kind = regime(c, dtype, rowwise)
    if kind == "fp32":
        bm = 16 if c <= 16 else 64
        return -(-depth * 8 // 128) * 128 + 4 * depth * (bm * 32 + 32 * 64)
    if kind == "thin":
        return thin_smem_bytes(depth, depth, max(1, thin_tiles(c, depth)))
    deep = _wide_smem(depth, 64)
    return deep if deep <= MAX_SMEM else _wide_smem(depth, 32)


@functools.lru_cache(maxsize=None)
def _plan(c_thin: bool, e: int, k: int, n: int, depth: int,
          dtype: torch.dtype, tiles: int = 1) -> int:
    """Check a launch's depth against the contract: ``c_thin`` a launch of
    at most 16 rows an expert or, in bf16, one row by row, whose thin
    block takes ``tiles`` 16-row tiles (:func:`thin_tiles`; 0 where not
    one fits).  Returns the K split it passes to the kernel (1 but for the
    thin kernel)."""
    if not 1 <= depth <= _MAX_DEPTH:
        raise ValueError(f"ring depth must lie in [1, {_MAX_DEPTH}], got "
                         f"{depth}")
    c = 1 if c_thin else THIN_MAX_C + 1
    kind = regime(c, dtype)
    need = (thin_smem_bytes(depth, depth, max(tiles, 1)) if kind == "thin"
            else smem_bytes(c, depth, dtype))
    if need > MAX_SMEM:
        rows = f"{16 * max(tiles, 1)} rows a block" if c_thin else "C > 16"
        raise ValueError(
            f"moe_gemm rings of depth {depth} need {need} bytes of shared "
            f"memory in the {kind} kernel ({rows}), above the {MAX_SMEM} a "
            f"block may use")
    return split_k(e, k, n) if kind == "thin" else 1


def operating_point() -> OperatingPoint:
    """The policy table's point for the ``moe_gemm`` workload."""
    return default_table().resolve("moe_gemm")


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library, its C functions typed (pointers and the
    stream as ``c_void_p``, the expert stride as ``c_longlong``)."""
    lib = _build.load("moe_gemm")
    lib.moe_gemm_launch.argtypes = ([ctypes.c_void_p] * 4
                                    + [ctypes.c_int] * 4
                                    + [ctypes.c_longlong]
                                    + [ctypes.c_int] * 4
                                    + [ctypes.c_void_p])
    lib.moe_gemm_launch.restype = ctypes.c_int
    lib.moe_gemm_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.moe_gemm_smem_bytes.restype = ctypes.c_longlong
    lib.moe_gemm_thin_tiles.argtypes = [ctypes.c_int] * 2
    lib.moe_gemm_thin_tiles.restype = ctypes.c_int
    lib.moe_gemm_error_string.argtypes = [ctypes.c_int]
    lib.moe_gemm_error_string.restype = ctypes.c_char_p
    return lib


def _check_active(active: Optional[torch.Tensor], x: torch.Tensor,
                  e: int) -> None:
    if active is None:
        return
    if active.shape != (e,) or active.dtype not in _MASK_DTYPES:
        raise ValueError(f"active must be an ({e},) bool or int8 "
                         f"tensor, got {tuple(active.shape)} {active.dtype}")
    if active.device != x.device:
        raise ValueError(f"active on {active.device}, x on {x.device}")


def _shared(x: torch.Tensor) -> Optional[torch.Tensor]:
    """The one (C, d) matrix every expert sees, if x is one (2-D, or a
    view whose expert stride is 0), else None."""
    if x.ndim == 2:
        return x
    return x[0] if x.stride(0) == 0 else None


def _launch(x: torch.Tensor, w: torch.Tensor, depth: int,
            active: Optional[torch.Tensor],
            rowwise: bool = False) -> torch.Tensor:
    """Run the kernel for x's C (bf16 on the thin kernel at any C when
    ``rowwise``)."""
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"moe_gemm kernel takes float32 or bfloat16 operands "
                        f"of one dtype, got {x.dtype} and {w.dtype}")
    if w.device != x.device:
        raise ValueError(f"operands on {x.device} and {w.device}")
    E, d, f = w.shape
    C = x.shape[-2]
    vec = 16 // x.element_size()
    pk, pf = (-d) % vec, (-f) % vec
    rows = rowwise and x.dtype == torch.bfloat16   # the thin kernel at any C
    split = _plan(C <= THIN_MAX_C or rows, E, d + pk, f + pf, depth, x.dtype,
                  thin_tiles(C, depth) if rows else 1)
    one = _shared(x)
    if one is not None:                  # one matrix seen by every expert
        xp = (F.pad(one, (0, pk)) if pk else one).contiguous()
        x_stride = 0
    else:
        xp = (F.pad(x, (0, pk)) if pk else x).contiguous()
        x_stride = C * (d + pk)
    wp = (F.pad(w, (0, pf, 0, pk)) if pk or pf else w).contiguous()
    for t in (xp, wp):
        if t.data_ptr() % 16:
            raise ValueError("moe_gemm kernel needs 16-byte aligned operands")
    mask = None if active is None else active.contiguous().data_ptr()
    out = torch.empty((E, C, f + pf), dtype=torch.float32, device=x.device)
    lib = _library()
    args = (xp.data_ptr(), wp.data_ptr(), out.data_ptr(), mask, E, C, f + pf,
            d + pk, x_stride, depth, _DTYPE_CODES[x.dtype], split,
            int(rowwise))
    # the launch goes to the current device: switch only when x is not on it
    if x.device.index == torch.cuda.current_device():
        err = lib.moe_gemm_launch(*args,
                                  torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(x.device):
            err = lib.moe_gemm_launch(
                *args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("moe_gemm kernel launch failed: "
                           + lib.moe_gemm_error_string(err).decode())
    moe_gemm.launches += 1
    return out[..., :f] if pf else out


def _launch_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                depth: int, active: Optional[torch.Tensor],
                need: Tuple[bool, bool]):
    g = dy.to(x.dtype)
    one = _shared(x)
    dx = dw = None
    if need[0]:
        dx = _launch(g, w.transpose(1, 2).contiguous(), depth, active)
        if x.ndim == 2:              # every expert's share, in expert order
            dx = dx.sum(0)
    if need[1]:
        xt = (one.t() if one is not None else x.transpose(1, 2)).contiguous()
        dw = _launch(xt, g, depth, active)
    moe_gemm_bwd.launches += 1
    return dx, dw


def moe_gemm_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, *,
                 depth: int = 2, active: Optional[torch.Tensor] = None,
                 need: Tuple[bool, bool] = (True, True)):
    """The gradient of :func:`moe_gemm` from its operands and the gradient
    ``dy`` (E, C, f) on its output: returns (dx, dw) in fp32, dx of x's
    shape (a 2-D x gets the sum over the experts), ``None`` for an operand
    whose ``need`` is false.  A CPU tensor takes the plain version; a CUDA
    tensor launches the two products at ring depth ``depth``."""
    if x.device.type in PLAIN_DEVICES:
        dx, dw = moe_gemm_bwd_ref(x, w, dy, active)
        return dx if need[0] else None, dw if need[1] else None
    if x.device.type != "cuda":
        raise ValueError(f"moe_gemm_bwd runs on CUDA or CPU tensors, got "
                         f"{x.device}")
    return _launch_bwd(x, w, dy, depth, active, need)


class _MoeGemmFn(torch.autograd.Function):
    """moe_gemm with a gradient: the backward is :func:`moe_gemm_bwd` at the
    forward's depth and mask."""

    @staticmethod
    def forward(ctx, x, w, depth, active):
        ctx.save_for_backward(x, w, active)
        ctx.depth = depth
        if x.device.type == "cpu":
            return moe_gemm_ref(x, w, active)
        return _launch(x, w, depth, active)

    @staticmethod
    def backward(ctx, dy):
        x, w, active = ctx.saved_tensors
        dx, dw = moe_gemm_bwd(x, w, dy, depth=ctx.depth, active=active,
                              need=tuple(ctx.needs_input_grad[:2]))
        return (None if dx is None else dx.to(x.dtype),
                None if dw is None else dw.to(w.dtype), None, None)


def moe_gemm(x: torch.Tensor, w: torch.Tensor, *, bc: int = 128,
             bf: int = 128, bk: int = 128, depth: int = 2,
             policy: Optional[ExecutionPolicy] = None,
             active: Optional[torch.Tensor] = None,
             slab: Optional[int] = None) -> torch.Tensor:
    """x: (E, C, d), or (C, d) seen by every expert; w: (E, d, f) ->
    (E, C, f) fp32.

    ``policy``: BASELINE is the plain version, COPIFT forces depth 1,
    COPIFTV2 (and ``None``) keep ``depth``.  ``active``: the experts to
    compute (``None``: all); the others' blocks are zeros.  ``slab`` runs
    the product row by row (see the module's docstring)."""
    if x.ndim not in (2, 3) or w.ndim != 3 or x.shape[-1] != w.shape[1] or \
            (x.ndim == 3 and x.shape[0] != w.shape[0]):
        raise ValueError(f"moe_gemm takes x (E, C, d) or (C, d) and w "
                         f"(E, d, f), got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    _check_active(active, x, w.shape[0])
    if slab is not None and slab < 1:
        raise ValueError(f"slab must be >= 1, got {slab}")
    if policy is ExecutionPolicy.BASELINE or x.device.type in PLAIN_DEVICES:
        return moe_gemm_ref(x, w, active, slab)
    if x.device.type != "cuda":
        raise ValueError(f"moe_gemm runs on CUDA or CPU tensors, got "
                         f"{x.device}")
    if policy is ExecutionPolicy.COPIFT:
        depth = 1
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _MoeGemmFn.apply(x, w, depth, active)
    return _launch(x, w, depth, active, rowwise=slab is not None)


#: kernel launches since the count was last set to 0
moe_gemm.launches = 0
#: backward calls (their products count in ``moe_gemm.launches`` too)
#: since the count was last set to 0
moe_gemm_bwd.launches = 0
