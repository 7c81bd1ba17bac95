"""Public wrapper of the CUDA queue matmul: policy plumbing and launch.

Queue geometry follows the JAX package's wrapper rule for rule: when the
depth / ``policy`` / ``unroll`` knobs are left unset they resolve once from
the port's :class:`~repro_torch.core.policy.PolicyTable` (the
``queue_matmul`` workload); explicit arguments always win, and any explicit
depth with ``policy`` unset runs the depth-honouring COPIFTv2 path.  The
activation (x) ring takes the I2F depth and the weight (w) ring the F2I
depth, each falling back to the symmetric ``queue_depth``.

Where it runs: a CPU tensor goes to the plain version (:func:`matmul_ref`),
and so does a meta tensor (shapes only; ``FlopCounterMode`` counts its
product); a CUDA tensor launches the kernel in ``csrc/queue_matmul.cu`` on the current
stream, except under ``ExecutionPolicy.BASELINE``, which is the plain matmul
on any device (as in the JAX wrapper) and launches nothing.  COPIFT forces
both rings to depth 1.  ``queue_matmul.launches`` counts kernel launches.

Two regimes, chosen here by M (not a fallback: each is the kernel for its
M, and each keeps the whole contract).  A bf16 product with M <= 16
(``THIN_MAX_M``; decode over the slots) takes the thin kernel, bound by the
bytes of w: 64-column tiles 128 deep copied with ``cp.async``, K split into
:func:`split_k` parts, a function of (K, N) alone, summed in rank order
inside a thread-block cluster.  A product run row by row (``slab`` given:
the decode body and a chunk's batched body) takes the thin kernel at any M,
a block taking up to four 16-row tiles (:func:`thin_tiles`) so that each
w stage it loads serves all of them.  A bf16 product with M > 16 (``forward``)
takes the wide kernel, bound by operations: a producer warp issues TMA
copies into the two rings and two ``wgmma`` warpgroups consume them, in
128 x 256 tiles, with K split the same way where the tiles alone would
leave SMs idle; its parts meet in an fp32 workspace allocated here.  fp32
takes the FMA kernel at any M: register-tiled, 128 x 128 tiles (128 x 64
or 64 x 64 where those would leave SMs idle, 16 x 64 at M <= 16), each
element's sum in one fixed order whatever the tile, M or depths.
Within a regime every depth pair gives the same bits, and a row's result
does not depend on the other rows nor on its place among them; a bf16
row's bits do depend on the regime.

``slab``: the product row by row, every row with the bits that a call over
its slab of ``slab`` consecutive rows alone gives (a chunk's B x C rows, C
slabs of B, get the decode body's bits).  On the card that is one launch:
bf16 on the thin kernel whatever M, fp32 on the FMA block, whose row bits
depend on neither M nor the row's place; the plain version (and BASELINE)
makes one product a slab, since a library product's row bits may depend on
M (the CPU's one-row product does).

The contract, in both regimes: ``depth_x`` and ``depth_w`` are real stage
counts in [1, 16]; a pair whose rings need more than 227 KB of shared
memory (``MAX_SMEM`` = 232448 bytes, :func:`smem_bytes`) raises
``ValueError`` naming the bytes it needed, before anything launches.
Every pair up to (8, 8) fits in every kernel; (16, 16) fits none but the
fp32 kernel at M <= 16.

Gradients: when x or w requires grad (and grad mode is on), the product
goes through :class:`_QueueMatmulFn`, whose forward is the same launch (the
same bits) and whose backward is two more products through the same path,
at the same depths and policy: dX = dY @ W^T and dW = X^T @ dY, the
transposes copied contiguous.  dW's rows are the forward's K, so in bf16
it always takes the wide kernel; dX's rows are the forward's M.

``block`` and ``unroll`` are the Pallas kernel's tile and K-loop unroll.
The CUDA kernels' tiles are compiled in and their K loops are unrolled at
compile time, so on the card neither changes what runs; both are kept so
that the precedence rules and the callers stay the same as the
reference's.
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
from .ref import matmul_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_DEPTH = 16
#: the most shared memory a block may use on an H100 (227 KB)
MAX_SMEM = 232448
#: bf16 products with at most this many rows take the thin kernel
THIN_MAX_M = 16
#: the most 16-row tiles a block of the thin kernel takes
MAX_TILES = 4
#: the thin kernel's column tile and stage depth; the wide kernel's column
#: tile and the K unit its parts are made of (its stages are 64 deep when
#: both rings fit at that depth, else 32); the largest K split (a portable
#: cluster)
_THIN_BN, _THIN_BK, _WIDE_BN, _WIDE_UNIT = 64, 128, 256, 64
_MAX_SPLIT = 8


def regime(m: int, dtype: torch.dtype, rowwise: bool = False) -> str:
    """Which kernel a product of ``m`` rows runs on the card: "fp32",
    "thin" (bf16, m <= ``THIN_MAX_M`` or run row by row) or "wide"
    (bf16)."""
    if dtype == torch.float32:
        return "fp32"
    return "thin" if m <= THIN_MAX_M or rowwise else "wide"


@functools.lru_cache(maxsize=None)
def split_k(k: int, n: int, wide: bool = False) -> int:
    """The number of K parts of a bf16 product with a (K, N) weight, summed
    in a fixed order.  Doubled from 1 while the parts fit one cluster (8),
    the column tiles times the parts stay under a target, and every part
    keeps a minimum depth.  Thin kernel: 160 blocks (two fit an SM at the
    default depths), parts of at least four 128-deep stages.  Wide kernel:
    20 tiles (80 blocks of 128 x 256 at M = 512), parts of at least 16
    64-deep units, since its parts meet through a workspace whose traffic
    grows with the split.  The targets were picked by timing the served
    shapes on an H100 at several splits.  A function of (K, N) only, so
    a row's sum order, and its bits, never depend on M, the depths or the
    card."""
    bn, bk, target, least = ((_WIDE_BN, _WIDE_UNIT, 20, 16) if wide
                             else (_THIN_BN, _THIN_BK, 160, 4))
    n_tiles, nk = -(-n // bn), -(-k // bk)
    s = 1
    while (s < _MAX_SPLIT and n_tiles * s < target
           and nk >= 2 * least * s):
        s *= 2
    return s


def _wide_smem(depth_x: int, depth_w: int, bk: int) -> int:
    # 1 KB to align the swizzled stages, x 128 x bk and w bk x 256 a stage,
    # full and empty barriers
    return (1024 + 2 * bk * (128 * depth_x + _WIDE_BN * depth_w)
            + 16 * (depth_x + depth_w))


def thin_smem_bytes(depth_x: int, depth_w: int, tiles: int) -> int:
    """Shared memory of the thin block (``kernels/_csrc/thin_gemm.cuh``,
    shared with ``moe_gemm``) at these depths and 16-row tiles a block:
    barriers in 128-byte lines; x 16 rows a tile and w 64 columns, 128
    deep a stage; the fp32 partials of 4 warps (one tile at a time) and of
    the block's tiles reuse the rings."""
    barriers = -(-(depth_x + depth_w) * 8 // 128) * 128
    return barriers + max(2 * (depth_x * tiles * 16 * _THIN_BK
                               + depth_w * _THIN_BK * _THIN_BN),
                          4 * (4 + tiles) * 16 * _THIN_BN)


def thin_tiles(m: int, depth_x: int, depth_w: int) -> int:
    """The 16-row tiles a block of the thin kernel takes for ``m`` rows:
    all of them up to ``MAX_TILES`` (a power of two), fewer where the rings
    at these depths would not fit; 0 where not one tile's do.  The bits do
    not depend on it."""
    need, g = -(-m // 16), 1
    while g < need and g < MAX_TILES:
        g *= 2
    while g > 1 and thin_smem_bytes(depth_x, depth_w, g) > MAX_SMEM:
        g //= 2
    return g if thin_smem_bytes(depth_x, depth_w, g) <= MAX_SMEM else 0


def smem_bytes(m: int, depth_x: int, depth_w: int, dtype: torch.dtype,
               rowwise: bool = False) -> int:
    """Shared memory one block of the kernel for ``m`` rows needs at these
    depths, as ``csrc/queue_matmul.cu`` lays it out.  The wide kernel's
    stages are 64 deep where both rings fit at that depth, else 32; every
    k16 step is the same either way, so the bits are too."""
    barriers = -(-(depth_x + depth_w) * 8 // 128) * 128
    kind = regime(m, dtype, rowwise)
    if kind == "fp32":
        bm = 16 if m <= 16 else 64
        return barriers + 4 * (depth_x * bm * 32 + depth_w * 32 * 64)
    if kind == "thin":
        return thin_smem_bytes(depth_x, depth_w,
                          max(1, thin_tiles(m, depth_x, depth_w)))
    deep = _wide_smem(depth_x, depth_w, 64)
    return deep if deep <= MAX_SMEM else _wide_smem(depth_x, depth_w, 32)


@functools.lru_cache(maxsize=None)
def _plan(m_thin: bool, k: int, n: int, depth_x: int, depth_w: int,
          dtype: torch.dtype) -> int:
    """Check a launch's depths against the contract; returns the K split
    it passes to the kernel (1 for fp32)."""
    if not (1 <= depth_x <= _MAX_DEPTH and 1 <= depth_w <= _MAX_DEPTH):
        raise ValueError(f"ring depths must lie in [1, {_MAX_DEPTH}], got "
                         f"({depth_x}, {depth_w})")
    m = 1 if m_thin else THIN_MAX_M + 1
    need = smem_bytes(m, depth_x, depth_w, dtype)
    if need > MAX_SMEM:
        raise ValueError(
            f"queue_matmul rings of depths ({depth_x}, {depth_w}) need "
            f"{need} bytes of shared memory in the {regime(m, dtype)} "
            f"kernel ({'M <= 16' if m_thin else 'M > 16'}), above the "
            f"{MAX_SMEM} a block may use")
    kind = regime(m, dtype)
    return 1 if kind == "fp32" else split_k(k, n, wide=kind == "wide")


def operating_point() -> OperatingPoint:
    """The operating point ``queue_matmul`` runs at when called without
    explicit ``depth``/``policy``/``unroll``."""
    return default_table().resolve("queue_matmul")


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library, its C functions typed (pointers and the
    stream as ``c_void_p``, so ctypes never cuts them to 32 bits)."""
    lib = _build.load("queue_matmul")
    lib.queue_matmul_launch.argtypes = ([ctypes.c_void_p] * 4
                                        + [ctypes.c_int] * 8
                                        + [ctypes.c_void_p])
    lib.queue_matmul_launch.restype = ctypes.c_int
    lib.queue_matmul_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.queue_matmul_smem_bytes.restype = ctypes.c_longlong
    lib.queue_matmul_thin_tiles.argtypes = [ctypes.c_int] * 3
    lib.queue_matmul_thin_tiles.restype = ctypes.c_int
    lib.queue_matmul_error_string.argtypes = [ctypes.c_int]
    lib.queue_matmul_error_string.restype = ctypes.c_char_p
    return lib


def _pad_cols(a: torch.Tensor, mult: int) -> torch.Tensor:
    pad = (-a.shape[1]) % mult
    return F.pad(a, (0, pad)) if pad else a


def _launch(x: torch.Tensor, w: torch.Tensor, depth_x: int, depth_w: int,
            rowwise: bool = False) -> torch.Tensor:
    """Run the CUDA kernel (bf16 on the thin kernel at any M when
    ``rowwise``).  K and N are padded with zeros to 16 bytes' worth of
    elements when they are not already (never on the serve path's shapes),
    so every tile row is one aligned 16-byte copy."""
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"queue_matmul kernel takes float32 or bfloat16 "
                        f"operands of one dtype, got {x.dtype} and {w.dtype}")
    if w.device != x.device:
        raise ValueError(f"operands on {x.device} and {w.device}")
    m, n = x.shape[0], w.shape[1]
    vec = 16 // x.element_size()
    xp = _pad_cols(x, vec).contiguous()
    wp = _pad_cols(w, vec)
    if wp.shape[0] != xp.shape[1]:
        wp = F.pad(wp, (0, 0, 0, xp.shape[1] - wp.shape[0]))
    wp = wp.contiguous()
    k, n_pad = xp.shape[1], wp.shape[1]
    thin = m <= THIN_MAX_M or rowwise
    split = _plan(thin, k, n_pad, depth_x, depth_w, x.dtype)
    px, pw = xp.data_ptr(), wp.data_ptr()
    if px % 16 or pw % 16:
        raise ValueError("queue_matmul kernel needs 16-byte aligned "
                         "operands")
    out = torch.empty((m, n_pad), dtype=x.dtype, device=x.device)
    # the wide kernel's K parts meet in an fp32 workspace (never in decode)
    work = (torch.empty((split, m, n_pad), dtype=torch.float32,
                        device=x.device)
            if split > 1 and not thin else None)
    lib = _library()
    args = (px, pw, out.data_ptr(), None if work is None else work.data_ptr(),
            m, n_pad, k, depth_x, depth_w, _DTYPE_CODES[x.dtype], split,
            int(rowwise))
    # the launch goes to the current device: switch only when x is not on it
    if x.device.index == torch.cuda.current_device():
        err = lib.queue_matmul_launch(
            *args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(x.device):
            err = lib.queue_matmul_launch(
                *args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("queue_matmul kernel launch failed: "
                           + lib.queue_matmul_error_string(err).decode())
    queue_matmul.launches += 1
    return out[:, :n] if n_pad != n else out


def _product(x: torch.Tensor, w: torch.Tensor, depth_x: int, depth_w: int,
             policy: ExecutionPolicy,
             slab: Optional[int] = None) -> torch.Tensor:
    if policy is ExecutionPolicy.BASELINE or x.device.type in PLAIN_DEVICES:
        if slab is None or slab >= x.shape[0]:
            return matmul_ref(x, w).to(x.dtype)
        return torch.cat([matmul_ref(x[i:i + slab], w).to(x.dtype)
                          for i in range(0, x.shape[0], slab)])
    if policy is ExecutionPolicy.COPIFT:
        depth_x = depth_w = 1
    return _launch(x, w, depth_x, depth_w, rowwise=slab is not None)


class _QueueMatmulFn(torch.autograd.Function):
    """x @ w with a gradient: both products of the backward run through
    :func:`_product` at the forward's depths and policy."""

    @staticmethod
    def forward(ctx, x, w, depth_x, depth_w, policy):
        ctx.save_for_backward(x, w)
        ctx.knobs = (depth_x, depth_w, policy)
        return _product(x, w, depth_x, depth_w, policy)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.to(x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _product(dy, w.t().contiguous(), *ctx.knobs)
        if ctx.needs_input_grad[1]:
            dw = _product(x.t().contiguous(), dy, *ctx.knobs)
        return dx, dw, None, None, None


def _queue_matmul(x: torch.Tensor, w: torch.Tensor, *,
                  block: Tuple[int, int, int], depth_x: int, depth_w: int,
                  unroll: int, policy: ExecutionPolicy,
                  slab: Optional[int] = None) -> torch.Tensor:
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"queue_matmul takes x (M, K) and w (K, N), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.device.type not in ("cuda", *PLAIN_DEVICES):
        raise ValueError(f"queue_matmul runs on CUDA, CPU or meta tensors, "
                         f"got {x.device}")
    if slab is not None and slab < 1:
        raise ValueError(f"slab must be >= 1, got {slab}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _QueueMatmulFn.apply(x, w, depth_x, depth_w, policy)
    return _product(x, w, depth_x, depth_w, policy, slab)


def queue_matmul(x: torch.Tensor, w: torch.Tensor, *,
                 block: Tuple[int, int, int] = (128, 128, 128),
                 depth: Optional[int] = None,
                 depth_x: Optional[int] = None,
                 depth_w: Optional[int] = None,
                 unroll: Optional[int] = None,
                 policy: Optional[ExecutionPolicy] = None,
                 slab: Optional[int] = None) -> torch.Tensor:
    """y = x @ w through the queue-pipelined kernel; returns ``x.dtype``.

    ``policy`` overrides the depths: BASELINE is the plain matmul, COPIFT
    forces both rings to depth 1, COPIFTV2 keeps the requested depths.
    Unset knobs come from the policy table (the x ring from the I2F depth,
    the w ring from the F2I depth, each defaulting to ``queue_depth``).
    ``depth`` pins both rings, ``depth_x``/``depth_w`` one each; any
    explicit depth with ``policy`` unset runs COPIFTV2, never a table
    policy that would discard it.  ``slab`` runs the product row by row
    (see the module's docstring); a product with a gradient ignores it.
    """
    if depth is not None:
        depth_x = depth if depth_x is None else depth_x
        depth_w = depth if depth_w is None else depth_w
    if depth_x is None or depth_w is None or unroll is None or policy is None:
        if policy is None and (depth_x is not None or depth_w is not None):
            policy = ExecutionPolicy.COPIFTV2
        pt = operating_point()
        if policy is None:
            policy = pt.policy
        cal_x, cal_w = pt.effective_depths()
        if depth_x is None:
            depth_x = cal_x
        if depth_w is None:
            depth_w = cal_w
        if unroll is None:
            unroll = pt.unroll
    return _queue_matmul(x, w, block=block, depth_x=depth_x, depth_w=depth_w,
                         unroll=unroll, policy=policy, slab=slab)


#: kernel launches since the count was last set to 0
queue_matmul.launches = 0
