"""Public wrapper of the CUDA queue matmul: policy plumbing and launch.

Queue geometry follows the JAX package's wrapper rule for rule: when the
depth / ``policy`` / ``unroll`` knobs are left unset they resolve once from
the port's :class:`~repro_torch.core.policy.PolicyTable` (the
``queue_matmul`` workload); explicit arguments always win, and any explicit
depth with ``policy`` unset runs the depth-honouring COPIFTv2 path.  The
activation (x) ring takes the I2F depth and the weight (w) ring the F2I
depth, each falling back to the symmetric ``queue_depth``.

Where it runs: a CPU tensor goes to the plain version (:func:`matmul_ref`);
a CUDA tensor launches the kernel in ``csrc/queue_matmul.cu`` on the current
stream, except under ``ExecutionPolicy.BASELINE``, which is the plain matmul
on any device (as in the JAX wrapper) and launches nothing.  COPIFT forces
both rings to depth 1.  ``queue_matmul.launches`` counts kernel launches.

``block`` and ``unroll`` are the Pallas kernel's tile and K-loop unroll.
The CUDA kernel's tiles are compiled in (a 16- or 64-row block by 64
columns, 32 deep) and its K loop is unrolled at compile time, so on the
card neither changes what runs; both are kept so that the precedence rules
and the callers stay the same as the reference's.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ...core.policy import ExecutionPolicy, OperatingPoint, default_table
from .. import _build
from .ref import matmul_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_DEPTH = 16


def operating_point() -> OperatingPoint:
    """The operating point ``queue_matmul`` runs at when called without
    explicit ``depth``/``policy``/``unroll``."""
    return default_table().resolve("queue_matmul")


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library, its C functions typed (pointers and the
    stream as ``c_void_p``, so ctypes never cuts them to 32 bits)."""
    lib = _build.load("queue_matmul")
    lib.queue_matmul_launch.argtypes = ([ctypes.c_void_p] * 3
                                        + [ctypes.c_int] * 6
                                        + [ctypes.c_void_p])
    lib.queue_matmul_launch.restype = ctypes.c_int
    lib.queue_matmul_error_string.argtypes = [ctypes.c_int]
    lib.queue_matmul_error_string.restype = ctypes.c_char_p
    return lib


def _pad_cols(a: torch.Tensor, mult: int) -> torch.Tensor:
    pad = (-a.shape[1]) % mult
    return F.pad(a, (0, pad)) if pad else a


def _launch(x: torch.Tensor, w: torch.Tensor, depth_x: int,
            depth_w: int) -> torch.Tensor:
    """Run the CUDA kernel.  K and N are padded with zeros to 16 bytes'
    worth of elements when they are not already (never on the serve path's
    shapes), so every tile row is one aligned 16-byte copy."""
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"queue_matmul kernel takes float32 or bfloat16 "
                        f"operands of one dtype, got {x.dtype} and {w.dtype}")
    if w.device != x.device:
        raise ValueError(f"operands on {x.device} and {w.device}")
    if not (1 <= depth_x <= _MAX_DEPTH and 1 <= depth_w <= _MAX_DEPTH):
        raise ValueError(f"ring depths must lie in [1, {_MAX_DEPTH}], got "
                         f"({depth_x}, {depth_w})")
    m, n = x.shape[0], w.shape[1]
    vec = 16 // x.element_size()
    xp = _pad_cols(x, vec).contiguous()
    wp = _pad_cols(w, vec)
    if wp.shape[0] != xp.shape[1]:
        wp = F.pad(wp, (0, 0, 0, xp.shape[1] - wp.shape[0]))
    wp = wp.contiguous()
    for t in (xp, wp):
        if t.data_ptr() % 16:
            raise ValueError("queue_matmul kernel needs 16-byte aligned "
                             "operands")
    out = torch.empty((m, wp.shape[1]), dtype=x.dtype, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.queue_matmul_launch(
            xp.data_ptr(), wp.data_ptr(), out.data_ptr(), m, wp.shape[1],
            xp.shape[1], depth_x, depth_w, _DTYPE_CODES[x.dtype], stream)
    if err != 0:
        raise RuntimeError("queue_matmul kernel launch failed: "
                           + lib.queue_matmul_error_string(err).decode())
    queue_matmul.launches += 1
    return out[:, :n] if wp.shape[1] != n else out


def _queue_matmul(x: torch.Tensor, w: torch.Tensor, *,
                  block: Tuple[int, int, int], depth_x: int, depth_w: int,
                  unroll: int, policy: ExecutionPolicy) -> torch.Tensor:
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"queue_matmul takes x (M, K) and w (K, N), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if policy is ExecutionPolicy.BASELINE or x.device.type == "cpu":
        return matmul_ref(x, w).to(x.dtype)
    if x.device.type != "cuda":
        raise ValueError(f"queue_matmul runs on CUDA or CPU tensors, got "
                         f"{x.device}")
    if policy is ExecutionPolicy.COPIFT:
        depth_x = depth_w = 1
    return _launch(x, w, depth_x, depth_w)


def queue_matmul(x: torch.Tensor, w: torch.Tensor, *,
                 block: Tuple[int, int, int] = (128, 128, 128),
                 depth: Optional[int] = None,
                 depth_x: Optional[int] = None,
                 depth_w: Optional[int] = None,
                 unroll: Optional[int] = None,
                 policy: Optional[ExecutionPolicy] = None) -> torch.Tensor:
    """y = x @ w through the queue-pipelined kernel; returns ``x.dtype``.

    ``policy`` overrides the depths: BASELINE is the plain matmul, COPIFT
    forces both rings to depth 1, COPIFTV2 keeps the requested depths.
    Unset knobs come from the policy table (the x ring from the I2F depth,
    the w ring from the F2I depth, each defaulting to ``queue_depth``).
    ``depth`` pins both rings, ``depth_x``/``depth_w`` one each; any
    explicit depth with ``policy`` unset runs COPIFTV2, never a table
    policy that would discard it.
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
                         unroll=unroll, policy=policy)


#: kernel launches since the count was last set to 0
queue_matmul.launches = 0
