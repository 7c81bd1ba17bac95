#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

  python3 chip_smoke.py                      # every phase, as CI runs it
  python3 chip_smoke.py --phases build,kernels --cases-out out/cases.json

Phases, each of which raises on failure (the run then exits non-zero and
prints no result):

1. build   — compile the four CUDA kernels from the sources in the
   checkout, one ``nvcc`` each, all at once.
2. kernels — each kernel against its plain PyTorch version on the card at
   the serve paths' shapes, with its time, its bound and the time of one
   library call that computes the same function where there is one (a
   yardstick the port never calls).  ``queue_matmul`` and ``moe_gemm``
   must be bit-identical across ring depths.
3. parity  — phi3-mini-3.8b, olmoe-1b-7b and falcon-mamba-7b at full
   width, depth cut to 2 layers: ``forward`` and 4 ``decode_step``s in
   fp32 on the card (kernels) and on the CPU (plain versions), and in fp64
   on the CPU, on the same seeded weights.  The card must be no farther
   from fp64 than the CPU's fp32 run (within ``FP64_RATIO``) and within
   2e-3 of the fp64 run; for olmoe every layer's top-k experts are
   compared first.  The
   kept layers are drawn at the full-depth model's scale, and olmoe's also
   at the fan-in scale (see ``PARITY``).
4. serve   — phi3-mini-3.8b (32 layers), olmoe-1b-7b (16) and
   falcon-mamba-7b (64) at full width, bf16, one after the other: the
   chunked-prefill engine serves 6 seeded requests, a token-prefill engine
   must give the same tokens, and one ``forward`` over 512 tokens runs
   ``flash_attention`` (and ``ssm_scan`` for falcon-mamba).  Each model's
   run is its own main path: the launch counts are set to 0 just before it
   and read just after it, and every kernel of that path must have run.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  It imports nothing of JAX.
"""
import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PHASES = ("build", "kernels", "parity", "serve")
HBM_BYTES_PER_S = 3.35e12                 # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,     # dense tensor-core bf16
              torch.float32: 67e12}       # fp32 outside the tensor cores
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
SEED = 20261016
SERVED = ("phi3-mini-3.8b", "olmoe-1b-7b", "falcon-mamba-7b")
#: phase 3's draws of the 2 kept layers: (arch, scale, whether the card is
#: held to 2e-3 of the CPU's fp64 run).  "depth" is the full-depth model's
#: scale, as the reference's initializer gives it (std 1/sqrt(n_layers));
#: "fan_in" is std 1/sqrt(fan-in) of each matrix.  The 2e-3 check is made
#: against fp64, not the CPU's fp32 run: where attention saturates, a
#: rounding difference in one fp32 run can move its logits by more than
#: the tolerance.  At olmoe's depth scale (std 1/4) fp32 itself misses
#: fp64 by several times the tolerance, so there the card is held to the
#: ratio below only, and the fan-in draw carries the 2e-3 check.
PARITY = (("phi3-mini-3.8b", "depth", True),
          ("olmoe-1b-7b", "depth", False),
          ("olmoe-1b-7b", "fan_in", True),
          ("falcon-mamba-7b", "depth", True))
#: the card's RMS distance from the fp64 witness may be at most this many
#: times the CPU's: both run fp32 with other summation orders, where a
#: product in TF32 or bf16 would be 10^3-10^4 times farther
FP64_RATIO = 2.0
#: the kernels each family's serve path runs
PATH_KERNELS = {"dense": ("queue_matmul", "flash_attention"),
                "moe": ("queue_matmul", "flash_attention", "moe_gemm"),
                "ssm": ("queue_matmul", "ssm_scan")}
WHERE = {
    "queue_matmul": ("src/repro_torch/kernels/queue_matmul/csrc/"
                     "queue_matmul.cu",
                     "src/repro/kernels/queue_matmul/kernel.py:90"),
    "flash_attention": ("src/repro_torch/kernels/flash_attention/csrc/"
                        "flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:63"),
    "moe_gemm": ("src/repro_torch/kernels/moe_gemm/csrc/moe_gemm.cu",
                 "src/repro/kernels/moe_gemm/kernel.py:59"),
    "ssm_scan": ("src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu",
                 "src/repro/kernels/ssm_scan/kernel.py:45"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def host_cpu() -> str:
    """The host CPU's model name (phase 3's CPU runs depend on it)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return "unknown"


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` in ms, from CUDA events around
    ``iters`` calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cycling(args_list):
    """A call-maker cycling over several copies of the operands, so that
    repeated calls read them from device memory rather than from the
    50 MB L2, as the serve path does for each layer's weights."""
    state = {"i": 0}

    def make(fn):
        def call():
            args = args_list[state["i"] % len(args_list)]
            state["i"] += 1
            return fn(*args)
        return call
    return make


def bound(flops: float, nbytes: float, dtype: torch.dtype):
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def within(out: torch.Tensor, ref: torch.Tensor, tol: float) -> float:
    """Max abs error; raises unless |out - ref| <= tol + tol * |ref|
    everywhere (``allclose`` with rtol = atol = tol)."""
    err = (out.float() - ref.float()).abs()
    if not bool((err <= tol + tol * ref.float().abs()).all()):
        raise AssertionError(f"max abs err {err.max().item():.3e} beyond "
                             f"rtol = atol = {tol}")
    return err.max().item()


def used(out: torch.Tensor, ref: torch.Tensor, tol: float) -> float:
    """The largest share of the allowed error that any element uses."""
    err = (out.float() - ref.float()).abs()
    return (err / (tol + tol * ref.float().abs())).max().item()


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------

def phase_build() -> None:
    from repro_torch.kernels import KERNELS, _build
    t0 = time.time()
    logs = _build.build_all(KERNELS)
    log(f"[build] {', '.join(KERNELS)} built in {time.time() - t0:.1f} s "
        f"({len(logs)} compiled now) into {_build.BUILD_DIR}")
    for name, out in logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def matmul_shapes(arch: str):
    """(product, K, N, dtypes) of every ``queue_matmul`` product on
    ``arch``'s serve path, at full width; the router runs in fp32 only."""
    from repro_torch.configs import get_config
    from repro_torch.models.ssm import ssm_dims
    cfg = get_config(arch)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    both = (torch.float32, torch.bfloat16)
    if cfg.family == "ssm":
        d_in, rank, n = ssm_dims(cfg)
        out = [("in_proj", d, 2 * d_in, both),
               ("x_proj", d_in, rank + 2 * n, both),
               ("dt_proj", rank, d_in, both), ("out_proj", d_in, d, both)]
    else:
        out = [("q", d, cfg.n_heads * hd, both),
               ("k/v", d, cfg.n_kv_heads * hd, both),
               ("o", cfg.n_heads * hd, d, both)]
        if cfg.moe:
            out.append(("router", d, cfg.moe.num_experts, (torch.float32,)))
        else:
            out += [("wi/wg", d, cfg.d_ff, both), ("ffn wo", cfg.d_ff, d, both)]
    out.append(("head", d, cfg.vocab, both))
    merged = {}                       # products of one shape, named once
    for name, k, n, dtypes in out:
        names = merged.get((k, n), ((), dtypes))[0]
        merged[(k, n)] = (names + (name,), dtypes)
    return [("/".join(names), k, n, dtypes)
            for (k, n), (names, dtypes) in merged.items()]


def check_queue_matmul(gen, report) -> dict:
    """Every product of the three serve paths at M = 4 (decode over 4
    slots) and M = 512 (``forward``), bit-identical across ring depths."""
    from repro_torch.kernels.queue_matmul import ops
    from repro_torch.kernels.queue_matmul.ref import matmul_ref
    rep = None
    log("[kernels] queue_matmul  model product  M     K     N    dtype  "
        "max_abs_err  ms  plain_ms  library_ms  bound_ms")
    cases = [(arch, name, k, n, dtype) for arch in SERVED
             for name, k, n, dtypes in matmul_shapes(arch)
             for dtype in dtypes]
    for arch, name, k, n, dtype in cases:
        for m in (4, 512):
            x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
            w = (torch.randn((k, n), generator=gen, device="cuda")
                 / math.sqrt(k)).to(dtype)
            ref = matmul_ref(x, w).to(dtype)
            outs = {d: ops.queue_matmul(x, w, depth_x=d[0], depth_w=d[1])
                    for d in ((1, 1), (2, 2), (4, 4), (2, 4))}
            torch.cuda.synchronize()
            base = outs[(1, 1)]
            for d, o in outs.items():
                if not torch.equal(o, base):
                    raise AssertionError(
                        f"queue_matmul depths {d} differ from depth 1 at "
                        f"{arch} {name} M={m} K={k} N={n} {dtype}")
            err = within(base, ref, TOL[dtype])
            copies = max(2, math.ceil(100e6 / (w.numel() * w.element_size())))
            args = [(x.clone(), w.clone()) for _ in range(copies)]
            make = cycling(args)
            ms = cuda_ms(make(lambda a, b: ops.queue_matmul(a, b)))
            plain = cuda_ms(make(lambda a, b: matmul_ref(a, b).to(a.dtype)))
            lib = cuda_ms(make(torch.matmul))
            b_ms, b_by = bound(2.0 * m * n * k,
                               (m * k + k * n + m * n) * x.element_size(),
                               dtype)
            del args, outs, ref
            log(f"[kernels] queue_matmul {arch.split('-')[0]:>6s} "
                f"{name:>8s} {m:4d} {k:5d} {n:5d} {str(dtype)[6:]:>8s} "
                f"{err:10.3e} {ms:8.4f} {plain:8.4f} {lib:8.4f} {b_ms:8.4f} "
                f"({b_by})")
            row = {"model": arch, "product": name, "M": m, "K": k, "N": n,
                   "dtype": str(dtype)[6:], "max_abs_err": err, "ms": ms,
                   "plain_ms": plain, "library_ms": lib, "bound_ms": b_ms,
                   "bound_by": b_by}
            report.append({"kernel": "queue_matmul", **row})
            if (m, k, n, dtype) == (4, 3072, 8192, torch.bfloat16):
                rep = row
        free_card()
    return rep


def _pairs(sq: int, sk: int, causal: bool, window) -> int:
    """(q, k) pairs the masks keep, counted from this run's shapes."""
    i = torch.arange(sq)[:, None]
    j = torch.arange(sk)[None]
    keep = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        keep &= j <= i
    if window is not None:
        keep &= j > i - window
    return int(keep.sum())


def _sdpa(q, k, v, causal, window):
    import torch.nn.functional as F
    hq, hkv = q.shape[1], k.shape[1]
    if hkv != hq:
        k = k.repeat_interleave(hq // hkv, dim=1)
        v = v.repeat_interleave(hq // hkv, dim=1)
    if window is None:
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal)
    s = q.shape[2]
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(s, device=q.device)[None]
    mask = j > i - window
    if causal:
        mask &= j <= i
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def check_flash_attention(gen, report) -> dict:
    from repro_torch.kernels.flash_attention import ops
    rep = None
    log("[kernels] flash_attention  B  Hq Hkv    S   D  causal window  dtype  "
        "max_abs_err  ms  plain_ms  library_ms  bound_ms")
    # phi3's heads (32 of 96) and olmoe's (16 of 128), at the 512 tokens of
    # phase 4's ``forward`` and the 128 of phase 3's; windows, GQA, longer
    # and ragged sequences at phi3's width
    cases = [(32, 32, 512, 96, True, None), (32, 32, 512, 96, True, 256),
             (32, 32, 512, 96, False, None), (32, 8, 512, 96, True, None),
             (32, 32, 1024, 96, True, None), (32, 32, 1024, 96, True, 256),
             (32, 32, 1024, 96, False, None), (32, 8, 1024, 96, True, None),
             (32, 32, 300, 96, True, None), (32, 32, 128, 96, True, None),
             (16, 16, 512, 128, True, None), (16, 16, 128, 128, True, None)]
    for dtype in (torch.float32, torch.bfloat16):
        for hq, hkv, s, d, causal, window in cases:
            q = torch.randn((1, hq, s, d), generator=gen, device="cuda").to(dtype)
            k = torch.randn((1, hkv, s, d), generator=gen, device="cuda").to(dtype)
            v = torch.randn((1, hkv, s, d), generator=gen, device="cuda").to(dtype)
            out = ops.flash_attention(q, k, v, causal=causal, window=window)
            ref = ops._plain(q, k, v, causal, window, 0)
            torch.cuda.synchronize()
            err = within(out, ref, TOL[dtype])
            ms = cuda_ms(lambda: ops.flash_attention(q, k, v, causal=causal,
                                                     window=window))
            plain = cuda_ms(lambda: ops._plain(q, k, v, causal, window, 0),
                            iters=5)
            lib = cuda_ms(lambda: _sdpa(q, k, v, causal, window))
            pairs = _pairs(s, s, causal, window)
            b_ms, b_by = bound(4.0 * hq * pairs * d,
                               (2 * hq + 2 * hkv) * s * d * q.element_size(),
                               dtype)
            log(f"[kernels] flash_attention  1 {hq:3d} {hkv:3d} {s:5d} {d:3d} "
                f"{int(causal):6d} {str(window):>6s} {str(dtype)[6:]:>8s} "
                f"{err:10.3e} {ms:8.4f} {plain:8.4f} {lib:8.4f} {b_ms:8.4f} "
                f"({b_by})")
            row = {"B": 1, "Hq": hq, "Hkv": hkv, "S": s, "D": d,
                   "causal": causal, "window": window,
                   "dtype": str(dtype)[6:], "max_abs_err": err, "ms": ms,
                   "plain_ms": plain, "library_ms": lib, "bound_ms": b_ms,
                   "bound_by": b_by}
            report.append({"kernel": "flash_attention", **row})
            if (hq, hkv, s, causal, window, dtype) == (
                    32, 32, 512, True, None, torch.bfloat16):
                rep = row
    return rep


def check_moe_gemm(gen, report) -> dict:
    """olmoe-1b-7b's expert products: decode (C = 4 slots) and ``forward``
    over 512 tokens (C = 512), wi/wg with the broadcast x of the dense
    dispatch (expert stride 0) and wo with a per-expert x."""
    from repro_torch.kernels.moe_gemm import ops
    from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref
    depth = ops.operating_point().effective_depths()[1]
    rep = None
    log(f"[kernels] moe_gemm  E    C     d     f  x  dtype  max_abs_err  ms  "
        f"plain_ms  library_ms  bound_ms  (depth {depth})")
    for dtype in (torch.float32, torch.bfloat16):
        for c in (4, 512):
            for d, f, bcast in ((2048, 1024, True), (1024, 2048, False)):
                e = 64
                if bcast:
                    x = torch.randn((c, d), generator=gen, device="cuda"
                                    ).to(dtype).expand(e, c, d)
                else:
                    x = torch.randn((e, c, d), generator=gen, device="cuda"
                                    ).to(dtype)
                w = (torch.randn((e, d, f), generator=gen, device="cuda")
                     / math.sqrt(d)).to(dtype)
                ref = moe_gemm_ref(x, w)
                outs = {k: ops.moe_gemm(x, w, depth=k) for k in (1, 2, 4)}
                torch.cuda.synchronize()
                for k, o in outs.items():
                    if not torch.equal(o, outs[1]):
                        raise AssertionError(
                            f"moe_gemm depth {k} differs from depth 1 at "
                            f"E={e} C={c} d={d} f={f} {dtype}")
                err = within(outs[1], ref, TOL[dtype])
                args = [(x, w.clone()) for _ in range(2)]
                make = cycling(args)
                ms = cuda_ms(make(lambda a, b: ops.moe_gemm(a, b,
                                                            depth=depth)))
                plain = cuda_ms(make(moe_gemm_ref), iters=5)
                lib = cuda_ms(make(torch.bmm))
                x_bytes = (c if bcast else e * c) * d * x.element_size()
                b_ms, b_by = bound(2.0 * e * c * d * f,
                                   x_bytes + w.numel() * w.element_size()
                                   + e * c * f * 4, dtype)
                del args, outs, ref
                log(f"[kernels] moe_gemm {e:3d} {c:4d} {d:5d} {f:5d} "
                    f"{'b' if bcast else 'e'} {str(dtype)[6:]:>8s} "
                    f"{err:10.3e} {ms:8.4f} {plain:8.4f} {lib:8.4f} "
                    f"{b_ms:8.4f} ({b_by})")
                row = {"E": e, "C": c, "d": d, "f": f, "broadcast_x": bcast,
                       "dtype": str(dtype)[6:], "depth": depth,
                       "max_abs_err": err, "ms": ms, "plain_ms": plain,
                       "library_ms": lib, "bound_ms": b_ms, "bound_by": b_by}
                report.append({"kernel": "moe_gemm", **row})
                if (c, d, dtype) == (4, 2048, torch.bfloat16):
                    rep = row
    return rep


def check_ssm_scan(gen, report) -> dict:
    """falcon-mamba-7b's scan: d_inner 8192, state 16, over the 512 tokens
    of phase 4's ``forward`` and the 128 of phase 3's.  No single PyTorch
    call computes it, so there is no library time."""
    from repro_torch.kernels.ssm_scan import ops
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
    rep = None
    log("[kernels] ssm_scan  B    T     d   N  dtype  max_abs_err  ms  "
        "plain_ms  bound_ms")
    for dtype in (torch.float32, torch.bfloat16):
        for b, t, d, n in ((1, 512, 8192, 16), (1, 128, 8192, 16)):
            def rnd(*shape):
                return torch.randn(shape, generator=gen, device="cuda")
            x = (rnd(b, t, d) * 0.5).to(dtype)
            dt = (torch.nn.functional.softplus(rnd(b, t, d) - 1.0)
                  ).to(dtype)
            A = -torch.exp(rnd(d, n) * 0.5)
            Bm, C = rnd(b, t, n).to(dtype), rnd(b, t, n).to(dtype)
            out = ops.ssm_scan(x, dt, A, Bm, C)
            ref = ssm_scan_ref(x, dt, A, Bm, C)
            torch.cuda.synchronize()
            err = within(out, ref, TOL[dtype])
            ms = cuda_ms(lambda: ops.ssm_scan(x, dt, A, Bm, C))
            plain = cuda_ms(lambda: ssm_scan_ref(x, dt, A, Bm, C), iters=2,
                            warmup=1)
            es = x.element_size()
            # per (b, t, channel, n): dt*A, exp, the update's mul and add,
            # (dt x)*B, h*C and the reduction's add; dt*x per channel
            flops = 7.0 * b * t * d * n + b * t * d
            nbytes = (2 * b * t * d * es + 2 * b * t * n * es + d * n * 4
                      + b * t * d * 4)
            b_ms, b_by = bound(flops, nbytes, torch.float32)
            log(f"[kernels] ssm_scan {b:2d} {t:4d} {d:5d} {n:3d} "
                f"{str(dtype)[6:]:>8s} {err:10.3e} {ms:8.4f} {plain:8.4f} "
                f"{b_ms:8.4f} ({b_by})")
            row = {"B": b, "T": t, "d": d, "N": n, "dtype": str(dtype)[6:],
                   "max_abs_err": err, "ms": ms, "plain_ms": plain,
                   "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
            report.append({"kernel": "ssm_scan", **row})
            if (t, dtype) == (512, torch.bfloat16):
                rep = row
    return rep


# ---------------------------------------------------------------------------
# phase 3: full width, cut depth, card against CPU
# ---------------------------------------------------------------------------

def fan_in(spec) -> int:
    """The contracted width of a stacked block matrix (layer axis first,
    then an expert axis if any): the product of its axes but the last when
    the last is "embed" (an output projection), else its first axis."""
    axes, shape = list(spec.axes[1:]), list(spec.shape[1:])
    if axes[0] == "experts" and len(axes) > 2:
        axes, shape = axes[1:], shape[1:]
    return math.prod(shape[:-1]) if axes[-1] == "embed" else shape[0]


def redraw_scale(params, cfg, full, rule: str) -> None:
    """Rescale the kept layers' normal-drawn leaves in place.  The
    reference's initializer takes a stacked leaf's fan-in from its layer
    axis (std 1/sqrt(n_layers)): "depth" scales them to the full-depth
    model's std, 1/sqrt(full.n_layers); "fan_in" to 1/sqrt(fan-in) of each
    matrix."""
    from repro_torch.models import param_specs
    specs = param_specs(cfg)["blocks"]

    def walk(p, s):
        for k, v in p.items():
            if isinstance(v, dict):
                walk(v, s[k])
            elif s[k].init == "normal":
                std = (1 / math.sqrt(full.n_layers) if rule == "depth"
                       else 1 / math.sqrt(fan_in(s[k])))
                v.mul_(std * math.sqrt(cfg.n_layers))
    walk(params["blocks"], specs)


@contextlib.contextmanager
def routing(store: list):
    """Append the top-k experts of every ``router_probs`` call (every MoE
    layer of a ``forward``, in order) to ``store``, on the CPU."""
    from repro_torch.models import moe
    real = moe.router_probs

    def spy(*args, **kwargs):
        w, idx = real(*args, **kwargs)
        store.append(idx.sort(-1).values.cpu())
        return w, idx
    moe.router_probs = spy
    try:
        yield store
    finally:
        moe.router_probs = real


def flips(a: list, b: list) -> list:
    """Per MoE layer, the tokens whose top-k sets differ between a and b."""
    return [int((x != y).any(-1).sum()) for x, y in zip(a, b)]


def rms(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.double() - b.double()).pow(2).mean().sqrt().item()


def against_witness(what, card, cpu, exact, hold: bool,
                    failures: list) -> None:
    """Log the card's and the CPU's fp32 distance from the fp64 witness
    and from each other; add to ``failures`` if the card is more than
    ``FP64_RATIO`` times farther from fp64 than the CPU's fp32 run is, or,
    when ``hold``, beyond 2e-3 of the fp64 run."""
    card, cpu = card.cpu(), cpu.cpu()
    r_card, r_cpu = rms(card, exact), rms(cpu, exact)
    m_card = (card.double() - exact).abs().max().item()
    m_cpu = (cpu.double() - exact).abs().max().item()
    m_both = (card - cpu).abs().max().item()
    log(f"[parity] {what}: from fp64, card rms {r_card:.3e} max "
        f"{m_card:.3e} ({used(card, exact, 2e-3):.3f} of 2e-3"
        f"{'' if hold else ', not held at this scale'}), CPU fp32 rms "
        f"{r_cpu:.3e} max {m_cpu:.3e} (card/CPU rms {r_card / r_cpu:.3f}); "
        f"card from CPU fp32 max {m_both:.3e} "
        f"({used(card, cpu, 2e-3):.3f} of 2e-3)")
    if r_card > FP64_RATIO * r_cpu:
        failures.append(f"{what}: the card is {r_card / r_cpu:.2f} times "
                        f"farther from fp64 than the CPU")
    if hold and used(card, exact, 2e-3) > 1:
        failures.append(f"{what}: card {m_card:.3e} from fp64, beyond "
                        f"rtol = atol = 2e-3")


def phase_parity(arch: str, scale: str, hold: bool, failures: list) -> None:
    """2 layers at full width: ``forward`` and 4 ``decode_step``s on the
    card (fp32, kernels), on the CPU (fp32, plain versions) and on the CPU
    in fp64 (the witness), on the same seeded weights.  An MoE model's
    routing is compared first, every layer, so that a flipped expert is
    reported as a flip.  Failures go to ``failures``, so that one run
    reports every model."""
    from repro_torch.config import RunConfig
    from repro_torch.configs import get_config
    from repro_torch.models import (decode_step, forward, init_cache,
                                    init_model_params)
    from repro_torch.models.layers import tree_map
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=2)
    rc = RunConfig(dtype="float32", remat=False)
    rc64 = RunConfig(dtype="float64", remat=False)
    t0 = time.time()
    p_cpu = init_model_params(SEED, cfg, device="cpu")
    redraw_scale(p_cpu, cfg, full, scale)
    p_gpu = tree_map(lambda a: a.to("cuda"), p_cpu)
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 128)))
    name = f"{arch} ({scale} scale)"
    routes = {"card": [], "cpu": [], "fp64": []}
    with routing(routes["card"]):
        out_gpu = forward(p_gpu, {"tokens": toks.cuda()}, cfg, rc)
    with routing(routes["cpu"]):
        out_cpu = forward(p_cpu, {"tokens": toks}, cfg, rc)
    with routing(routes["fp64"]):
        exact = forward(p_cpu, {"tokens": toks}, cfg, rc64)
    if cfg.moe:
        both = flips(routes["card"], routes["cpu"])
        log(f"[parity] {name} top-{cfg.moe.top_k} experts of "
            f"{toks.numel()} tokens, tokens flipped per layer: card vs CPU "
            f"{both}, card vs fp64 {flips(routes['card'], routes['fp64'])}, "
            f"CPU vs fp64 {flips(routes['cpu'], routes['fp64'])}")
        if hold and any(both):
            failures.append(f"{name}: the router flips an expert between "
                            f"card and CPU ({both} tokens)")
    against_witness(f"{name} forward B=1 S=128", out_gpu, out_cpu, exact,
                    hold, failures)
    caches = {"card": init_cache(cfg, 4, 16, torch.float32, device="cuda"),
              "cpu": init_cache(cfg, 4, 16, torch.float32, device="cpu"),
              "fp64": init_cache(cfg, 4, 16, torch.float64, device="cpu")}
    steps = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 4)))
    for t in range(4):
        tok = steps[:, t:t + 1]
        lg, caches["card"] = decode_step(p_gpu, caches["card"],
                                         {"tokens": tok.cuda()}, cfg, rc)
        lc, caches["cpu"] = decode_step(p_cpu, caches["cpu"],
                                        {"tokens": tok}, cfg, rc)
        le, caches["fp64"] = decode_step(p_cpu, caches["fp64"],
                                         {"tokens": tok}, cfg, rc64)
        against_witness(f"{name} decode_step {t}", lg, lc, le, hold,
                        failures)
    del p_gpu, caches
    free_card()
    log(f"[parity] {name} done in {time.time() - t0:.1f} s")


def free_card() -> None:
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 4: serve at full width
# ---------------------------------------------------------------------------

def launch_counters():
    from repro_torch.kernels import (flash_attention, moe_gemm, queue_matmul,
                                     ssm_scan)
    return {"queue_matmul": queue_matmul, "flash_attention": flash_attention,
            "moe_gemm": moe_gemm, "ssm_scan": ssm_scan}


def phase_serve(arch: str) -> dict:
    """Serve ``arch`` at full width in bf16 and return the launches of its
    main path, by kernel.  The weights are freed before returning."""
    from repro_torch.config import RunConfig
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_model_params
    from repro_torch.serve import ServeEngine
    cfg = get_config(arch)
    rc = RunConfig(dtype="bfloat16")
    counters = launch_counters()
    t0 = time.time()
    params = init_model_params(SEED, cfg, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    # the peak counts serving from here on, not the fp32 temporaries of
    # the random draw
    torch.cuda.reset_peak_memory_stats()
    log(f"[serve] {arch} full width ({cfg.n_layers} layers), bf16 weights "
        f"drawn in {time.time() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    rng = np.random.default_rng(SEED + 1)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab,
                                             int(rng.integers(16, 65)))]
               for _ in range(6)]

    for c in counters.values():
        c.launches = 0
    eng = ServeEngine(params, cfg, rc, batch_slots=4, max_len=256,
                      prefill_chunk=8)
    del params
    rids = [eng.submit(p, max_new=16) for p in prompts]
    t0 = time.time()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    if sorted(done) != sorted(rids):
        raise AssertionError(f"unfinished requests: {set(rids) - set(done)}")
    n_tok = sum(len(r.generated) for r in done.values())
    if n_tok != 16 * len(rids):
        raise AssertionError(f"{n_tok} tokens generated, want {16 * len(rids)}")
    log(f"[serve] {arch} chunked prefill: {len(done)} requests, {n_tok} "
        f"tokens in {wall:.2f} s wall = {n_tok / wall:.2f} tok/s; "
        f"{eng._n_steps} steps; launches "
        f"{ {k: c.launches for k, c in counters.items()} }; prefill widths "
        f"{sorted(eng._prefill_fns)}")

    tok_eng = ServeEngine(eng.params, cfg, rc, batch_slots=4, max_len=256,
                          prefill="token")
    rids_t = [tok_eng.submit(p, max_new=16) for p in prompts]
    t0 = time.time()
    done_t = tok_eng.run()
    torch.cuda.synchronize()
    wall_t = time.time() - t0
    for a, b in zip(rids, rids_t):
        if done[a].generated != done_t[b].generated:
            raise AssertionError(f"{arch}: chunked and token prefill differ "
                                 f"on request {a}: {done[a].generated} vs "
                                 f"{done_t[b].generated}")
    log(f"[serve] {arch} token prefill: same tokens for all {len(rids)} "
        f"requests; {n_tok / wall_t:.2f} tok/s wall; {tok_eng._n_steps} "
        f"steps")
    del tok_eng

    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 512))).cuda()
    before = {k: c.launches for k, c in counters.items()}
    t0 = time.time()
    logits = forward(eng.params, {"tokens": toks}, cfg, eng.rc)
    torch.cuda.synchronize()
    fwd_s = time.time() - t0
    if logits.shape != (1, 512, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{arch}: forward logits {tuple(logits.shape)} "
                             f"not finite")
    del logits
    log(f"[serve] {arch} forward B=1 S=512: {fwd_s:.3f} s wall; launches "
        f"{ {k: c.launches - before[k] for k, c in counters.items()} }")
    counts = {k: c.launches for k, c in counters.items()}
    for name in PATH_KERNELS[cfg.family]:
        if counts[name] <= 0:
            raise AssertionError(f"{name} never launched on {arch}'s main "
                                 f"path")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[serve] {arch} launches on the main path: {counts}; peak memory "
        f"{peak:.2f} GiB")
    log(f"[serve] {arch} first tokens: {done[rids[0]].generated}")
    profile_decode(eng.params, eng.cache, cfg, eng.rc, arch)
    del eng
    free_card()
    return counts


def profile_decode(params, cache, cfg, rc, arch: str, n: int = 5) -> None:
    """Launches per decode body over the engine's slots, its wall time
    (host clock, no profiler), and the kernel time inside it
    (torch.profiler, CUDA activity only), by kernel: the device's idle
    share is one minus their ratio.  Runs after the launch counts are
    read."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import decode_step
    tok = torch.zeros((cache["len"].shape[0], 1), dtype=torch.long,
                      device="cuda")
    step = lambda: decode_step(params, cache, {"tokens": tok}, cfg, rc)
    counters = launch_counters()
    before = {k: c.launches for k, c in counters.items()}
    step()
    torch.cuda.synchronize()
    per_body = {k: c.launches - before[k] for k, c in counters.items()
                if c.launches > before[k]}
    t0 = time.time()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.time() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    dev = {e.key: e.self_device_time_total / n / 1e3
           for e in prof.key_averages() if e.self_device_time_total > 0}
    busy = sum(dev.values())
    if busy == 0:
        log(f"[profile] {arch} idle share: not measured (the profiler saw "
            f"no device time)")
        return
    ours = {k: sum(v for key, v in dev.items() if k in key)
            for k in per_body}
    log(f"[profile] {arch} decode body ({tok.shape[0]} slots, "
        f"{cfg.n_layers} layers): launches {per_body}; {wall_ms:.2f} ms "
        f"wall, {busy:.2f} ms in kernels ("
        + ", ".join(f"{v:.2f} {k}" for k, v in ours.items())
        + f", {busy - sum(ours.values()):.2f} other); device idle share "
        f"{1 - busy / wall_ms:.3f}")
    for k, v in sorted(dev.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[profile]   {v:8.3f} ms  {k[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES}")
    ap.add_argument("--cases-out", default=None,
                    help="write every kernel case of phase 2 to this JSON "
                         "file")
    args = ap.parse_args()
    phases = args.phases.split(",")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 checks stay fp32
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(smi)
    log(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}; host CPU {host_cpu()}, "
        f"{torch.get_num_threads()} threads")
    t_start = time.time()
    kernels = []
    if "build" in phases:
        phase_build()
    if "kernels" in phases:
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        report = []
        kernels = [("queue_matmul", check_queue_matmul(gen, report)),
                   ("flash_attention", check_flash_attention(gen, report)),
                   ("moe_gemm", check_moe_gemm(gen, report)),
                   ("ssm_scan", check_ssm_scan(gen, report))]
        free_card()
        if args.cases_out:
            os.makedirs(os.path.dirname(os.path.abspath(args.cases_out)),
                        exist_ok=True)
            with open(args.cases_out, "w") as f:
                json.dump({"card": smi, "cases": report}, f, indent=1)
    if "parity" in phases:
        failures = []
        for arch, scale, hold in PARITY:
            phase_parity(arch, scale, hold, failures)
        if failures:
            raise AssertionError("phase 3 failed:\n" + "\n".join(failures))
    launches = {}
    if "serve" in phases:
        for arch in SERVED:
            for name, n in phase_serve(arch).items():
                launches[name] = launches.get(name, 0) + n
        log(f"[serve] launches over the three main paths: {launches}")
    log(f"[done] {time.time() - t_start:.1f} s")

    line = []
    for name, row in kernels:
        src, replaces = WHERE[name]
        line.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches.get(name, 0),
                     "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                     "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                     "bound_by": row["bound_by"],
                     "library_ms": row["library_ms"]})
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
