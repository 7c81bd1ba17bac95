#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

  python3 chip_smoke.py                      # every phase, as CI runs it
  python3 chip_smoke.py --phases build,kernels --cases-out out/cases.json

Phases, each of which raises on failure (the run then exits non-zero and
prints no result):

1. build   — compile the five CUDA kernels from the sources in the
   checkout, one ``nvcc`` each, all at once.
2. kernels — each kernel against its plain PyTorch version on the card at
   the serve paths' shapes, with its device time (``cuda_ms``), its bound
   and the time of one library call that computes the same function where
   there is one (a yardstick the port never calls); ``queue_matmul`` and
   ``flash_attention`` also with their wall time launched back to back
   (``wall_ms``), and ``queue_matmul`` with its host time a call
   (``host_ms``).  ``queue_matmul`` and
   ``moe_gemm`` must be bit-identical across ring depths; ``queue_matmul``
   is checked at M = 4 (its thin bf16 kernel), 64, 128 and 512 (its wide
   one), ``moe_gemm`` at C = 4 (thin), also with the expert mask of a
   top-8 routing of 4 tokens (the active experts' bits equal to the
   unmasked call's, the others zeros), and at C = 130 and 512 (wide),
   ``flash_attention`` also at head dims 80 and 200 and on a query
   chunk at the end of a longer key sequence (Sk != Sq, ``q_offset``).
3. parity  — phi3-mini-3.8b, olmoe-1b-7b and falcon-mamba-7b at full
   width, depth cut to 2 layers, and recurrentgemma-2b cut to 5 (one
   (rec, rec, attn) macro block and the full model's (rec, rec) tail):
   ``forward`` and 4 ``decode_step``s in fp32 on the card (kernels) and on
   the CPU (plain versions), and in fp64 on the CPU, on the same seeded
   weights.  The card must be no farther from fp64 than the CPU's fp32 run
   (within ``FP64_RATIO``) and, where ``PARITY`` holds it, within 2e-3 of
   the fp64 run; for olmoe every layer's top-k experts are compared first.
   recurrentgemma also prefills and decodes with its window cut to
   ``RING_WINDOW``, so that its K/V ring wraps.  The kept layers are drawn
   at the full-depth model's scale, and olmoe's also at the fan-in scale
   (see ``PARITY``).
4. serve   — phi3-mini-3.8b (32 layers), olmoe-1b-7b (16),
   falcon-mamba-7b (64) and recurrentgemma-2b (26) at full width, bf16, one
   after the other: the chunked-prefill engine serves 6 seeded requests, a
   token-prefill engine must give the same tokens, and one ``forward`` over
   512 tokens runs ``flash_attention`` (and ``ssm_scan`` for falcon-mamba,
   ``rglru_scan`` for recurrentgemma).  Each model's run is its own main
   path: the launch counts are set to 0 just before it and read just after
   it, and every kernel of that path must have run.  Then a profile of a
   decode body: launches, kernel time by kernel, the device's idle share,
   and for olmoe the experts each layer's mask keeps.

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
#: cuda_ms's sleep: cycles per second at the H100's highest SM clock (a
#: lower clock sleeps longer), and the longest sleep
SLEEP_CYCLES_PER_S, MAX_SLEEP_S = 1.98e9, 0.2
SEED = 20261016
SERVED = ("phi3-mini-3.8b", "olmoe-1b-7b", "falcon-mamba-7b",
          "recurrentgemma-2b")
#: phase 3's draws of the kept layers: (arch, scale, whether the card is
#: held to 2e-3 of the CPU's fp64 run).  "depth" is the full-depth model's
#: scale, as the reference's initializer gives it (std 1/sqrt(n_layers));
#: "fan_in" is std 1/sqrt(fan-in) of each matrix.  The 2e-3 check is made
#: against fp64, not the CPU's fp32 run: where attention saturates, a
#: rounding difference in one fp32 run can move its logits by more than
#: the tolerance.  At olmoe's depth scale (std 1/4) fp32 itself misses
#: fp64 by several times the tolerance, so there the card is held to the
#: ratio below only, and the fan-in draw carries the 2e-3 check.
#: recurrentgemma's depth scale (macro blocks at std 1/sqrt(8)) saturates
#: its gates and attention, but a saturated sigmoid or softmax is flat, so
#: rounding does not grow through it: the card measured 0.12 of 2e-3 from
#: fp64 there (and 0.004 at the fan-in scale), so its depth draw carries
#: the 2e-3 check alone.
PARITY = (("phi3-mini-3.8b", "depth", True),
          ("olmoe-1b-7b", "depth", False),
          ("olmoe-1b-7b", "fan_in", True),
          ("falcon-mamba-7b", "depth", True),
          ("recurrentgemma-2b", "depth", True))
#: recurrentgemma's ring check: window, cache length and prompt length
#: (the prompt passes the window, so the ring has wrapped before the 4
#: decode steps)
RING_WINDOW, RING_MAX_LEN, RING_PROMPT = 16, 32, 24
#: the card's RMS distance from the fp64 witness may be at most this many
#: times the CPU's: both run fp32 with other summation orders, where a
#: product in TF32 or bf16 would be 10^3-10^4 times farther
FP64_RATIO = 2.0
#: the kernels each family's serve path runs
PATH_KERNELS = {"dense": ("queue_matmul", "flash_attention"),
                "moe": ("queue_matmul", "flash_attention", "moe_gemm"),
                "ssm": ("queue_matmul", "ssm_scan"),
                "hybrid": ("queue_matmul", "flash_attention", "rglru_scan")}
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
    "rglru_scan": ("src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu",
                   "src/repro/kernels/rglru_scan/kernel.py:33"),
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
    ``iters`` calls after ``warmup`` calls.  The calls queue behind a sleep
    on the card long enough (up to ``MAX_SLEEP_S``) for the host to enqueue
    them all, so that the host's time to launch them does not show."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    sleep_s = min(MAX_SLEEP_S, 1.5 * iters * host_s + 1e-3)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(sleep_s * SLEEP_CYCLES_PER_S))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int = 100, warmup: int = 3) -> float:
    """Median host time of one ``fn()`` call in ms (what the host spends to
    launch it: the wrapper's Python, ``ctypes`` and the launch), each call
    timed on the host clock while the card works through the queue; the
    median, since the host's clock is shared with other work."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return sorted(times)[iters // 2] * 1e3


def wall_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of ``fn()`` in ms with the calls launched back to back
    from an idle card, as a decode body launches them: the host's launch
    cost and the kernel's, whichever is longer."""
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
    elif cfg.family == "hybrid":
        w = cfg.rglru.lru_width or d
        out = [("in/gate_proj", d, w, both), ("rg/ig", w, w, both),
               ("out_proj", w, d, both), ("q", d, cfg.n_heads * hd, both),
               ("k/v", d, cfg.n_kv_heads * hd, both),
               ("o", cfg.n_heads * hd, d, both),
               ("wi/wg", d, cfg.d_ff, both), ("ffn wo", cfg.d_ff, d, both)]
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


#: ring depth pairs every queue_matmul case must give the same bits at
QM_DEPTHS = ((1, 1), (2, 2), (4, 4), (2, 4), (8, 8), (1, 8))


def check_queue_matmul(gen, report) -> dict:
    """Every product of the served models at M = 4 (decode over 4 slots)
    and M = 512 (``forward``), and phi3's q/k/v/o and ffn products also at
    M = 64 and 128 (the wide kernel's smallest tiles), bit-identical
    across the ring depths of ``QM_DEPTHS``."""
    from repro_torch.kernels.queue_matmul import ops
    from repro_torch.kernels.queue_matmul.ref import matmul_ref
    rep = None
    log("[kernels] queue_matmul  model product  M     K     N    dtype  "
        "max_abs_err  ms  plain_ms  library_ms  bound_ms")
    cases = [(arch, name, k, n, dtype) for arch in SERVED
             for name, k, n, dtypes in matmul_shapes(arch)
             for dtype in dtypes]
    for arch, name, k, n, dtype in cases:
        ms_ = (4, 512)
        if arch == "phi3-mini-3.8b" and name != "head":
            ms_ = (4, 64, 128, 512)
        for m in ms_:
            x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
            w = (torch.randn((k, n), generator=gen, device="cuda")
                 / math.sqrt(k)).to(dtype)
            ref = matmul_ref(x, w).to(dtype)
            outs = {d: ops.queue_matmul(x, w, depth_x=d[0], depth_w=d[1])
                    for d in QM_DEPTHS}
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
            wall = wall_ms(make(lambda a, b: ops.queue_matmul(a, b)))
            host = host_ms(make(lambda a, b: ops.queue_matmul(a, b)))
            plain = cuda_ms(make(lambda a, b: matmul_ref(a, b).to(a.dtype)))
            lib = cuda_ms(make(torch.matmul))
            b_ms, b_by = bound(2.0 * m * n * k,
                               (m * k + k * n + m * n) * x.element_size(),
                               dtype)
            del args, outs, ref
            # the kernel this M takes (older trees have one kernel)
            kind = (ops.regime(m, dtype) if hasattr(ops, "regime")
                    else "ring")
            log(f"[kernels] queue_matmul {arch.split('-')[0]:>6s} "
                f"{name:>8s} {m:4d} {k:5d} {n:5d} {str(dtype)[6:]:>8s} "
                f"{err:10.3e} {ms:8.4f} {plain:8.4f} {lib:8.4f} {b_ms:8.4f} "
                f"({b_by}; {kind}"
                + (f", split {ops.split_k(k, n)}" if kind == "thin" else "")
                + f"; {2.0 * m * n * k / ms / 1e9:.1f} TFLOP/s, "
                f"{(m * k + k * n + m * n) * x.element_size() / ms / 1e6:.0f}"
                f" GB/s; wall {wall:.4f}, host {host:.4f})")
            row = {"model": arch, "product": name, "M": m, "K": k, "N": n,
                   "dtype": str(dtype)[6:], "regime": kind,
                   "max_abs_err": err, "ms": ms, "wall_ms": wall,
                   "host_ms": host,
                   "plain_ms": plain, "library_ms": lib, "bound_ms": b_ms,
                   "bound_by": b_by}
            report.append({"kernel": "queue_matmul", **row})
            if (m, k, n, dtype) == (4, 3072, 8192, torch.bfloat16):
                rep = row
        free_card()
    return rep


def _keep(sq: int, sk: int, causal: bool, window, q_offset: int,
          device=None) -> torch.Tensor:
    """The (q, k) pairs the masks keep: query i sits at q_offset + i."""
    i = q_offset + torch.arange(sq, device=device)[:, None]
    j = torch.arange(sk, device=device)[None]
    keep = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        keep &= j <= i
    if window is not None:
        keep &= j > i - window
    return keep


def _sdpa(q, k, v, causal, window, q_offset):
    import torch.nn.functional as F
    hq, hkv = q.shape[1], k.shape[1]
    if hkv != hq:
        k = k.repeat_interleave(hq // hkv, dim=1)
        v = v.repeat_interleave(hq // hkv, dim=1)
    if window is None and q_offset == 0 and q.shape[2] == k.shape[2]:
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal)
    mask = _keep(q.shape[2], k.shape[2], causal, window, q_offset, q.device)
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def check_flash_attention(gen, report) -> dict:
    from repro_torch.kernels.flash_attention import ops
    rep = None
    log("[kernels] flash_attention  B  Hq Hkv   Sq    Sk   D  causal window "
        "q_off  dtype  max_abs_err  ms  plain_ms  library_ms  bound_ms")
    # phi3's heads (32 of 96), olmoe's (16 of 128) and recurrentgemma's (10
    # of 256 over one KV head, window 2048), at the 512 tokens of phase 4's
    # ``forward`` and the 128 of phase 3's; windows, GQA, longer and ragged
    # sequences at phi3's width, and recurrentgemma's at 4096 tokens, where
    # its window bites; head dims 80 and 200 (padded to 16 in the kernel);
    # a query chunk at the end of a longer key sequence (Sk != Sq,
    # q_offset), as a chunked prefill would give it
    cases = [(32, 32, 512, 512, 96, True, None, 0),
             (32, 32, 512, 512, 96, True, 256, 0),
             (32, 32, 512, 512, 96, False, None, 0),
             (32, 8, 512, 512, 96, True, None, 0),
             (32, 32, 1024, 1024, 96, True, None, 0),
             (32, 32, 1024, 1024, 96, True, 256, 0),
             (32, 32, 1024, 1024, 96, False, None, 0),
             (32, 8, 1024, 1024, 96, True, None, 0),
             (32, 32, 300, 300, 96, True, None, 0),
             (32, 32, 128, 128, 96, True, None, 0),
             (16, 16, 512, 512, 128, True, None, 0),
             (16, 16, 128, 128, 128, True, None, 0),
             (10, 1, 512, 512, 256, True, 2048, 0),
             (10, 1, 128, 128, 256, True, 2048, 0),
             (10, 1, 4096, 4096, 256, True, 2048, 0),
             (32, 32, 512, 512, 80, True, None, 0),
             (16, 4, 512, 512, 200, True, 300, 0),
             (32, 8, 128, 640, 96, True, None, 512),
             (10, 1, 256, 4096, 256, True, 2048, 3840)]
    for dtype in (torch.float32, torch.bfloat16):
        for hq, hkv, sq, sk, d, causal, window, q_off in cases:
            q = torch.randn((1, hq, sq, d), generator=gen, device="cuda").to(dtype)
            k = torch.randn((1, hkv, sk, d), generator=gen, device="cuda").to(dtype)
            v = torch.randn((1, hkv, sk, d), generator=gen, device="cuda").to(dtype)

            def run():
                return ops.flash_attention(q, k, v, causal=causal,
                                           window=window, q_offset=q_off)
            out = run()
            ref = ops._plain(q, k, v, causal, window, q_off)
            torch.cuda.synchronize()
            err = within(out, ref, TOL[dtype])
            ms = cuda_ms(run)
            wall = wall_ms(run)
            plain = cuda_ms(lambda: ops._plain(q, k, v, causal, window, q_off),
                            iters=5)
            lib = cuda_ms(lambda: _sdpa(q, k, v, causal, window, q_off))
            pairs = int(_keep(sq, sk, causal, window, q_off).sum())
            b_ms, b_by = bound(4.0 * hq * pairs * d,
                               (2 * hq * sq + 2 * hkv * sk) * d
                               * q.element_size(), dtype)
            log(f"[kernels] flash_attention  1 {hq:3d} {hkv:3d} {sq:5d} "
                f"{sk:5d} {d:3d} {int(causal):6d} {str(window):>6s} "
                f"{q_off:5d} {str(dtype)[6:]:>8s} {err:10.3e} {ms:8.4f} "
                f"{plain:8.4f} {lib:8.4f} {b_ms:8.4f} ({b_by}; "
                f"{ms / lib:.2f}x library; "
                f"{4.0 * hq * pairs * d / ms / 1e9:.1f} TFLOP/s; "
                f"wall {wall:.4f})")
            row = {"B": 1, "Hq": hq, "Hkv": hkv, "Sq": sq, "Sk": sk, "D": d,
                   "causal": causal, "window": window, "q_offset": q_off,
                   "dtype": str(dtype)[6:], "max_abs_err": err, "ms": ms,
                   "wall_ms": wall, "plain_ms": plain, "library_ms": lib,
                   "bound_ms": b_ms, "bound_by": b_by}
            report.append({"kernel": "flash_attention", **row})
            if (hq, hkv, sq, causal, window, d, dtype) == (
                    32, 32, 512, True, None, 96, torch.bfloat16):
                rep = row
    return rep


def routed_mask(gen, tokens: int, experts: int, k: int) -> torch.Tensor:
    """The experts a top-k router picks for ``tokens`` independent tokens
    (seeded normal logits, top ``k`` of ``experts`` each): the mask the
    decode body hands ``moe_gemm``."""
    logits = torch.randn((tokens, experts), generator=gen, device="cuda")
    active = torch.zeros(experts, dtype=torch.int8, device="cuda")
    return active.scatter_(0, logits.topk(k, dim=-1).indices.reshape(-1), 1)


def check_moe_gemm(gen, report) -> dict:
    """olmoe-1b-7b's expert products: decode (C = 4 slots) with every
    expert and with the mask of a top-8 routing of 4 tokens, and a
    ``forward`` over 130 and 512 tokens (C = 130, 512: bf16's wide
    kernel), wi/wg with the broadcast x of the dense dispatch (expert
    stride 0) and wo with a per-expert x.  Bit-identical across depths;
    with the mask, the active experts' blocks are the unmasked call's bits
    and the others zeros.  The bound of a routed call counts the active
    experts' weights only; no single library call computes it."""
    from repro_torch.kernels.moe_gemm import ops
    from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref
    depth = ops.operating_point().effective_depths()[1]
    rep = None
    log(f"[kernels] moe_gemm  E    C     d     f  x  dtype  max_abs_err  ms  "
        f"plain_ms  library_ms  bound_ms  (depth {depth})")
    cases = [(dtype, c, routed) for dtype in (torch.float32, torch.bfloat16)
             for c, routed in ((4, False), (4, True), (130, False),
                               (512, False))
             if not (dtype == torch.float32 and c == 130)]
    for dtype, c, routed in cases:
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
            active = routed_mask(gen, c, e, 8) if routed else None
            n_act = int(active.sum()) if routed else e
            ref = moe_gemm_ref(x, w, active)
            outs = {k: ops.moe_gemm(x, w, depth=k, active=active)
                    for k in (1, 2, 4)}
            torch.cuda.synchronize()
            for k, o in outs.items():
                if not torch.equal(o, outs[1]):
                    raise AssertionError(
                        f"moe_gemm depth {k} differs from depth 1 at "
                        f"E={e} C={c} d={d} f={f} {dtype} routed={routed}")
            if routed:
                on = active != 0
                full = ops.moe_gemm(x, w, depth=depth)
                if not torch.equal(outs[1][on], full[on]) or \
                        not bool((outs[1][~on] == 0).all()):
                    raise AssertionError(
                        f"moe_gemm's mask changed an active expert's bits or "
                        f"left an inactive one nonzero at C={c} d={d} {dtype}")
                del full
            err = within(outs[1], ref, TOL[dtype])
            args = [(x, w.clone()) for _ in range(2)]
            make = cycling(args)
            ms = cuda_ms(make(lambda a, b: ops.moe_gemm(a, b, depth=depth,
                                                        active=active)))
            plain = cuda_ms(make(lambda a, b: moe_gemm_ref(a, b, active)),
                            iters=5)
            lib = None if routed else cuda_ms(make(torch.bmm))
            x_bytes = (c if bcast else n_act * c) * d * x.element_size()
            b_ms, b_by = bound(2.0 * n_act * c * d * f,
                               x_bytes + n_act * d * f * w.element_size()
                               + e * c * f * 4, dtype)
            del args, outs, ref
            kind = ops.regime(c, dtype)
            log(f"[kernels] moe_gemm {e:3d} {c:4d} {d:5d} {f:5d} "
                f"{'b' if bcast else 'e'} {str(dtype)[6:]:>8s} "
                f"{err:10.3e} {ms:8.4f} {plain:8.4f} "
                f"{'    none' if lib is None else f'{lib:8.4f}'} "
                f"{b_ms:8.4f} ({b_by}; {kind}"
                + (f", split {ops.split_k(e, d, f)}" if kind == "thin"
                   else "")
                + f"; {n_act} of {e} experts active"
                + (f", routed top-8 of {c} tokens" if routed else "")
                + f"; {2.0 * n_act * c * d * f / ms / 1e9:.1f} TFLOP/s, "
                f"{(x_bytes + n_act * d * f * w.element_size() + e * c * f * 4) / ms / 1e6:.0f}"
                f" GB/s"
                + (f"; {ms / lib:.2f}x library)" if lib else ")"))
            row = {"E": e, "C": c, "d": d, "f": f, "broadcast_x": bcast,
                   "dtype": str(dtype)[6:], "depth": depth, "regime": kind,
                   "routed": routed, "active": n_act,
                   "max_abs_err": err, "ms": ms, "plain_ms": plain,
                   "library_ms": lib, "bound_ms": b_ms, "bound_by": b_by}
            report.append({"kernel": "moe_gemm", **row})
            # the decode body's call: C = 4 slots over the routed experts
            if (c, d, dtype, routed) == (4, 2048, torch.bfloat16, True):
                rep = row
        free_card()
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


def check_rglru_scan(gen, report) -> dict:
    """recurrentgemma-2b's scan: width 2560, over the 512 tokens of phase
    4's ``forward`` and the 128 of phase 3's, with a and bx drawn as the
    model's gates make them.  No single PyTorch call computes it, so there
    is no library time."""
    from repro_torch.kernels.rglru_scan import ops
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
    rep = None
    log("[kernels] rglru_scan  B    T     w  dtype  max_abs_err  ms  "
        "plain_ms  bound_ms")
    for dtype in (torch.float32, torch.bfloat16):
        for b, t, w in ((1, 512, 2560), (1, 128, 2560)):
            def rnd(*shape):
                return torch.randn(shape, generator=gen, device="cuda")
            # a = exp(-8 softplus(1) r), r a sigmoid; bx = sqrt(1 - a^2) x
            a = torch.exp(-8.0 * math.log1p(math.e)
                          * torch.sigmoid(rnd(b, t, w)))
            bx = torch.sqrt(1.0 - a * a) * rnd(b, t, w)
            a, bx = a.to(dtype), bx.to(dtype)
            out = ops.rglru_scan(a, bx)
            ref = rglru_scan_ref(a, bx)
            torch.cuda.synchronize()
            err = within(out, ref, TOL[dtype])
            ms = cuda_ms(lambda: ops.rglru_scan(a, bx))
            plain = cuda_ms(lambda: rglru_scan_ref(a, bx), iters=5)
            # a multiply and an add per element; a and bx read, h written
            b_ms, b_by = bound(2.0 * b * t * w,
                               b * t * w * (2 * a.element_size() + 4),
                               torch.float32)
            log(f"[kernels] rglru_scan {b:2d} {t:4d} {w:5d} "
                f"{str(dtype)[6:]:>8s} {err:10.3e} {ms:8.4f} {plain:8.4f} "
                f"{b_ms:8.4f} ({b_by}); bit-equal to plain: "
                f"{bool(torch.equal(out, ref))}")
            row = {"B": b, "T": t, "w": w, "dtype": str(dtype)[6:],
                   "max_abs_err": err, "ms": ms, "plain_ms": plain,
                   "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
            report.append({"kernel": "rglru_scan", **row})
            if (t, dtype) == (512, torch.float32):   # the model's inputs
                rep = row
    return rep


# ---------------------------------------------------------------------------
# phase 3: full width, cut depth, card against CPU
# ---------------------------------------------------------------------------

def cut_depth(full):
    """Phase 3's cut: 2 layers, or for the hybrid family one macro block
    and the full model's tail, which keeps an attention layer, the stacked
    ``macros`` and the unstacked ``tail_*`` leaves."""
    if full.family != "hybrid":
        return dataclasses.replace(full, n_layers=2)
    pat = len(full.rglru.pattern)
    return dataclasses.replace(full, n_layers=pat + full.n_layers % pat)


def fan_in(spec) -> int:
    """The contracted width of a block matrix (after its layer axis, if it
    is stacked, and its expert axis, if any): the product of its axes but
    the last when the last is "embed" (an output projection), else its
    first axis."""
    axes, shape = list(spec.axes), list(spec.shape)
    if axes[0] == "layers":
        axes, shape = axes[1:], shape[1:]
    if axes[0] == "experts" and len(axes) > 2:
        axes, shape = axes[1:], shape[1:]
    return math.prod(shape[:-1]) if axes[-1] == "embed" else shape[0]


def redraw_scale(params, cfg, full, rule: str) -> None:
    """Rescale the kept layers' normal-drawn leaves in place.  The
    reference's initializer draws every such leaf at std 1/sqrt(its first
    axis), which for a stacked leaf is the layer axis (``n_layers``, or the
    hybrid family's ``n_full`` macro blocks) and for a hybrid tail leaf its
    input width.  "depth" gives each leaf the full-depth model's std for
    it; "fan_in" gives it 1/sqrt(fan-in) of its matrix."""
    from repro_torch.models import param_specs
    specs, full_specs = param_specs(cfg), param_specs(full)

    def walk(p, s, f):
        for k, v in p.items():
            if isinstance(v, dict):
                walk(v, s[k], f[k])
            elif s[k].init == "normal":
                std = (1 / math.sqrt(f[k].shape[0]) if rule == "depth"
                       else 1 / math.sqrt(fan_in(s[k])))
                v.mul_(std * math.sqrt(s[k].shape[0]))
    walk({k: v for k, v in params.items()
          if k == "blocks" or k == "macros" or k.startswith("tail_")},
         specs, full_specs)


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
    """The cut depth (:func:`cut_depth`) at full width: ``forward`` and 4
    ``decode_step``s on the card (fp32, kernels), on the CPU (fp32, plain
    versions) and on the CPU in fp64 (the witness), on the same seeded
    weights.  An MoE model's routing is compared first, every layer, so
    that a flipped expert is reported as a flip; a hybrid model also runs
    :func:`ring_parity`.  Failures go to ``failures``, so that one run
    reports every model."""
    from repro_torch.config import RunConfig
    from repro_torch.configs import get_config
    from repro_torch.models import (decode_step, forward, init_cache,
                                    init_model_params)
    from repro_torch.models.layers import tree_map
    full = get_config(arch)
    cfg = cut_depth(full)
    rc = RunConfig(dtype="float32", remat=False)
    rc64 = RunConfig(dtype="float64", remat=False)
    t0 = time.time()
    p_cpu = init_model_params(SEED, cfg, device="cpu")
    redraw_scale(p_cpu, cfg, full, scale)
    p_gpu = tree_map(lambda a: a.to("cuda"), p_cpu)
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 128)))
    name = f"{arch} ({cfg.n_layers} layers, {scale} scale)"
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
    del caches
    if cfg.family == "hybrid":
        ring_parity(p_gpu, p_cpu, cfg, rng, name, hold, failures)
    del p_gpu
    free_card()
    log(f"[parity] {name} done in {time.time() - t0:.1f} s")


def ring_parity(p_gpu, p_cpu, cfg, rng, name: str, hold: bool,
                failures: list) -> None:
    """The hybrid model with its window cut to ``RING_WINDOW``: a
    ``prefill_step`` of ``RING_PROMPT`` tokens into caches of
    ``RING_MAX_LEN``, whose K/V ring of ``RING_WINDOW`` slots wraps, then 4
    ``decode_step``s, on the card, on the CPU and in fp64, each held as in
    :func:`phase_parity`.  The weights are prepared once for each run
    (the head transposed, as the engine holds it), not at every body."""
    from repro_torch.config import RunConfig
    from repro_torch.models import (decode_step, init_cache, prefill_step,
                                    prepare_params)
    wcfg = dataclasses.replace(
        cfg, rglru=dataclasses.replace(cfg.rglru, window=RING_WINDOW))
    runs = {}
    for k, p, dev, dtype in (("card", p_gpu, "cuda", "float32"),
                             ("cpu", p_cpu, "cpu", "float32"),
                             ("fp64", p_cpu, "cpu", "float64")):
        rc = RunConfig(dtype=dtype, remat=False)
        runs[k] = (prepare_params(p, wcfg, rc), dev, rc)
    caches = {k: init_cache(wcfg, 2, RING_MAX_LEN, rc.dtype, device=dev)
              for k, (_, dev, rc) in runs.items()}
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (2, RING_PROMPT)))
    steps = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 4)))
    what = f"{name} window {RING_WINDOW}"
    for t in range(5):
        logits = {}
        for k, (p, dev, rc) in runs.items():
            if t == 0:
                batch = {"tokens": prompt.to(dev),
                         "n_tokens": torch.full((2,), RING_PROMPT,
                                                dtype=torch.int32).to(dev)}
                logits[k], caches[k] = prefill_step(p, caches[k], batch,
                                                    wcfg, rc)
            else:
                logits[k], caches[k] = decode_step(
                    p, caches[k], {"tokens": steps[:, t - 1:t].to(dev)},
                    wcfg, rc)
        against_witness(f"{what} prefill {RING_PROMPT} tokens" if t == 0
                        else f"{what} decode_step {t - 1} (ring wrapped)",
                        logits["card"], logits["cpu"], logits["fp64"], hold,
                        failures)


def free_card() -> None:
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 4: serve at full width
# ---------------------------------------------------------------------------

def launch_counters():
    from repro_torch.kernels import (flash_attention, moe_gemm, queue_matmul,
                                     rglru_scan, ssm_scan)
    return {"queue_matmul": queue_matmul, "flash_attention": flash_attention,
            "moe_gemm": moe_gemm, "ssm_scan": ssm_scan,
            "rglru_scan": rglru_scan}


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
    routes = []
    with routing(routes):
        step()
    torch.cuda.synchronize()
    per_body = {k: c.launches - before[k] for k, c in counters.items()
                if c.launches > before[k]}
    if cfg.moe:
        # the experts each MoE layer's mask keeps: those its slots route to
        act = [len(torch.unique(r)) for r in routes]
        log(f"[profile] {arch} active experts per MoE layer of a decode "
            f"body ({tok.shape[0]} slots, top-{cfg.moe.top_k} of "
            f"{cfg.moe.num_experts}): mean {sum(act) / len(act):.2f}, "
            f"{act}")
    t0 = time.time()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    body_ms = (time.time() - t0) / n * 1e3
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
        f"{cfg.n_layers} layers): launches {per_body}; {body_ms:.2f} ms "
        f"wall, {busy:.2f} ms in kernels ("
        + ", ".join(f"{v:.2f} {k}" for k, v in ours.items())
        + f", {busy - sum(ours.values()):.2f} other); device idle share "
        f"{1 - busy / body_ms:.3f}")
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
                   ("ssm_scan", check_ssm_scan(gen, report)),
                   ("rglru_scan", check_rglru_scan(gen, report))]
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
        log(f"[serve] launches over the {len(SERVED)} main paths: "
            f"{launches}")
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
