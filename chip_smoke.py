#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

  python3 chip_smoke.py                      # every phase, as CI runs it
  python3 chip_smoke.py --phases build,kernels --cases-out out/cases.json

Phases, each of which raises on failure (the run then exits non-zero and
prints no result):

1. build   — compile both CUDA kernels from the sources in the checkout.
2. kernels — each kernel against its plain PyTorch version on the card at
   the serve path's shapes, with its time, its bound and the time of one
   library call that computes the same function (a yardstick the port
   never calls).  ``queue_matmul`` must be bit-identical across ring depths.
3. parity  — phi3-mini-3.8b at full width, depth cut to 2 layers, fp32:
   ``forward`` and 4 ``decode_step``s on the card (kernels) against the CPU
   (plain versions) on the same seeded weights.
4. serve   — phi3-mini-3.8b, all 32 layers, bf16: the chunked-prefill
   engine serves 6 seeded requests, a token-prefill engine must give the
   same tokens, and one ``forward`` over 512 tokens runs ``flash_attention``.
   The launch counts are set to 0 before this phase and read after it.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  It imports nothing of JAX.
"""
import argparse
import dataclasses
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


def log(msg: str) -> None:
    print(msg, flush=True)


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

def check_queue_matmul(gen, report) -> dict:
    from repro_torch.kernels.queue_matmul import ops
    from repro_torch.kernels.queue_matmul.ref import matmul_ref
    rep = None
    log("[kernels] queue_matmul  M     K     N    dtype  max_abs_err  "
        "ms  plain_ms  library_ms  bound_ms")
    for dtype in (torch.float32, torch.bfloat16):
        for m in (4, 512):
            for k, n in ((3072, 3072), (3072, 8192), (3072, 32064),
                         (8192, 3072)):
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
                            f"M={m} K={k} N={n} {dtype}")
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
                del args
                log(f"[kernels] queue_matmul {m:4d} {k:5d} {n:5d} "
                    f"{str(dtype)[6:]:>8s} {err:10.3e} {ms:8.4f} {plain:8.4f} "
                    f"{lib:8.4f} {b_ms:8.4f} ({b_by})")
                row = {"M": m, "K": k, "N": n, "dtype": str(dtype)[6:],
                       "max_abs_err": err, "ms": ms, "plain_ms": plain,
                       "library_ms": lib, "bound_ms": b_ms, "bound_by": b_by}
                report.append({"kernel": "queue_matmul", **row})
                if (m, k, n, dtype) == (4, 3072, 8192, torch.bfloat16):
                    rep = row
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
    cases = [(32, 32, 512, True, None), (32, 32, 512, True, 256),
             (32, 32, 512, False, None), (32, 8, 512, True, None),
             (32, 32, 1024, True, None), (32, 32, 1024, True, 256),
             (32, 32, 1024, False, None), (32, 8, 1024, True, None),
             (32, 32, 300, True, None)]
    d = 96
    for dtype in (torch.float32, torch.bfloat16):
        for hq, hkv, s, causal, window in cases:
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


# ---------------------------------------------------------------------------
# phase 3: full width, cut depth, card against CPU
# ---------------------------------------------------------------------------

def phase_parity() -> None:
    from repro_torch.config import RunConfig
    from repro_torch.configs import get_config
    from repro_torch.models import (decode_step, forward, init_cache,
                                    init_model_params)
    from repro_torch.models.layers import tree_map
    full = get_config("phi3-mini-3.8b")
    cfg = dataclasses.replace(full, n_layers=2)
    rc = RunConfig(dtype="float32", remat=False)
    t0 = time.time()
    p_cpu = init_model_params(SEED, cfg, device="cpu")
    # the reference's initializer takes a stacked leaf's fan-in from its
    # layer axis (std 1/sqrt(n_layers)); draw the 2 kept layers at the
    # full-depth model's scale, 1/sqrt(32), not at 1/sqrt(2)
    f = math.sqrt(cfg.n_layers / full.n_layers)
    p_cpu["blocks"] = tree_map(lambda a: a * f if a.ndim > 2 else a,
                               p_cpu["blocks"])
    p_gpu = tree_map(lambda a: a.to("cuda"), p_cpu)
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 128)))
    out_gpu = forward(p_gpu, {"tokens": toks.cuda()}, cfg, rc).cpu()
    out_cpu = forward(p_cpu, {"tokens": toks}, cfg, rc)
    err = within(out_gpu, out_cpu, 2e-3)
    log(f"[parity] phi3-mini-3.8b width 3072, 2 layers, fp32: forward "
        f"B=1 S=128 logits max abs err {err:.3e} (tol 2e-3, "
        f"{used(out_gpu, out_cpu, 2e-3):.3f} of it used)")
    c_gpu = init_cache(cfg, 4, 16, torch.float32, device="cuda")
    c_cpu = init_cache(cfg, 4, 16, torch.float32, device="cpu")
    steps = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 4)))
    for t in range(4):
        tok = steps[:, t:t + 1]
        lg, c_gpu = decode_step(p_gpu, c_gpu, {"tokens": tok.cuda()}, cfg, rc)
        lc, c_cpu = decode_step(p_cpu, c_cpu, {"tokens": tok}, cfg, rc)
        err = within(lg.cpu(), lc, 2e-3)
        log(f"[parity] decode_step {t}: logits max abs err {err:.3e} "
            f"(tol 2e-3, {used(lg.cpu(), lc, 2e-3):.3f} of it used)")
    log(f"[parity] done in {time.time() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 4: serve at full width
# ---------------------------------------------------------------------------

def phase_serve() -> dict:
    from repro_torch.config import RunConfig
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.queue_matmul import queue_matmul
    from repro_torch.models import forward, init_model_params
    from repro_torch.serve import ServeEngine
    cfg = get_config("phi3-mini-3.8b")
    rc = RunConfig(dtype="bfloat16")
    t0 = time.time()
    params = init_model_params(SEED, cfg, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    log(f"[serve] phi3-mini-3.8b full width ({cfg.n_layers} layers), bf16 "
        f"weights drawn in {time.time() - t0:.1f} s")
    rng = np.random.default_rng(SEED + 1)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab,
                                             int(rng.integers(16, 65)))]
               for _ in range(6)]

    torch.cuda.reset_peak_memory_stats()
    queue_matmul.launches = 0
    flash_attention.launches = 0
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
    qm_serve = queue_matmul.launches
    log(f"[serve] chunked prefill: {len(done)} requests, {n_tok} tokens in "
        f"{wall:.2f} s wall = {n_tok / wall:.2f} tok/s; {eng._n_steps} steps; "
        f"{qm_serve} queue_matmul launches; prefill widths "
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
            raise AssertionError(f"chunked and token prefill differ on "
                                 f"request {a}: {done[a].generated} vs "
                                 f"{done_t[b].generated}")
    log(f"[serve] token prefill: same tokens for all {len(rids)} requests; "
        f"{n_tok / wall_t:.2f} tok/s wall; {tok_eng._n_steps} steps")

    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 512))).cuda()
    fa0, qm0 = flash_attention.launches, queue_matmul.launches
    t0 = time.time()
    logits = forward(eng.params, {"tokens": toks}, cfg, eng.rc)
    torch.cuda.synchronize()
    fwd_s = time.time() - t0
    if logits.shape != (1, 512, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"forward logits {tuple(logits.shape)} not "
                             f"finite")
    log(f"[serve] forward B=1 S=512: {fwd_s:.3f} s wall, "
        f"{flash_attention.launches - fa0} flash_attention and "
        f"{queue_matmul.launches - qm0} queue_matmul launches")
    counts = {"queue_matmul": queue_matmul.launches,
              "flash_attention": flash_attention.launches}
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[serve] launches on the main path: {counts}; peak memory "
        f"{peak:.2f} GiB")
    log(f"[serve] first tokens: {done[rids[0]].generated}")
    profile_decode(eng.params, eng.cache, cfg, eng.rc)
    return counts


def profile_decode(params, cache, cfg, rc, n: int = 5) -> None:
    """Wall time of one decode body over the engine's slots (host clock,
    no profiler), and the kernel time inside it (torch.profiler, CUDA
    activity only), by kernel: the device's idle share is one minus their
    ratio.  Runs after the launch counts are read."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import decode_step
    tok = torch.zeros((cache["len"].shape[0], 1), dtype=torch.long,
                      device="cuda")
    step = lambda: decode_step(params, cache, {"tokens": tok}, cfg, rc)
    step()
    torch.cuda.synchronize()
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
        log("[profile] idle share: not measured (the profiler saw no "
            "device time)")
        return
    qm = sum(v for k, v in dev.items() if "queue_matmul" in k)
    log(f"[profile] decode body ({tok.shape[0]} slots, {cfg.n_layers} "
        f"layers): {wall_ms:.2f} ms wall, {busy:.2f} ms in kernels "
        f"({qm:.2f} queue_matmul, {busy - qm:.2f} other); device idle "
        f"share {1 - busy / wall_ms:.3f}")
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
        f"python {sys.version.split()[0]}")
    t_start = time.time()
    kernels = []
    if "build" in phases:
        phase_build()
    if "kernels" in phases:
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        report = []
        kernels = [("queue_matmul", check_queue_matmul(gen, report)),
                   ("flash_attention", check_flash_attention(gen, report))]
        if args.cases_out:
            os.makedirs(os.path.dirname(os.path.abspath(args.cases_out)),
                        exist_ok=True)
            with open(args.cases_out, "w") as f:
                json.dump({"card": smi, "cases": report}, f, indent=1)
    if "parity" in phases:
        phase_parity()
    launches = phase_serve() if "serve" in phases else {}
    log(f"[done] {time.time() - t_start:.1f} s")

    where = {"queue_matmul": ("src/repro_torch/kernels/queue_matmul/csrc/"
                              "queue_matmul.cu",
                              "src/repro/kernels/queue_matmul/kernel.py:90"),
             "flash_attention": ("src/repro_torch/kernels/flash_attention/"
                                 "csrc/flash_attention.cu",
                                 "src/repro/kernels/flash_attention/"
                                 "kernel.py:63")}
    line = []
    for name, row in kernels:
        src, replaces = where[name]
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
