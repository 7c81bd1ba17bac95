#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

  python3 chip_smoke.py                      # every phase, as CI runs it
  python3 chip_smoke.py --phases build,kernels --cases-out out/cases.json

Phases, each of which raises on failure (the run then exits non-zero and
prints no result):

1. build   — compile the seven CUDA sources in the checkout (the five
   kernels, ``flash_attention_bwd`` and ``ssm_scan_bwd``), one ``nvcc``
   each, all at once.
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
   ``flash_attention`` also at head dims 80 and 200, with minicpm3's v
   head dim 64 below its q/k head dim 96, granite-moe-3b-a800m's heads
   (24 over 8, D 64), and on a query chunk at the end of a longer key
   sequence (Sk != Sq, ``q_offset``), ``ssm_scan`` also with its chunk
   states written (y's bits unchanged), ``rglru_scan`` (a chunked scan,
   whose rounding differs from the plain version's sequential walk) also
   at 4096 steps, where it walks T in segments.  The products are those
   of the served models (nemotron-4-340b's at full width: a head weight of
   4.72e9 elements, an ffn wo summing K = 73728), of granite-moe-3b-a800m
   (trained in phase 5; its vocab of 49155 is not a multiple of 8) and of
   hubert-xlarge, each held to its plain version over the whole output;
   ``flash_attention`` also at pixtral's (32 over 8 of 128), hubert's (16
   of 80, non-causal) and nemotron's heads (96 over 8 of 192).
3. parity  — phi3-mini-3.8b, olmoe-1b-7b, falcon-mamba-7b, minicpm3-4b,
   pixtral-12b (with 256 patch rows, over 512 positions) and
   hubert-xlarge (on frames) at full width, depth cut to 2 layers, and
   recurrentgemma-2b cut to 5 (one (rec, rec, attn) macro block and the
   full model's (rec, rec) tail): ``forward`` and, for the decoders, 4
   ``decode_step``s in fp32 on the card (kernels) and on the CPU (plain
   versions), and in fp64 on the CPU, on the same seeded weights
   (nemotron-4-340b has no fp64 witness: one layer is 96 GB in fp64).
   The card must be no farther from fp64 than the CPU's fp32 run (within
   ``FP64_RATIO``) and, where ``PARITY`` holds it, within 2e-3 of the fp64
   run; for olmoe every layer's top-k experts are compared first.
   recurrentgemma also prefills and decodes with its window cut to
   ``RING_WINDOW``, so that its K/V ring wraps.  The kept layers are drawn
   at the full-depth model's scale, and olmoe's also at the fan-in scale
   (see ``PARITY``).
4. serve   — phi3-mini-3.8b (32 layers), olmoe-1b-7b (16),
   falcon-mamba-7b (64), recurrentgemma-2b (26), minicpm3-4b (62, MLA),
   pixtral-12b (40) and nemotron-4-340b (2 of 96, ``SERVE_LAYERS``) at full
   width, bf16, one after the other: the chunked-prefill engine serves 6
   seeded requests, a token-prefill engine must give the same tokens, and
   one ``forward`` over 512 tokens (pixtral's with its 256 patch rows) runs
   ``flash_attention`` (and ``ssm_scan`` for falcon-mamba, ``rglru_scan``
   for recurrentgemma); then hubert-xlarge (48 layers), whose engine must
   refuse it, runs one non-causal ``forward`` over 512 frames.  Each
   model's run is its own main path: the launch counts are set to 0 just
   before it and read just after it, and every kernel of that path must
   have run.  The engine's weights (the leaves ``param_specs`` names) and
   cache must hold exactly the bytes the dry run counts for them
   (``repro_torch.launch.dryrun.device_state_bytes`` on a 1 x 1 mesh at the
   engine's slots and length).  Then a profile of a
   decode body: launches, kernel time by kernel, the device's idle share,
   and for olmoe the experts each layer's mask keeps.
4b. policy — the serve path on a calibrated operating point: the port's
   machine model calibrates a smoke grid on the host (``POLICY_CALIBRATION``,
   in-process), ``REPRO_CALIBRATION_DIR`` points at the artifacts, and the
   ``queue_matmul`` depth the table resolves must leave the default 4;
   phi3-mini-3.8b at full width and depth in bf16 is served again with phase
   4's slots, prompts and seed in measured-traffic mode: the same tokens as
   phase 4, every retarget and the report on calibrated points, each traffic
   level charged what ``StepCostModel.from_operating_point`` gives for its
   point, every ``queue_matmul`` launch at the calibrated depths (its own
   main path); then its wall and tokens/s, a profile of its decode body
   (kernel time and idle share at the calibrated depths), and
   ``repro_torch.examples.copiftv2_demo``'s depth-1 against
   depth-4 products (equal bits), each line with the card's name and power
   limit.
4c. dist  — ``repro_torch.distributed.tp_matmul`` on a one-rank NCCL group
   (started in-process from a ``HashStore``; no other backend is tried)
   and ``make_local_mesh(1, 1)``: phi3-mini-3.8b's q/k/v/o and head
   products over 1024 tokens in bf16, bulk (COPIFT: an NCCL all-gather,
   then the product) and ring (COPIFTv2), each equal bit for bit to
   ``queue_matmul`` alone, its main path's launches counted, timed beside
   ``queue_matmul`` alone; the group is destroyed at the end.
5. train   — the training path (``--train-parts`` picks among a-d):
   (a) each backward against its plain backward on the same inputs, fp32
   and bf16, equal to itself across two calls, timed with its bound and
   its library yardstick: ``flash_attention_bwd`` (o and lse from the
   forward kernel) at ``BWD_CASES``, rows that see no key with zero
   gradients, beside SDPA's backward; ``queue_matmul``'s dX and dW at
   phi3's products and granite's head over 1024 tokens; ``moe_gemm``'s
   (``MOE_BWD``: a shared and a per-expert x, with and without an expert
   mask, beside ``torch.bmm``), and ``moe_apply``'s gradients equal with
   the mask and without; ``rglru_scan``'s reverse walk at 2 x 512 x 2560
   and ``ssm_scan_bwd`` at 2 x 512 x 8192 x 16, on the chunk states its
   forward writes; (b) the loss and every gradient leaf of
   ``GRAD_PARITY``'s models at full width and cut depth (phase 3's cut),
   fp32 on the card, fp32 on the CPU and fp64 on the CPU, each leaf held
   to ``FP64_RATIO`` as phase 3 holds logits, the loss to 2e-3 of fp64;
   (c) ``FaultTolerantTrainer`` on 2-layer phi3 at full width, a fault
   injected after the first checkpoint, the replayed losses equal bit for
   bit; (d) ``TRAIN_FULL``'s models at full width (falcon-mamba-7b's and
   pixtral-12b's depth cut to fit; hubert-xlarge on frames, pixtral with
   patches), bf16 with remat and AdamW, ``FULL_STEPS`` steps of
   ``make_train_step`` each: each its own main path, the launch counts set
   to 0 just before it and read just after, every loss finite and every
   forward and backward kernel of its family (``TRAIN_KERNELS``)
   launched, the parameters and AdamW moments exactly the bytes the dry
   run counts; then its MFU, the roofline of the step's FLOPs as the dry
   run counts them on the meta device, and a profile of one step.

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
PHASES = ("build", "kernels", "parity", "serve", "policy", "dist", "train")
TRAIN_PARTS = ("a", "b", "c", "d")
#: the H100 SXM's HBM rate and peak FLOP/s by dtype, from
#: ``repro_torch.roofline`` (set in :func:`main` once the checkout's
#: package is importable)
HBM_BYTES_PER_S = PEAK_FLOPS = None
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
#: cuda_ms's sleep: cycles per second at the H100's highest SM clock (a
#: lower clock sleeps longer), and the longest sleep
SLEEP_CYCLES_PER_S, MAX_SLEEP_S = 1.98e9, 0.2
SEED = 20261016
SERVED = ("phi3-mini-3.8b", "olmoe-1b-7b", "falcon-mamba-7b",
          "recurrentgemma-2b", "minicpm3-4b", "pixtral-12b",
          "nemotron-4-340b")
#: served models cut in depth: nemotron-4-340b's embedding and head alone
#: are 18.9 GB in bf16 and each of its layers 6.9 GB, so 2 of its 96
#: layers are served (phase 2 holds every product at its full shape)
SERVE_LAYERS = {"nemotron-4-340b": 2}
#: the encoder: phase 4 runs its ``forward`` only, and its engine must
#: refuse it (no autoregressive decode, as in the reference)
ENCODERS = ("hubert-xlarge",)
#: models whose phase 2 products draw their inputs from a generator of
#: their own (``SEED`` + the offset), so that adding them left the inputs
#: of every case before them as they were
OWN_DRAWS = {"granite-moe-3b-a800m": 11, "pixtral-12b": 13,
             "nemotron-4-340b": 13, "hubert-xlarge": 13}
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
#: the 2e-3 check alone.  minicpm3's depth scale (std 1/sqrt(62)) leaves
#: its logits well conditioned (the card measured 0.017 of 2e-3 from
#: fp64), so its depth draw carries the check alone too.
PARITY = (("phi3-mini-3.8b", "depth", True),
          ("olmoe-1b-7b", "depth", False),
          ("olmoe-1b-7b", "fan_in", True),
          ("falcon-mamba-7b", "depth", True),
          ("recurrentgemma-2b", "depth", True),
          ("minicpm3-4b", "depth", True),
          ("pixtral-12b", "fan_in", True),
          ("hubert-xlarge", "depth", True))
#: draws whose decode ``PARITY`` cannot hold to ``FP64_RATIO``, logged by
#: :func:`decode_spread`, not held.  At pixtral-12b's depth scale (std
#: 1/sqrt(40) over widths of 5120-14336) a decode step's softmax sits near
#: a tie in some slots and amplifies rounding: the CPU's own fp32 distance
#: from fp64 moves about 2x with its thread count alone, and the card's
#: plain versions (cuBLAS) land farther than its kernels, so a ratio to
#: one CPU run cannot tell a kernel fault from luck there.  Its fan-in
#: draw carries the phase 3 checks (its forward at the depth scale, and
#: phase 5 (b)'s gradients, hold them)
SPREAD = (("pixtral-12b", "depth"),)
#: the CPU thread count :func:`decode_spread` adds to the default
SPREAD_THREADS = (1,)
#: phase 3's and 5 (b)'s sequence: 128 tokens, but 512 for the vision
#: model, whose 256 patch rows replace the first 256 token embeddings (at
#: S <= 256 the reference's concatenation gives the patches' 256 rows, not
#: S).  nemotron-4-340b has no CPU witness: one of its layers in fp64 is
#: 96 GB of host memory, so phase 2's products at its full shapes and phase
#: 4's gates hold it
PARITY_SEQ = {"pixtral-12b": 512}
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
                "hybrid": ("queue_matmul", "flash_attention", "rglru_scan"),
                "vlm": ("queue_matmul", "flash_attention"),
                "audio": ("queue_matmul", "flash_attention")}
#: the forward and backward launches each family's training path makes
#: (``moe_gemm_bwd`` and ``rglru_scan_bwd`` count backward calls through
#: their forward kernels' sources)
TRAIN_KERNELS = {
    "dense": ("queue_matmul", "flash_attention", "flash_attention_bwd"),
    "moe": ("queue_matmul", "flash_attention", "flash_attention_bwd",
            "moe_gemm", "moe_gemm_bwd"),
    "ssm": ("queue_matmul", "ssm_scan", "ssm_scan_bwd"),
    "hybrid": ("queue_matmul", "flash_attention", "flash_attention_bwd",
               "rglru_scan", "rglru_scan_bwd"),
    "vlm": ("queue_matmul", "flash_attention", "flash_attention_bwd"),
    "audio": ("queue_matmul", "flash_attention", "flash_attention_bwd")}
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
    # no Pallas kernel: the JAX train path differentiates the plain
    # blocked attention with XLA's autodiff
    "flash_attention_bwd": ("src/repro_torch/kernels/flash_attention/csrc/"
                            "flash_attention_bwd.cu",
                            "src/repro/models/attention.py:51"),
    # no Pallas kernel: the JAX train path differentiates the plain
    # associative scan of the Mamba block with XLA's autodiff
    "ssm_scan_bwd": ("src/repro_torch/kernels/ssm_scan/csrc/ssm_scan_bwd.cu",
                     "src/repro/models/ssm.py:96"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def host_memory() -> str:
    """The host's total and available memory (phase 3's and 5 (b)'s fp64
    witnesses of the wider models take tens of GB of it)."""
    try:
        with open("/proc/meminfo") as f:
            info = {line.split(":")[0]: int(line.split()[1]) for line in f}
        return (f"host memory {info['MemTotal'] / 2**20:.1f} GiB, "
                f"{info['MemAvailable'] / 2**20:.1f} GiB available")
    except (OSError, KeyError, ValueError, IndexError):
        return "host memory unknown"


def model_inputs(cfg, rng, batch: int, seq: int) -> dict:
    """A model's inputs from the numpy generator ``rng``, as the
    reference's tests/test_models.py ``_batch`` makes them: tokens, with
    the vision frontend's patches (0.1 of a normal draw) beside them, or
    the audio frontend's frames in their place; CPU tensors."""
    if cfg.frontend == "audio":
        return {"frames": torch.from_numpy(
            (rng.standard_normal((batch, seq, cfg.d_model)) * 0.1
             ).astype(np.float32))}
    out = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab,
                                                   (batch, seq)))}
    if cfg.frontend == "vision":
        out["patches"] = torch.from_numpy(
            (rng.standard_normal((batch, cfg.n_frontend_tokens, cfg.d_model))
             * 0.1).astype(np.float32))
    return out


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
    ``arch``'s serve path, at full width; the router runs in fp32 only.
    MLA's wuk and wuv (the latent to every head's k and v) run in the
    expanded form of ``forward`` only; its decode absorbs them."""
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
    elif cfg.mla:
        m, h = cfg.mla, cfg.n_heads
        out = [("wdq", d, m.q_lora_rank, both),
               ("wuq", m.q_lora_rank,
                h * (m.qk_nope_head_dim + m.qk_rope_head_dim), both),
               ("wdkv", d, m.kv_lora_rank + m.qk_rope_head_dim, both),
               ("wuk", m.kv_lora_rank, h * m.qk_nope_head_dim, both),
               ("wuv", m.kv_lora_rank, h * m.v_head_dim, both),
               ("o", h * m.v_head_dim, d, both),
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
    """Every product of the served models, of granite-moe-3b-a800m and of
    hubert-xlarge at M = 4 (decode over 4 slots; not the encoder's) and M =
    512 (``forward``; MLA's wuk/wuv there only), and phi3's q/k/v/o and ffn
    products also at M = 64 and 128 (the wide kernel's smallest tiles),
    bit-identical across the ring depths of ``QM_DEPTHS`` and held to the
    plain version over the whole output (nemotron-4-340b's head weight has
    4.72e9 elements, its ffn wo sums K = 73728).  A product of more than
    a TFLOP is timed over fewer calls."""
    from repro_torch.kernels.queue_matmul import ops
    from repro_torch.kernels.queue_matmul.ref import matmul_ref
    rep = None
    log("[kernels] queue_matmul  model product  M     K     N    dtype  "
        "max_abs_err  ms  plain_ms  library_ms  bound_ms")
    cases = [(arch, name, k, n, dtype)
             for arch in SERVED + ("granite-moe-3b-a800m",) + ENCODERS
             for name, k, n, dtypes in matmul_shapes(arch)
             for dtype in dtypes]
    gens = {off: torch.Generator(device="cuda").manual_seed(SEED + off)
            for off in set(OWN_DRAWS.values())}
    seen = set()                      # a shape two models share runs once
    for arch, name, k, n, dtype in cases:
        ms_ = (4, 512)
        if arch == "phi3-mini-3.8b" and name != "head":
            ms_ = (4, 64, 128, 512)
        elif name == "wuk/wuv" or arch in ENCODERS:
            ms_ = (512,)
        for m in ms_:
            if (m, k, n, dtype) in seen:
                continue
            seen.add((m, k, n, dtype))
            g = gens[OWN_DRAWS[arch]] if arch in OWN_DRAWS else gen
            x = torch.randn((m, k), generator=g, device="cuda").to(dtype)
            # scaled in place: nemotron's head is 18.9 GB in fp32
            w = torch.randn((k, n), generator=g, device="cuda").div_(
                math.sqrt(k)).to(dtype)
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
            del outs, ref
            copies = max(2, math.ceil(100e6 / (w.numel() * w.element_size())))
            args = [(x, w)] + [(x.clone(), w.clone())
                               for _ in range(copies - 1)]
            make = cycling(args)
            n_it = 3 if 2.0 * m * n * k > 1e12 else 20
            ms = cuda_ms(make(lambda a, b: ops.queue_matmul(a, b)), n_it)
            wall = wall_ms(make(lambda a, b: ops.queue_matmul(a, b)), n_it)
            host = host_ms(make(lambda a, b: ops.queue_matmul(a, b)),
                           5 * n_it)
            plain = cuda_ms(make(lambda a, b: matmul_ref(a, b).to(a.dtype)),
                            n_it)
            lib = cuda_ms(make(torch.matmul), n_it)
            b_ms, b_by = bound(2.0 * m * n * k,
                               (m * k + k * n + m * n) * x.element_size(),
                               dtype)
            del args, make, w, base   # before the next draw: heads are GBs
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
    log("[kernels] flash_attention  B  Hq Hkv   Sq    Sk   D  Dv causal "
        "window q_off  dtype  max_abs_err  ms  plain_ms  library_ms  "
        "bound_ms")
    # phi3's heads (32 of 96), olmoe's (16 of 128) and recurrentgemma's (10
    # of 256 over one KV head, window 2048), at the 512 tokens of phase 4's
    # ``forward`` and the 128 of phase 3's; granite's (24 of 64 over 8) at
    # 512; windows, GQA, longer and ragged
    # sequences at phi3's width, and recurrentgemma's at 4096 tokens, where
    # its window bites; head dims 80 and 200 (padded to 16 in the kernel);
    # a query chunk at the end of a longer key sequence (Sk != Sq,
    # q_offset), as a chunked prefill would give it; minicpm3's MLA heads
    # (40 of q/k 96 and v 64) at phase 4's and phase 3's lengths
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
    cases = [c + (c[4],) for c in cases] + [
        (40, 40, 512, 512, 96, True, None, 0, 64),
        (40, 40, 128, 128, 96, True, None, 0, 64)]
    # granite's heads draw from a generator of their own (see
    # check_queue_matmul)
    extra = torch.Generator(device="cuda").manual_seed(SEED + 12)
    trained = [(24, 8, 512, 512, 64, True, None, 0, 64)]
    # pixtral's heads (32 over 8 of 128), hubert's (16 of 80, both ways)
    # and nemotron's (96 over 8 of 192: no compiled-in case, the generic
    # 256-wide code) at phase 4's 512 tokens, from a generator of their own
    latest = torch.Generator(device="cuda").manual_seed(SEED + 14)
    registry = [(32, 8, 512, 512, 128, True, None, 0, 128),
                (16, 16, 512, 512, 80, False, None, 0, 80),
                (96, 8, 512, 512, 192, True, None, 0, 192)]
    for dtype in (torch.float32, torch.bfloat16):
        for case in cases + trained + registry:
            hq, hkv, sq, sk, d, causal, window, q_off, dv = case
            g = (extra if case in trained else latest if case in registry
                 else gen)
            q = torch.randn((1, hq, sq, d), generator=g, device="cuda").to(dtype)
            k = torch.randn((1, hkv, sk, d), generator=g, device="cuda").to(dtype)
            v = torch.randn((1, hkv, sk, dv), generator=g, device="cuda").to(dtype)

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
            # QK^T over D and PV over Dv, 2 operations a multiply-add
            flops = 2.0 * hq * pairs * (d + dv)
            b_ms, b_by = bound(flops, (hq * sq + hkv * sk) * (d + dv)
                               * q.element_size(), dtype)
            log(f"[kernels] flash_attention  1 {hq:3d} {hkv:3d} {sq:5d} "
                f"{sk:5d} {d:3d} {dv:3d} {int(causal):6d} {str(window):>6s} "
                f"{q_off:5d} {str(dtype)[6:]:>8s} {err:10.3e} {ms:8.4f} "
                f"{plain:8.4f} {lib:8.4f} {b_ms:8.4f} ({b_by}; "
                f"{ms / lib:.2f}x library; "
                f"{flops / ms / 1e9:.1f} TFLOP/s; "
                f"wall {wall:.4f})")
            row = {"B": 1, "Hq": hq, "Hkv": hkv, "Sq": sq, "Sk": sk, "D": d,
                   "Dv": dv, "causal": causal, "window": window, "q_offset": q_off,
                   "dtype": str(dtype)[6:], "max_abs_err": err, "ms": ms,
                   "wall_ms": wall, "plain_ms": plain, "library_ms": lib,
                   "bound_ms": b_ms, "bound_by": b_by}
            report.append({"kernel": "flash_attention", **row})
            if (hq, hkv, sq, causal, window, d, dtype) == (
                    32, 32, 512, True, None, 96, torch.bfloat16):
                rep = row
    return rep


# ---------------------------------------------------------------------------
# phase 5 (a): the training path's kernels against their plain versions
# ---------------------------------------------------------------------------

#: phase 5's backward cases: (B, Hq, Hkv, Sq, Sk, D, Dv, causal, window):
#: phi3's heads at 2 x 512 tokens, granite's (24 over 8 of 64) there too,
#: GQA 32 over 8, recurrentgemma-like heads of 256 with window 128,
#: minicpm3's MLA heads (v 64 under q/k 96), a non-causal window over fewer
#: keys than queries, so that the rows from Sk - 1 + window on see no key,
#: hubert's heads (16 of 80, non-causal) and pixtral's (32 over 8 of 128)
#: at 2 x 512 tokens
BWD_CASES = ((2, 32, 32, 512, 512, 96, 96, True, None),
             (2, 24, 8, 512, 512, 64, 64, True, None),
             (1, 32, 8, 512, 512, 128, 128, True, None),
             (1, 10, 1, 512, 512, 256, 256, True, 128),
             (1, 40, 40, 512, 512, 96, 64, True, None),
             (1, 4, 2, 512, 128, 96, 96, False, 64),
             (2, 16, 16, 512, 512, 80, 80, False, None),
             (2, 32, 8, 512, 512, 128, 128, True, None))
#: the cases of the models trained since the list began (hubert-xlarge,
#: non-causal at head dim 80; pixtral-12b), drawn from a generator of their
#: own, so the earlier cases and every later check keep their inputs
BWD_OWN = BWD_CASES[6:]


def _sdpa_bwd(q, k, v, do, causal, window):
    """The backward of one ``scaled_dot_product_attention`` call on the
    same inputs (GQA's K and V repeated, a mask where windowed): the
    yardstick for ``flash_attention_bwd``.  Returns a call that runs it."""
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    out = _sdpa(qg, kg, vg, causal, window, 0)
    return lambda: torch.autograd.grad(out, (qg, kg, vg), do,
                                       retain_graph=True)


def check_flash_attention_bwd(gen, report) -> dict:
    """The backward kernel against :func:`attention_bwd_ref` (through the
    wrapper's plain GQA path) on the same q, k, v, o, lse and dO, o and lse
    from the forward kernel, at ``BWD_CASES`` in fp32 and bf16; two calls
    must give the same bits, and rows that see no key zero gradients."""
    from repro_torch.kernels.flash_attention import ops
    rep = None
    log("[train] flash_attention_bwd  B  Hq Hkv   Sq   Sk   D  Dv causal "
        "window  dtype  max_abs_err  ms  plain_ms  library_ms  bound_ms")
    own = torch.Generator(device="cuda").manual_seed(SEED + 15)
    for dtype in (torch.float32, torch.bfloat16):
        for case in BWD_CASES:
            b, hq, hkv, sq, sk, d, dv, causal, window = case
            g = own if case in BWD_OWN else gen

            def rnd(*shape):
                return torch.randn(shape, generator=g, device="cuda").to(
                    dtype)
            q, k, v = rnd(b, hq, sq, d), rnd(b, hkv, sk, d), rnd(b, hkv, sk, dv)
            do = rnd(b, hq, sq, dv)
            o, lse = ops._launch(q, k, v, causal, window, 0, with_lse=True)

            def run():
                return ops.flash_attention_bwd(q, k, v, o, lse, do,
                                               causal=causal, window=window)
            got, again = run(), run()
            ref = ops._plain_bwd(q, k, v, o, lse, do, causal, window)
            torch.cuda.synchronize()
            for name, x, y in zip(("dq", "dk", "dv"), got, again):
                if not torch.equal(x, y):
                    raise AssertionError(f"flash_attention_bwd {name} differs "
                                         f"between two calls")
            err = max(within(x, r, TOL[dtype]) for x, r in zip(got, ref))
            keep = _keep(sq, sk, causal, window, 0, "cuda")
            empty = ~keep.any(-1)
            if bool(empty.any()):
                if not bool((got[0][:, :, empty] == 0).all()) or not all(
                        bool(torch.isfinite(x).all()) for x in got):
                    raise AssertionError("flash_attention_bwd: rows with no "
                                         "key in range got nonzero or "
                                         "non-finite gradients")
            ms = cuda_ms(run)
            plain = cuda_ms(lambda: ops._plain_bwd(q, k, v, o, lse, do,
                                                   causal, window), iters=3)
            lib = cuda_ms(_sdpa_bwd(q, k, v, do, causal, window))
            pairs = int(keep.sum()) * b * hq
            # S and dQ, dK over D; dP, dV over Dv
            flops = 2.0 * pairs * (3 * d + 2 * dv)
            es = q.element_size()
            nbytes = (b * hq * sq * (2 * d + 2 * dv) * es    # q, o, dO, dQ
                      + b * hkv * sk * 2 * (d + dv) * es     # k, v, dK, dV
                      + b * hq * sq * 4)                     # lse
            b_ms, b_by = bound(flops, nbytes, dtype)
            t_ops = flops / PEAK_FLOPS[dtype] * 1e3
            t_mem = nbytes / HBM_BYTES_PER_S * 1e3
            n_empty = int(empty.sum())
            log(f"[train] flash_attention_bwd {b:2d} {hq:3d} {hkv:3d} "
                f"{sq:4d} {sk:4d} {d:3d} {dv:3d} {int(causal):6d} "
                f"{str(window):>6s} {str(dtype)[6:]:>8s} {err:10.3e} "
                f"{ms:8.4f} {plain:8.4f} {lib:8.4f} {b_ms:8.4f} ({b_by}: "
                f"ops {t_ops:.4f}, bytes {t_mem:.4f}; "
                f"{ms / lib:.2f}x library; {flops / ms / 1e9:.1f} TFLOP/s"
                + (f"; {n_empty} rows see no key: zero gradients"
                   if n_empty else "") + "; deterministic)")
            row = {"B": b, "Hq": hq, "Hkv": hkv, "Sq": sq, "Sk": sk, "D": d,
                   "Dv": dv, "causal": causal, "window": window,
                   "dtype": str(dtype)[6:], "max_abs_err": err, "ms": ms,
                   "plain_ms": plain, "library_ms": lib, "bound_ms": b_ms,
                   "bound_by": b_by}
            report.append({"kernel": "flash_attention_bwd", **row})
            if (b, hq, sq, d, dtype) == (2, 32, 512, 96, torch.bfloat16):
                rep = row
            del got, again, ref
        free_card()
    return rep


def check_queue_matmul_grads(gen, report) -> None:
    """``queue_matmul``'s backward (dX = dY W^T and dW = X^T dY, both
    through the kernel) against the autograd of :func:`matmul_ref`, at
    phi3's products and granite's head (49155 columns, not a multiple of
    8) over 2 x 512 tokens, fp32 and bf16; dW's rows are K,
    so in bf16 both products take the wide kernel.  Times: the two
    products with their transposes, and ``torch.matmul``'s two."""
    from repro_torch.kernels.queue_matmul import ops
    from repro_torch.kernels.queue_matmul.ref import matmul_ref
    log("[train] queue_matmul grads  M     K     N  dtype  dX err  dW err  "
        "dX ms  dW ms  library dX, dW ms  bound ms (each)")
    m = 1024
    for dtype in (torch.float32, torch.bfloat16):
        for k, n in ((3072, 3072), (3072, 8192), (8192, 3072),
                     (3072, 32064), (1536, 49155)):
            x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
            w = (torch.randn((k, n), generator=gen, device="cuda")
                 / math.sqrt(k)).to(dtype)
            dy = torch.randn((m, n), generator=gen, device="cuda").to(dtype)
            xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
            dx, dw = torch.autograd.grad(ops.queue_matmul(xg, wg), (xg, wg),
                                         dy)
            xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
            rx, rw = torch.autograd.grad(matmul_ref(xr, wr).to(dtype),
                                         (xr, wr), dy)
            torch.cuda.synchronize()
            ex, ew = within(dx, rx, TOL[dtype]), within(dw, rw, TOL[dtype])
            ms_x = cuda_ms(lambda: ops.queue_matmul(dy, w.t().contiguous()))
            ms_w = cuda_ms(lambda: ops.queue_matmul(x.t().contiguous(), dy))
            lib_x = cuda_ms(lambda: torch.matmul(dy, w.t()))
            lib_w = cuda_ms(lambda: torch.matmul(x.t(), dy))
            # either product reads two of x, w, dy and writes the third
            b_ms, b_by = bound(2.0 * m * k * n,
                               (m * k + k * n + m * n) * x.element_size(),
                               dtype)
            log(f"[train] queue_matmul grads {m:5d} {k:5d} {n:5d} "
                f"{str(dtype)[6:]:>8s} {ex:.3e} {ew:.3e} {ms_x:8.4f} "
                f"{ms_w:8.4f} {lib_x:8.4f} {lib_w:8.4f} {b_ms:8.4f} "
                f"({b_by}; {2.0 * m * k * n / ms_x / 1e9:.1f}, "
                f"{2.0 * m * k * n / ms_w / 1e9:.1f} TFLOP/s)")
            report.append({"kernel": "queue_matmul_grads", "M": m, "K": k,
                           "N": n, "dtype": str(dtype)[6:], "dx_err": ex,
                           "dw_err": ew, "dx_ms": ms_x, "dw_ms": ms_w,
                           "library_dx_ms": lib_x, "library_dw_ms": lib_w,
                           "bound_ms": b_ms, "bound_by": b_by})
            del x, w, dy, dx, dw, rx, rw, xg, wg, xr, wr
        free_card()


#: phase 5 (a)'s expert products at 2 x 512 tokens: (model, E, d, f); the
#: shared x is wi/wg's (C, d) against (E, d, f), the per-expert x wo's
#: (E, C, f) against (E, f, d)
MOE_BWD = (("granite-moe-3b-a800m", 40, 1536, 512),
           ("olmoe-1b-7b", 64, 2048, 1024))


def check_moe_gemm_bwd(gen, report) -> None:
    """``moe_gemm_bwd`` (dX and dW, two grouped products through the
    forward's kernels) against :func:`moe_gemm_bwd_ref` on the same x, w
    and dY at ``MOE_BWD``'s products over 1024 tokens, fp32 and bf16, with
    every expert and with the mask of a top-8 routing of 4 tokens (the
    active experts' dW and per-expert dX equal to the unmasked call's, the
    others zeros); equal across two calls.  The yardstick is ``torch.bmm``
    on the same two products (and the sum over experts for a shared x)."""
    from repro_torch.kernels.moe_gemm import ops
    from repro_torch.kernels.moe_gemm.ref import moe_gemm_bwd_ref
    depth = ops.operating_point().effective_depths()[1]
    c = 1024
    log(f"[train] moe_gemm_bwd  model  E     C     K     N  x  masked  dtype  "
        f"max_abs_err  ms  plain_ms  library_ms  bound_ms  (depth {depth})")
    for dtype in (torch.float32, torch.bfloat16):
        for arch, e, d, f in MOE_BWD:
            for shared in (True, False):
                k, n = (d, f) if shared else (f, d)
                x = torch.randn((c, k) if shared else (e, c, k),
                                generator=gen, device="cuda").to(dtype)
                w = (torch.randn((e, k, n), generator=gen, device="cuda")
                     / math.sqrt(k)).to(dtype)
                dy = torch.randn((e, c, n), generator=gen, device="cuda"
                                 ).to(dtype)
                full = None
                for masked in (False, True):
                    active = routed_mask(gen, 4, e, 8) if masked else None
                    n_act = int(active.sum()) if masked else e

                    def run():
                        return ops.moe_gemm_bwd(x, w, dy, depth=depth,
                                                active=active)
                    got, again = run(), run()
                    ref = moe_gemm_bwd_ref(x, w, dy, active)
                    torch.cuda.synchronize()
                    for name, a, b in zip(("dx", "dw"), got, again):
                        if not torch.equal(a, b):
                            raise AssertionError(f"moe_gemm_bwd {name} "
                                                 f"differs between two calls")
                    err = max(within(a, r, TOL[dtype])
                              for a, r in zip(got, ref))
                    if masked:
                        # dW's blocks, and a per-expert x's dX blocks (a
                        # shared x's dX is their sum)
                        on = active != 0
                        pairs = [(got[1], full[1])] + (
                            [] if shared else [(got[0], full[0])])
                        if not all(torch.equal(a[on], b[on]) and
                                   bool((a[~on] == 0).all())
                                   for a, b in pairs):
                            raise AssertionError(
                                f"moe_gemm_bwd's mask changed an active "
                                f"expert's bits or left an inactive one "
                                f"nonzero ({arch} {dtype})")
                    else:
                        full = got
                    del again, ref
                    ms = cuda_ms(run)
                    plain = cuda_ms(lambda: moe_gemm_bwd_ref(x, w, dy,
                                                             active),
                                    iters=3, warmup=1)
                    lib = None
                    if not masked:
                        xe = x.expand(e, c, k) if shared else x

                        def library():
                            gx = torch.bmm(dy, w.transpose(1, 2))
                            return (gx.sum(0) if shared else gx,
                                    torch.bmm(xe.transpose(1, 2), dy))
                        lib = cuda_ms(library)
                    es = x.element_size()
                    flops = 2 * 2.0 * n_act * c * k * n
                    nbytes = ((c * k if shared else n_act * c * k) * es
                              + n_act * (k * n + c * n) * es
                              + (c * k if shared else e * c * k) * 4
                              + e * k * n * 4)
                    b_ms, b_by = bound(flops, nbytes, dtype)
                    kind = ops.regime(c, dtype)
                    log(f"[train] moe_gemm_bwd {arch.split('-')[0]:>7s} "
                        f"{e:3d} {c:5d} {k:5d} {n:5d} "
                        f"{'b' if shared else 'e'} {int(masked):6d} "
                        f"{str(dtype)[6:]:>8s} {err:10.3e} {ms:8.4f} "
                        f"{plain:8.4f} "
                        f"{'    none' if lib is None else f'{lib:8.4f}'} "
                        f"{b_ms:8.4f} ({b_by}; {kind}; {n_act} of {e} "
                        f"experts; {flops / ms / 1e9:.1f} TFLOP/s"
                        + (f"; {ms / lib:.2f}x library" if lib else "")
                        + "; deterministic)")
                    report.append({
                        "kernel": "moe_gemm_bwd", "model": arch, "E": e,
                        "C": c, "K": k, "N": n, "shared_x": shared,
                        "masked": masked, "active": n_act,
                        "dtype": str(dtype)[6:], "max_abs_err": err,
                        "ms": ms, "plain_ms": plain, "library_ms": lib,
                        "bound_ms": b_ms, "bound_by": b_by})
                    del got
                del x, w, dy, full
                free_card()


def check_moe_apply_grad_mask() -> None:
    """``moe_apply``'s gradients (x and every leaf of the layer) on
    granite-moe-3b-a800m's first layer at full width, bf16, over 4 tokens
    (about half the experts routed): the same bits with the expert mask as
    with every expert computed."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_model_params, moe
    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m"), n_layers=1)
    p = init_model_params(SEED, cfg, device="cuda")["blocks"]["ffn"]
    p = {k: v[0].to(torch.bfloat16).requires_grad_() for k, v in p.items()}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    x = (torch.randn((1, 4, cfg.d_model), generator=gen, device="cuda")
         * 0.3).bfloat16().requires_grad_()
    dout = torch.randn((1, 4, cfg.d_model), generator=gen,
                       device="cuda").bfloat16()
    leaves = [x, *p.values()]
    routed = torch.autograd.grad(moe.moe_apply(p, x, cfg), leaves, dout)
    real = moe.moe_gemm
    moe.moe_gemm = lambda *a, active=None, **k: real(*a, **k)
    try:
        every = torch.autograd.grad(moe.moe_apply(p, x, cfg), leaves, dout)
    finally:
        moe.moe_gemm = real
    torch.cuda.synchronize()
    for name, a, b in zip(["x", *p], routed, every):
        if not torch.equal(a, b):
            raise AssertionError(f"moe_apply's gradient of {name} changes "
                                 f"with the expert mask")
    log(f"[train] moe_apply gradients (granite layer 0, 4 tokens, bf16): "
        f"the same bits with the expert mask as with every expert, on "
        f"x and {', '.join(p)}")
    del p, x, routed, every
    free_card()


def check_rglru_scan_bwd(gen, report) -> dict:
    """``rglru_scan_bwd`` (the kernel's reverse walk) against
    :func:`rglru_scan_bwd_ref` on the forward kernel's h at
    recurrentgemma's 2 x 512 x 2560, a in fp32 and bf16, g fp32; equal
    across two calls.  No single PyTorch call computes it."""
    from repro_torch.kernels.rglru_scan import ops
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_bwd_ref
    rep = None
    log("[train] rglru_scan_bwd  B    T     w  dtype  max_abs_err  ms  "
        "plain_ms  bound_ms")
    b, t, w = 2, 512, 2560
    for dtype in (torch.float32, torch.bfloat16):
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda")
        a = torch.exp(-8.0 * math.log1p(math.e)
                      * torch.sigmoid(rnd(b, t, w)))
        bx = (torch.sqrt(1.0 - a * a) * rnd(b, t, w)).to(dtype)
        a, g = a.to(dtype), rnd(b, t, w)
        h = ops.rglru_scan(a, bx)

        def run():
            return ops.rglru_scan_bwd(a, h, g)
        got, again = run(), run()
        ref = rglru_scan_bwd_ref(a, h, g)
        torch.cuda.synchronize()
        for name, x, y in zip(("da", "dbx"), got, again):
            if not torch.equal(x, y):
                raise AssertionError(f"rglru_scan_bwd {name} differs "
                                     f"between two calls")
        err = max(within(x, r, TOL[dtype]) for x, r in zip(got, ref))
        ms = cuda_ms(run)
        plain = cuda_ms(lambda: rglru_scan_bwd_ref(a, h, g), iters=3,
                        warmup=1)
        # a (its dtype), g and h in, da and dbx out (fp32); an FMA and a
        # multiply an element
        b_ms, b_by = bound(3.0 * b * t * w,
                           b * t * w * (a.element_size() + 16),
                           torch.float32)
        log(f"[train] rglru_scan_bwd {b:2d} {t:4d} {w:5d} "
            f"{str(dtype)[6:]:>8s} {err:10.3e} {ms:8.4f} {plain:8.4f} "
            f"{b_ms:8.4f} ({b_by}; {b_ms / ms:.2f} of the bound; "
            f"deterministic)")
        row = {"B": b, "T": t, "w": w, "dtype": str(dtype)[6:],
               "max_abs_err": err, "ms": ms, "plain_ms": plain,
               "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
        report.append({"kernel": "rglru_scan_bwd", **row})
        if dtype == torch.float32:            # the model's inputs
            rep = row
        del got, again, ref
    return rep


def check_ssm_scan_bwd(gen, report) -> dict:
    """``ssm_scan_bwd`` against :func:`ssm_scan_bwd_ref` at falcon-mamba's
    2 x 512 x 8192 x 16 on the chunk states the forward writes (whose y
    must keep its bits), fp32 and bf16 inputs, dy fp32; equal across two
    calls.  No single PyTorch call computes it."""
    from repro_torch.kernels.ssm_scan import ops
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref
    rep = None
    log("[train] ssm_scan_bwd  B    T     d   N  dtype  max_abs_err  ms  "
        "plain_ms  bound_ms")
    b, t, d, n = 2, 512, 8192, 16
    for dtype in (torch.float32, torch.bfloat16):
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda")
        x = (rnd(b, t, d) * 0.5).to(dtype)
        dt = torch.nn.functional.softplus(rnd(b, t, d) - 1.0).to(dtype)
        A = -torch.exp(rnd(d, n) * 0.5)
        Bm, C, dy = rnd(b, t, n).to(dtype), rnd(b, t, n).to(dtype), \
            rnd(b, t, d)
        y, states = ops.ssm_scan_states(x, dt, A, Bm, C)
        if not torch.equal(y, ops.ssm_scan(x, dt, A, Bm, C)):
            raise AssertionError("ssm_scan: writing the chunk states "
                                 "changed y")

        def run():
            return ops.ssm_scan_bwd(x, dt, A, Bm, C, dy, states)
        got, again = run(), run()
        ref = ssm_scan_bwd_ref(x, dt, A, Bm, C, dy)
        torch.cuda.synchronize()
        for name, u, v in zip(("dx", "ddt", "dA", "dB", "dC"), got, again):
            if not torch.equal(u, v):
                raise AssertionError(f"ssm_scan_bwd {name} differs between "
                                     f"two calls")
        errs = [within(u, r, TOL[dtype]) for u, r in zip(got, ref)]
        ms = cuda_ms(run)
        plain = cuda_ms(lambda: ssm_scan_bwd_ref(x, dt, A, Bm, C, dy),
                        iters=2, warmup=1)
        es = x.element_size()
        # per (b, t, channel, n): the state h_t (dt*A, exp, two products,
        # an add: 5) and the gradient terms (dh, the dC and dB products,
        # the B and A sums, e h_{t-1}, dA's update and the carry: 14); the
        # reads once (x, dt, B, C, dy, A, the chunk states), the gradients
        # written once
        flops = 19.0 * b * t * d * n
        nbytes = (2 * b * t * d * es + 2 * b * t * n * es + b * t * d * 4
                  + d * n * 4 + states.numel() * 4
                  + 2 * b * t * d * 4 + d * n * 4 + 2 * b * t * n * 4)
        b_ms, b_by = bound(flops, nbytes, torch.float32)
        log(f"[train] ssm_scan_bwd {b:2d} {t:4d} {d:5d} {n:3d} "
            f"{str(dtype)[6:]:>8s} {max(errs):10.3e} {ms:8.4f} "
            f"{plain:8.4f} {b_ms:8.4f} ({b_by}; errors dx, ddt, dA, dB, dC "
            + ", ".join(f"{e:.2e}" for e in errs)
            + f"; {b_ms / ms:.3f} of the bound; deterministic)")
        row = {"B": b, "T": t, "d": d, "N": n, "dtype": str(dtype)[6:],
               "max_abs_err": max(errs), "ms": ms, "plain_ms": plain,
               "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
        report.append({"kernel": "ssm_scan_bwd", **row})
        if dtype == torch.bfloat16:           # the model's inputs
            rep = row
        del got, again, ref, states
        free_card()
    return rep


# ---------------------------------------------------------------------------
# phase 5 (b)-(d): gradients at cut depth, the trainer, the slice at full
# width
# ---------------------------------------------------------------------------

#: the models phase 5 (b) takes gradients of at full width and phase 3's
#: cut depth (2 layers; recurrentgemma one macro block and its (rec, rec)
#: tail, so the tail runs outside remat), and the scale their kept layers
#: are drawn at (see ``PARITY``: at olmoe's depth scale fp32 itself misses
#: fp64, so its fan-in draw carries the check)
GRAD_PARITY = (("phi3-mini-3.8b", "depth"), ("minicpm3-4b", "depth"),
               ("olmoe-1b-7b", "fan_in"), ("falcon-mamba-7b", "depth"),
               ("recurrentgemma-2b", "depth"), ("pixtral-12b", "depth"),
               ("hubert-xlarge", "depth"))
#: phase 5 (c): steps, checkpoint interval and the step an injected fault
#: hits (so steps 5-7 run twice); phase 5 (d): steps at full width
TRAINER_STEPS, TRAINER_EVERY, TRAINER_FAULT = 12, 5, 8
FULL_STEPS = 6
#: phase 5 (d)'s models: (arch, layers or None for the full depth).
#: falcon-mamba-7b's 64 layers (7.27 B parameters, 108 GiB of fp32
#: parameters, gradients and AdamW moments) do not fit one 80 GB card; 32
#: layers (3.90 B) do.  pixtral-12b's 40 layers need 182.5 GiB of that
#: state; 10 layers (4.07 B parameters, 1.34 B of them its embedding and
#: head) need 60.6 GiB, beside falcon-mamba-7b's 58.1 at 32 layers
TRAIN_FULL = (("phi3-mini-3.8b", None), ("granite-moe-3b-a800m", None),
              ("recurrentgemma-2b", None), ("falcon-mamba-7b", 32),
              ("hubert-xlarge", None), ("pixtral-12b", 10))


def phase_grad_parity(arch: str, scale: str, failures: list) -> None:
    """The loss and every gradient leaf of phase 3's cut depth at full
    width (drawn as phase 3 draws them, at ``scale``), remat on, in fp32 on
    the card (the kernels and their backward kernels), in fp32 on the CPU
    and in fp64 on the CPU (the witness).  Each leaf's RMS distance from
    fp64 on the card must be at most ``FP64_RATIO`` times the CPU fp32
    run's, and the loss within 2e-3 of fp64."""
    from repro_torch.config import RunConfig
    from repro_torch.configs import get_config
    from repro_torch.models import init_model_params
    from repro_torch.models.layers import tree_map
    from repro_torch.models.layers import tree_leaves
    from repro_torch.train.step import _grads
    full = get_config(arch)
    cfg = cut_depth(full)
    t0 = time.time()
    p_cpu = init_model_params(SEED, cfg, device="cpu")
    redraw_scale(p_cpu, cfg, full, scale)
    rng = np.random.default_rng(SEED + 2)
    if cfg.frontend:
        seq = PARITY_SEQ.get(arch, 128)
        batch = model_inputs(cfg, rng, 1, seq)
        batch["labels"] = torch.from_numpy(rng.integers(0, cfg.vocab,
                                                        (1, seq)))
        log(f"[train] {arch} gradients on {sorted(batch)} ({seq} "
            f"positions); {host_memory()}")
    else:
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 129)))
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    runs = {}
    for name, dev, dtype in (("card", "cuda", "float32"),
                             ("cpu", "cpu", "float32"),
                             ("fp64", "cpu", "float64")):
        p = tree_map(lambda a: a.to(dev, torch.float64 if dtype == "float64"
                                    else a.dtype), p_cpu)
        b = {k: v.to(dev) for k, v in batch.items()}
        g, m = _grads(p, b, cfg, RunConfig(dtype=dtype, remat=True))
        runs[name] = (float(m["loss"]), [x.cpu() for x in tree_leaves(g)])
        del p, g
        free_card()
    names = _leaf_names(p_cpu)
    what = f"{arch} ({cfg.n_layers} layers, {scale} scale) gradients"
    loss = {k: v[0] for k, v in runs.items()}
    log(f"[train] {what}: loss card {loss['card']:.7f}, CPU fp32 "
        f"{loss['cpu']:.7f}, fp64 {loss['fp64']:.7f} (card off fp64 by "
        f"{abs(loss['card'] - loss['fp64']):.3e})")
    if abs(loss["card"] - loss["fp64"]) > 2e-3:
        failures.append(f"{what}: loss {loss['card']} is more than 2e-3 "
                        f"from fp64's {loss['fp64']}")
    worst = 0.0
    for name, card, cpu, exact in zip(names, runs["card"][1],
                                      runs["cpu"][1], runs["fp64"][1]):
        r_card, r_cpu = rms(card, exact), rms(cpu, exact)
        ratio = r_card / r_cpu if r_cpu > 0 else (0.0 if r_card == 0
                                                  else math.inf)
        worst = max(worst, ratio)
        log(f"[train]   {name:>22s}: from fp64 card rms {r_card:.3e}, CPU "
            f"fp32 rms {r_cpu:.3e} (card/CPU {ratio:.3f}); fp64 rms "
            f"{exact.pow(2).mean().sqrt().item():.3e}")
        if ratio > FP64_RATIO:
            failures.append(f"{what}: leaf {name} is {ratio:.2f} times "
                            f"farther from fp64 on the card than on the CPU")
    log(f"[train] {what}: worst card/CPU rms ratio {worst:.3f} (at most "
        f"{FP64_RATIO}); done in {time.time() - t0:.1f} s")


def _leaf_names(tree, prefix: str = "") -> list:
    """The leaves' paths in the optimizer's (sorted key) order."""
    if not isinstance(tree, dict):
        return [prefix]
    return [n for k in sorted(tree)
            for n in _leaf_names(tree[k], f"{prefix}/{k}" if prefix else k)]


def phase_trainer() -> None:
    """``FaultTolerantTrainer`` on phi3-mini-3.8b at full width, 2 layers,
    ``RunConfig`` defaults (bf16, remat), ``TRAINER_STEPS`` steps with a
    checkpoint every ``TRAINER_EVERY`` and an ``InjectedFault`` at step
    ``TRAINER_FAULT``: exactly one restart, and the replayed steps' losses
    equal the first pass's bit for bit.  The checkpoints go to a directory
    under ``build/`` that is removed afterwards."""
    import shutil
    import tempfile
    from repro_torch.config import RunConfig, ShapeConfig
    from repro_torch.configs import get_config
    from repro_torch.models import init_model_params
    from repro_torch.runtime import FaultTolerantTrainer, InjectedFault
    cfg = cut_depth(get_config("phi3-mini-3.8b"))
    shape = ShapeConfig("smoke", 256, 2, "train")
    faults = {TRAINER_FAULT}

    def fault_hook(step):
        if step in faults:
            faults.discard(step)
            raise InjectedFault(f"device loss @ {step}")

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="trainer_ckpt_",
                            dir=os.path.join(ROOT, "build"))
    t0 = time.time()
    try:
        params = init_model_params(SEED, cfg, device="cuda")
        tr = FaultTolerantTrainer(cfg, shape, RunConfig(), "cuda", ckpt,
                                  ckpt_every=TRAINER_EVERY,
                                  fault_hook=fault_hook)
        out = tr.run(params, num_steps=TRAINER_STEPS)
        tr.ckpt.close()
        saved = sorted(d for d in os.listdir(ckpt) if d.startswith("step_"))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    seen = {}
    for step, loss in out["metrics"]:
        seen.setdefault(step, []).append(loss)
    replayed = {s: v for s, v in seen.items() if len(v) > 1}
    log(f"[train] trainer: phi3-mini-3.8b {cfg.n_layers} layers, seq "
        f"{shape.seq_len} batch {shape.global_batch}, bf16 remat; "
        f"{out['restarts']} restart(s), ended at step {out['step']} in "
        f"{time.time() - t0:.1f} s; checkpoints {saved}; losses "
        + ", ".join(f"{s}: " + " / ".join(f"{x:.9g}" for x in v)
                    for s, v in sorted(seen.items())))
    want = list(range(TRAINER_EVERY, TRAINER_FAULT))
    if out["restarts"] != 1 or out["step"] != TRAINER_STEPS or \
            sorted(replayed) != want:
        raise AssertionError(f"trainer: {out['restarts']} restarts, ended "
                             f"at {out['step']}, replayed {sorted(replayed)}"
                             f" (want 1, {TRAINER_STEPS}, {want})")
    for s, v in replayed.items():
        if v[0] != v[1] or not math.isfinite(v[0]):
            raise AssertionError(f"trainer: step {s}'s replayed loss {v[1]!r}"
                                 f" is not the first pass's {v[0]!r}")
    log(f"[train] trainer: replayed steps {want} give the first pass's "
        f"losses bit for bit")
    del out, params, tr
    free_card()


def phase_train_full(arch: str, layers=None, smi: str = "") -> dict:
    """``arch`` at full width (and full depth, or ``layers``),
    ``RunConfig`` defaults (bf16 compute, fp32 parameters, remat), AdamW,
    seq 512 and batch 2: ``FULL_STEPS`` steps of ``make_train_step`` on
    ``SyntheticLMStream`` (with the frontend's patches or frames,
    :func:`train_batch`), the launch counts set to 0 just before and read
    just after.  Every loss must be finite and each kernel of the family's
    training path (``TRAIN_KERNELS``) launched.  Then a profile of one more
    step: kernel time by kernel and the device's idle share.  Returns the
    launches by kernel."""
    from repro_torch.config import RunConfig, ShapeConfig
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMStream
    from repro_torch.models import init_model_params
    from repro_torch.optim import init_opt_state
    from repro_torch.train import make_train_step
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    shape = ShapeConfig("smoke_full", 512, 2, "train")
    t0 = time.time()
    before = torch.cuda.memory_allocated()
    params = init_model_params(SEED, cfg, device="cuda")
    opt = init_opt_state(params)
    torch.cuda.synchronize()
    state_gib = torch.cuda.memory_allocated() / 2**30
    name = f"{arch} ({cfg.n_layers} layers)"
    log(f"[train] {name} full width ({cfg.n_params() / 1e9:.3f} B "
        f"parameters): fp32 parameters and AdamW state drawn in "
        f"{time.time() - t0:.1f} s, {state_gib:.2f} GiB")
    step = make_train_step(cfg, shape, RunConfig(), device="cuda")
    check_train_state(params, opt, cfg, shape, step.rc, before)
    stream = SyntheticLMStream(cfg.vocab, shape.seq_len, shape.global_batch,
                               seed=SEED)
    if cfg.frontend:
        log(f"[train] {name}: batches {sorted(train_batch(cfg, stream, 0))}")
    counters = launch_counters()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    walls, losses = [], []
    for i in range(FULL_STEPS):
        t1 = time.time()
        params, opt, m = step(params, opt, train_batch(cfg, stream, i))
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        walls.append(time.time() - t1)
    counts = {k: c.launches for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    tokens = shape.seq_len * shape.global_batch
    steady = walls[1:]
    wall = sum(steady) / len(steady)
    log(f"[train] {name} full width: losses "
        f"{[f'{x:.6f}' for x in losses]}; step walls "
        f"{[f'{w:.3f}' for w in walls]} s (first includes set-up); steady "
        f"{wall:.3f} s = {tokens / wall:.0f} tokens/s; peak memory "
        f"{peak:.2f} GiB; launches {counts} "
        f"({ {k: v // FULL_STEPS for k, v in counts.items() if v} } a step)")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{name} full-width training: losses {losses}")
    for kernel in TRAIN_KERNELS[cfg.family]:
        if counts[kernel] <= 0:
            raise AssertionError(f"{kernel} never launched on {name}'s "
                                 f"training path")
    log_train_roofline(cfg, shape, step.rc, wall, name, smi)
    profile_train_step(step, params, opt,
                       train_batch(cfg, stream, FULL_STEPS), wall, name)
    del params, opt
    free_card()
    return counts


def check_train_state(params, opt, cfg, shape, rc, before: int) -> None:
    """The parameters + ``mu`` + ``nu`` on the card, in bytes, must equal
    the dry run's ``params`` + ``opt`` on a 1 x 1 mesh (shape x dtype sums:
    exact).  Logged beside: what the allocator holds for them
    (``memory_allocated`` after the draw less before it), leaf by leaf
    the difference is its rounding of each allocation up to 512 bytes, and
    the step counter."""
    from repro_torch.launch import dryrun
    from repro_torch.models.layers import tree_leaves
    leaves = (tree_leaves(params) + tree_leaves(opt.mu)
              + tree_leaves(opt.nu))
    held = sum(t.nbytes for t in leaves)
    want = dryrun.device_state_bytes(cfg, shape, dryrun.ONE_CARD, rc)
    rounded = sum(-(-t.nbytes // 512) * 512 for t in leaves + [opt.step])
    alloc = torch.cuda.memory_allocated() - before
    log(f"[train] {cfg.name} ({cfg.n_layers} layers) state: parameters + mu "
        f"+ nu {held} B = {held / 2**30:.4f} GiB; the dry run's params + "
        f"opt {want['params'] + want['opt']:.0f} B on a 1x1 mesh; "
        f"{len(leaves)} leaves and the step counter rounded up to 512 B "
        f"each: {rounded} B; the allocator holds {alloc} B for them "
        f"({torch.cuda.memory_allocated() / 2**30:.4f} GiB in all, "
        f"{before / 2**30:.4f} GiB of it before the draw)")
    if held != want["params"] + want["opt"]:
        raise AssertionError(f"{cfg.name}: {held} B of state on the card, "
                             f"the dry run counts {want}")


def log_train_roofline(cfg, shape, rc, wall: float, name: str,
                       smi: str) -> None:
    """MFU of the measured step (``model_flops_for`` at its tokens over the
    step wall x the bf16 peak) and the roofline of the step's FLOPs as the
    dry run counts them on the meta device (one card, no collective)."""
    from repro_torch.launch import dryrun
    from repro_torch.roofline import PEAK_FLOPS, Roofline, model_flops_for
    t0 = time.time()
    flops = dryrun.count_flops(cfg, shape, rc)
    count_s = time.time() - t0
    model = model_flops_for(cfg, shape)
    rl = Roofline(arch=cfg.name, shape=f"{shape.global_batch}x"
                  f"{shape.seq_len} train", mesh="1x1", chips=1,
                  per_device_flops=flops,
                  per_device_bytes=dryrun.memory_bytes(cfg, shape,
                                                       dryrun.ONE_CARD, rc),
                  per_device_coll_bytes=0.0, model_flops=model)
    log(f"[train] {name} roofline: model FLOPs {model:.4e}, counted "
        f"{flops:.4e} (meta device, {count_s:.1f} s); MFU "
        f"{model / (wall * PEAK_FLOPS):.4f} at the {wall:.3f} s step; "
        f"counted FLOPs at {flops / wall / 1e12:.1f} TFLOP/s; t_compute "
        f"{rl.t_compute * 1e3:.2f} ms, t_memory {rl.t_memory * 1e3:.2f} ms, "
        f"bottleneck {rl.bottleneck}; {smi}")


def train_batch(cfg, stream, i: int) -> dict:
    """The stream's batch ``i`` (numpy), with the frontend's inputs drawn
    as :func:`model_inputs` draws them, from a generator seeded with the
    step: pixtral's patches beside the tokens, hubert's frames in their
    place (its loss reads the labels only)."""
    b = stream.batch_at(i)
    if not cfg.frontend:
        return b
    rng = np.random.default_rng(SEED + 100 + i)
    drawn = model_inputs(cfg, rng, *b["labels"].shape)
    extra = {k: v.numpy() for k, v in drawn.items() if k != "tokens"}
    if cfg.frontend == "audio":
        b = {"labels": b["labels"]}
    return {**b, **extra}


def profile_train_step(step, params, opt, batch, wall: float,
                       name: str) -> None:
    """Kernel time of one more step by kernel and by phase (torch.profiler,
    CUDA activity): the forward to the loss, the backward (remat's
    recomputed forward, dX and dW, the backward kernels) and the AdamW
    update, each profiled alone, as ``train_step`` runs them; the
    device's idle share is one minus their sum over the steady step wall.
    The kernels are grouped by the port's kernel (``PROFILE_GROUPS``) and
    PyTorch's own."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.layers import tree_leaves, tree_unflatten
    from repro_torch.optim import adamw_update
    from repro_torch.train.step import loss_fn
    cfg, rc = step.cfg, step.rc
    b = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    ps = tree_leaves(params)
    groups = PROFILE_GROUPS
    phases, top = {}, {}

    def record(name, fn):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        dev = {e.key: e.self_device_time_total / 1e3
               for e in prof.key_averages() if e.self_device_time_total > 0}
        sums = dict.fromkeys(groups + ("other",), 0.0)
        for key, ms in dev.items():
            sums[next((g for g in groups if g in key), "other")] += ms
            top[key] = top.get(key, 0.0) + ms
        sums = {k: v for k, v in sums.items() if v > 0}
        phases[name] = sums
        return out

    for p in ps:
        p.requires_grad_(True)
    try:
        loss, _ = record("forward", lambda: loss_fn(params, b, cfg, rc))
        grads = record("backward", lambda: torch.autograd.grad(
            loss, ps, allow_unused=True))
    finally:
        for p in ps:
            p.requires_grad_(False)
    # a leaf the loss never reads (hubert's embed) gets zeros, as in
    # train_step
    grads = tree_unflatten(params, [torch.zeros_like(p) if g is None
                                    else g.contiguous()
                                    for p, g in zip(ps, grads)])
    record("optimizer", lambda: adamw_update(params, opt, grads, rc))
    busy = sum(sum(v.values()) for v in phases.values())
    if busy == 0:
        log("[profile] training step idle share: not measured (the profiler "
            "saw no device time)")
        return
    for part, sums in phases.items():
        log(f"[profile] {name} training step {part}: "
            f"{sum(sums.values()):.2f} ms in kernels ("
            + ", ".join(f"{v:.2f} {k}" for k, v in sums.items()) + ")")
    log(f"[profile] {name} training step: {busy:.1f} ms in kernels "
        f"over a {wall * 1e3:.1f} ms step; device idle share "
        f"{1 - busy / (wall * 1e3):.3f}")
    for k, v in sorted(top.items(), key=lambda kv: -kv[1])[:12]:
        log(f"[profile]   {v:9.3f} ms  {k[:160]}")


#: the kernel-name groups of a training step's profile, each matched as a
#: substring of the CUDA kernel's name in this order (the reverse walk of
#: ``rglru_scan`` is its kernel's ``true`` instantiation)
PROFILE_GROUPS = ("flash_attention_bwd", "flash_attention", "queue_matmul",
                  "moe_gemm", "ssm_scan_bwd", "ssm_scan",
                  "rglru_scan_kernel<float, float, true>", "rglru_scan")


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
    of phase 4's ``forward`` and the 128 of phase 3's; with the chunk
    states written (what a gradient takes), y must keep its bits.  No
    single PyTorch call computes it, so there is no library time."""
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
            y_st, states = ops.ssm_scan_states(x, dt, A, Bm, C)
            torch.cuda.synchronize()
            if not torch.equal(y_st, out):
                raise AssertionError(f"ssm_scan: writing the chunk states "
                                     f"changed y at T={t} {dtype}")
            del y_st, states
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
                f"{b_ms:8.4f} ({b_by}; y equal with the chunk states "
                f"written)")
            row = {"B": b, "T": t, "d": d, "N": n, "dtype": str(dtype)[6:],
                   "max_abs_err": err, "ms": ms, "plain_ms": plain,
                   "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
            report.append({"kernel": "ssm_scan", **row})
            if (t, dtype) == (512, torch.bfloat16):
                rep = row
    return rep


def check_rglru_scan(gen, report) -> dict:
    """recurrentgemma-2b's scan: width 2560, over the 512 tokens of phase
    4's ``forward``, the 128 of phase 3's and 4096 (walked in segments),
    with a and bx drawn as the model's gates make them.  No single PyTorch
    call computes it, so there is no library time."""
    from repro_torch.kernels.rglru_scan import ops
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
    rep = None
    log("[kernels] rglru_scan  B    T     w  dtype  max_abs_err  ms  "
        "plain_ms  bound_ms")
    for dtype in (torch.float32, torch.bfloat16):
        for b, t, w in ((1, 512, 2560), (1, 128, 2560), (1, 4096, 2560)):
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
            plain = cuda_ms(lambda: rglru_scan_ref(a, bx),
                            iters=5 if t <= 512 else 1)
            # a multiply and an add per element; a and bx read, h written
            b_ms, b_by = bound(2.0 * b * t * w,
                               b * t * w * (2 * a.element_size() + 4),
                               torch.float32)
            log(f"[kernels] rglru_scan {b:2d} {t:4d} {w:5d} "
                f"{str(dtype)[6:]:>8s} {err:10.3e} {ms:8.4f} {plain:8.4f} "
                f"{b_ms:8.4f} ({b_by}; {b_ms / ms:.2f} of the bound)")
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
    """The cut depth (:func:`cut_depth`) at full width: ``forward`` (over
    ``PARITY_SEQ`` tokens, with the frontend's patches or frames) and, for
    a decoder, 4 ``decode_step``s on the card (fp32, kernels), on the CPU
    (fp32, plain versions) and on the CPU in fp64 (the witness), on the
    same seeded weights.  An MoE model's routing is compared first, every
    layer, so that a flipped expert is reported as a flip; a hybrid model
    also runs :func:`ring_parity`.  Failures go to ``failures``, so that
    one run reports every model."""
    from repro_torch.config import RunConfig
    from repro_torch.configs import get_config
    from repro_torch.models import (decode_step, forward, init_cache,
                                    init_model_params, prepare_params)
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
    seq = PARITY_SEQ.get(arch, 128)
    inputs = model_inputs(cfg, rng, 1, seq)
    name = f"{arch} ({cfg.n_layers} layers, {scale} scale)"
    if cfg.frontend:
        log(f"[parity] {name}: inputs {sorted(inputs)}; {host_memory()}")
    routes = {"card": [], "cpu": [], "fp64": []}
    with routing(routes["card"]):
        out_gpu = forward(p_gpu, {k: v.cuda() for k, v in inputs.items()},
                          cfg, rc)
    with routing(routes["cpu"]):
        out_cpu = forward(p_cpu, inputs, cfg, rc)
    with routing(routes["fp64"]):
        exact = forward(p_cpu, inputs, cfg, rc64)
    if cfg.moe:
        both = flips(routes["card"], routes["cpu"])
        log(f"[parity] {name} top-{cfg.moe.top_k} experts of "
            f"{seq} tokens, tokens flipped per layer: card vs CPU "
            f"{both}, card vs fp64 {flips(routes['card'], routes['fp64'])}, "
            f"CPU vs fp64 {flips(routes['cpu'], routes['fp64'])}")
        if hold and any(both):
            failures.append(f"{name}: the router flips an expert between "
                            f"card and CPU ({both} tokens)")
    against_witness(f"{name} forward B=1 S={seq}", out_gpu, out_cpu, exact,
                    hold, failures)
    del out_gpu, out_cpu, exact
    if not cfg.causal:
        log(f"[parity] {name}: an encoder, no decode; done in "
            f"{time.time() - t0:.1f} s")
        del p_gpu
        free_card()
        return
    caches = {"card": init_cache(cfg, 4, 16, torch.float32, device="cuda"),
              "cpu": init_cache(cfg, 4, 16, torch.float32, device="cpu"),
              "fp64": init_cache(cfg, 4, 16, torch.float64, device="cpu")}
    steps = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 4)))
    # the weights prepared once for each run, as the engine holds them
    # (cast, the head transposed), not again at every step
    prep = {"card": prepare_params(p_gpu, cfg, rc),
            "cpu": prepare_params(p_cpu, cfg, rc),
            "fp64": prepare_params(p_cpu, cfg, rc64)}
    for t in range(4):
        tok = steps[:, t:t + 1]
        lg, caches["card"] = decode_step(prep["card"], caches["card"],
                                         {"tokens": tok.cuda()}, cfg, rc)
        lc, caches["cpu"] = decode_step(prep["cpu"], caches["cpu"],
                                        {"tokens": tok}, cfg, rc)
        le, caches["fp64"] = decode_step(prep["fp64"], caches["fp64"],
                                         {"tokens": tok}, cfg, rc64)
        against_witness(f"{name} decode_step {t}", lg, lc, le, hold,
                        failures)
    del caches, prep
    if cfg.family == "hybrid":
        ring_parity(p_gpu, p_cpu, cfg, rng, name, hold, failures)
    del p_gpu
    free_card()
    log(f"[parity] {name} done in {time.time() - t0:.1f} s")


def decode_spread(arch: str, scale: str) -> None:
    """The 4 ``decode_step``s of :func:`phase_parity` on the same draw and
    tokens, each as its logits' RMS distance from the fp64 run, per step
    and per slot: on the card through the kernels and through the plain
    versions (``ExecutionPolicy.BASELINE``: cuBLAS, no TF32), and on the
    CPU in fp32 at the default thread count and at ``SPREAD_THREADS``.
    Logged, not held: it shows how far fp32 runs that differ only in
    their summation order land from fp64 on a draw where ``SPREAD`` says
    the ratio cannot be held."""
    from repro_torch.config import RunConfig
    from repro_torch.configs import get_config
    from repro_torch.core.policy import ExecutionPolicy
    from repro_torch.models import (decode_step, init_cache,
                                    init_model_params, prepare_params)
    from repro_torch.models.layers import tree_map
    full = get_config(arch)
    cfg = cut_depth(full)
    t0 = time.time()
    p_cpu = init_model_params(SEED, cfg, device="cpu")
    redraw_scale(p_cpu, cfg, full, scale)
    p_gpu = tree_map(lambda a: a.to("cuda"), p_cpu)
    rng = np.random.default_rng(SEED)
    model_inputs(cfg, rng, 1, PARITY_SEQ.get(arch, 128))  # phase 3's draws
    steps = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 4)))
    rc = RunConfig(dtype="float32", remat=False)
    plain = RunConfig(dtype="float32", remat=False,
                      policy=ExecutionPolicy.BASELINE)
    threads = torch.get_num_threads()
    runs = ([("card kernels", p_gpu, "cuda", rc, threads),
             ("card plain", p_gpu, "cuda", plain, threads)]
            + [(f"CPU fp32 {n} threads", p_cpu, "cpu", rc, n)
               for n in (threads,) + SPREAD_THREADS]
            + [("fp64", p_cpu, "cpu", RunConfig(dtype="float64",
                                                remat=False), threads)])
    logits = {}
    try:
        for name, p, dev, r, n in runs:
            torch.set_num_threads(n)
            p = prepare_params(p, cfg, r)
            cache = init_cache(cfg, 4, 16, r.dtype, device=dev)
            logits[name] = []
            for t in range(4):
                lg, cache = decode_step(p, cache, {
                    "tokens": steps[:, t:t + 1].to(dev)}, cfg, r)
                logits[name].append(lg.cpu().double())
    finally:
        torch.set_num_threads(threads)
    exact = logits.pop("fp64")
    base = f"CPU fp32 {threads} threads"
    for t in range(4):
        for name, out in logits.items():
            d = out[t] - exact[t]
            r_all = d.pow(2).mean().sqrt().item()
            r_base = (logits[base][t] - exact[t]).pow(2).mean().sqrt().item()
            log(f"[parity] {arch} ({cfg.n_layers} layers, {scale} scale) "
                f"decode_step {t} {name:>20s}: from fp64 rms {r_all:.3e} "
                f"({r_all / r_base:.2f} of the {base} run's); per slot "
                + " ".join(f"{x:.2e}"
                           for x in d.pow(2).mean(-1).sqrt().tolist()))
    del p_gpu
    free_card()
    log(f"[parity] {arch} ({scale} scale) decode spread, logged not held, "
        f"in {time.time() - t0:.1f} s")


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
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.kernels.moe_gemm import moe_gemm_bwd
    from repro_torch.kernels.rglru_scan import rglru_scan_bwd
    from repro_torch.kernels.ssm_scan import ssm_scan_bwd
    return {"queue_matmul": queue_matmul, "flash_attention": flash_attention,
            "flash_attention_bwd": flash_attention_bwd,
            "moe_gemm": moe_gemm, "moe_gemm_bwd": moe_gemm_bwd,
            "ssm_scan": ssm_scan, "ssm_scan_bwd": ssm_scan_bwd,
            "rglru_scan": rglru_scan, "rglru_scan_bwd": rglru_scan_bwd}


#: phase 4's engine: slots, cache length and prefill chunk
SERVE_ENGINE = dict(batch_slots=4, max_len=256, prefill_chunk=8)
#: phase 4's tokens by model, one list per request, for the policy phase
SERVED_TOKENS = {}


def serve_prompts(cfg, rng) -> list:
    """Phase 4's 6 requests: 16-64 prompt tokens each, drawn from ``rng``
    (``SEED`` + 1)."""
    return [[int(t) for t in rng.integers(0, cfg.vocab,
                                          int(rng.integers(16, 65)))]
            for _ in range(6)]


def phase_serve(arch: str) -> dict:
    """Serve ``arch`` at full width in bf16 and return the launches of its
    main path, by kernel.  The weights are drawn leaf by leaf in bf16 (one
    fp32 leaf alive at a time) and freed before returning; the peak counts
    the engine's transposed copy of the head (``head_t``)."""
    from repro_torch.config import RunConfig
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_model_params
    from repro_torch.serve import ServeEngine
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=SERVE_LAYERS.get(
        arch, full.n_layers))
    rc = RunConfig(dtype="bfloat16")
    counters = launch_counters()
    t0 = time.time()
    params = init_model_params(SEED, cfg, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    # the peak counts serving from here on, not the fp32 temporaries of
    # the random draw
    torch.cuda.reset_peak_memory_stats()
    log(f"[serve] {arch} full width ({cfg.n_layers} of {full.n_layers} "
        f"layers), bf16 weights "
        f"drawn in {time.time() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    rng = np.random.default_rng(SEED + 1)
    prompts = serve_prompts(cfg, rng)

    for c in counters.values():
        c.launches = 0
    eng = ServeEngine(params, cfg, rc, **SERVE_ENGINE)
    del params
    check_serve_state(eng, cfg, rc)
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
    SERVED_TOKENS[arch] = [done[r].generated for r in rids]
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

    inputs = {k: v.cuda() for k, v in model_inputs(cfg, rng, 1, 512).items()}
    before = {k: c.launches for k, c in counters.items()}
    t0 = time.time()
    logits = forward(eng.params, inputs, cfg, eng.rc)
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


def _named(tree, specs, prefix: str = ""):
    """(path, tensor) of each leaf of ``tree`` that ``specs`` (the
    ``param_specs`` tree) names, a prepared tree's ``head_t`` standing for
    ``head`` (the same elements, transposed)."""
    from repro_torch.models.layers import ParamSpec
    for k in sorted(specs):
        path = f"{prefix}{k}"
        if isinstance(specs[k], ParamSpec):
            yield path, tree["head_t"] if k == "head" and not prefix \
                else tree[k]
        else:
            yield from _named(tree[k], specs[k], path + "/")


def check_serve_state(eng, cfg, rc) -> None:
    """The engine's weights (the leaves ``param_specs`` names) and cache, in
    bytes, must equal the dry run's ``params`` + ``cache`` on a 1 x 1 mesh
    at the engine's slots and length: both are shape x dtype sums, so
    equality is exact.  The engine's other leaves are logged beside."""
    from repro_torch.config import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.models import param_specs
    from repro_torch.models.layers import tree_leaves
    specs = param_specs(cfg)
    named = dict(_named(eng.params, specs))
    held = sum(t.nbytes for t in named.values())
    cache = sum(t.nbytes for t in tree_leaves(eng.cache))
    shape = ShapeConfig("serve", SERVE_ENGINE["max_len"],
                        SERVE_ENGINE["batch_slots"], "decode")
    want = dryrun.device_state_bytes(
        cfg, shape, dryrun.ONE_CARD,
        dataclasses.replace(rc, param_dtype=rc.dtype))
    extra = {k: v.nbytes for k, v in eng.params.items() if k not in specs}
    log(f"[serve] {cfg.name} state: weights {held} B + cache {cache} B; the "
        f"dry run's params {want['params']:.0f} B + cache "
        f"{want['cache']:.0f} B on a 1x1 mesh; the engine's leaves beyond "
        f"param_specs' {extra}"
        + (" (head_t stands for head, counted above)" if "head" in specs
           else ""))
    if held != want["params"] or cache != want["cache"]:
        raise AssertionError(f"{cfg.name}: the engine holds {held} + {cache} "
                             f"B, the dry run counts {want}")


def phase_encode(arch: str) -> dict:
    """An encoder at full width and depth in bf16: its engine must refuse
    it (no autoregressive decode, as the reference's refuses it), and one
    ``forward`` over 512 frames is its main path, the launch counts set to
    0 just before it and read just after; every kernel of the family's
    path must have run.  Returns the launches by kernel."""
    from repro_torch.config import RunConfig
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_model_params, prepare_params
    from repro_torch.serve import ServeEngine
    cfg = get_config(arch)
    rc = RunConfig(dtype="bfloat16")
    counters = launch_counters()
    t0 = time.time()
    params = init_model_params(SEED, cfg, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    log(f"[serve] {arch} full width ({cfg.n_layers} layers), bf16 weights "
        f"drawn in {time.time() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    try:
        ServeEngine(params, cfg, rc, batch_slots=4, max_len=256)
    except ValueError as e:
        log(f"[serve] {arch}: the engine refuses it ({e})")
    else:
        raise AssertionError(f"{arch}: the engine accepted an encoder")
    params = prepare_params(params, cfg, rc)
    inputs = model_inputs(cfg, np.random.default_rng(SEED + 1), 1, 512)
    inputs = {k: v.cuda() for k, v in inputs.items()}
    for c in counters.values():
        c.launches = 0
    t0 = time.time()
    logits = forward(params, inputs, cfg, rc)
    torch.cuda.synchronize()
    fwd_s = time.time() - t0
    counts = {k: c.launches for k, c in counters.items()}
    if logits.shape != (1, 512, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{arch}: forward logits {tuple(logits.shape)} "
                             f"not finite")
    for name in PATH_KERNELS[cfg.family]:
        if counts[name] <= 0:
            raise AssertionError(f"{name} never launched on {arch}'s main "
                                 f"path")
    log(f"[serve] {arch} forward B=1 S=512 ({', '.join(sorted(inputs))}; "
        f"non-causal): {fwd_s:.3f} s wall; launches on the main path "
        f"{counts}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del params, logits, inputs
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


# ---------------------------------------------------------------------------
# policy: the calibrated operating point on the serve path
# ---------------------------------------------------------------------------

#: the policy phase's model and its calibration: the smoke grid of the
#: port's ``explore calibrate`` (two kernels, queue depths 1 and 2,
#: latency 1, unrolls 4 and 8, 16 samples), in-process on the host
POLICY_ARCH = "phi3-mini-3.8b"
POLICY_CALIBRATION = dict(kernels=["dequant_dot", "expf"], grid_kw=dict(
    queue_depths=(1, 2), queue_latencies=(1,), unrolls=(4, 8),
    n_samples=16))


def serve_until_done(eng, prompts, on_step=None):
    """Submit ``prompts`` (16 new tokens each) and step ``eng`` until every
    request is done; ``on_step()`` runs after each step.  Returns the
    generated tokens per request, the wall seconds and the token count.
    At most 1000 steps, as ``ServeEngine.run`` takes."""
    rids = [eng.submit(p, max_new=16) for p in prompts]
    t0 = time.time()
    for _ in range(1000):
        if not eng.sched.busy:
            break
        eng.step()
        if on_step is not None:
            on_step()
    torch.cuda.synchronize()
    wall = time.time() - t0
    if sorted(eng.finished) != sorted(rids):
        raise AssertionError(f"unfinished requests: "
                             f"{set(rids) - set(eng.finished)}")
    tokens = [eng.finished[r].generated for r in rids]
    return tokens, wall, sum(len(t) for t in tokens)


def phase_policy(smi: str) -> dict:
    """The serve path on an operating point the port's own machine model
    chose.  (a) Calibrate ``POLICY_CALIBRATION`` with the port on the host
    (``workers=1``: no process pool once the card holds a context) into a
    directory under ``build/``, point ``REPRO_CALIBRATION_DIR`` at it and
    clear the table cache; the ``queue_matmul`` point must leave the
    default depth 4.  (b) Serve ``POLICY_ARCH`` at full width and depth in
    bf16 with phase 4's slots, prompts and seed, in measured-traffic mode:
    every token equals phase 4's (``queue_matmul`` gives the same bits at
    every depth of a regime), the report and every retarget name
    calibrated points, the cost model charged at each traffic level equals
    ``StepCostModel.from_operating_point`` recomputed for that level's
    point, and every ``queue_matmul`` launch ran at the calibrated depths.
    The launch counts are set to 0 just before this run and read just after
    it: it is a main path.  (c) Its wall time and tokens/s, and the
    device's idle share over decode bodies at the calibrated depths
    (:func:`profile_decode`, as phase 4 profiles the default ones).  Then
    the demo's depth-1 against depth-4 products (``copiftv2_demo.part2``).
    The calibration directory is removed and the variable restored at the
    end.  Returns the main path's launches by kernel."""
    import shutil
    import tempfile
    from repro_torch.config import RunConfig
    from repro_torch.configs import get_config
    from repro_torch.core import (calibrate, clear_policy_table_cache,
                                  default_table)
    from repro_torch.core.policy import TRAFFIC_LEVELS, OperatingPoint
    from repro_torch.examples import copiftv2_demo
    from repro_torch.kernels.queue_matmul import ops as qm_ops
    from repro_torch.models import init_model_params
    from repro_torch.serve import ServeEngine, StepCostModel
    cfg = get_config(POLICY_ARCH)
    rc = RunConfig(dtype="bfloat16")
    counters = launch_counters()
    t_phase = time.time()
    prompts = serve_prompts(cfg, np.random.default_rng(SEED + 1))
    params = init_model_params(SEED, cfg, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    log(f"[policy] {POLICY_ARCH} bf16 weights drawn in "
        f"{time.time() - t_phase:.1f} s")
    want = SERVED_TOKENS.get(POLICY_ARCH)
    if want is None:                  # phase 4 did not run in this call
        want, wall0, n0 = serve_until_done(
            ServeEngine(params, cfg, rc, **SERVE_ENGINE), prompts)
        log(f"[policy] {POLICY_ARCH} on the default table (phase 4 did not "
            f"run): {n0} tokens in {wall0:.2f} s wall = {n0 / wall0:.2f} "
            f"tok/s; first tokens {want[0]}")

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    directory = tempfile.mkdtemp(prefix="calibration_",
                                 dir=os.path.join(ROOT, "build"))
    before_env = os.environ.get("REPRO_CALIBRATION_DIR")
    launch = qm_ops._launch
    depths = {}

    def recording_launch(x, w, depth_x, depth_w):
        depths[(depth_x, depth_w)] = depths.get((depth_x, depth_w), 0) + 1
        return launch(x, w, depth_x, depth_w)

    try:
        # (a) calibrate on the host
        t0 = time.time()
        records = calibrate(workers=1, out_dir=directory,
                            **POLICY_CALIBRATION)
        cal_s = time.time() - t0
        os.environ["REPRO_CALIBRATION_DIR"] = directory
        clear_policy_table_cache()
        table = default_table()
        qm = table.resolve("queue_matmul")
        serve_pts = {lvl: table.resolve("serve", traffic=lvl)
                     for lvl in (None, *TRAFFIC_LEVELS)}
        log(f"[policy] calibrated {sorted(records)} in {cal_s:.2f} s on the "
            f"host into {os.path.relpath(directory, ROOT)}; queue_matmul "
            f"resolves {qm}")
        for lvl, op in serve_pts.items():
            log(f"[policy] serve at traffic {lvl}: {op}")
        if qm.source != "calibrated" or qm_ops.operating_point() != qm:
            raise AssertionError(f"queue_matmul's wrapper resolves "
                                 f"{qm_ops.operating_point()}, the table "
                                 f"{qm}")
        if qm.queue_depth == OperatingPoint().queue_depth:
            raise AssertionError(f"the calibrated queue_matmul depth "
                                 f"{qm.queue_depth} is the default's")

        # (b) serve on the calibrated table, measured traffic
        qm_ops._launch = recording_launch
        for c in counters.values():
            c.launches = 0
        eng = ServeEngine(params, cfg, rc, **SERVE_ENGINE)
        charged = []

        def check_retarget():
            if len(eng.traffic_history) == len(charged):
                return
            level = eng.traffic_history[-1]["level"]
            op = table.resolve("serve", traffic=level)
            cost = StepCostModel.from_operating_point(op)
            if eng.operating_point != op or \
                    dataclasses.asdict(eng._cost) != \
                    dataclasses.asdict(cost):
                raise AssertionError(f"traffic {level}: the engine charges "
                                     f"{eng._cost} at {eng.operating_point}"
                                     f", the machine model gives {cost} at "
                                     f"{op}")
            charged.append((level, cost))

        tokens, wall, n_tok = serve_until_done(eng, prompts, check_retarget)
        counts = {k: c.launches for k, c in counters.items()}
        qm_ops._launch = launch
        report = eng.metrics()
        log(f"[policy] {POLICY_ARCH} full width ({cfg.n_layers} layers), "
            f"bf16, calibrated, measured traffic: {len(tokens)} requests, "
            f"{n_tok} tokens in {wall:.2f} s wall = {n_tok / wall:.2f} "
            f"tok/s; {eng._n_steps} steps; {smi}")
        log(f"[policy] operating point {eng.operating_point}; report "
            f"cost_source {report.cost_source}; traffic history "
            f"{eng.traffic_history}")
        for level, cost in charged:
            log(f"[policy] traffic {level}: {cost.cycles_decode_token!r} "
                f"cycles and {cost.energy_decode_token!r} energy per decode "
                f"token, {cost.cycles_prefill_token!r} cycles per prefill "
                f"token ({cost.source}), the machine model's")
        log(f"[policy] queue_matmul launches by ring depths (x, w): {depths}"
            f"; launches on the main path {counts}")
        if tokens != want:
            bad = [i for i, (a, b) in enumerate(zip(tokens, want)) if a != b]
            raise AssertionError(f"{POLICY_ARCH}: calibrated tokens differ "
                                 f"from phase 4's on requests {bad}")
        if not charged or report.cost_source != "calibrated" or any(
                h["source"] != "calibrated" for h in eng.traffic_history):
            raise AssertionError(f"not calibrated: report "
                                 f"{report.cost_source}, history "
                                 f"{eng.traffic_history}")
        if set(depths) != {qm.effective_depths()} or \
                counts["queue_matmul"] != sum(depths.values()) or \
                counts["queue_matmul"] <= 0:
            raise AssertionError(f"queue_matmul launched at {depths} "
                                 f"({counts['queue_matmul']} counted), "
                                 f"calibrated {qm.effective_depths()}")
        log(f"[policy] same tokens as phase 4 for all {len(tokens)} "
            f"requests; every queue_matmul launch at the calibrated depths "
            f"{qm.effective_depths()}")

        # (c) the device's idle share of a decode body at the calibrated
        # depths, beside phase 4's at the default ones
        profile_decode(eng.params, eng.cache, cfg, eng.rc, POLICY_ARCH)
        del eng, params
        free_card()
        t0 = time.time()
        for row in copiftv2_demo.part2():
            log(f"[policy] demo {row}; {smi}")
        log(f"[policy] demo in {time.time() - t0:.1f} s; the phase in "
            f"{time.time() - t_phase:.1f} s")
    finally:
        qm_ops._launch = launch
        if before_env is None:
            os.environ.pop("REPRO_CALIBRATION_DIR", None)
        else:
            os.environ["REPRO_CALIBRATION_DIR"] = before_env
        clear_policy_table_cache()
        shutil.rmtree(directory, ignore_errors=True)
    free_card()
    return counts


# ---------------------------------------------------------------------------
# dist: tensor-parallel products through queue_matmul
# ---------------------------------------------------------------------------

#: phase dist's products, phi3-mini-3.8b's: (name, M, K, N) of x (M, K) @
#: w (K, N), 1024 tokens
DIST_SHAPES = (("phi3 q/k/v/o", 1024, 3072, 3072),
               ("phi3 head", 1024, 3072, 32064))


def phase_dist(smi: str) -> dict:
    """``tp_matmul`` on the card: a one-rank NCCL group started in-process
    (a ``HashStore``, world size 1; if it cannot start the phase fails,
    with no other backend) and ``make_local_mesh(1, 1)``.  At each of
    ``DIST_SHAPES``, in bf16, under COPIFT (the bulk gather: one NCCL
    all-gather, then the product) and COPIFTv2 (the ring: at one rank no
    send, one product), the result must equal ``queue_matmul`` alone at the
    same depths bit for bit.  The ``tp_matmul`` calls are the main path: the
    launch counts are set to 0 just before them and read just after, and
    ``queue_matmul`` must have run.  Then the device time of each beside
    ``queue_matmul`` alone (``cuda_ms``).  The group is destroyed at the
    end, on failure too.  Returns the main path's launches by kernel."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.core.policy import ExecutionPolicy
    from repro_torch.distributed.collective_matmul import (recording,
                                                           tp_matmul)
    from repro_torch.kernels import queue_matmul
    from repro_torch.launch.mesh import make_local_mesh
    counters = launch_counters()
    t_phase = time.time()
    torch.cuda.set_device(0)       # the one rank's card, before the mesh
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_local_mesh(1, 1)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
        cases = []
        for name, m, k, n in DIST_SHAPES:
            x = torch.randn((m, k), generator=gen, device="cuda").to(
                torch.bfloat16)
            w = (torch.randn((k, n), generator=gen, device="cuda")
                 / math.sqrt(k)).to(torch.bfloat16)
            xd = DTensor.from_local(x, mesh, (Replicate(), Shard(0)),
                                    run_check=False)
            wd = DTensor.from_local(w, mesh, (Replicate(), Shard(1)),
                                    run_check=False)
            for policy in (ExecutionPolicy.COPIFT, ExecutionPolicy.COPIFTV2):
                for c in counters.values():
                    c.launches = 0
                with recording() as recs:
                    y = tp_matmul(xd, wd, mesh, policy=policy)
                torch.cuda.synchronize()
                counts = {k_: c.launches for k_, c in counters.items()
                          if c.launches}
                if counts.get("queue_matmul", 0) <= 0:
                    raise AssertionError(f"dist {name} {policy.value}: "
                                         f"queue_matmul never launched")
                ref = queue_matmul(x, w, policy=policy)
                if y.placements != (Replicate(), Shard(1)) or \
                        not torch.equal(y.to_local(), ref):
                    raise AssertionError(
                        f"dist {name} {policy.value}: tp_matmul differs "
                        f"from queue_matmul by "
                        f"{(y.to_local().float() - ref.float()).abs().max()}")
                ms = cuda_ms(lambda: tp_matmul(xd, wd, mesh, policy=policy))
                plain = cuda_ms(lambda: queue_matmul(x, w, policy=policy))
                cases.append(counts)
                log(f"[dist] {name} {m}x{k} @ {k}x{n} bf16 "
                    f"{policy.value}: equal bits to queue_matmul; "
                    f"tp_matmul {ms:.4f} ms, queue_matmul alone "
                    f"{plain:.4f} ms; collectives {recs}; launches "
                    f"{counts}; {smi}")
    finally:
        dist.destroy_process_group()
    launches = {}
    for counts in cases:
        for k_, v in counts.items():
            launches[k_] = launches.get(k_, 0) + v
    log(f"[dist] launches on the main path: {launches}; the phase in "
        f"{time.time() - t_phase:.1f} s")
    free_card()
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES}")
    ap.add_argument("--cases-out", default=None,
                    help="write every kernel case of phases 2 and 5 to this "
                         "JSON file")
    ap.add_argument("--train-parts", default=",".join(TRAIN_PARTS),
                    help=f"comma-separated subset of phase 5's parts "
                         f"{TRAIN_PARTS}")
    args = ap.parse_args()
    phases = args.phases.split(",")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    from repro_torch import roofline
    global HBM_BYTES_PER_S, PEAK_FLOPS
    HBM_BYTES_PER_S, PEAK_FLOPS = roofline.HBM_BW, roofline.PEAK_FLOPS_BY_DTYPE
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
    report = []
    if "build" in phases:
        phase_build()
    if "kernels" in phases:
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        kernels = [("queue_matmul", check_queue_matmul(gen, report)),
                   ("flash_attention", check_flash_attention(gen, report)),
                   ("moe_gemm", check_moe_gemm(gen, report)),
                   ("ssm_scan", check_ssm_scan(gen, report)),
                   ("rglru_scan", check_rglru_scan(gen, report))]
        free_card()
    if "parity" in phases:
        failures = []
        for arch, scale, hold in PARITY:
            phase_parity(arch, scale, hold, failures)
        for arch, scale in SPREAD:
            decode_spread(arch, scale)
        if failures:
            raise AssertionError("phase 3 failed:\n" + "\n".join(failures))
    launches = {}
    if "serve" in phases:
        for arch in SERVED:
            for name, n in phase_serve(arch).items():
                launches[name] = launches.get(name, 0) + n
        for arch in ENCODERS:
            for name, n in phase_encode(arch).items():
                launches[name] = launches.get(name, 0) + n
        log(f"[serve] launches over the {len(SERVED) + len(ENCODERS)} main "
            f"paths: {launches}")
    if "policy" in phases:
        for name, n in phase_policy(smi).items():
            launches[name] = launches.get(name, 0) + n
    if "dist" in phases:
        for name, n in phase_dist(smi).items():
            launches[name] = launches.get(name, 0) + n
    if "train" in phases:
        parts = args.train_parts.split(",")
        gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
        if "a" in parts:
            kernels.append(("flash_attention_bwd",
                            check_flash_attention_bwd(gen, report)))
            check_queue_matmul_grads(gen, report)
            check_moe_gemm_bwd(gen, report)
            check_moe_apply_grad_mask()
            check_rglru_scan_bwd(gen, report)
            kernels.append(("ssm_scan_bwd", check_ssm_scan_bwd(gen, report)))
        if "b" in parts:
            failures = []
            for arch, scale in GRAD_PARITY:
                phase_grad_parity(arch, scale, failures)
            if failures:
                raise AssertionError("phase 5 (b) failed:\n"
                                     + "\n".join(failures))
        if "c" in parts:
            phase_trainer()
        if "d" in parts:
            for arch, layers in TRAIN_FULL:
                for name, n in phase_train_full(arch, layers, smi).items():
                    launches[name] = launches.get(name, 0) + n
            log(f"[train] launches over every main path run: {launches}")
    if args.cases_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.cases_out)),
                    exist_ok=True)
        with open(args.cases_out, "w") as f:
            json.dump({"card": smi, "cases": report}, f, indent=1)
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
