#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

  python3 chip_smoke.py                      # every phase, as CI runs it
  python3 chip_smoke.py --phases build,kernels --cases-out out/cases.json

Phases, each of which raises on failure (the run then exits non-zero and
prints no result):

1. build   — compile the ten CUDA sources in the checkout (the five
   kernels, ``flash_attention_bwd``, ``ssm_scan_bwd`` and the serve
   bodies' ``rms_norm``, ``decode_attention`` and ``latent_attention``),
   one ``nvcc`` each, all at once.
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
   ``flash_attention`` also at head dims 80 and 200, on rows that see no
   key (zeros, a log-sum-exp of +inf), with minicpm3's v
   head dim 64 below its q/k head dim 96, granite-moe-3b-a800m's heads
   (24 over 8, D 64), and on a query chunk at the end of a longer key
   sequence (Sk != Sq, ``q_offset``), ``ssm_scan`` also with its chunk
   states written (y's bits unchanged), ``rglru_scan`` (a chunked scan,
   whose rounding differs from the plain version's sequential walk) also
   at 4096 steps, where it walks T in segments, and at recurrentgemma's
   training shape 2 x 512 x 2560 in fp32.  The products are those
   of the served models (nemotron-4-340b's at full width: a head weight of
   4.72e9 elements, an ffn wo summing K = 73728), of granite-moe-3b-a800m
   (trained in phase 5; its vocab of 49155 is not a multiple of 8), of
   hubert-xlarge and of glm4-9b (served in phase ``entry``: d_ff 13696,
   vocab 151552), each held to its plain version over the whole output;
   ``flash_attention`` also at pixtral's (32 over 8 of 128), hubert's (16
   of 80, non-causal), nemotron's (96 over 8 of 192) and glm4-9b's heads
   (32 over 2 of 128).  Then phase ``entry``'s other main paths at the
   shapes they give the kernels (``entry_paths``, from a generator of
   their own): quickstart's products (reduced phi3, fp32, M = 512 and 2)
   and heads (8 x 64 tokens, 4 of 16), train_lm 100m's products (fp32, M =
   4096) and heads (8 x 512 tokens, 8 over 4 of 64), the prefill cell's
   decode products (phi3 over 2 slots, bf16) and serve_batch's (glm4-9b
   over 3 slots, bf16).  Then the batched chunk bodies' layer products
   row by row (``CHUNK_ROWS``: 32 rows in slabs of 4 slots for phi3,
   pixtral, nemotron, olmoe, falcon-mamba, recurrentgemma and minicpm3,
   glm4-9b's 24 in slabs of 3, reduced phi3's 32 in fp32), every slab's
   rows equal to a call over the slab alone, and the MoE chunks' expert
   products row by row
   (``MOE_ROWS``: olmoe's 32 and 64 rows an expert, granite-moe-3b-a800m's
   32, in slabs of 4, with every expert and routed), each slab equal to a
   call over it alone and the C = 4 launch's bits unchanged row by row; the
   row-wise ``rms_norm`` (``NORM_CASES``) and ``decode_attention``
   (``ATTN_CASES``: decode bodies and chunks over the served models'
   heads, and phi3's and glm4's at a 4K context) against their plain
   versions, each row or column equal to itself computed alone, beside
   ``F.rms_norm`` and masked SDPA and the floor of one launch (a
   one-element in-place add); then minicpm3's MLA: ``latent_attention``
   (``LATENT_CASES``: its decode body and chunk, a chunk whose columns
   clamp at ``max_len - 1``, a 4K context, fp32 and reduced widths)
   against its plain version, each column equal to itself alone and heads
   0-15 and 16-39 launched alone equal to the whole launch's, beside
   masked SDPA over [latent | rope] keys; and its per-head absorb products
   (``MLA_ABSORB``: ``moe_gemm`` row by row with the 40 heads as experts,
   at a decode body's 4 rows and a chunk's 32) against their plain
   version, each slab equal to itself alone, beside ``torch.bmm``.
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
4. serve   — phi3-mini-3.8b (32 layers), olmoe-1b-7b, falcon-mamba-7b,
   recurrentgemma-2b, minicpm3-4b (MLA) and pixtral-12b (8 layers each)
   and nemotron-4-340b (2 of 96; ``SERVE_LAYERS``) at full
   width, bf16, one after the other: the chunked-prefill engine serves 6
   seeded requests (``SERVE_PROMPT``, ``SERVE_NEW``), a token-prefill engine
   must give the same tokens, and
   one ``forward`` over 512 tokens (pixtral's with its 256 patch rows) runs
   ``flash_attention`` (and ``ssm_scan`` for falcon-mamba, ``rglru_scan``
   for recurrentgemma); then hubert-xlarge (48 layers), whose engine must
   refuse it, runs one non-causal ``forward`` over 512 frames.  Each
   model's run is its own main path: the launch counts are set to 0 just
   before it and read just after it, and every kernel of that path must
   have run.  The engine's weights (the leaves ``param_specs`` names) and
   cache must hold exactly the bytes the dry run counts for them
   (``repro_torch.launch.dryrun.device_state_bytes`` on a 1 x 1 mesh at the
   engine's slots and length).  Each engine runs its decode step and each
   chunk width as one CUDA graph (``repro_torch.serve.graphs``): every
   program it ran must be captured, and its capture seconds, replays,
   launches a replay and pool bytes are logged; its requests are served
   once more on the same engine, warm, giving the same tokens.  Then a
   profile of a decode body, eager and replayed: launches, wall, kernels
   and kernel time by kernel, the device's idle share of each, and for
   olmoe the experts each layer's mask keeps; and of the widest chunk
   program replayed with every count 0 (the cache must stay unchanged),
   its wall, kernels and kernel time a chunk and a prompt token (one
   batched body for every served model).
4b. policy — the serve path on a calibrated operating point: the port's
   machine model calibrates a smoke grid on the host (``POLICY_CALIBRATION``,
   in-process), ``REPRO_CALIBRATION_DIR`` points at the artifacts, and the
   ``queue_matmul`` depth the table resolves must leave the default 4;
   phi3-mini-3.8b at full width and depth in bf16 is served again with phase
   4's slots, prompts and seed in measured-traffic mode: the same tokens as
   phase 4, every retarget and the report on calibrated points, each traffic
   level charged what ``StepCostModel.from_operating_point`` gives for its
   point, every ``queue_matmul`` launch at the calibrated depths, those
   its graphs captured included, and the launch counts equal to the eager
   launches plus each graph's replays times its captured launches (its own
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
4d. entry — the port's entry scripts, each its own main path:
   ``repro_torch.examples.quickstart`` at its default (reduced
   phi3-mini-3.8b, 20 steps: finite losses, the last below the first, 8
   tokens decoded); ``serve_batch --full`` on glm4-9b (``ENTRY_ARCH``: 40
   layers, bf16, its GQA group of 16), chunked and token prefill on the
   same weights giving the same tokens and traffic history, then one
   ``forward`` over 512 tokens (``flash_attention`` at 32 over 2 heads of
   128; phase 2 holds its products and attention, drawn from a generator
   of their own), its peak memory and a profile of a decode body;
   ``train_lm --preset 100m`` (``TRAIN_LM``: fp32, 8 x 512 tokens a step,
   200 steps, checkpoints under ``build/`` removed afterwards; the loss
   must improve); the live chunked-prefill cell
   ``serve_slo.run_prefill(PREFILL_CARD)`` (full-width phi3-mini-3.8b in
   bf16, ``PREFILL_TRIALS`` trials) with its hard gates (equal tokens and
   cache rows, the cycles-domain TTFT gain, the chunk-program bound, the
   wall-clock gain at the reference's bar of 2.0), then the reference's
   own cells ``PREFILL_SMOKE`` and ``PREFILL_FULL`` (reduced phi3, fp32)
   on the card, the same gates at their wall bars (1.2, 2.0); a miss
   fails the run; then
   ``kernel_bench`` at the reference's shapes and
   ``--shapes main`` (``queue_matmul``'s depths over rounds, their bits
   equal) and ``collective_policy`` on one NCCL rank in its child process;
   then, in a child of its own (``HOST_STEP``), the reference's ten host
   smoke sections (the machine model and the simulated scheduler: fig3,
   dse, the three sweeps, calibration, cluster scaling and pipeline,
   front_diff, serve_slo) and the port's ``bench_diff`` (the regenerated
   FULL serve report and the strong-scaling points against the
   reference's committed artifacts, and this run's prefill cell), its
   artifacts under ``build/``, removed afterwards, its wall a ``[time]``
   line.
5. train  — the training path (``--train-parts`` picks among a-d):
   (a) each backward against its plain backward on the same inputs, fp32
   and bf16, equal to itself across two calls, timed with its bound and
   its library yardstick (each row logs the kernel's factor against the
   library and the share of its bound it reaches): ``flash_attention_bwd``
   (o and lse from the
   forward kernel) at ``BWD_CASES``, rows that see no key with zero
   gradients, beside SDPA's backward; ``queue_matmul``'s dX and dW at
   phi3's products and granite's head over 1024 tokens; both also at the
   training shapes of phase ``entry``'s quickstart and train_lm (their
   heads; their products over 512 and 4096 tokens, dY at 1/sqrt(M), with
   the kernel's and the plain version's distances from fp64 logged);
   ``moe_gemm``'s
   (``MOE_BWD``: a shared and a per-expert x, with and without an expert
   mask, beside ``torch.bmm``), and ``moe_apply``'s gradients equal with
   the mask and without; ``rglru_scan``'s reverse walk (a kernel of its
   own, its launch geometry logged) at 2 x 512 x 2560 and ``ssm_scan_bwd`` at 2 x 512 x 8192 x 16, on the chunk states its
   forward writes; (b) the loss and every gradient leaf of
   ``GRAD_PARITY``'s models at full width and cut depth (phase 3's cut),
   fp32 on the card (remat on), fp32 on the CPU and fp64 on the CPU
   (remat off: it recomputes the same values), each leaf held to
   ``FP64_RATIO`` as phase 3 holds logits, the loss to 2e-3 of fp64;
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
PHASES = ("build", "kernels", "parity", "serve", "policy", "dist", "entry",
          "train")
TRAIN_PARTS = ("a", "b", "c", "d")
#: the H100 SXM's HBM rate and peak FLOP/s by dtype, from
#: ``repro_torch.roofline`` (set in :func:`main` once the checkout's
#: package is importable)
HBM_BYTES_PER_S = PEAK_FLOPS = None
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
SEED = 20261016
SERVED = ("phi3-mini-3.8b", "olmoe-1b-7b", "falcon-mamba-7b",
          "recurrentgemma-2b", "minicpm3-4b", "pixtral-12b",
          "nemotron-4-340b")
#: served models cut in depth: nemotron-4-340b's embedding and head alone
#: are 18.9 GB in bf16 and each of its layers 6.9 GB, so 2 of its 96
#: layers are served (phase 2 holds every product at its full shape); the
#: others but phi3-mini-3.8b (served at full depth here, in phase 4b and in
#: phase ``entry``'s prefill cell) at 8 layers, for the time limit: the
#: host's dispatch, which sets a served step's wall, grows with the depth
SERVE_LAYERS = {"olmoe-1b-7b": 8, "falcon-mamba-7b": 8,
                "recurrentgemma-2b": 8, "minicpm3-4b": 8, "pixtral-12b": 8,
                "nemotron-4-340b": 2}
#: the encoder: phase 4 runs its ``forward`` only, and its engine must
#: refuse it (no autoregressive decode, as in the reference)
ENCODERS = ("hubert-xlarge",)
#: models whose phase 2 products draw their inputs from a generator of
#: their own (``SEED`` + the offset), so that adding them left the inputs
#: of every case before them as they were
OWN_DRAWS = {"granite-moe-3b-a800m": 11, "pixtral-12b": 13,
             "nemotron-4-340b": 13, "hubert-xlarge": 13, "glm4-9b": 22}
#: the model phase ``entry`` serves at full width through the port's
#: ``serve_batch`` (its products and attention join phase 2)
ENTRY_ARCH = "glm4-9b"
#: phase ``entry``'s other main paths, which phases 2 and 5 (a) check at
#: the shapes they give the kernels (:func:`entry_paths`), draw their
#: inputs from a generator of their own (``SEED`` + this offset), so every
#: earlier case keeps its inputs
ENTRY_DRAW = 23
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
#: pixtral-12b's depth draw is not in ``PARITY``: at its depth scale (std
#: 1/sqrt(40) over widths of 5120-14336) a decode step's softmax sits near
#: a tie in some slots and amplifies rounding: the CPU's own fp32 distance
#: from fp64 moved about 2x with its thread count alone, and the card's
#: plain versions (cuBLAS) landed farther than its kernels (the card's
#: readings, in ROADMAP.md's standing notes), so a
#: ratio to one CPU run cannot tell a kernel fault from luck there.  Its
#: fan-in draw carries the phase 3 checks (its forward at the depth scale,
#: and phase 5 (b)'s gradients, hold them)
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
#: the kernels the decode and chunk bodies of a family that batches a
#: chunk's columns add to its path (``models.model.batches_columns``): the
#: norm, and the attention where the family has GQA layers; an MLA layer's
#: latent attention and its per-head absorb products (``moe_gemm``)
COLUMN_KERNELS = ("rms_norm", "decode_attention")
MLA_KERNELS = ("rms_norm", "latent_attention", "moe_gemm")


def path_kernels(cfg) -> tuple:
    """The kernels ``cfg``'s serve path runs: its family's, and for a
    family that batches its columns the batched bodies' norm and, but for
    the SSM family (no attention), their attention (MLA's with its absorb
    products)."""
    from repro_torch.models.model import batches_columns
    if not batches_columns(cfg):
        return PATH_KERNELS[cfg.family]
    if cfg.family == "ssm":
        return PATH_KERNELS["ssm"] + ("rms_norm",)
    if cfg.mla:
        return PATH_KERNELS[cfg.family] + MLA_KERNELS
    return PATH_KERNELS[cfg.family] + COLUMN_KERNELS


#: the forward and backward launches each family's training path makes
#: (``moe_gemm_bwd`` counts backward calls through its forward kernel;
#: ``rglru_scan_bwd`` is a kernel of its own in its forward's source)
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
    # no Pallas kernel: the JAX package norms in jnp (XLA fuses it); the
    # port's serve bodies need a norm whose row bits ignore the row count
    "rms_norm": ("src/repro_torch/kernels/rms_norm/csrc/rms_norm.cu",
                 "src/repro/models/layers.py:67"),
    # no Pallas kernel: the JAX package's decode attention is jnp; the
    # port's serve bodies need one whose query bits ignore the row count
    "decode_attention": ("src/repro_torch/kernels/decode_attention/csrc/"
                         "decode_attention.cu",
                         "src/repro/models/attention.py:137"),
    # no Pallas kernel: the JAX package's MLA absorbed attention is jnp;
    # the port's serve bodies need one whose query bits ignore the row count
    "latent_attention": ("src/repro_torch/kernels/latent_attention/csrc/"
                         "latent_attention.cu",
                         "src/repro/models/attention.py:306"),
    # no Pallas kernel: the JAX train path differentiates the plain
    # blocked attention with XLA's autodiff
    "flash_attention_bwd": ("src/repro_torch/kernels/flash_attention/csrc/"
                            "flash_attention_bwd.cu",
                            "src/repro/models/attention.py:51"),
    # no Pallas kernel: the JAX train path differentiates the plain
    # associative scan of the Mamba block with XLA's autodiff
    "ssm_scan_bwd": ("src/repro_torch/kernels/ssm_scan/csrc/ssm_scan_bwd.cu",
                     "src/repro/models/ssm.py:96"),
    # no Pallas kernel: the JAX train path differentiates the plain
    # associative scan of the RG-LRU block with XLA's autodiff
    "rglru_scan_bwd": ("src/repro_torch/kernels/rglru_scan/csrc/"
                       "rglru_scan.cu", "src/repro/models/rglru.py:77"),
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
    ``iters`` calls after ``warmup`` calls queued behind a sleep on the
    card (``repro_torch.benchmarks.timing.event_ms``)."""
    from repro_torch.benchmarks.timing import event_ms
    return event_ms(fn, iters, warmup)


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
            if "Compiling entry function" in line:   # the kernel, mangled
                log(f"[build] {name}: {line.split(chr(39))[1][:120]}")
            elif "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def matmul_shapes(arch):
    """(product, K, N, dtypes) of every ``queue_matmul`` product on
    ``arch``'s serve path, at full width (or on the ``ModelConfig`` given
    in its place); the router runs in fp32 only.
    MLA's wuk and wuv (the latent to every head's k and v) run in the
    expanded form of ``forward`` only; its decode and chunk bodies absorb
    them, per head through ``moe_gemm`` (``MLA_ABSORB``)."""
    from repro_torch.configs import get_config
    from repro_torch.models.ssm import ssm_dims
    cfg = get_config(arch) if isinstance(arch, str) else arch
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


def entry_paths():
    """(path, config, the row counts M of its products, dtype, (batch,
    seq) of its training attention or None) of phase ``entry``'s main
    paths besides glm4-9b's ``forward``: quickstart (reduced
    phi3-mini-3.8b, fp32: 8 x 64 tokens a step, then 2 decode slots),
    train_lm's preset (fp32: batch x seq tokens a step), the prefill cell's
    decode bodies (``PREFILL_CARD``: full-width phi3-mini-3.8b over its
    slots, bf16) and serve_batch's (glm4-9b over 3 slots, bf16)."""
    from repro_torch.benchmarks import serve_slo
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.examples import train_lm
    lm = train_lm.PRESETS[TRAIN_LM["preset"]]
    card = serve_slo.PREFILL_CARD
    return [("quickstart", get_reduced("phi3-mini-3.8b"), (8 * 64, 2),
             torch.float32, (8, 64)),
            (f"train_lm {TRAIN_LM['preset']}",
             train_lm.model_config(TRAIN_LM["preset"]),
             (lm["batch"] * lm["seq"],), torch.float32,
             (lm["batch"], lm["seq"])),
            ("prefill cell", get_config(card["arch"]),
             (card["batch_slots"],), torch.bfloat16, None),
            ("serve_batch", get_config(ENTRY_ARCH), (3,), torch.bfloat16,
             None)]


#: (model, rows, slab, dtype) of the batched chunk bodies' products:
#: phase 4's chunks of 8 over 4 slots, serve_batch's over 3 (glm4-9b), the
#: prefill cells' of 16 over 2 (full width in bf16, reduced in fp32), each
#: row by row in slabs of the slots (models added since the list began
#: last, so that every earlier case keeps its inputs)
CHUNK_ROWS = (("phi3-mini-3.8b", False, 32, 4, torch.bfloat16),
              ("pixtral-12b", False, 32, 4, torch.bfloat16),
              ("nemotron-4-340b", False, 32, 4, torch.bfloat16),
              ("glm4-9b", False, 24, 3, torch.bfloat16),
              ("phi3-mini-3.8b", True, 32, 2, torch.float32),
              ("olmoe-1b-7b", False, 32, 4, torch.bfloat16),
              ("falcon-mamba-7b", False, 32, 4, torch.bfloat16),
              ("recurrentgemma-2b", False, 32, 4, torch.bfloat16),
              ("minicpm3-4b", False, 32, 4, torch.bfloat16))
#: the generator offset of those products' inputs (see ``OWN_DRAWS``)
CHUNK_DRAW = 29


#: ring depth pairs every queue_matmul case must give the same bits at
QM_DEPTHS = ((1, 1), (2, 2), (4, 4), (2, 4), (8, 8), (1, 8))


def check_queue_matmul(gen, report) -> dict:
    """Every product of the served models, of granite-moe-3b-a800m and of
    hubert-xlarge at M = 4 (decode over 4 slots; not the encoder's) and M =
    512 (``forward``; MLA's wuk/wuv there only), and phi3's q/k/v/o and ffn
    products also at M = 64 and 128 (the wide kernel's smallest tiles),
    then every product of :func:`entry_paths` at its rows and dtype,
    bit-identical across the ring depths of ``QM_DEPTHS`` and held to the
    plain version over the whole output (nemotron-4-340b's head weight has
    4.72e9 elements, its ffn wo sums K = 73728).  A product of more than
    a TFLOP is timed over fewer calls."""
    from repro_torch.kernels.queue_matmul import ops
    from repro_torch.kernels.queue_matmul.ref import matmul_ref
    rep = None
    log("[kernels] queue_matmul  model product  M     K     N    dtype  "
        "max_abs_err  ms  plain_ms  library_ms  bound_ms")

    def one(model, label, name, m, k, n, dtype, g, slab=None) -> dict:
        x = torch.randn((m, k), generator=g, device="cuda").to(dtype)
        # scaled in place: nemotron's head is 18.9 GB in fp32
        w = torch.randn((k, n), generator=g, device="cuda").div_(
            math.sqrt(k)).to(dtype)
        ref = matmul_ref(x, w).to(dtype)
        outs = {d: ops.queue_matmul(x, w, depth_x=d[0], depth_w=d[1],
                                    slab=slab)
                for d in QM_DEPTHS}
        torch.cuda.synchronize()
        base = outs[(1, 1)]
        for d, o in outs.items():
            if not torch.equal(o, base):
                raise AssertionError(
                    f"queue_matmul depths {d} differ from depth 1 at "
                    f"{model} {name} M={m} K={k} N={n} {dtype}")
        if slab is not None:
            # a chunk's rows: each slab's bits are the decode body's
            for i in range(0, m, slab):
                if not torch.equal(ops.queue_matmul(x[i:i + slab], w,
                                                    slab=slab),
                                   base[i:i + slab]):
                    raise AssertionError(
                        f"queue_matmul row by row: rows {i}-{i + slab} of "
                        f"{m} differ from their slab alone at {model} "
                        f"{name} K={k} N={n} {dtype}")
        err = within(base, ref, TOL[dtype])
        del outs, ref
        copies = max(2, math.ceil(100e6 / (w.numel() * w.element_size())))
        args = [(x, w)] + [(x.clone(), w.clone())
                           for _ in range(copies - 1)]
        make = cycling(args)
        n_it = 3 if 2.0 * m * n * k > 1e12 else 20
        ms = cuda_ms(make(lambda a, b: ops.queue_matmul(a, b, slab=slab)),
                     n_it)
        wall = wall_ms(make(lambda a, b: ops.queue_matmul(a, b, slab=slab)),
                       n_it)
        host = host_ms(make(lambda a, b: ops.queue_matmul(a, b, slab=slab)),
                       5 * n_it)
        plain = cuda_ms(make(lambda a, b: matmul_ref(a, b).to(a.dtype)),
                        n_it)
        lib = cuda_ms(make(torch.matmul), n_it)
        b_ms, b_by = bound(2.0 * m * n * k,
                           (m * k + k * n + m * n) * x.element_size(),
                           dtype)
        del args, make, w, base       # before the next draw: heads are GBs
        # the kernel this M takes (older trees have one kernel)
        kind = (ops.regime(m, dtype, slab is not None)
                if hasattr(ops, "regime") else "ring")
        log(f"[kernels] queue_matmul {label:>6s} "
            f"{name:>8s} {m:4d} {k:5d} {n:5d} {str(dtype)[6:]:>8s} "
            f"{err:10.3e} {ms:8.4f} {plain:8.4f} {lib:8.4f} {b_ms:8.4f} "
            f"({b_by}; {kind}"
            + (f", split {ops.split_k(k, n)}" if kind == "thin" else "")
            + (f", row by row in slabs of {slab}"
               + (f", {ops.thin_tiles(m, 4, 4)} tiles a block"
                  if kind == "thin" else "")
               if slab is not None else "")
            + f"; {2.0 * m * n * k / ms / 1e9:.1f} TFLOP/s, "
            f"{(m * k + k * n + m * n) * x.element_size() / ms / 1e6:.0f}"
            f" GB/s; wall {wall:.4f}, host {host:.4f})")
        row = {"model": model, "product": name, "M": m, "K": k, "N": n,
               "dtype": str(dtype)[6:], "regime": kind, "slab": slab,
               "max_abs_err": err, "ms": ms, "wall_ms": wall,
               "host_ms": host,
               "plain_ms": plain, "library_ms": lib, "bound_ms": b_ms,
               "bound_by": b_by}
        report.append({"kernel": "queue_matmul", **row})
        return row

    cases = [(arch, name, k, n, dtype)
             for arch in SERVED + ("granite-moe-3b-a800m",) + ENCODERS
             + (ENTRY_ARCH,)
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
            row = one(arch, arch.split("-")[0], name, m, k, n, dtype, g)
            if (m, k, n, dtype) == (4, 3072, 8192, torch.bfloat16):
                rep = row
        free_card()
    # phase entry's other main paths, from a generator of their own
    g = torch.Generator(device="cuda").manual_seed(SEED + ENTRY_DRAW)
    for path, cfg, rows, dtype, _ in entry_paths():
        for name, k, n, _ in matmul_shapes(cfg):
            for m in rows:
                if (m, k, n, dtype) in seen:
                    continue
                seen.add((m, k, n, dtype))
                one(cfg.name, path.split()[0], name, m, k, n, dtype, g)
            free_card()
    # a chunk's batched body (its head runs on the slots' rows only, as
    # decode's; MLA's wuk/wuv only in forward): each layer product row by
    # row, from a generator of its own, at CHUNK_ROWS
    from repro_torch.configs import get_config, get_reduced
    g = torch.Generator(device="cuda").manual_seed(SEED + CHUNK_DRAW)
    for arch, reduced, m, slab, dtype in CHUNK_ROWS:
        cfg = (get_reduced if reduced else get_config)(arch)
        for name, k, n, dtypes in matmul_shapes(cfg):
            if name not in ("head", "wuk/wuv") and dtype in dtypes:
                one(cfg.name, "chunk", name, m, k, n, dtype, g, slab)
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
    # glm4-9b's heads (32 over 2 of 128, a GQA group of 16) at phase
    # entry's 512 tokens, from its phase 2 products' generator
    entry = [(32, 2, 512, 512, 128, True, None, 0, 128)]
    glm = torch.Generator(device="cuda").manual_seed(
        SEED + OWN_DRAWS[ENTRY_ARCH])
    # the training heads of phase entry's other paths (quickstart's 4 of
    # 16 and train_lm's 8 over 4 of 64), causal, over their batches
    paths = [(b, (cfg.n_heads, cfg.n_kv_heads, seq, seq,
                  cfg.resolved_head_dim, True, None, 0,
                  cfg.resolved_head_dim))
             for _, cfg, _, _, (b, seq) in
             [p for p in entry_paths() if p[4] is not None]]
    own = torch.Generator(device="cuda").manual_seed(SEED + ENTRY_DRAW)
    runs = ([(1, c, gen) for c in cases] + [(1, c, extra) for c in trained]
            + [(1, c, latest) for c in registry]
            + [(1, c, glm) for c in entry] + [(b, c, own) for b, c in paths])
    for dtype in (torch.float32, torch.bfloat16):
        for b, case, g in runs:
            hq, hkv, sq, sk, d, causal, window, q_off, dv = case
            q = torch.randn((b, hq, sq, d), generator=g, device="cuda").to(dtype)
            k = torch.randn((b, hkv, sk, d), generator=g, device="cuda").to(dtype)
            v = torch.randn((b, hkv, sk, dv), generator=g, device="cuda").to(dtype)

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
            flops = 2.0 * b * hq * pairs * (d + dv)
            b_ms, b_by = bound(flops, b * (hq * sq + hkv * sk) * (d + dv)
                               * q.element_size(), dtype)
            log(f"[kernels] flash_attention {b:2d} {hq:3d} {hkv:3d} {sq:5d} "
                f"{sk:5d} {d:3d} {dv:3d} {int(causal):6d} {str(window):>6s} "
                f"{q_off:5d} {str(dtype)[6:]:>8s} {err:10.3e} {ms:8.4f} "
                f"{plain:8.4f} {lib:8.4f} {b_ms:8.4f} ({b_by}; "
                f"{ms / lib:.2f}x library; "
                f"{flops / ms / 1e9:.1f} TFLOP/s; "
                f"wall {wall:.4f})")
            row = {"B": b, "Hq": hq, "Hkv": hkv, "Sq": sq, "Sk": sk, "D": d,
                   "Dv": dv, "causal": causal, "window": window, "q_offset": q_off,
                   "dtype": str(dtype)[6:], "max_abs_err": err, "ms": ms,
                   "wall_ms": wall, "plain_ms": plain, "library_ms": lib,
                   "bound_ms": b_ms, "bound_by": b_by}
            report.append({"kernel": "flash_attention", **row})
            if (b, hq, hkv, sq, causal, window, d, dtype) == (
                    1, 32, 32, 512, True, None, 96, torch.bfloat16):
                rep = row
    # rows that see no key (a window of 64 without the causal mask over
    # 128 keys: query rows from 191 on), from a generator of their own:
    # exact zeros and a log-sum-exp of +inf, the rows before them the plain
    # version's (which averages v over a row whose scores are all masked)
    none = torch.Generator(device="cuda").manual_seed(SEED + 25)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(shape, generator=none, device="cuda").to(dtype)
                   for shape in ((1, 4, 512, 96), (1, 2, 128, 96),
                                 (1, 2, 128, 96)))
        out, lse = ops._launch(q, k, v, False, 64, 0, with_lse=True)
        torch.cuda.synchronize()
        if not (bool((out[:, :, 191:] == 0).all())
                and bool((lse[:, :, 191:] == math.inf).all())
                and bool(torch.isfinite(lse[:, :, :191]).all())):
            raise AssertionError(f"flash_attention {dtype}: a row with no key "
                                 f"is not 0 with a log-sum-exp of +inf")
        err = within(out[:, :, :191],
                     ops._plain(q, k, v, False, 64, 0)[:, :, :191], TOL[dtype])
        log(f"[kernels] flash_attention rows with no key, {str(dtype)[6:]}: "
            f"rows 191-511 of 512 zero, lse +inf; max abs err {err:.3e}")
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


def bwd_passes(run, calls: int = 10) -> dict:
    """Device ms per call of each kind of kernel a ``flash_attention_bwd``
    call launches (its prologue ``prep``, the dK/dV pass ``dkdv``, two
    launches at D > 128, the bf16 dQ pass ``dq_tc``, the fp32 pass
    ``f32``), by torch.profiler over ``calls`` calls after three warm-up
    calls; empty (not measured) unless every kind came back with a
    multiple of ``calls`` launches."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    ms, seen = {}, {}
    for e in prof.key_averages():
        part = next((p for p in ("prep", "dkdv", "dq_tc", "f32")
                     if f"flash_attention_bwd_{p}" in e.key), None)
        if part is not None:
            ms[part] = ms.get(part, 0.0) + e.device_time_total / 1e3 / calls
            seen[part] = seen.get(part, 0) + e.count
    if "prep" not in seen or any(n % calls for n in seen.values()):
        return {}
    return ms


def check_flash_attention_bwd(gen, report) -> dict:
    """The backward kernel against :func:`attention_bwd_ref` (through the
    wrapper's plain GQA path) on the same q, k, v, o, lse and dO, o and lse
    from the forward kernel, at ``BWD_CASES`` and the training heads of
    :func:`entry_paths` in fp32 and bf16; two calls must give the same
    bits, and rows that see no key zero gradients."""
    from repro_torch.kernels.flash_attention import ops
    rep = None
    log("[train] flash_attention_bwd  B  Hq Hkv   Sq   Sk   D  Dv causal "
        "window  dtype  max_abs_err  ms  plain_ms  library_ms  bound_ms")
    own = torch.Generator(device="cuda").manual_seed(SEED + 15)
    # the training heads of phase entry's other paths (quickstart's 4 of
    # 16, train_lm's 8 over 4 of 64), causal, from a generator of their own
    paths = [(b, cfg.n_heads, cfg.n_kv_heads, seq, seq,
              cfg.resolved_head_dim, cfg.resolved_head_dim, True, None)
             for _, cfg, _, _, (b, seq) in
             [p for p in entry_paths() if p[4] is not None]]
    entry = torch.Generator(device="cuda").manual_seed(SEED + ENTRY_DRAW)
    runs = ([(c, own if c in BWD_OWN else gen) for c in BWD_CASES]
            + [(c, entry) for c in paths])
    for dtype in (torch.float32, torch.bfloat16):
        for case, g in runs:
            b, hq, hkv, sq, sk, d, dv, causal, window = case

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
            passes = bwd_passes(run)
            log(f"[train] flash_attention_bwd {b:2d} {hq:3d} {hkv:3d} "
                f"{sq:4d} {sk:4d} {d:3d} {dv:3d} {int(causal):6d} "
                f"{str(window):>6s} {str(dtype)[6:]:>8s} {err:10.3e} "
                f"{ms:8.4f} {plain:8.4f} {lib:8.4f} {b_ms:8.4f} ({b_by}: "
                f"ops {t_ops:.4f}, bytes {t_mem:.4f}; "
                f"{ms / lib:.2f}x library; {b_ms / ms:.3f} of the bound; "
                f"{flops / ms / 1e9:.1f} TFLOP/s"
                + (f"; {n_empty} rows see no key: zero gradients"
                   if n_empty else "") + "; deterministic; by launch "
                + (", ".join(f"{k} {v:.4f}" for k, v in passes.items())
                   or "not measured") + ")")
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
    8) over 2 x 512 tokens, fp32 and bf16, then the products of the
    training paths of :func:`entry_paths` at their tokens and dtype
    (dY at 1/sqrt(M); the distances of both from fp64 logged); dW's
    rows are K, so in bf16 both products take the wide kernel.  Times: the two
    products with their transposes, and ``torch.matmul``'s two."""
    from repro_torch.kernels.queue_matmul import ops
    from repro_torch.kernels.queue_matmul.ref import matmul_ref
    log("[train] queue_matmul grads  M     K     N  dtype  dX err  dW err  "
        "dX ms  dW ms  library dX, dW ms  bound ms (each)")

    def one(m, k, n, dtype, gen, entry: bool = False) -> None:
        x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
        w = (torch.randn((k, n), generator=gen, device="cuda")
             / math.sqrt(k)).to(dtype)
        dy = torch.randn((m, n), generator=gen, device="cuda")
        if entry:
            dy = dy / math.sqrt(m)
        dy = dy.to(dtype)
        xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
        dx, dw = torch.autograd.grad(ops.queue_matmul(xg, wg), (xg, wg),
                                     dy)
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        rx, rw = torch.autograd.grad(matmul_ref(xr, wr).to(dtype),
                                     (xr, wr), dy)
        note = ""
        if entry:
            # both against the plain version on fp64 copies, logged
            xe, we = (t.double().requires_grad_() for t in (x, w))
            gx, gw = torch.autograd.grad(matmul_ref(xe, we), (xe, we),
                                         dy.double())
            note = "; from fp64 dX, dW: kernel {:.3e}, {:.3e}, plain {:.3e}, " \
                   "{:.3e}".format(*((a.double() - b).abs().max().item()
                                     for a, b in ((dx, gx), (dw, gw),
                                                  (rx, gx), (rw, gw))))
            del xe, we, gx, gw
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
            f"{2.0 * m * k * n / ms_w / 1e9:.1f} TFLOP/s{note})")
        report.append({"kernel": "queue_matmul_grads", "M": m, "K": k,
                       "N": n, "dtype": str(dtype)[6:], "dx_err": ex,
                       "dw_err": ew, "dx_ms": ms_x, "dw_ms": ms_w,
                       "library_dx_ms": lib_x, "library_dw_ms": lib_w,
                       "bound_ms": b_ms, "bound_by": b_by})
        del x, w, dy, dx, dw, rx, rw, xg, wg, xr, wr

    for dtype in (torch.float32, torch.bfloat16):
        for k, n in ((3072, 3072), (3072, 8192), (8192, 3072),
                     (3072, 32064), (1536, 49155)):
            one(1024, k, n, dtype, gen)
        free_card()
    # the training paths of phase entry, at their own tokens and products,
    # from a generator of their own.  dY is drawn at 1/sqrt(M), as w is at
    # 1/sqrt(K), so that dW = X^T dY, a sum over M = 4096 tokens, stays
    # O(1): at unit dY its entries reach the hundreds, and where they
    # cancel near 0 the fp32 plain version's own rounding passed 2e-4 on
    # the card (cuBLAS, farther from fp64 than the kernel there).  Both
    # distances from fp64 are logged
    gen = torch.Generator(device="cuda").manual_seed(SEED + ENTRY_DRAW)
    for _, cfg, rows, dtype, batch in entry_paths():
        if batch is None:
            continue
        for _, k, n, _ in matmul_shapes(cfg):
            one(rows[0], k, n, dtype, gen, entry=True)
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
    """``rglru_scan_bwd`` (the reverse walk's kernel) against
    :func:`rglru_scan_bwd_ref` on the forward kernel's h at
    recurrentgemma's training shape ``RGLRU_TRAIN``, a in fp32 and bf16, g
    fp32; equal across two calls; its launch (``ops.bwd_geometry``)
    logged.  No single PyTorch call computes it."""
    from repro_torch.kernels.rglru_scan import ops
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_bwd_ref
    rep = None
    log("[train] rglru_scan_bwd  B    T     w  dtype  max_abs_err  ms  "
        "plain_ms  bound_ms")
    b, t, w = RGLRU_TRAIN
    for dtype in (torch.float32, torch.bfloat16):
        a, bx = rglru_inputs(gen, (b, t, w), dtype)
        g = torch.randn((b, t, w), generator=gen, device="cuda")
        h = ops.rglru_scan(a, bx)
        geo = ops.bwd_geometry(b, t, w, dtype)
        log(f"[train] rglru_scan_bwd {str(dtype)[6:]} a: blocks of "
            f"{geo.tile} channels x {geo.chunks} chunks of "
            f"{ops.plan.STEPS} steps ({geo.threads} threads, "
            f"{geo.segments} segments of {geo.segment}), {geo.blocks} "
            f"blocks, {geo.resident} an SM on {geo.sms} SMs: "
            f"{geo.waves} wave(s)")

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
            + f"; {b_ms / ms:.3f} of the bound; no library call; "
            "deterministic)")
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
    width (drawn as phase 3 draws them, at ``scale``) in fp32 on the card
    (the kernels and their backward kernels, remat on, as the training path
    runs them), in fp32 on the CPU and in fp64 on the CPU (the witness).
    Each leaf's RMS distance from fp64 on the card must be at most
    ``FP64_RATIO`` times the CPU fp32 run's, and the loss within 2e-3 of
    fp64.  The two CPU runs go side by side in two threads, without remat
    and with the head held transposed (``head_t``, as the serving engine
    holds it); neither changes a bit of their gradients, whose ``head_t``
    is transposed back.  The distances are taken on the card in fp64, one
    leaf at a time."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.config import RunConfig
    from repro_torch.configs import get_config
    from repro_torch.models.layers import tree_map
    from repro_torch.models.layers import tree_leaves
    from repro_torch.train.step import _grads
    full = get_config(arch)
    cfg = cut_depth(full)
    t0 = time.time()
    p_gpu = cut_weights(cfg, full, scale)
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
    laps = [f"weights {time.time() - t0:.1f}"]
    t1 = time.time()
    g, m = _grads(p_gpu, {k: v.cuda() for k, v in batch.items()}, cfg,
                  RunConfig(dtype="float32", remat=True))
    runs = {"card": (float(m["loss"]), tree_leaves(g))}
    names = _leaf_names(p_gpu)
    del g
    laps.append(f"card {time.time() - t1:.1f}")
    t1 = time.time()
    p32 = tree_map(lambda a: a.cpu(),
                   {k: v for k, v in p_gpu.items() if k != "head"})
    if "head" in p_gpu:
        p32["head_t"] = p_gpu["head"].t().contiguous().cpu()
    del p_gpu
    free_card()
    p64 = tree_map(lambda a: a.double(), p32)
    laps.append(f"host copies {time.time() - t1:.1f}")

    def witness(p, dtype):
        t = time.time()
        g, m = _grads(p, batch, cfg, RunConfig(dtype=dtype, remat=False))
        if "head_t" in g:
            g["head"] = g.pop("head_t").t()
        return float(m["loss"]), tree_leaves(g), time.time() - t

    with ThreadPoolExecutor(2) as pool:
        jobs = {"cpu": pool.submit(witness, p32, "float32"),
                "fp64": pool.submit(witness, p64, "float64")}
        for name, job in jobs.items():
            loss, leaves, secs = job.result()
            runs[name] = (loss, leaves)
            laps.append(f"{name} {secs:.1f}")
    del p32, p64, jobs
    what = f"{arch} ({cfg.n_layers} layers, {scale} scale) gradients"
    loss = {k: v[0] for k, v in runs.items()}
    log(f"[train] {what}: loss card {loss['card']:.7f}, CPU fp32 "
        f"{loss['cpu']:.7f}, fp64 {loss['fp64']:.7f} (card off fp64 by "
        f"{abs(loss['card'] - loss['fp64']):.3e})")
    if abs(loss["card"] - loss["fp64"]) > 2e-3:
        failures.append(f"{what}: loss {loss['card']} is more than 2e-3 "
                        f"from fp64's {loss['fp64']}")
    t1 = time.time()
    worst = 0.0
    for name, card, cpu, exact in zip(names, runs["card"][1],
                                      runs["cpu"][1], runs["fp64"][1]):
        exact = exact.cuda()
        r_card, r_cpu = rms(card, exact), rms(cpu.cuda(), exact)
        ratio = r_card / r_cpu if r_cpu > 0 else (0.0 if r_card == 0
                                                  else math.inf)
        worst = max(worst, ratio)
        log(f"[train]   {name:>22s}: from fp64 card rms {r_card:.3e}, CPU "
            f"fp32 rms {r_cpu:.3e} (card/CPU {ratio:.3f}); fp64 rms "
            f"{exact.pow(2).mean().sqrt().item():.3e}")
        if ratio > FP64_RATIO:
            failures.append(f"{what}: leaf {name} is {ratio:.2f} times "
                            f"farther from fp64 on the card than on the CPU")
        del exact
    del runs
    free_card()
    laps.append(f"distances {time.time() - t1:.1f}")
    log(f"[train] {what}: worst card/CPU rms ratio {worst:.3f} (at most "
        f"{FP64_RATIO}); done in {time.time() - t0:.1f} s (seconds "
        f"{', '.join(laps)})")


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


#: the kernel-name groups of a training step's profile, one for every
#: kernel of the port, each matched as a substring of the CUDA kernel's name
#: in this order (the reverse walk of ``rglru_scan`` is
#: ``rglru_scan_bwd_kernel``)
PROFILE_GROUPS = ("flash_attention_bwd", "flash_attention", "queue_matmul",
                  "moe_gemm", "ssm_scan_bwd", "ssm_scan",
                  "rglru_scan_bwd_kernel", "rglru_scan", "rms_norm",
                  "decode_attention", "latent_attention")


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
    check_moe_rows(report)
    return rep


#: (model, E, d, f, rows an expert) of the batched chunk's expert products
#: row by row in slabs of ``MOE_SLAB`` slots: olmoe-1b-7b at phase 4's
#: chunk (8 columns, 2 tiles a block) and at 16 columns (4 tiles), granite-
#: moe-3b-a800m at 8; wi/wg with the shared x, wo with a per-expert x
MOE_ROWS = (("olmoe-1b-7b", 64, 2048, 1024, (32, 64)),
            ("granite-moe-3b-a800m", 40, 1536, 512, (32,)))
MOE_SLAB = 4
#: the generator offset of those products' inputs (see ``OWN_DRAWS``)
MOE_ROWS_DRAW = 31


def check_moe_rows(report) -> None:
    """``moe_gemm`` row by row (``slab``: the thin kernel at any C, up to
    four 16-row tiles of an expert a block) at ``MOE_ROWS``, with every
    expert and with the mask of a top-8 routing of the chunk's tokens (the
    union of its rows' experts), in bf16: held to the plain version, the
    same bits at every depth, every slab of 4 rows the bits of a call over
    that slab alone (the decode body's), and at C = 4 the same bits with
    and without ``slab``.  Timed beside its byte bound (the active experts'
    weights) and ``torch.bmm`` with x broadcast over every expert (a
    yardstick: it computes every expert)."""
    from repro_torch.kernels.moe_gemm import ops
    from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref
    depth = ops.operating_point().effective_depths()[1]
    dtype = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(SEED + MOE_ROWS_DRAW)
    log(f"[kernels] moe_gemm row by row  model  E    C     d     f  x  "
        f"max_abs_err  ms  plain_ms  library_ms  bound_ms  (depth {depth}, "
        f"slabs of {MOE_SLAB})")
    for arch, e, dm, fe, cs in MOE_ROWS:
        for d, f, bcast in ((dm, fe, True), (fe, dm, False)):
            w = (torch.randn((e, d, f), generator=g, device="cuda")
                 / math.sqrt(d)).to(dtype)
            for c in cs:
                x = torch.randn((c, d) if bcast else (e, c, d), generator=g,
                                device="cuda").to(dtype)
                if bcast:
                    x = x.expand(e, c, d)
                small = ops.moe_gemm(x[:, :MOE_SLAB], w)
                if not torch.equal(ops.moe_gemm(x[:, :MOE_SLAB], w,
                                                slab=MOE_SLAB), small):
                    raise AssertionError(
                        f"moe_gemm's C = {MOE_SLAB} bits changed row by row "
                        f"at {arch} d={d} f={f}")
                for routed in (False, True):
                    active = routed_mask(g, c, e, 8) if routed else None
                    n_act = int(active.sum()) if routed else e
                    ref = moe_gemm_ref(x, w, active)
                    outs = {k: ops.moe_gemm(x, w, depth=k, active=active,
                                            slab=MOE_SLAB) for k in (1, 2, 4)}
                    torch.cuda.synchronize()
                    base = outs[1]
                    for k, o in outs.items():
                        if not torch.equal(o, base):
                            raise AssertionError(
                                f"moe_gemm row by row: depth {k} differs "
                                f"from depth 1 at {arch} C={c} d={d}")
                    for i in range(0, c, MOE_SLAB):
                        alone = ops.moe_gemm(x[:, i:i + MOE_SLAB], w,
                                             depth=depth, active=active,
                                             slab=MOE_SLAB)
                        if not torch.equal(alone, base[:, i:i + MOE_SLAB]):
                            raise AssertionError(
                                f"moe_gemm row by row: rows {i}-"
                                f"{i + MOE_SLAB} of {c} differ from their "
                                f"slab alone at {arch} d={d} f={f}")
                    err = within(base, ref, TOL[dtype])
                    del outs, ref, base
                    args = [(x, w.clone()) for _ in range(2)]
                    make = cycling(args)
                    ms = cuda_ms(make(lambda a, b: ops.moe_gemm(
                        a, b, depth=depth, active=active, slab=MOE_SLAB)))
                    plain = cuda_ms(make(lambda a, b: moe_gemm_ref(
                        a, b, active, MOE_SLAB)), iters=5)
                    xb = x.contiguous()
                    lib = cuda_ms(lambda: torch.bmm(xb, w))
                    x_bytes = (c if bcast else n_act * c) * d * 2
                    nbytes = x_bytes + n_act * d * f * 2 + e * c * f * 4
                    b_ms, b_by = bound(2.0 * n_act * c * d * f, nbytes,
                                       dtype)
                    del args, make, xb
                    tiles = ops.thin_tiles(c, depth)
                    log(f"[kernels] moe_gemm rows {arch.split('-')[0]:>7s} "
                        f"{e:3d} {c:4d} {d:5d} {f:5d} {'b' if bcast else 'e'}"
                        f" {err:10.3e} {ms:8.4f} {plain:8.4f} {lib:8.4f} "
                        f"{b_ms:8.4f} ({b_by}; thin, {tiles} tiles a block, "
                        f"split {ops.split_k(e, d, f)}; {n_act} of {e} "
                        f"experts active"
                        + (f", routed top-8 of {c} tokens" if routed else "")
                        + f"; {nbytes / ms / 1e6:.0f} GB/s; "
                        f"{ms / lib:.2f}x bmm)")
                    report.append({
                        "kernel": "moe_gemm", "model": arch, "E": e, "C": c,
                        "d": d, "f": f, "broadcast_x": bcast, "dtype":
                        "bfloat16", "depth": depth, "regime": "thin",
                        "slab": MOE_SLAB, "tiles": tiles, "routed": routed,
                        "active": n_act, "max_abs_err": err, "ms": ms,
                        "plain_ms": plain, "library_ms": lib,
                        "bound_ms": b_ms, "bound_by": b_by})
                del x
            del w
            free_card()


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


#: (B, T, w) of phase 2's ``rglru_scan`` cases, a and bx in fp32 and in
#: bf16: recurrentgemma-2b's width over the 512 tokens of phase 4's
#: ``forward``, the 128 of phase 3's and 4096 (walked in segments)
RGLRU_CASES = ((1, 512, 2560), (1, 128, 2560), (1, 4096, 2560))
#: recurrentgemma-2b's training shape (phase 5 (d): 2 x 512 tokens), a
#: forward case of phase 2 in fp32 (the model's inputs) and phase 5 (a)'s
#: reverse walk
RGLRU_TRAIN = (2, 512, 2560)


def rglru_inputs(gen, shape, dtype):
    """a and bx as the model's gates make them: a = exp(-8 softplus(1) r),
    r a sigmoid; bx = sqrt(1 - a^2) x; both in ``dtype``."""
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    a = torch.exp(-8.0 * math.log1p(math.e) * torch.sigmoid(rnd(*shape)))
    bx = torch.sqrt(1.0 - a * a) * rnd(*shape)
    return a.to(dtype), bx.to(dtype)


def check_rglru_scan(gen, report) -> dict:
    """recurrentgemma-2b's scan at ``RGLRU_CASES``, then at its training
    shape ``RGLRU_TRAIN`` in fp32 (34 launches a training step), with a and
    bx drawn as the model's gates make them.  No single PyTorch call
    computes it, so there is no library time."""
    from repro_torch.kernels.rglru_scan import ops
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
    rep = None
    log("[kernels] rglru_scan  B    T     w  dtype  max_abs_err  ms  "
        "plain_ms  bound_ms")
    cases = [(dtype, shape) for dtype in (torch.float32, torch.bfloat16)
             for shape in RGLRU_CASES] + [(torch.float32, RGLRU_TRAIN)]
    for dtype, (b, t, w) in cases:
        a, bx = rglru_inputs(gen, (b, t, w), dtype)
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
        if (b, t, dtype) == (1, 512, torch.float32):   # the model's inputs
            rep = row
    return rep


#: (model, rows, d, dtype, gamma's dtype) of phase 2's ``rms_norm`` cases:
#: the norms of the serve path's decode bodies (B rows) and chunks (B x C
#: rows) at phase 4's 4 slots and chunk 8, the final norm's fp32 gamma,
#: serve_batch's 3 slots (glm4-9b) and the reduced prefill cells' 2 x 16
#: rows in fp32
NORM_CASES = (("phi3", 4, 3072, torch.bfloat16, torch.bfloat16),
              ("phi3", 32, 3072, torch.bfloat16, torch.bfloat16),
              ("phi3 final", 4, 3072, torch.bfloat16, torch.float32),
              ("pixtral", 32, 5120, torch.bfloat16, torch.bfloat16),
              ("nemotron", 4, 18432, torch.bfloat16, torch.bfloat16),
              ("nemotron", 32, 18432, torch.bfloat16, torch.bfloat16),
              ("glm4", 24, 4096, torch.bfloat16, torch.bfloat16),
              ("phi3-smoke", 32, 64, torch.float32, torch.float32),
              ("falcon-mamba", 4, 4096, torch.bfloat16, torch.bfloat16),
              ("falcon-mamba", 32, 4096, torch.bfloat16, torch.bfloat16),
              ("rgemma", 4, 2560, torch.bfloat16, torch.bfloat16),
              ("rgemma", 32, 2560, torch.bfloat16, torch.bfloat16))


def norm_inputs(gen, rows, d, dtype, gdt):
    """x (rows, d) and gamma (d,) of a ``NORM_CASES`` row, drawn on the
    card from ``gen``."""
    x = (3 * torch.randn((rows, d), generator=gen, device="cuda")).to(dtype)
    g = (0.1 * torch.randn((d,), generator=gen, device="cuda")).to(gdt)
    return x, g


def norm_work(x, g):
    """(operations, bytes) of the norm: x read and y written, gamma read;
    a square, an add and two multiplies an element."""
    rows, d = x.shape
    return (4.0 * rows * d,
            2 * rows * d * x.element_size() + d * g.element_size())


def check_rms_norm(gen, report) -> dict:
    """The row-wise norm of the decode and chunk bodies at ``NORM_CASES``
    against its plain version (the model's norm), every row's bits equal
    to that row normed alone; beside ``F.rms_norm`` with the weight
    ``1 + gamma`` made beforehand (one library call, the same function)."""
    import torch.nn.functional as F
    from repro_torch.kernels import rms_norm
    from repro_torch.kernels.rms_norm.ref import rms_norm_ref
    rep = None
    # the floor of one launch, timed as the rows below are: a one-element
    # in-place add (the yardstick of the norm at decode's few rows)
    one = torch.zeros(1, device="cuda")
    floor = cuda_ms(lambda: one.add_(1))
    log(f"[kernels] floor: one-element in-place add {floor:8.4f} ms")
    report.append({"kernel": "floor", "ms": floor})
    log("[kernels] rms_norm  model  rows  d  dtype  gamma  max_abs_err  ms  "
        "plain_ms  library_ms  bound_ms")
    for model, rows, d, dtype, gdt in NORM_CASES:
        x, g = norm_inputs(gen, rows, d, dtype, gdt)
        out = rms_norm(x, g)
        err = within(out, rms_norm_ref(x, g), TOL[dtype])
        for i in (0, rows - 1):
            if not torch.equal(rms_norm(x[i:i + 1], g), out[i:i + 1]):
                raise AssertionError(f"rms_norm: row {i} of {rows} differs "
                                     f"from the row alone at d={d} {dtype}")
        ms = cuda_ms(lambda: rms_norm(x, g))
        plain = cuda_ms(lambda: rms_norm_ref(x, g))
        weight = (1.0 + g.float()).to(dtype)
        lib = cuda_ms(lambda: F.rms_norm(x, (d,), weight, 1e-5))
        b_ms, b_by = bound(*norm_work(x, g), torch.float32)
        log(f"[kernels] rms_norm {model:>10s} {rows:3d} {d:5d} "
            f"{str(dtype)[6:]:>8s} {str(gdt)[6:]:>8s} {err:10.3e} "
            f"{ms:8.4f} {plain:8.4f} {lib:8.4f} {b_ms:8.4f} ({b_by}; rows "
            f"equal alone)")
        row = {"model": model, "rows": rows, "d": d, "dtype": str(dtype)[6:],
               "gamma": str(gdt)[6:], "max_abs_err": err, "ms": ms,
               "plain_ms": plain, "library_ms": lib, "bound_ms": b_ms,
               "bound_by": b_by}
        report.append({"kernel": "rms_norm", **row})
        if (model, rows) == ("phi3", 32):
            rep = row
    return rep


#: (model, slots B, columns C, query heads, K/V heads, cache rows T, head
#: dim, dtype, the slots' lengths) of phase 2's ``decode_attention``
#: cases: phase 4's decode bodies (C 1) and chunks of 8 over 4 slots of
#: 256 rows (recurrentgemma's ring of 256 rows, shorter than its window,
#: attends a chunk's columns at once), the prefill cells' chunks of 16 over
#: 2 slots of 80 rows (full width in bf16, reduced in fp32), serve_batch's
#: 3 slots of 128 rows, and the decode steps and a chunk that a served
#: phi3-mini-3.8b and glm4-9b reach at a 4K context (rows that cross many
#: 64-position spans)
ATTN_CASES = (
    ("phi3", 4, 1, 32, 32, 256, 96, torch.bfloat16, (40, 17, 33, 8)),
    ("phi3", 4, 8, 32, 32, 256, 96, torch.bfloat16, (24, 0, 9, 16)),
    ("phi3 cell", 2, 16, 32, 32, 80, 96, torch.bfloat16, (48, 0)),
    ("pixtral", 4, 8, 32, 8, 256, 128, torch.bfloat16, (24, 0, 9, 16)),
    ("nemotron", 4, 8, 96, 8, 256, 192, torch.bfloat16, (24, 0, 9, 16)),
    ("glm4", 3, 8, 32, 2, 128, 128, torch.bfloat16, (5, 0, 12)),
    ("phi3-smoke", 2, 16, 4, 4, 80, 16, torch.float32, (48, 0)),
    ("olmoe", 4, 1, 16, 16, 256, 128, torch.bfloat16, (40, 17, 33, 8)),
    ("rgemma", 4, 1, 10, 1, 256, 256, torch.bfloat16, (40, 17, 33, 8)),
    ("phi3 4k", 4, 1, 32, 32, 4096, 96, torch.bfloat16,
     (4095, 3000, 2047, 999)),
    ("phi3 4k chunk", 4, 8, 32, 32, 4096, 96, torch.bfloat16,
     (4000, 2900, 2000, 990)),
    ("glm4 4k", 3, 1, 32, 2, 4096, 128, torch.bfloat16, (4095, 2047, 999)),
    ("rgemma", 4, 8, 10, 1, 256, 256, torch.bfloat16, (24, 0, 9, 16)))


#: q's scale where the cache is longer than one 256-position group (the 4K
#: rows): scores of standard deviation 4 rest each softmax on a few
#: positions, so the outputs are O(0.5), well above the bf16 tolerance, and
#: a lost span or group shows (unscaled, they are about 0.03 at 4K)
LONG_Q_SCALE = 4.0


def attn_inputs(gen, b, c, hq, hkv, t, d, dtype, lens):
    """q, the caches and valid of an ``ATTN_CASES`` row, drawn on the card
    from ``gen``: query (c, b) sees rows [0, lens[b] + c + 1), at most T;
    q scaled by ``LONG_Q_SCALE`` where T is over 256."""
    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device="cuda")
                ).to(dtype)
    q = rnd(c, b, hq, d, scale=LONG_Q_SCALE if t > 256 else 1.0)
    k, v = rnd(b, hkv, t, d), rnd(b, hkv, t, d)
    valid = (torch.tensor(lens, device="cuda")[None] + 1
             + torch.arange(c, device="cuda")[:, None]).clamp(max=t)
    return q, k, v, valid.to(torch.int32)


def attn_library(q, k, v, valid):
    """One library call of the same function: SDPA with a boolean mask
    over the GQA heads."""
    import torch.nn.functional as F
    qs = q.permute(1, 2, 0, 3)                          # (B, Hq, C, D)
    mask = (torch.arange(k.shape[2], device=q.device)[None, None]
            < valid.t()[:, :, None])[:, None]           # (B, 1, C, T)
    return lambda: F.scaled_dot_product_attention(qs, k, v, attn_mask=mask,
                                                  enable_gqa=True)


def attn_work(q, k, valid):
    """(operations, bytes) of decode attention: each query's visible rows'
    scores and weighted sum; q read and the output written, each slot's
    K/V rows up to its longest column's length read once, valid read."""
    hq, d = q.shape[2], q.shape[3]
    hkv = k.shape[1]
    seen = valid.long().sum().item()
    flops = 4.0 * seen * d * (hq // hkv) * hkv
    rows = valid.long().max(dim=0).values.sum().item()
    es = q.element_size()
    return flops, (2 * q.numel() * es + 2 * rows * hkv * d * es
                   + valid.numel() * 4)


def check_decode_attention(gen, report) -> dict:
    """The decode and chunk bodies' attention at ``ATTN_CASES`` (query
    (c, b) sees rows [0, len[b] + c + 1)) against its plain version, every
    column's queries equal bit for bit to the column alone (a decode
    step's call); beside SDPA with a boolean mask over the GQA heads (one
    library call, the same function)."""
    from repro_torch.kernels import decode_attention
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_rows_ref)
    rep = None
    log("[kernels] decode_attention  model  B  C  Hq/Hkv  T  D  dtype  "
        "max_abs_err  ms  plain_ms  library_ms  bound_ms")
    for model, b, c, hq, hkv, t, d, dtype, lens in ATTN_CASES:
        q, k, v, valid = attn_inputs(gen, b, c, hq, hkv, t, d, dtype, lens)
        out = decode_attention(q, k, v, valid)
        err = within(out, decode_attention_rows_ref(q, k, v, valid),
                     TOL[dtype])
        for j in range(c):
            if not torch.equal(decode_attention(q[j:j + 1], k, v,
                                                valid[j:j + 1]),
                               out[j:j + 1]):
                raise AssertionError(f"decode_attention: column {j} of {c} "
                                     f"differs from the column alone "
                                     f"({model} {dtype})")
        ms = cuda_ms(lambda: decode_attention(q, k, v, valid))
        plain = cuda_ms(lambda: decode_attention_rows_ref(q, k, v, valid),
                        iters=5)
        lib = cuda_ms(attn_library(q, k, v, valid))
        b_ms, b_by = bound(*attn_work(q, k, valid), torch.float32)
        log(f"[kernels] decode_attention {model:>10s} {b:2d} {c:3d} "
            f"{hq:3d}/{hkv:<3d} {t:4d} {d:4d} {str(dtype)[6:]:>8s} "
            f"{err:10.3e} {ms:8.4f} {plain:8.4f} {lib:8.4f} {b_ms:8.4f} "
            f"({b_by}; columns equal alone)")
        row = {"model": model, "B": b, "C": c, "Hq": hq, "Hkv": hkv, "T": t,
               "D": d, "dtype": str(dtype)[6:], "max_abs_err": err, "ms": ms,
               "plain_ms": plain, "library_ms": lib, "bound_ms": b_ms,
               "bound_by": b_by}
        report.append({"kernel": "decode_attention", **row})
        if (model, c) == ("phi3", 8):
            rep = row
    return rep


#: (case, slots B, columns C, heads H, cache rows T, latent r, rope dr,
#: dtype, the slots' first-column positions) of phase 2's
#: ``latent_attention`` cases: minicpm3's decode body and chunk of 8 over
#: phase 4's 4 slots of 256 rows, a chunk whose columns reach ``max_len``
#: (each clamped column reads rows [0, T - 1) and its own row), a decode
#: step at a 4K context (16 groups and the merge), the chunk in fp32 (the
#: parity runs'), and reduced minicpm3's widths in both dtypes (an 8-byte
#: rope row in bf16)
LATENT_CASES = (
    ("minicpm3", 4, 1, 40, 256, 256, 32, torch.bfloat16, (40, 17, 33, 8)),
    ("minicpm3", 4, 8, 40, 256, 256, 32, torch.bfloat16, (24, 0, 9, 16)),
    ("clamped", 4, 8, 40, 256, 256, 32, torch.bfloat16,
     (250, 255, 252, 100)),
    ("minicpm3 4k", 4, 1, 40, 4096, 256, 32, torch.bfloat16,
     (4095, 3000, 2047, 999)),
    ("fp32", 4, 8, 40, 256, 256, 32, torch.float32, (24, 0, 9, 16)),
    ("reduced", 2, 8, 4, 16, 16, 4, torch.float32, (3, 12)),
    ("reduced", 2, 8, 4, 16, 16, 4, torch.bfloat16, (3, 12)))
#: minicpm3's q/k head dim (nope 64 + rope 32): the scores' 1/sqrt
LATENT_QK = 96


def latent_inputs(gen, b, c, h, t, r, dr, dtype, lens):
    """q_eff, q_rope, the caches, rows and the self rows of a
    ``LATENT_CASES`` row, drawn on the card from ``gen``: column c of slot
    b at position lens[b] + c reads rows [0, min(position, T - 1)); q_eff
    scaled by ``LONG_Q_SCALE`` where T is over 256."""
    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device="cuda")
                ).to(dtype)
    q = rnd(c, b, h, r, scale=LONG_Q_SCALE if t > 256 else 1.0)
    qr, lat, rope = rnd(c, b, h, dr), rnd(b, t, r), rnd(b, t, dr)
    own, own_r = rnd(c, b, r), rnd(c, b, dr)
    rows = (torch.tensor(lens, device="cuda")[None]
            + torch.arange(c, device="cuda")[:, None]).clamp(max=t - 1)
    return q, qr, lat, rope, rows.to(torch.int32), own, own_r


def latent_library(q, qr, lat, rope, rows, own, own_r):
    """One library call of the same function: SDPA with q = [q_eff |
    q_rope] over one K/V head (``enable_gqa``), k = [latent | rope] of the
    cache rows and then every column's own row, v = the latent, and a
    boolean mask (column c sees rows [0, rows) and its own row)."""
    import torch.nn.functional as F
    c = q.shape[0]
    t = lat.shape[1]
    qs = torch.cat([q, qr], dim=-1).permute(1, 2, 0, 3)      # (B, H, C, .)
    k = torch.cat([torch.cat([lat, rope], dim=-1),
                   torch.cat([own, own_r], dim=-1).transpose(0, 1)],
                  dim=1)[:, None]                          # (B, 1, T + C, .)
    v = torch.cat([lat, own.transpose(0, 1)], dim=1)[:, None]
    pos = torch.arange(t + c, device=q.device)
    cols = torch.arange(c, device=q.device)
    mask = ((pos[None, None] < rows.t()[:, :, None])
            | (pos[None, None] == t + cols[None, :, None]))[:, None]
    return lambda: F.scaled_dot_product_attention(
        qs, k, v, attn_mask=mask, scale=1.0 / math.sqrt(LATENT_QK),
        enable_gqa=True)


def latent_work(q, qr, rows, esize):
    """(operations, bytes) of the latent attention: each query's rows and
    its own row, scored over r + dr and summed over r; q_eff, q_rope and
    the self rows read and the output written once, each slot's cache rows
    up to its longest column's read once, rows read."""
    c, b, h, r = q.shape
    dr = qr.shape[-1]
    seen = (rows.long() + 1).sum().item()
    flops = 2.0 * seen * h * (r + dr + r)
    cache = rows.long().max(dim=0).values.sum().item() * (r + dr)
    nbytes = ((2 * q.numel() + qr.numel() + c * b * (r + dr) + cache)
              * esize + rows.numel() * 4)
    return flops, nbytes


def check_latent_attention(gen, report) -> dict:
    """MLA's attention of the decode and chunk bodies at ``LATENT_CASES``
    against its plain version, every column's queries equal bit for bit to
    the column alone (a decode step's call) and the heads below and from 16
    launched alone equal to the whole launch's (a row's bits ignore its
    place in a 16-row tile); beside SDPA over the [latent | rope] keys with
    a boolean mask (one library call, the same function).  The bound is
    taken at the inputs' dtype's peak: bf16's tensor-core rate for the bf16
    rows, fp32's CUDA-core rate for the fp32 rows."""
    from repro_torch.kernels import latent_attention
    from repro_torch.kernels.latent_attention.ref import latent_attention_ref
    rep = None
    scale = 1.0 / math.sqrt(LATENT_QK)
    log("[kernels] latent_attention  case  B  C  H  T  r/dr  dtype  "
        "max_abs_err  ms  plain_ms  library_ms  bound_ms")
    for case, b, c, h, t, r, dr, dtype, lens in LATENT_CASES:
        args = latent_inputs(gen, b, c, h, t, r, dr, dtype, lens)
        q, qr, lat, _, rows, _, _ = args
        out = latent_attention(*args, scale)
        err = within(out, latent_attention_ref(*args, scale), TOL[dtype])
        for j in range(c):
            one = [a if a is lat or a is args[3] else a[j:j + 1]
                   for a in args]
            if not torch.equal(latent_attention(*one, scale),
                               out[j:j + 1]):
                raise AssertionError(f"latent_attention: column {j} of {c} "
                                     f"differs from the column alone "
                                     f"({case} {dtype})")
        for lo, hi in ((0, min(16, h)), (min(16, h), h)):
            if lo < hi and not torch.equal(latent_attention(
                    q[:, :, lo:hi].contiguous(),
                    qr[:, :, lo:hi].contiguous(), *args[2:], scale),
                    out[:, :, lo:hi]):
                raise AssertionError(f"latent_attention: heads {lo}-{hi - 1}"
                                     f" differ from the whole launch's "
                                     f"({case} {dtype})")
        ms = cuda_ms(lambda: latent_attention(*args, scale))
        plain = cuda_ms(lambda: latent_attention_ref(*args, scale), iters=5)
        lib = cuda_ms(latent_library(*args))
        b_ms, b_by = bound(*latent_work(q, qr, rows, lat.element_size()),
                           dtype)
        log(f"[kernels] latent_attention {case:>11s} {b:2d} {c:3d} {h:3d} "
            f"{t:5d} {r:3d}/{dr:<3d} {str(dtype)[6:]:>8s} {err:10.3e} "
            f"{ms:8.4f} {plain:8.4f} {lib:8.4f} {b_ms:8.4f} ({b_by}; "
            f"columns and heads equal alone)")
        row = {"model": case, "B": b, "C": c, "H": h, "T": t, "r": r,
               "dr": dr, "dtype": str(dtype)[6:], "max_abs_err": err,
               "ms": ms, "plain_ms": plain, "library_ms": lib,
               "bound_ms": b_ms, "bound_by": b_by}
        report.append({"kernel": "latent_attention", **row})
        if (case, c, dtype) == ("minicpm3", 8, torch.bfloat16):
            rep = row
        del args, q, qr, lat, rows, out
    free_card()
    return rep


#: (product, heads E, rows an expert C, d, f, dtype) of an MLA layer's
#: per-head absorb products on minicpm3's serve path: q_nope W_uk (64 to
#: the latent's 256) and o_lat W_uv (256 to v's 64) over a decode body's 4
#: slots and a chunk's 32 rows, row by row in slabs of 4
MLA_ABSORB = tuple((name, 40, c, d, f, dtype)
                   for dtype in (torch.bfloat16, torch.float32)
                   for c in (4, 32)
                   for name, d, f in (("q_nope W_uk", 64, 256),
                                      ("o_lat W_uv", 256, 64)))
#: the generator offset of those products' inputs (see ``OWN_DRAWS``)
MLA_ABSORB_DRAW = 37


def check_mla_absorb(report) -> None:
    """``moe_gemm`` row by row (``slab`` 4) at ``MLA_ABSORB``, a per-head x
    of C rows an expert: held to the plain version, every slab's rows equal
    to a call over that slab alone (the decode body's); timed beside its
    bound and ``torch.bmm`` (one library call, the same products)."""
    from repro_torch.kernels.moe_gemm import ops
    from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref
    depth = ops.operating_point().effective_depths()[1]
    g = torch.Generator(device="cuda").manual_seed(SEED + MLA_ABSORB_DRAW)
    log(f"[kernels] moe_gemm MLA absorb  product  E  C  d  f  dtype  "
        f"max_abs_err  ms  plain_ms  library_ms  bound_ms  (depth {depth}, "
        f"slabs of 4)")
    for name, e, c, d, f, dtype in MLA_ABSORB:
        w = (torch.randn((e, d, f), generator=g, device="cuda")
             / math.sqrt(d)).to(dtype)
        x = torch.randn((e, c, d), generator=g, device="cuda").to(dtype)
        out = ops.moe_gemm(x, w, depth=depth, slab=4)
        err = within(out, moe_gemm_ref(x, w), TOL[dtype])
        for i in range(0, c, 4):
            if not torch.equal(ops.moe_gemm(x[:, i:i + 4], w, depth=depth,
                                            slab=4), out[:, i:i + 4]):
                raise AssertionError(f"moe_gemm MLA absorb: rows {i}-"
                                     f"{i + 4} of {c} differ from their slab "
                                     f"alone at {name} {dtype}")
        ms = cuda_ms(lambda: ops.moe_gemm(x, w, depth=depth, slab=4))
        plain = cuda_ms(lambda: moe_gemm_ref(x, w, None, 4), iters=5)
        lib = cuda_ms(lambda: torch.bmm(x, w))
        es = x.element_size()
        b_ms, b_by = bound(2.0 * e * c * d * f,
                           (e * c * d + e * d * f) * es + e * c * f * 4,
                           dtype)
        kind = ops.regime(c, dtype, True)
        log(f"[kernels] moe_gemm absorb {name:>12s} {e:3d} {c:3d} {d:4d} "
            f"{f:4d} {str(dtype)[6:]:>8s} {err:10.3e} {ms:8.4f} "
            f"{plain:8.4f} {lib:8.4f} {b_ms:8.4f} ({b_by}; {kind}; slabs "
            f"equal alone)")
        report.append({"kernel": "moe_gemm", "model": "minicpm3-4b",
                       "product": name, "E": e, "C": c, "d": d, "f": f,
                       "dtype": str(dtype)[6:], "depth": depth,
                       "regime": kind, "slab": 4, "max_abs_err": err,
                       "ms": ms, "plain_ms": plain, "library_ms": lib,
                       "bound_ms": b_ms, "bound_by": b_by})
        del w, x, out
    free_card()


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


def cut_weights(cfg, full, scale: str):
    """Phase 3's and 5 (b)'s seeded weights of the cut depth ``cfg``, drawn
    on the card (its generator is faster than the host's) and rescaled to
    ``scale`` (:func:`redraw_scale`)."""
    from repro_torch.models import init_model_params
    params = init_model_params(SEED, cfg, device="cuda")
    redraw_scale(params, cfg, full, scale)
    return params


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
                                    prepare_params)
    from repro_torch.models.layers import tree_map
    full = get_config(arch)
    cfg = cut_depth(full)
    rc = RunConfig(dtype="float32", remat=False)
    rc64 = RunConfig(dtype="float64", remat=False)
    t0 = time.time()
    p_gpu = cut_weights(cfg, full, scale)
    laps = [f"weights {time.time() - t0:.1f}"]
    rng = np.random.default_rng(SEED)
    seq = PARITY_SEQ.get(arch, 128)
    inputs = model_inputs(cfg, rng, 1, seq)
    name = f"{arch} ({cfg.n_layers} layers, {scale} scale)"
    if cfg.frontend:
        log(f"[parity] {name}: inputs {sorted(inputs)}; {host_memory()}")
    routes = {"card": [], "cpu": [], "fp64": []}

    def lap(what, t1):
        laps.append(f"{what} {time.time() - t1:.1f}")
    t1 = time.time()
    # the weights prepared once for each run, as the engine holds them
    # (cast, the head transposed), for the forward and every step; the
    # host's from a copy of the card's, whose head the card transposed
    prep = {"card": prepare_params(p_gpu, cfg, rc)}
    prep["cpu"] = tree_map(lambda a: a.cpu(), prep["card"])
    prep["fp64"] = prepare_params(prep["cpu"], cfg, rc64)
    del p_gpu
    lap("prepare", t1)
    t1 = time.time()
    with routing(routes["card"]):
        out_gpu = forward(prep["card"],
                          {k: v.cuda() for k, v in inputs.items()}, cfg, rc)
        torch.cuda.synchronize()
    lap("card", t1)
    t1 = time.time()
    with routing(routes["cpu"]):
        out_cpu = forward(prep["cpu"], inputs, cfg, rc)
    lap("cpu", t1)
    t1 = time.time()
    with routing(routes["fp64"]):
        exact = forward(prep["fp64"], inputs, cfg, rc64)
    lap("fp64", t1)
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
            f"{time.time() - t0:.1f} s (seconds {', '.join(laps)})")
        del prep
        free_card()
        return
    caches = {"card": init_cache(cfg, 4, 16, torch.float32, device="cuda"),
              "cpu": init_cache(cfg, 4, 16, torch.float32, device="cpu"),
              "fp64": init_cache(cfg, 4, 16, torch.float64, device="cpu")}
    steps = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 4)))
    t1 = time.time()
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
    del caches
    lap("decode", t1)
    if cfg.family == "hybrid":
        t1 = time.time()
        ring_parity(prep, cfg, rng, name, hold, failures)
        lap("ring", t1)
    del prep
    free_card()
    log(f"[parity] {name} done in {time.time() - t0:.1f} s (seconds "
        f"{', '.join(laps)})")


def ring_parity(prep: dict, cfg, rng, name: str, hold: bool,
                failures: list) -> None:
    """The hybrid model with its window cut to ``RING_WINDOW``: a
    ``prefill_step`` of ``RING_PROMPT`` tokens into caches of
    ``RING_MAX_LEN``, whose K/V ring of ``RING_WINDOW`` slots wraps, then 4
    ``decode_step``s, on the card, on the CPU and in fp64 (on
    :func:`phase_parity`'s prepared weights ``prep``, which the window does
    not change), each held as in :func:`phase_parity`."""
    from repro_torch.config import RunConfig
    from repro_torch.models import decode_step, init_cache, prefill_step
    wcfg = dataclasses.replace(
        cfg, rglru=dataclasses.replace(cfg.rglru, window=RING_WINDOW))
    runs = {k: (prep[k], dev, RunConfig(dtype=dtype, remat=False))
            for k, dev, dtype in (("card", "cuda", "float32"),
                                  ("cpu", "cpu", "float32"),
                                  ("fp64", "cpu", "float64"))}
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
    from repro_torch.kernels import launch_counters as counters
    return counters()


def log_programs(eng, arch: str, what: str) -> None:
    """Log each step program ``eng`` ran (its capture seconds, replays,
    launches a replay and pool bytes); raises unless every one is a
    captured CUDA graph."""
    progs = eng.programs()
    for name, p in progs.items():
        log(f"[serve] {arch} {what} program {name}: {p['kind']}, "
            f"{p['calls']} calls, {p['replays']} replays, captured in "
            f"{p['capture_s']:.3f} s, pool +{p['pool_bytes'] / 2**20:.1f} "
            f"MiB; launches a replay {p['launches_per_replay']}")
    if eng.program_kind != "cuda_graph" or not progs or not all(
            p["kind"] == "cuda_graph" and p["captured"]
            for p in progs.values()):
        raise AssertionError(f"{arch} {what}: a step program was not "
                             f"captured as a CUDA graph: {progs}")


#: phase 4's engine: slots, cache length and prefill chunk; and the
#: requests' prompt lengths (least, most) and new tokens (phases 4 and 4b)
SERVE_ENGINE = dict(batch_slots=4, max_len=256, prefill_chunk=8)
SERVE_PROMPT, SERVE_NEW = (8, 32), 8
#: phase 4's tokens by model, one list per request, for the policy phase
SERVED_TOKENS = {}


def serve_prompts(cfg, rng) -> list:
    """Phase 4's 6 requests: ``SERVE_PROMPT`` prompt tokens each, drawn
    from ``rng`` (``SEED`` + 1)."""
    lo, hi = SERVE_PROMPT
    return [[int(t) for t in rng.integers(0, cfg.vocab,
                                          int(rng.integers(lo, hi + 1)))]
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
    rids = [eng.submit(p, max_new=SERVE_NEW) for p in prompts]
    t0 = time.time()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    if sorted(done) != sorted(rids):
        raise AssertionError(f"unfinished requests: {set(rids) - set(done)}")
    n_tok = sum(len(r.generated) for r in done.values())
    if n_tok != SERVE_NEW * len(rids):
        raise AssertionError(f"{n_tok} tokens generated, want "
                             f"{SERVE_NEW * len(rids)}")
    SERVED_TOKENS[arch] = [done[r].generated for r in rids]
    log(f"[serve] {arch} chunked prefill: {len(done)} requests, {n_tok} "
        f"tokens in {wall:.2f} s wall = {n_tok / wall:.2f} tok/s; "
        f"{eng._n_steps} steps; launches "
        f"{ {k: c.launches for k, c in counters.items()} }; prefill widths "
        f"{sorted(eng._prefill_fns)}")
    log_programs(eng, arch, "chunked")
    # the same requests again on the same engine, its programs captured:
    # the warm rate, and readmitted slots giving the first run's tokens
    rids_w = [eng.submit(p, max_new=SERVE_NEW) for p in prompts]
    t0 = time.time()
    eng.run()
    torch.cuda.synchronize()
    wall_w = time.time() - t0
    if [eng.finished[r].generated for r in rids_w] != SERVED_TOKENS[arch]:
        raise AssertionError(f"{arch}: the warm run's tokens differ from "
                             f"the first run's")
    log(f"[serve] {arch} chunked prefill again, programs captured: same "
        f"tokens; {n_tok} tokens in {wall_w:.2f} s wall = "
        f"{n_tok / wall_w:.2f} tok/s")

    tok_eng = ServeEngine(eng.params, cfg, rc, batch_slots=4, max_len=256,
                          prefill="token")
    rids_t = [tok_eng.submit(p, max_new=SERVE_NEW) for p in prompts]
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
    log_programs(tok_eng, arch, "token")
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
    for name in path_kernels(cfg):
        if counts[name] <= 0:
            raise AssertionError(f"{name} never launched on {arch}'s main "
                                 f"path")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[serve] {arch} launches on the main path: {counts}; peak memory "
        f"{peak:.2f} GiB")
    log(f"[serve] {arch} first tokens: {done[rids[0]].generated}")
    profile_decode(eng, arch)
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


def _extra(tree, specs, prefix: str = ""):
    """(path, bytes) of each leaf of ``tree`` that ``specs`` does not name:
    the prepared tree's ``head_t`` and an MLA layer's head-major
    ``wuk_h``/``wuv_h``."""
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if k not in specs:
            yield path, sum(t.nbytes for t in (
                v.values() if isinstance(v, dict) else [v]))
        elif isinstance(v, dict):
            yield from _extra(v, specs[k], path + "/")


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
    extra = dict(_extra(eng.params, specs))
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


def _profiled(step, n: int):
    """Mean wall ms of ``step()`` over ``n`` calls back to back (host
    clock, no profiler), the device ms by kernel name of ``n`` more calls
    (torch.profiler, CUDA activity only), and the device kernels a
    call."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    wall = (time.time() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    ran = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    return (wall, {e.key: e.self_device_time_total / n / 1e3 for e in ran},
            sum(e.count for e in ran) / n)


def profile_decode(eng, arch: str, n: int = 5) -> None:
    """A decode body over the engine's slots, eager (``decode_step``) and
    as the engine runs it (its captured CUDA graph replayed, the tokens
    copied in): launches per body, its wall time (host clock, no
    profiler), and the kernel time inside it (torch.profiler, CUDA
    activity only), by kernel; the device's idle share is one minus their
    ratio.  Runs after the launch counts are read."""
    from repro_torch.models import decode_step
    cfg = eng.cfg
    slots = eng.cache["len"].shape[0]
    tok = torch.zeros((slots, 1), dtype=torch.long, device="cuda")
    tok_np = np.zeros((slots, 1), np.int64)
    eager = lambda: decode_step(eng.params, eng.cache, {"tokens": tok}, cfg,
                                eng.rc)
    replay = lambda: eng._step(tokens=tok_np)
    counters = launch_counters()
    before = {k: c.launches for k, c in counters.items()}
    routes = []
    with routing(routes):
        eager()
    torch.cuda.synchronize()
    per_body = {k: c.launches - before[k] for k, c in counters.items()
                if c.launches > before[k]}
    if cfg.moe:
        # the experts each MoE layer's mask keeps: those its slots route to
        act = [len(torch.unique(r)) for r in routes]
        log(f"[profile] {arch} active experts per MoE layer of a decode "
            f"body ({slots} slots, top-{cfg.moe.top_k} of "
            f"{cfg.moe.num_experts}): mean {sum(act) / len(act):.2f}, "
            f"{act}")
    replay()                      # captures the graph if it has none yet
    for what, step in (("eager", eager), ("replayed", replay)):
        wall, dev, kernels = _profiled(step, n)
        busy = sum(dev.values())
        if busy == 0:
            log(f"[profile] {arch} {what} decode body: {wall:.2f} ms wall; "
                f"idle share not measured (the profiler saw no device "
                f"time)")
            continue
        ours = {k: sum(v for key, v in dev.items() if k in key)
                for k in per_body}
        log(f"[profile] {arch} {what} decode body ({slots} slots, "
            f"{cfg.n_layers} layers): launches {per_body}; {wall:.2f} ms "
            f"wall, {busy:.2f} ms in {kernels:.0f} kernels ("
            + ", ".join(f"{v:.2f} {k}" for k, v in ours.items())
            + f", {busy - sum(ours.values()):.2f} other); device idle share "
            f"{1 - busy / wall:.3f}")
        if what == "eager":
            for k, v in sorted(dev.items(), key=lambda kv: -kv[1])[:8]:
                log(f"[profile]   {v:8.3f} ms  {k[:90]}")
    profile_chunk(eng, arch, n)


def profile_chunk(eng, arch: str, n: int) -> None:
    """The engine's widest chunk program replayed with every count 0 (a
    no-op on the cache by construction; a count changes which rows are
    kept, not the work): wall, kernels and kernel time a chunk and a
    prompt token of a full chunk (slots x width of them), and its largest
    kernels.  Every decoder family runs one body over the chunk's rows,
    only the SSM and RG-LRU recurrences walking the columns."""
    if not eng._prefill_fns:
        return
    width = max(eng._prefill_fns)
    prog = eng._prefill_fns[width]
    slots = eng.cache["len"].shape[0]
    tok = np.zeros((slots, width), np.int64)
    zero = np.zeros((slots,), np.int32)
    before = {k: v.clone() for k, v in eng.cache.items()}
    wall, dev, kernels = _profiled(lambda: prog(tokens=tok, n_tokens=zero),
                                   n)
    for k, v in eng.cache.items():
        if not torch.equal(v, before[k]):
            raise AssertionError(f"{arch}: a chunk of zero counts changed "
                                 f"the cache leaf {k}")
    busy, per = sum(dev.values()), slots * width
    log(f"[profile] {arch} replayed chunk of width {width} ({slots} slots, "
        f"one batched body; counts 0, the cache unchanged): a chunk "
        f"{wall:.2f} ms "
        f"wall, {busy:.2f} ms in {kernels:.0f} kernels; a prompt token "
        f"{wall / per:.3f} ms wall, {busy / per:.3f} ms in "
        f"{kernels / per:.1f} kernels")
    for k, v in sorted(dev.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[profile]   {v:8.3f} ms a chunk  {k[:90]}")


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
    """Submit ``prompts`` (``SERVE_NEW`` new tokens each) and step ``eng``
    until every request is done; ``on_step()`` runs after each step.
    Returns the generated tokens per request, the wall seconds and the token
    count.  At most 1000 steps, as ``ServeEngine.run`` takes."""
    rids = [eng.submit(p, max_new=SERVE_NEW) for p in prompts]
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
    # launches by ring depths, in eager calls and in graph captures
    depths = {}
    captured = {}

    def recording_launch(x, w, depth_x, depth_w, **kw):
        into = (captured if torch.cuda.is_current_stream_capturing()
                else depths)
        into[(depth_x, depth_w)] = into.get((depth_x, depth_w), 0) + 1
        return launch(x, w, depth_x, depth_w, **kw)

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
        graphs = [p for p in eng.programs().values() if p["captured"]]
        per_graph = sum(p["launches_per_replay"].get("queue_matmul", 0)
                        for p in graphs)
        replayed = sum(p["replays"]
                       * p["launches_per_replay"].get("queue_matmul", 0)
                       for p in graphs)
        log(f"[policy] queue_matmul launches by ring depths (x, w): eager "
            f"{depths}, captured in {len(graphs)} CUDA graphs {captured} "
            f"(replayed {replayed}); launches on the main path {counts}")
        log_programs(eng, POLICY_ARCH, "calibrated")
        if tokens != want:
            bad = [i for i, (a, b) in enumerate(zip(tokens, want)) if a != b]
            raise AssertionError(f"{POLICY_ARCH}: calibrated tokens differ "
                                 f"from phase 4's on requests {bad}")
        if not charged or report.cost_source != "calibrated" or any(
                h["source"] != "calibrated" for h in eng.traffic_history):
            raise AssertionError(f"not calibrated: report "
                                 f"{report.cost_source}, history "
                                 f"{eng.traffic_history}")
        if set(depths) | set(captured) != {qm.effective_depths()} or \
                sum(captured.values()) != per_graph or \
                counts["queue_matmul"] != sum(depths.values()) + replayed \
                or replayed <= 0:
            raise AssertionError(f"queue_matmul launched at {depths}, "
                                 f"captured at {captured} ({per_graph} a "
                                 f"replay of each graph, {replayed} "
                                 f"replayed; {counts['queue_matmul']} "
                                 f"counted), calibrated "
                                 f"{qm.effective_depths()}")
        log(f"[policy] same tokens as phase 4 for all {len(tokens)} "
            f"requests; every queue_matmul launch at the calibrated depths "
            f"{qm.effective_depths()}, eager, captured and replayed")

        # (c) the device's idle share of a decode body at the calibrated
        # depths, beside phase 4's at the default ones
        profile_decode(eng, POLICY_ARCH)
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


# ---------------------------------------------------------------------------
# entry: the entry scripts on the card
# ---------------------------------------------------------------------------

#: phase ``entry``'s cut for the script's time limit: train_lm takes 200
#: of the reference's 300 steps (hosts differ up to 2x in a served step's
#: wall, NVIDIA H100 80GB HBM3, 700.00 W, so the script keeps to well
#: under its 1200 s).  The full-width prefill cell runs its 5 timed trials
#: after its warm run, as its steps replay CUDA graphs
TRAIN_LM = dict(preset="100m", steps=200)
PREFILL_TRIALS = 5
#: phase ``entry``'s host step, run in a child: the reference's ten host
#: smoke sections, then the port's drift gate on the committed artifacts
#: and this run's prefill cell (``sys.argv[1]``).  The sweep floors read the
#: full sweep sections' artifacts, which a fresh checkout does not have and
#: the time limit leaves no room to write, so their rows say so
HOST_STEP = """\
import sys
from repro_torch.benchmarks import bench_diff, run
run.run_sections(run.host_smoke_sections() + [
    ("bench drift gate (committed artifacts; the card's prefill cell)",
     lambda: bench_diff.run(prefill_path=sys.argv[1], sweep_floors=False))])
"""
HOST_STEP_TIMEOUT = 300


def _reset(counters) -> None:
    for c in counters.values():
        c.launches = 0


def _read(counters, need, what: str) -> dict:
    """The launches since :func:`_reset`; raises unless every kernel of
    ``need`` ran."""
    counts = {k: c.launches for k, c in counters.items() if c.launches}
    for name in need:
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"{name} never launched on {what}'s main "
                                 f"path")
    return counts


def entry_quickstart(counters) -> dict:
    """``repro_torch.examples.quickstart`` at its default (reduced
    phi3-mini-3.8b, 20 steps): finite losses, the last below the first,
    8 tokens decoded."""
    from repro_torch.configs import get_reduced
    from repro_torch.examples import quickstart
    from repro_torch.models import init_model_params
    cfg = get_reduced("phi3-mini-3.8b")
    params = init_model_params(0, cfg, device="cuda")
    _reset(counters)
    t0 = time.time()
    out = quickstart.run(params, cfg, 20, "cuda")
    torch.cuda.synchronize()
    counts = _read(counters, TRAIN_KERNELS["dense"], "quickstart")
    losses = out["losses"]
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0] or len(out["generated"]) != 8:
        raise AssertionError(f"quickstart: losses {losses}, generated "
                             f"{out['generated']}")
    log(f"[entry] quickstart {cfg.name}: 20 steps in {time.time() - t0:.1f}"
        f" s, loss {losses[0]:.4f} -> {losses[-1]:.4f}, generated "
        f"{out['generated']}; launches {counts}")
    return counts


def entry_serve_batch(counters, smi: str) -> dict:
    """``serve_batch --full`` on ``ENTRY_ARCH`` (glm4-9b: 40 layers, bf16,
    weights drawn leaf by leaf), chunked and token prefill on the same
    weights: equal tokens for every request and the same traffic history;
    then ``forward`` at B=1 S=512 (``flash_attention`` at 32 over 2
    heads), the peak memory and a profile of a decode body."""
    from repro_torch.config import RunConfig
    from repro_torch.configs import get_config
    from repro_torch.examples import serve_batch
    from repro_torch.models import forward, init_model_params
    cfg = get_config(ENTRY_ARCH)
    rc = RunConfig(dtype="bfloat16", param_dtype="bfloat16", remat=False)
    t0 = time.time()
    params = init_model_params(SEED, cfg, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    log(f"[entry] serve_batch --full {ENTRY_ARCH} ({cfg.n_layers} layers, "
        f"d {cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}; {cfg.n_params() / 1e9:.2f} B "
        f"parameters): bf16 weights drawn in {time.time() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    _reset(counters)
    res = {p: serve_batch.run(params, cfg, rc, 6, 10, p, "cuda")
           for p in ("chunked", "token")}
    del params
    chunked, token = res["chunked"], res["token"]
    if chunked["tokens"] != token["tokens"] or \
            chunked["traffic_history"] != token["traffic_history"]:
        raise AssertionError(f"{ENTRY_ARCH}: chunked and token prefill "
                             f"differ: {chunked['tokens']} vs "
                             f"{token['tokens']}")
    if [len(t) for t in chunked["tokens"]] != [10] * 6:
        raise AssertionError(f"{ENTRY_ARCH}: tokens {chunked['tokens']}")
    for p, r in res.items():
        log(f"[entry] {ENTRY_ARCH} {p} prefill: 60 tokens in "
            f"{r['wall_s']:.2f} s wall = {60 / r['wall_s']:.2f} tok/s; "
            f"{r['steps']} steps, {r['prefill_compiles']} chunk programs; "
            f"traffic {r['traffic_level']}; {smi}")
    log(f"[entry] {ENTRY_ARCH}: chunked and token prefill give the same "
        f"tokens and traffic history")
    del token["engine"]
    eng = chunked["engine"]
    inputs = {k: v.cuda() for k, v in model_inputs(
        cfg, np.random.default_rng(SEED + 1), 1, 512).items()}
    fa = counters["flash_attention"].launches
    t0 = time.time()
    logits = forward(eng.params, inputs, cfg, eng.rc)
    torch.cuda.synchronize()
    fwd_s = time.time() - t0
    if logits.shape != (1, 512, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{ENTRY_ARCH}: forward logits not finite")
    if counters["flash_attention"].launches - fa != cfg.n_layers:
        raise AssertionError(f"{ENTRY_ARCH}: forward launched "
                             f"flash_attention "
                             f"{counters['flash_attention'].launches - fa} "
                             f"times, want {cfg.n_layers}")
    del logits
    counts = _read(counters, path_kernels(cfg), ENTRY_ARCH)
    log(f"[entry] {ENTRY_ARCH} forward B=1 S=512 ({cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads of {cfg.resolved_head_dim}): {fwd_s:.3f} s "
        f"wall; launches on the main path {counts}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {smi}")
    log_programs(eng, ENTRY_ARCH, "serve_batch chunked")
    profile_decode(eng, ENTRY_ARCH)
    del eng, chunked, res
    free_card()
    return counts


def entry_train_lm(counters, smi: str) -> dict:
    """``train_lm --preset 100m`` (fp32, 8 x 512 tokens a step) for
    ``TRAIN_LM["steps"]`` steps, its checkpoints under ``build/`` removed
    afterwards; the script raises unless the loss improved."""
    import shutil
    import tempfile
    from repro_torch.examples import train_lm
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="train_lm_",
                            dir=os.path.join(ROOT, "build"))
    _reset(counters)
    try:
        out = train_lm.run(TRAIN_LM["preset"], TRAIN_LM["steps"], 1e-3,
                           ckpt, "cuda")
        saved = sorted(d for d in os.listdir(ckpt) if d.startswith("step_"))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    counts = _read(counters, TRAIN_KERNELS["dense"], "train_lm")
    steps = TRAIN_LM["steps"]
    log(f"[entry] train_lm --preset {TRAIN_LM['preset']} "
        f"({out['params_count'] / 1e6:.1f} M parameters, fp32): {steps} "
        f"steps in {out['wall_s']:.1f} s = {out['wall_s'] / steps:.4f} s a "
        f"step, {out['tokens'] / out['wall_s']:.0f} tokens/s (checkpoints "
        f"included); loss {out['first']:.4f} -> {out['last']:.4f}; "
        f"checkpoints {saved}; launches {counts}; {smi}")
    free_card()
    return counts


def entry_benchmarks(smi: str) -> None:
    """``kernel_bench`` at the reference's shapes and ``--shapes main``
    (the depths' bits equal, their medians and spreads over the rounds),
    and ``collective_policy`` on one NCCL rank, in its child process."""
    from repro_torch.benchmarks import collective_policy, kernel_bench
    for name, us, derived in kernel_bench.run("cuda", "reference"):
        log(f"[entry] kernel_bench {name},{us:.2f},{derived:.4f}")
    kernel_bench.run("cuda", "main")
    with open(kernel_bench.OUT_PATHS["main"]) as f:
        art = json.load(f)
    for r in art["rounds"]:
        log(f"[entry] kernel_bench --shapes main {'x'.join(map(str, r['shape']))}"
            f" {r['call']}: median {r['median_us']:.2f} us over "
            f"{len(r['rounds_us'])} rounds (min {r['min_us']:.2f}, max "
            f"{r['max_us']:.2f}, spread {r['spread']:.3f}); "
            f"{art['device']}")
    data = collective_policy.measure("cuda")
    for name, us, derived in collective_policy.rows(data):
        log(f"[entry] collective_policy {name},{us:.2f},{derived:.4f} "
            f"(mesh {data['mesh']}; {smi})")


def _prefill_cell(counters, cfg, out_path: str, min_wall_gain: float,
                  what: str, smi: str) -> dict:
    """``serve_slo.run_prefill(cfg)`` on the card as its own main path (the
    counts set to 0 just before it, read just after): its gates, TTFTs,
    gains and programs logged.  Returns its launches."""
    from repro_torch.benchmarks import serve_slo
    _reset(counters)
    t0 = time.time()
    serve_slo.run_prefill(dict(cfg), out_path=out_path,
                          min_wall_gain=min_wall_gain, device="cuda")
    counts = _read(counters, ("queue_matmul",) + COLUMN_KERNELS,
                   f"the prefill cell {what}")
    with open(out_path) as f:
        rep = json.load(f)
    head, ttft, c = rep["headline"], rep["ttft"], rep["config"]
    log(f"[entry] prefill cell {what} ({c['arch']}"
        f"{' full width' if c.get('full') else ' reduced'}, "
        f"{c.get('dtype', 'float32')}, prompt {c['prompt_len']}, chunk "
        f"{c['prefill_chunk']}, {c['trials']} trials) in "
        f"{time.time() - t0:.1f} s: bit-exact {head['bit_exact']}; "
        f"cycles-domain TTFT gain {head['ttft_cycles_gain']:.3f} (gate >= "
        f"{serve_slo.MIN_PREFILL_TTFT_GAIN}); {rep['prefill_compiles']} "
        f"chunk programs (<= {rep['max_prefill_compiles']}), "
        f"{rep['program_kind']}; steps {rep['steps']}; launches {counts}")
    for path, progs in rep["programs"].items():
        log(f"[entry] prefill cell {what} {path} programs: "
            + "; ".join(f"{k} {p['kind']} {p['calls']} calls, captured in "
                        f"{p['capture_s']:.3f} s, pool +"
                        f"{p['pool_bytes'] / 2**20:.1f} MiB"
                        for k, p in progs.items()))
    log(f"[entry] prefill cell {what} wall TTFT: chunked "
        f"{ttft['wall_s_chunked_median']:.4f} s, token "
        f"{ttft['wall_s_token_median']:.4f} s (medians of "
        f"{ttft['wall_s_chunked']} and {ttft['wall_s_token']}); "
        f"ttft_wall_gain {head['ttft_wall_gain']:.4f}, min_required "
        f"{head['min_required']}, meets_wall_bar {head['meets_wall_bar']} "
        f"(enforced); {smi}")
    free_card()
    return counts


def entry_prefill(counters, smi: str) -> dict:
    """The prefill cells on the card, each its own main path:
    ``PREFILL_CARD`` at ``PREFILL_TRIALS`` trials (full-width
    phi3-mini-3.8b in bf16: its hard gates and the reference's wall bar of
    2.0), then the reference's own ``PREFILL_SMOKE`` and ``PREFILL_FULL``
    (reduced phi3, fp32; their bars of 1.2 and 2.0).  A cell that misses
    its bar fails the run.  Returns their launches by kernel."""
    from repro_torch.benchmarks import serve_slo
    launches = {}
    for cfg, path, bar, what in (
            (dict(serve_slo.PREFILL_CARD, trials=PREFILL_TRIALS),
             serve_slo.PREFILL_CARD_OUT_PATH, serve_slo.MIN_PREFILL_TTFT_GAIN,
             "PREFILL_CARD"),
            (serve_slo.PREFILL_SMOKE, serve_slo.PREFILL_SMOKE_OUT_PATH,
             serve_slo.MIN_PREFILL_TTFT_GAIN_SMOKE, "PREFILL_SMOKE"),
            (serve_slo.PREFILL_FULL, serve_slo.PREFILL_OUT_PATH,
             serve_slo.MIN_PREFILL_TTFT_GAIN, "PREFILL_FULL")):
        for name, n in _prefill_cell(counters, cfg, path, bar, what,
                                     smi).items():
            launches[name] = launches.get(name, 0) + n
    return launches


def entry_host(smi: str) -> None:
    """:data:`HOST_STEP` in a child process (the parent holds the card, and
    a sweep may fork workers), its artifacts and calibration under
    ``build/``, removed afterwards; a failed section or a non-zero exit
    fails the phase.  Logs each section's verdict, the drift gate's table
    and the step's wall."""
    import shutil
    from repro_torch.benchmarks import serve_slo
    out = os.path.join(ROOT, "build", "entry_host")
    shutil.rmtree(out, ignore_errors=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env["REPRO_PORT_ART_DIR"] = out
    env["REPRO_CALIBRATION_DIR"] = os.path.join(out, "calibration")
    t0 = time.time()
    try:
        res = subprocess.run(
            [sys.executable, "-c", HOST_STEP,
             serve_slo.PREFILL_CARD_OUT_PATH], env=env, cwd=ROOT,
            capture_output=True, text=True, timeout=HOST_STEP_TIMEOUT)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    wall = time.time() - t0
    for line in res.stdout.splitlines():
        if line.startswith(("# PASS", "# FAIL", "| ", "bench_diff_")):
            log(f"[entry] host {line}")
    if res.returncode != 0:
        raise AssertionError(
            f"phase entry's host step failed ({res.returncode}):\n"
            f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    log(f"[time] phase entry's host step (10 host smoke sections and "
        f"bench_diff, in a child) in {wall:.1f} s; host CPU {host_cpu()}; "
        f"{smi}")


def phase_entry(smi: str) -> dict:
    """The entry scripts on the card, each of quickstart, serve_batch (and
    its ``forward``), train_lm and the prefill cell its own main path:
    the launch counts set to 0 just before it and read just after, every
    kernel of its path launched.  Returns their launches by kernel."""
    counters = launch_counters()
    t_phase = time.time()
    launches = {}
    for part in (lambda: entry_quickstart(counters),
                 lambda: entry_serve_batch(counters, smi),
                 lambda: entry_train_lm(counters, smi),
                 lambda: entry_prefill(counters, smi)):
        for name, n in part().items():
            launches[name] = launches.get(name, 0) + n
    entry_benchmarks(smi)
    entry_host(smi)
    log(f"[entry] launches on the main paths: {launches}; the phase in "
        f"{time.time() - t_phase:.1f} s")
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
    laps = [t_start]

    def lap(what: str) -> None:
        """Log the wall of the part that just ended."""
        laps.append(time.time())
        log(f"[time] {what} in {laps[-1] - laps[-2]:.1f} s")
    kernels = []
    report = []
    if "build" in phases:
        phase_build()
        lap("phase build")
    if "kernels" in phases:
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        kernels = [("queue_matmul", check_queue_matmul(gen, report)),
                   ("flash_attention", check_flash_attention(gen, report)),
                   ("moe_gemm", check_moe_gemm(gen, report)),
                   ("ssm_scan", check_ssm_scan(gen, report)),
                   ("rglru_scan", check_rglru_scan(gen, report)),
                   ("rms_norm", check_rms_norm(gen, report)),
                   ("decode_attention",
                    check_decode_attention(gen, report)),
                   ("latent_attention",
                    check_latent_attention(gen, report))]
        check_mla_absorb(report)
        free_card()
        lap("phase kernels")
    if "parity" in phases:
        failures = []
        for arch, scale, hold in PARITY:
            phase_parity(arch, scale, hold, failures)
        if failures:
            raise AssertionError("phase 3 failed:\n" + "\n".join(failures))
        lap("phase parity")
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
        lap("phase serve")
    if "policy" in phases:
        for name, n in phase_policy(smi).items():
            launches[name] = launches.get(name, 0) + n
        lap("phase policy")
    if "dist" in phases:
        for name, n in phase_dist(smi).items():
            launches[name] = launches.get(name, 0) + n
        lap("phase dist")
    if "entry" in phases:
        for name, n in phase_entry(smi).items():
            launches[name] = launches.get(name, 0) + n
        lap("phase entry")
    if "train" in phases:
        parts = args.train_parts.split(",")
        gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
        if "a" in parts:
            kernels.append(("flash_attention_bwd",
                            check_flash_attention_bwd(gen, report)))
            check_queue_matmul_grads(gen, report)
            check_moe_gemm_bwd(gen, report)
            check_moe_apply_grad_mask()
            kernels.append(("rglru_scan_bwd",
                            check_rglru_scan_bwd(gen, report)))
            kernels.append(("ssm_scan_bwd", check_ssm_scan_bwd(gen, report)))
            lap("phase train (a)")
        if "b" in parts:
            failures = []
            for arch, scale in GRAD_PARITY:
                phase_grad_parity(arch, scale, failures)
            if failures:
                raise AssertionError("phase 5 (b) failed:\n"
                                     + "\n".join(failures))
            lap("phase train (b)")
        if "c" in parts:
            phase_trainer()
            lap("phase train (c)")
        if "d" in parts:
            for arch, layers in TRAIN_FULL:
                for name, n in phase_train_full(arch, layers, smi).items():
                    launches[name] = launches.get(name, 0) + n
            log(f"[train] launches over every main path run: {launches}")
            lap("phase train (d)")
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
