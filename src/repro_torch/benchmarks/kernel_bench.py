"""Kernel micro-benchmarks: the port's kernels at the reference's shapes
and, with ``--shapes main``, ``queue_matmul``'s ring depths at phi3-mini-3.8b's
products — the kernel-level COPIFT-vs-v2 experiment.

  PYTHONPATH=src python -m repro_torch.benchmarks.kernel_bench
  PYTHONPATH=src python -m repro_torch.benchmarks.kernel_bench --shapes main
  PYTHONPATH=src python -m repro_torch.benchmarks.kernel_bench --device cpu

On the card every time is device time from CUDA events; on the CPU
(``--device cpu``) the wrappers take their plain versions and the times
are the host clock's.  Prints ``name,us_per_call,derived`` rows as the
reference's ``benchmarks/kernel_bench.py`` does (its baseline row, XLA's
product, becomes ``kernel_matmul_torch``) and writes
``artifacts/BENCH_port_kernels.json`` (``BENCH_port_kernels_main.json``
under ``--shapes main``) with the device's name and power limit.  ``queue_matmul`` and ``moe_gemm`` must give the same bits at
every depth, or the run raises.

``--shapes main`` times ``queue_matmul`` in bf16 at depths 1, 2 and 4 on
phi3-mini-3.8b's decode product (4 x 3072 x 3072, the thin kernel) and its
``forward`` product (512 x 3072 x 8192, the wide kernel), the depths taken
in turns over :data:`ROUNDS` rounds (the order rotated each round) in one
process, so that their medians and spreads compare across rounds, not
across processes.  The weights cycle over copies of at least 100 MB, so
each call reads them from device memory, as a decode body does.
"""
from __future__ import annotations

import argparse
import json
import math
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.policy import ExecutionPolicy
from ..device import DeviceLike, resolve_device
from ..kernels import flash_attention, moe_gemm, queue_matmul, ssm_scan
from . import ART_DIR, device_label
from .timing import event_ms, host_us

#: the artifact of each set of shapes
OUT_PATHS = {"reference": os.path.join(ART_DIR, "BENCH_port_kernels.json"),
             "main": os.path.join(ART_DIR, "BENCH_port_kernels_main.json")}
#: phi3-mini-3.8b's q/k/v/o product over 4 decode slots and its ffn wi
#: over a 512-token ``forward``: (M, K, N)
MAIN_SHAPES = ((4, 3072, 3072), (512, 3072, 8192))
MAIN_DEPTHS = (1, 2, 4)
ROUNDS = 7

Row = Tuple[str, float, float]


def _timer(dev: torch.device) -> Callable[[Callable, int], float]:
    """Microseconds a call of ``fn``: device time on the card (CUDA events
    around ``reps`` calls queued behind a sleep), the host clock around
    ``reps`` calls after a warm one on the CPU."""
    if dev.type == "cuda":
        return lambda fn, reps: event_ms(fn, reps) * 1e3
    return host_us


def _normal(rng: np.random.Generator, shape, dev, scale: float = 1.0):
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)


def _equal_across(outs: Dict[int, torch.Tensor], what: str) -> None:
    base = outs[max(outs)]
    for depth, out in outs.items():
        if not torch.equal(out, base):
            raise AssertionError(f"{what}: depth {depth} differs from depth "
                                 f"{max(outs)}")


def reference_rows(dev: torch.device, seed: int = 0) -> List[Row]:
    """The reference's rows, at its shapes, in its order."""
    time_us = _timer(dev)
    reps = 20 if dev.type == "cuda" else 3
    rng = np.random.default_rng(seed)
    rows: List[Row] = []
    x = _normal(rng, (256, 512), dev)
    w = _normal(rng, (512, 256), dev)
    base = time_us(lambda: torch.matmul(x, w), reps)
    rows.append(("kernel_matmul_torch", base, 1.0))
    outs = {}
    for depth in (1, 2, 4):
        def qm(d=depth):
            return queue_matmul(x, w, depth=d,
                                policy=ExecutionPolicy.COPIFTV2)
        outs[depth] = qm()
        us = time_us(qm, reps)
        rows.append((f"kernel_queue_matmul_depth{depth}", us, us / base))
    _equal_across(outs, "queue_matmul 256x512x256 fp32")

    q, k, v = (_normal(rng, (1, 4, 512, 64), dev) for _ in range(3))
    us = time_us(lambda: flash_attention(q, k, v, causal=True), reps)
    rows.append(("kernel_flash_attention_512", us, 0.0))

    xs = _normal(rng, (1, 256, 128), dev, 0.3)
    dt = F.softplus(_normal(rng, (1, 256, 128), dev)) * 0.1
    A = -_normal(rng, (128, 16), dev).abs()
    Bm = _normal(rng, (1, 256, 16), dev)
    C = _normal(rng, (1, 256, 16), dev)
    us = time_us(lambda: ssm_scan(xs, dt, A, Bm, C), reps)
    rows.append(("kernel_ssm_scan_256x128", us, 0.0))

    xe = _normal(rng, (4, 128, 256), dev)
    we = _normal(rng, (4, 256, 128), dev)
    outs = {}
    for depth in (1, 2):
        def mg(d=depth):
            return moe_gemm(xe, we, depth=d)
        outs[depth] = mg()
        rows.append((f"kernel_moe_gemm_depth{depth}", time_us(mg, reps),
                     0.0))
    _equal_across(outs, "moe_gemm (4, 128, 256) @ (4, 256, 128) fp32")
    return rows


def main_rounds(dev: torch.device, rounds: int = ROUNDS, seed: int = 0,
                iters: int = 50) -> Tuple[List[Row], List[dict]]:
    """``queue_matmul`` at :data:`MAIN_DEPTHS` and ``torch.matmul`` on
    :data:`MAIN_SHAPES` in bf16, taken in turns over ``rounds`` rounds.
    Rows: the median microseconds of each depth (derived: its ratio to
    depth 4's median) and of ``torch.matmul``; records: every round's
    times, the median, min, max and spread ((max - min) / median)."""
    time_us = _timer(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows: List[Row] = []
    records = []
    for m, k, n in MAIN_SHAPES:
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn((k, n), generator=gen, device=dev)
             / math.sqrt(k)).to(torch.bfloat16)
        copies = [w] + [w.clone() for _ in range(
            max(1, math.ceil(100e6 / (w.numel() * w.element_size()))) - 1)]
        outs = {d: queue_matmul(x, w, depth=d,
                                policy=ExecutionPolicy.COPIFTV2)
                for d in MAIN_DEPTHS}
        _equal_across(outs, f"queue_matmul {m}x{k}x{n} bf16")
        del outs

        def cycled(fn):
            state = {"i": 0}

            def call():
                state["i"] += 1
                return fn(copies[state["i"] % len(copies)])
            return call
        calls = {f"depth{d}": cycled(
            lambda wc, d=d: queue_matmul(x, wc, depth=d,
                                         policy=ExecutionPolicy.COPIFTV2))
            for d in MAIN_DEPTHS}
        calls["torch_matmul"] = cycled(lambda wc: torch.matmul(x, wc))
        names = list(calls)
        times: Dict[str, List[float]] = {name: [] for name in names}
        for r in range(rounds):
            for name in names[r % len(names):] + names[:r % len(names)]:
                times[name].append(time_us(calls[name], iters))
        ref = float(np.median(times["depth4"]))
        for name in names:
            t = times[name]
            med = float(np.median(t))
            records.append({"shape": [m, k, n], "dtype": "bfloat16",
                            "call": name, "rounds_us": t, "median_us": med,
                            "min_us": min(t), "max_us": max(t),
                            "spread": (max(t) - min(t)) / med})
            rows.append((f"kernel_queue_matmul_{m}x{k}x{n}_{name}", med,
                         med / ref))
        del copies, calls
    return rows, records


def run(device: DeviceLike = None, shapes: str = "reference",
        rounds: int = ROUNDS, out_path: Optional[str] = None
        ) -> List[Row]:
    """The rows of ``shapes`` (``"reference"`` or ``"main"``) on
    ``device``, written with the device's name to ``out_path`` (default:
    the shapes' file of :data:`OUT_PATHS`)."""
    dev = resolve_device(device)
    if shapes == "reference":
        rows, records = reference_rows(dev), []
    elif shapes == "main":
        rows, records = main_rounds(dev, rounds)
    else:
        raise ValueError(f"shapes must be 'reference' or 'main', got "
                         f"{shapes!r}")
    out_path = out_path or OUT_PATHS[shapes]
    if out_path:
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump({"device": device_label(dev), "shapes": shapes,
                       "timer": ("cuda events" if dev.type == "cuda"
                                 else "host clock"),
                       "rows": [list(r) for r in rows], "rounds": records},
                      f, indent=1)
            f.write("\n")
    return rows


def main(argv: Optional[List[str]] = None) -> List[Row]:
    ap = argparse.ArgumentParser(description="Kernel micro-benchmarks")
    ap.add_argument("--shapes", choices=("reference", "main"),
                    default="reference")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    rows = run(args.device, args.shapes)
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived:.4f}")
    return rows


if __name__ == "__main__":
    main()
