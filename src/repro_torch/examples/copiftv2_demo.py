"""The paper's contribution, end to end, on the port:

1. Take mixed integer/FP kernels (expf, Fig. 1b of the paper), lower them
   with all three methodologies and simulate them on the Snitch machine
   model — IPC, throughput and energy as in Fig. 3.
2. Show the same queue idea as a Hopper kernel: ``queue_matmul`` with ring
   depth 1 (COPIFT-style staging: copy a tile, wait, compute) against
   depth 4 (COPIFTv2: four tiles of each operand in flight in shared
   memory), at phi3-mini-3.8b's decode and ``forward`` products in bf16,
   timed on the device with CUDA events next to one ``torch.matmul``.  The
   two depths must give the same bits.  Part 2 needs the card; without one
   it raises.

  PYTHONPATH=src python -m repro_torch.examples.copiftv2_demo

The port's counterpart of the JAX package's ``examples/copiftv2_demo.py``.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ..benchmarks.timing import event_ms
from ..core import KERNELS, MachineConfig, TransformConfig, lower, simulate
from ..core.policy import ExecutionPolicy as P
from ..device import resolve_device
from ..kernels import queue_matmul

#: phi3-mini-3.8b's q/k/v/o product over 4 decode slots (the thin kernel)
#: and its ffn wi over a 512-token ``forward`` (the wide kernel): (M, K, N)
SHAPES = ((4, 3072, 3072), (512, 3072, 8192))
#: ring depths compared: COPIFT's single stage against COPIFTv2's four
DEPTHS = (1, 4)


def part1(n_samples: int = 256) -> Dict[str, Dict[str, object]]:
    """The three methodologies on the machine model: kernel -> policy ->
    its ``SimResult``, printed as the paper's Fig. 3 ratios."""
    print("== 1. the paper's methodology on the Snitch machine model ==")
    tc = TransformConfig(n_samples=n_samples)
    out: Dict[str, Dict[str, object]] = {}
    for name in ("expf", "poly_lcg", "dequant_dot"):
        dfg = KERNELS[name]
        print(f"\n{name}:")
        base = None
        out[name] = {}
        for pol in (P.BASELINE, P.COPIFT, P.COPIFTV2):
            res = simulate(lower(dfg, pol, tc), MachineConfig())
            base = base or res
            out[name][pol.value] = res
            print(f"  {pol.value:<9} IPC={res.ipc:5.2f}  "
                  f"samples/cycle={res.throughput:6.4f} "
                  f"({res.throughput/base.throughput:4.2f}x)  "
                  f"samples/J={res.efficiency:8.6f} "
                  f"({res.efficiency/base.efficiency:4.2f}x)")
    return out


def part2(iters: int = 50, seed: int = 0) -> List[Dict[str, object]]:
    """``queue_matmul`` at depth 1 and depth 4 on the card, bf16, at
    :data:`SHAPES`: one row per shape with each depth's time, the
    ``torch.matmul`` time, the launches the depth runs made, and the
    largest difference from ``torch.matmul``.  Raises without a card, and
    if the two depths' products differ in any bit."""
    dev = resolve_device(None)
    print("\n== 2. the same queue idea as a Hopper kernel (bf16) ==")
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = []
    for m, k, n in SHAPES:
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn((k, n), generator=gen, device=dev)
             / k ** 0.5).to(torch.bfloat16)
        lib = torch.matmul(x, w)
        row: Dict[str, object] = {"shape": (m, k, n)}
        outs = {}
        before = queue_matmul.launches
        for depth in DEPTHS:
            outs[depth] = queue_matmul(x, w, depth=depth,
                                       policy=P.COPIFTV2)
            row[f"depth{depth}_ms"] = event_ms(
                lambda: queue_matmul(x, w, depth=depth, policy=P.COPIFTV2),
                iters)
        row["launches"] = queue_matmul.launches - before
        row["matmul_ms"] = event_ms(lambda: torch.matmul(x, w), iters)
        if not torch.equal(outs[DEPTHS[0]], outs[DEPTHS[1]]):
            raise AssertionError(f"queue_matmul {m}x{k}x{n}: depth "
                                 f"{DEPTHS[0]} and depth {DEPTHS[1]} differ")
        row["max_abs_diff_from_matmul"] = float(
            (outs[DEPTHS[1]].float() - lib.float()).abs().max())
        print(f"  {m}x{k}x{n}: depth 1 (COPIFT) {row['depth1_ms']:.4f} ms, "
              f"depth 4 (COPIFTv2) {row['depth4_ms']:.4f} ms, "
              f"torch.matmul {row['matmul_ms']:.4f} ms; equal bits across "
              f"depths; max |diff| from torch.matmul "
              f"{row['max_abs_diff_from_matmul']:.3e}")
        rows.append(row)
    return rows


def main() -> None:
    part1()
    part2()


if __name__ == "__main__":
    main()
