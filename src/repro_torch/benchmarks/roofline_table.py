"""Render the roofline table from the port's dry-run artifacts.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
  PYTHONPATH=src python -m repro_torch.benchmarks.roofline_table

Reads ``artifacts/dryrun_port/*_pod16x16_*_analysis.json`` (written by
``repro_torch.launch.dryrun``: each cell counted on the meta device, the
three roofline terms on the H100's rates) and prints the reference's
columns (``benchmarks/roofline_table.py``).  The rows carry ``count_s``,
the seconds the meta-device count took, where the reference's carry the
compile time: the port compiles nothing.  No device is touched.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Tuple

from ..launch.dryrun import ART_DIR

Row = Tuple[str, float, float]


def load(variant: str = "analysis", mesh: str = "pod16x16",
         art_dir: str = ART_DIR) -> Dict[Tuple[str, str], dict]:
    cells = {}
    for p in sorted(glob.glob(os.path.join(art_dir,
                                           f"*_{mesh}_*_{variant}.json"))):
        with open(p) as f:
            a = json.load(f)
        cells[(a["arch"], a["shape"])] = a
    return cells


def table(cells: Dict[Tuple[str, str], dict]) -> str:
    hdr = (f"{'arch':<22} {'shape':<12} {'t_comp':>9} {'t_mem':>9} "
           f"{'t_coll':>9} {'bound':<10} {'useful':>7} {'mfu':>7}")
    lines = [hdr, "-" * len(hdr)]
    for (arch, shape), a in sorted(cells.items()):
        r = a["roofline"]
        lines.append(
            f"{arch:<22} {shape:<12} {r['t_compute']:>9.2e} "
            f"{r['t_memory']:>9.2e} {r['t_collective']:>9.2e} "
            f"{r['bottleneck']:<10} {r['useful_flops_ratio']:>7.3f} "
            f"{r['mfu']:>7.4f}")
    return "\n".join(lines)


def run(art_dir: str = ART_DIR) -> List[Row]:
    rows = []
    for (arch, shape), a in sorted(load(art_dir=art_dir).items()):
        rows.append((f"roofline_{arch}_{shape}_mfu", a["count_s"] * 1e6,
                     a["roofline"]["mfu"]))
    return rows


def main(art_dir: str = ART_DIR) -> None:
    cells = load(art_dir=art_dir)
    if not cells:
        print("roofline_no_artifacts,0,0")
        return
    print(table(cells))
    for name, us, derived in run(art_dir):
        print(f"{name},{us:.1f},{derived:.6f}")


if __name__ == "__main__":
    main()
