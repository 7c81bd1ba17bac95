"""The tables of the JAX package's ``benchmarks/report.py`` over the port's
dry-run cells (``artifacts/dryrun_port/``, written by
``python -m repro_torch.launch.dryrun --all --mesh both``): the roofline of
each analysis cell and each deploy cell's persistent state a device on
both production meshes, against one H100's capacity
(``repro_torch.roofline.HBM_BYTES``).

  PYTHONPATH=src python -m repro_torch.benchmarks.report [--out PATH]

Prints the tables, or writes them to ``--out``.  The reference rewrites a
block of its ``EXPERIMENTS.md``; the repo has none and the port writes
none.
"""
import argparse
import glob
import json
import os

from ..launch.dryrun import ART_DIR
from ..roofline import HBM_BYTES

MARKER = "## §Tables"


def load(variant, mesh="pod16x16", art_dir=None):
    cells = {}
    for p in sorted(glob.glob(os.path.join(
            art_dir or ART_DIR, f"*_{mesh}_*_{variant}.json"))):
        with open(p) as f:
            a = json.load(f)
        cells[(a["arch"], a["shape"])] = a
    return cells


def render(art_dir=None) -> str:
    opt = load("analysis", art_dir=art_dir)
    dep = load("deploy", art_dir=art_dir)
    dep2 = load("deploy", "pod2x16x16", art_dir=art_dir)
    cap_gb = HBM_BYTES / 1e9

    L = [MARKER, "",
         "Regenerate with `python -m repro_torch.benchmarks.report`.", ""]
    L += ["### Roofline — current code, analysis variant, 256 chips "
          "(H100 rates)",
          "",
          "| arch | shape | t_compute | t_memory | t_collective | bound "
          "| useful | MFU |",
          "|---|---|---|---|---|---|---|---|"]
    for (arch, shape), a in sorted(opt.items()):
        r = a["roofline"]
        L.append(f"| {arch} | {shape} | {r['t_compute']:.2e} | "
                 f"{r['t_memory']:.2e} | {r['t_collective']:.2e} | "
                 f"{r['bottleneck']} | {r['useful_flops_ratio']:.3f} | "
                 f"{r['mfu']:.4f} |")

    L += ["", "### Roofline — paper-faithful baseline", "",
          "The port's dry run writes no baseline cells (the reference's "
          "`artifacts/dryrun_baseline`), so this table and the step-vs-"
          "baseline column are not rendered."]

    L += ["", "### Dry run — deploy cells: per-device state",
          "",
          "All cells are counted on the meta device on both meshes.  "
          "`state` = exact analytic",
          "per-device persistent bytes (params + optimizer + caches) from the",
          f"leaf placements; H100 HBM = {cap_gb:.0f} GB.", "",
          "| arch | shape | state GB @256 | state GB @512 "
          "| collective GB/dev @256 (AR/AG/RS/A2A/CP) |",
          "|---|---|---|---|---|"]
    over = []
    for (arch, shape), a in sorted(dep.items()):
        g = a.get("analytic_device_gb", {}).get("total_gb", float("nan"))
        g2 = dep2.get((arch, shape), {}).get(
            "analytic_device_gb", {}).get("total_gb", float("nan"))
        c = a["collectives"]
        cs = "/".join(f"{c.get(k, 0)/1e9:.1f}" for k in
                      ("all-reduce", "all-gather", "reduce-scatter",
                       "all-to-all", "collective-permute"))
        flag = " ⚠" if g > cap_gb else ""
        if flag:
            over.append(f"{arch} {shape}")
        L.append(f"| {arch} | {shape} | {g:.2f}{flag} | {g2:.2f} | {cs} |")
    L += ["", (f"⚠ over one card's {cap_gb:.0f} GB at 256 chips: "
               + ", ".join(over) + ".") if over else
          f"No cell holds more than one card's {cap_gb:.0f} GB a device at "
          f"256 chips.", ""]
    return "\n".join(L)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="write the tables to this file, not to stdout")
    args = ap.parse_args(argv)
    text = render()
    if args.out is None:
        print(text)
        return
    with open(args.out, "w") as f:
        f.write(text + "\n")
    print(f"# wrote {args.out}")


if __name__ == "__main__":
    main()
