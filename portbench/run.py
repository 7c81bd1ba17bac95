#!/usr/bin/env python3
"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout, on a machine with the card(s) the cell
asks for; it refuses to measure without them.  ``--trace 0`` reports the
cell's end-to-end metrics, ``--trace 1`` its per-layer metrics, read from
``torch.profiler`` over a few seconds of the window and from the harness's
own records.  The last line of standard output is the result (JSON); the
last lines of standard error are each number compared beside its limit.
``--rate`` (the knee sweep's) overrides an open-loop mix's arrival rate.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.bench import env  # noqa: E402

env.pin_environment()


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rate", type=float, default=None)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from portbench.bench import harness, manifest
    cell = manifest.load_cell(args.workload)
    if args.rate is not None:
        cell.traffic = dict(cell.traffic, rate_per_s=args.rate)
    import torch
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell {args.workload} needs {chips} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              "; nothing is measured", file=sys.stderr)
        return 2
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0))
    loaded = env.forbidden_loaded()
    if loaded:
        print(f"portbench: the measured process loaded {loaded}; no result",
              file=sys.stderr)
        return 3
    harness.report(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
