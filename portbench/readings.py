#!/usr/bin/env python3
"""The two readings a cell's check limit is set from, on the card, in one
process: for each seed, one run of the cell at its own load (the same
set-up, window and sample as the benchmark's run), the program's
served-token logit gaps, and the control's: at the same positions of the
same sequences, the gaps of the tokens that the reference computed with
float8 operands puts first.

    python3 portbench/readings.py --workload phi3-chat-poisson \\
        --seeds 101,102,103 --seconds 30 --out build/readings.json

For each number of ``bench.check.NUMBERS`` (the widest gap, the mean gap,
the worst request's mean gap, the share of served tokens not the
reference's first choice) the lower reading is the program's largest
over the seeds and the upper the control's smallest; the limit of each
number a cell compares (``portbench/checks/<cell>.json``) lies between
them.  Each seed also scores the control, in the program's place,
against the cell's limits as they stand (``control_correct``, which a
sound check reads false on every seed).  The benchmark's own runs never
run the control.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.bench import env  # noqa: E402

env.pin_environment()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    from portbench.bench import check, harness, manifest
    if not torch.cuda.is_available():
        print("portbench: readings need a CUDA device", file=sys.stderr)
        return 2
    rows = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        cell = manifest.load_cell(args.workload)
        out = harness.run(cell, seed, args.seconds, False,
                          torch.device("cuda", 0), started=time.time(),
                          control=True)
        row = {"seed": seed, "correct": out["correct"],
               "control_correct": out["control_correct"], **out["checked"],
               **{k: v["value"] for k, v in out["metrics"].items()}}
        rows.append(row)
        print(json.dumps(row), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    summary = {"workload": args.workload,
               "device": torch.cuda.get_device_name(0),
               "all_correct": all(r["correct"] for r in rows),
               "control_ever_correct": any(r["control_correct"]
                                           for r in rows)}
    for name in check.NUMBERS:
        lower = max(r[f"served_{name}"] for r in rows)
        upper = min(r[f"control_{name}"] for r in rows)
        summary[name] = {"lower": lower, "upper": upper,
                         "ratio": upper / lower if lower > 0 else None}
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"rows": rows, **summary},
                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
