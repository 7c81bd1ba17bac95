#!/usr/bin/env python3
"""The knee sweep of an open-loop cell: its command at a list of arrival
rates, one process a rate, and the highest rate whose backlog does not
grow.

    python3 portbench/sweep.py --workload phi3-chat-poisson \\
        --rates 4,6,8,10,12 --seconds 30 --seed 7 [--write]

A rate is sustained where every request due in the window finished
within the drain and the backlog (requests due and not yet in a slot) at
the window's close is no larger than half way through it, give or take a
quarter of the slots.  The cell's rate is four fifths of the knee, rounded
down to a tenth; ``--write`` stores it in the cell's traffic file.  The
table goes to standard output and, as JSON, to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench.bench import manifest  # noqa: E402


def sustained(load: dict, slots: int) -> bool:
    return (load["unfinished"] == 0
            and load["backlog_close"] <= load["backlog_half"] + slots / 4)


def run_rate(cell: str, rate: float, seconds: float, seed: int) -> dict:
    cmd = [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
           cell, "--seed", str(seed), "--seconds", str(seconds), "--trace",
           "0", "--rate", str(rate)]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        sys.stderr.write(proc.stderr[-4000:])
        raise SystemExit(f"rate {rate}: exit {proc.returncode}")
    return json.loads(lines[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--write", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = manifest.load_cell(args.workload)
    slots = cell.config["serving"]["slots"]
    rows = []
    for rate in [float(r) for r in args.rates.split(",")]:
        out = run_rate(args.workload, rate, args.seconds, args.seed)
        row = {"rate_per_s": rate, **out["load"],
               **{k: v["value"] for k, v in out["metrics"].items()},
               "correct": out["correct"],
               "sustained": sustained(out["load"], slots)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    ok = [r["rate_per_s"] for r in rows if r["sustained"]]
    knee = max(ok) if ok else None
    chosen = math.floor(8 * knee) / 10 if knee else None
    print(json.dumps({"knee_per_s": knee, "rate_per_s": chosen}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"workload": args.workload, "seconds": args.seconds,
             "seed": args.seed, "rows": rows, "knee_per_s": knee,
             "rate_per_s": chosen}, indent=1))
    if args.write and chosen:
        path = manifest.PORTBENCH / "traffic" / f"{cell.workload['traffic']}.json"
        mix = json.loads(path.read_text())
        mix["rate_per_s"] = chosen
        path.write_text(json.dumps(mix, indent=2) + "\n")
    return 0 if knee else 1


if __name__ == "__main__":
    sys.exit(main())
