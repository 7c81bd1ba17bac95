"""Calibration section, the port's counterpart of the JAX package's
``benchmarks/calibration.py``: prove the port's DSE-calibrated operating
points beat the old hard-coded defaults on the swept grid.

For every kernel the section (1) runs the calibration pipeline (sweep →
Pareto front → objective selection → artifact), (2) re-simulates the old
hard-coded configurations — the paper's headline point (COPIFTv2, queue
depth 4, latency 1, unroll 8: the machine-model/OperatingPoint default) and
the pre-policy-layer queue_matmul consumer point (depth 2) — and asserts
the contract the CI gate relies on:

* the selected point is a member of the swept Pareto front (non-dominated
  by every ok record in the sweep);
* NO hard-coded default dominates the calibrated selection — going through
  calibration cannot make any kernel strictly worse than what any consumer
  previously hard-coded.

Emits ``name,us_per_call,derived`` CSV rows (IPC / energy gains of the
calibrated point over the default) and writes
``artifacts/BENCH_port_calibration.json`` plus the per-kernel calibration
artifacts themselves, in ``calibration_dir()`` (the live policy table both
packages read, as ``repro_torch.examples.explore calibrate`` writes it).
The smoke run writes ``BENCH_port_calibration_smoke.json`` and its
artifacts to ``artifacts/calibration_port_smoke/``, never to the live
table or to the reference's ``artifacts/calibration_smoke/``.

  PYTHONPATH=src python -m repro_torch.benchmarks.calibration
"""
import json
import os
import time

from ..core import SweepPoint, run_point
from ..core.calibrate import calibrate, never_dominated_by
from . import ART_DIR

OUT_PATH = os.path.join(ART_DIR, "BENCH_port_calibration.json")
SMOKE_OUT_PATH = os.path.join(ART_DIR, "BENCH_port_calibration_smoke.json")
#: the smoke grid's calibration artifacts
SMOKE_ARTIFACT_DIR = os.path.join(ART_DIR, "calibration_port_smoke")

#: the hard-coded configurations the policy layer replaced: the paper's
#: headline point (machine model / OperatingPoint fallback) and the old
#: ``queue_matmul`` consumer default (depth=2, no K-loop unrolling — unroll
#: has no schedule analogue below 1, so 1 is the closest machine point)
DEFAULT_POINTS = {
    "paper_headline": dict(policy="copiftv2", queue_depth=4,
                           queue_latency=1, unroll=8),
    "queue_matmul_pre_policy": dict(policy="copiftv2", queue_depth=2,
                                    queue_latency=1, unroll=1),
}
DEFAULT_POINT = DEFAULT_POINTS["paper_headline"]


def run(grid_kw=None, kernels=None, objective="max-ipc", workers=None,
        out_path=None, artifact_dir=None):
    out_path = out_path or OUT_PATH
    t0 = time.time()
    records = calibrate(kernels=kernels, objective=objective,
                        grid_kw=grid_kw, workers=workers,
                        out_dir=artifact_dir)
    us = (time.time() - t0) * 1e6 / max(len(records), 1)

    rows, report = [], {}
    for kernel, rec in sorted(records.items()):
        sel = rec.selected
        if sel not in rec.front:
            raise AssertionError(
                f"{kernel}: calibrated point is not on the swept Pareto "
                f"front: {sel}")
        defaults = {}
        for name, cfg in DEFAULT_POINTS.items():
            pt = run_point(SweepPoint(kernel=kernel,
                                      n_samples=rec.grid["n_samples"], **cfg))
            if not pt.ok:
                continue             # an infeasible legacy point dominates nothing
            defaults[name] = pt
            if not never_dominated_by(rec, pt):
                raise AssertionError(
                    f"{kernel}: hard-coded {name} point (ipc={pt.ipc:.4f}, "
                    f"energy={pt.energy:.1f}) dominates the calibrated "
                    f"point {sel} — selection under {rec.objective} "
                    f"regressed")
        if "paper_headline" not in defaults:
            raise AssertionError(
                f"{kernel}: the paper headline point no longer simulates")
        default = defaults["paper_headline"]
        ipc_gain = sel["ipc"] / default.ipc
        energy_gain = default.energy / sel["energy"]
        rows.append((f"calibration_{kernel}_ipc_gain", us, ipc_gain))
        rows.append((f"calibration_{kernel}_energy_gain", us, energy_gain))
        report[kernel] = {
            "objective": rec.objective,
            "selected": sel,
            "default": {**DEFAULT_POINT, "ipc": default.ipc,
                        "energy": default.energy},
            "ipc_gain": round(ipc_gain, 4),
            "energy_gain": round(energy_gain, 4),
            "front_size": len(rec.front),
            "rationale": rec.rationale,
        }
    rows.append(("calibration_kernels", us, float(len(records))))
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump({"default_point": DEFAULT_POINT, "kernels": report},
                  f, indent=2, sort_keys=True)
    return rows


def main():
    for name, us, derived in run():
        print(f"{name},{us:.1f},{derived:.4f}")
    print(f"# wrote {OUT_PATH}")


def smoke():
    """Tiny grid over two kernels.  Artifacts land in
    :data:`SMOKE_ARTIFACT_DIR` — a smoke-grid selection must never
    overwrite the live policy table that queue_matmul/serve/train load."""
    rows = run(kernels=["expf", "dequant_dot"],
               grid_kw=dict(queue_depths=(1, 2, 4), queue_latencies=(1,),
                            unrolls=(4, 8), n_samples=16),
               workers=1,
               out_path=SMOKE_OUT_PATH, artifact_dir=SMOKE_ARTIFACT_DIR)
    if not any(name.endswith("_ipc_gain") for name, _u, _d in rows):
        raise AssertionError("calibration smoke produced no gain rows")
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived:.4f}")


if __name__ == "__main__":
    main()
