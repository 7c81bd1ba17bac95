"""Calibration-front drift gate, the port's counterpart of the JAX package's
``benchmarks/front_diff.py``: recompute the pinned smoke-grid Pareto front
through the port's machine model and fail when it differs from the
reference's committed one.

The machine model is deterministic pure Python, so the Pareto front of a
pinned grid is a *golden artifact*.  The reference's committed baseline
(``benchmarks/data/front_baseline.json``, read only) stores, per kernel,
the full (IPC, energy) front of :data:`PINNED_GRID` as config->metrics
points; this section recomputes the front with the port's ``run_sweep``
and fails when

* a baseline front point disappeared or a new one appeared (the front
  *moved*), or
* a matching configuration's cycles differ at all, or its energy/IPC drift
  beyond :data:`REL_TOL` (float-repr headroom only).

The baseline is the reference's and the port's job is to equal it, so
there is no ``--update``: any drift is a fault of the port (ROADMAP
queue C).

  PYTHONPATH=src python -m repro_torch.benchmarks.front_diff
"""
import json
import os
import time

from ..core import grid, pareto_by_kernel, run_sweep
from . import ROOT

BASELINE_PATH = os.path.join(ROOT, "benchmarks", "data",
                             "front_baseline.json")

#: the pinned grid: small enough for CI smoke, crossing every policy, the
#: depth axis, both unrolls, and a 2-core cluster row so the cluster path
#: is inside the drift gate too
PINNED_GRID = dict(kernels=["expf", "dequant_dot"],
                   queue_depths=(1, 2, 4), queue_latencies=(1,),
                   unrolls=(4, 8), n_samples=16, n_cores=(1, 2))

#: relative tolerance for float metrics (energy/IPC): generous only against
#: repr round-tripping — any real model change is far bigger
REL_TOL = 1e-9

#: keys identifying one configuration on the front
CONFIG_KEYS = ("kernel", "policy", "queue_depth", "queue_latency", "unroll",
               "n_cores", "tcdm_banks")
#: pinned metrics per configuration
METRIC_KEYS = ("cycles", "ipc", "energy")


def compute_fronts():
    recs = run_sweep(grid(**PINNED_GRID), workers=1)
    bad = [r for r in recs if not r.ok or not r.equivalent]
    if bad:
        raise AssertionError(
            f"{len(bad)} pinned-grid points failed to simulate cleanly, "
            f"e.g. {bad[0]}")
    fronts = {}
    for kernel, front in pareto_by_kernel(recs).items():
        fronts[kernel] = [
            {**{k: getattr(r, k) for k in CONFIG_KEYS},
             **{k: getattr(r, k) for k in METRIC_KEYS}}
            for r in front]
    return fronts


def _key(point):
    return tuple(point[k] for k in CONFIG_KEYS)


def _sortable(key):
    """Order keys whose optional slots (tcdm_banks) mix None with ints."""
    return tuple((v is None, "" if v is None else v) for v in key)


def _fmt(key):
    return ", ".join(f"{k}={v}" for k, v in zip(CONFIG_KEYS, key))


def diff_fronts(baseline, current):
    """Human-readable drift list (empty = gate passes)."""
    problems = []
    for kernel in sorted(set(baseline) | set(current)):
        if kernel not in current:
            problems.append(f"{kernel}: kernel missing from recomputed front")
            continue
        if kernel not in baseline:
            problems.append(f"{kernel}: kernel absent from the committed "
                            f"baseline")
            continue
        base = {_key(p): p for p in baseline[kernel]}
        cur = {_key(p): p for p in current[kernel]}
        for k in sorted(base.keys() - cur.keys(), key=_sortable):
            problems.append(f"{kernel}: front point vanished ({_fmt(k)})")
        for k in sorted(cur.keys() - base.keys(), key=_sortable):
            problems.append(f"{kernel}: new front point appeared ({_fmt(k)})")
        for k in sorted(base.keys() & cur.keys(), key=_sortable):
            b, c = base[k], cur[k]
            if b["cycles"] != c["cycles"]:
                problems.append(
                    f"{kernel}: cycles moved {b['cycles']} -> {c['cycles']} "
                    f"({_fmt(k)})")
            for m in ("ipc", "energy"):
                ref = abs(b[m]) or 1.0
                if abs(b[m] - c[m]) / ref > REL_TOL:
                    problems.append(
                        f"{kernel}: {m} drifted {b[m]!r} -> {c[m]!r} "
                        f"({_fmt(k)})")
    return problems


def run():
    t0 = time.time()
    current = compute_fronts()
    if not os.path.exists(BASELINE_PATH):
        raise AssertionError(
            f"no committed front baseline at {BASELINE_PATH}: the "
            f"reference's benchmarks/data/front_baseline.json is missing "
            f"from the checkout")
    with open(BASELINE_PATH) as f:
        baseline = json.load(f)["fronts"]
    problems = diff_fronts(baseline, current)
    if problems:
        raise AssertionError(
            "the port's Pareto front differs from the reference's committed "
            "one:\n  " + "\n  ".join(problems)
            + "\nThe baseline is the reference's: the drift is a fault of "
              "the port's machine model")
    us = (time.time() - t0) * 1e6
    rows = [(f"front_diff_{kernel}_points", us, float(len(front)))
            for kernel, front in sorted(current.items())]
    rows.append(("front_diff_drift_findings", us, 0.0))
    return rows


def main():
    for name, us, derived in run():
        print(f"{name},{us:.1f},{derived:.4f}")


#: the gate is already CI-sized; smoke runs the identical pinned grid
smoke = main


if __name__ == "__main__":
    main()
