"""Cluster scaling benchmark, the port's counterpart of the JAX package's
``benchmarks/cluster_scaling.py``: weak/strong scaling of the port's N-core
machine model (``repro_torch.core.cluster``) plus a TCDM bank-contention
study.

Three sections, all through the standard sweep pipeline (every point still
re-checks bit-identical equivalence against the sequential interpreter):

* **strong scaling** — fixed total sample count split across 1..N cores of
  a conflict-free cluster; the headline is the aggregate-throughput speedup
  at 4 cores on a contention-light kernel (no TCDM traffic at all), gated
  at >= :data:`MIN_SPEEDUP_4C` (the acceptance bar of 3x).
* **weak scaling** — fixed per-core sample count, so the makespan should
  stay ~flat while aggregate throughput grows ~linearly.
* **contention** — a memory-heavy kernel at 4 cores across a bank axis
  (conflict-free -> 8 -> 2 banks): throughput must degrade monotonically
  as banks get scarcer and the ``*_bank`` stall cause must appear.

Writes ``artifacts/BENCH_port_cluster.json``
(``BENCH_port_cluster_smoke.json`` under ``--smoke``) with the schema::

    {
      "strong_scaling": {kernel: {"n_samples": N, "points": [
          {"n_cores", "tcdm_banks", "cycles", "throughput", "speedup",
           "ipc", "ipc_per_core", "energy_per_sample", "bank_stalls"}, ...]}},
      "weak_scaling":   {kernel: {"per_core_samples": N, "points": [...]}},
      "contention":     {kernel: {"n_cores": 4, "points": [...]}},
      "headline": {"kernel", "speedup_4c", "min_required"}
    }

``speedup`` is aggregate throughput (samples/cycle over the makespan)
relative to the 1-core point of the same row; ``energy_per_sample``
includes the interconnect energy charged per TCDM access in multi-core
clusters.  Emits ``name,us_per_call,derived`` CSV rows like every other
section.  ``bench_diff`` recomputes the reference's committed strong-scaling
points through the port's ``run_point``.

  PYTHONPATH=src python -m repro_torch.benchmarks.cluster_scaling
"""
import json
import os
import time

from ..core import SweepPoint, run_point
from . import ART_DIR

OUT_PATH = os.path.join(ART_DIR, "BENCH_port_cluster.json")
SMOKE_OUT_PATH = os.path.join(ART_DIR, "BENCH_port_cluster_smoke.json")

#: the acceptance bar: >=3x aggregate throughput from 1 -> 4 cores on
#: a contention-light kernel
MIN_SPEEDUP_4C = 3.0

#: contention-light headline kernel: pure compute, zero TCDM accesses
#: (poly_lcg is IALU/IMUL/CVT/FMA only), so scaling is limited purely by
#: per-core schedule fill, not by the shared memory model
STRONG_KERNEL = "poly_lcg"
#: memory-heavy kernel for the bank-contention study (LW+SW per sample)
CONTENTION_KERNEL = "histf"

FULL = dict(strong_kernels=("poly_lcg", "expf", "dequant_dot"),
            strong_n=128, weak_per_core=32, cores=(1, 2, 4, 8),
            contention_cores=4, banks_axis=(None, 8, 2))
SMOKE = dict(strong_kernels=("poly_lcg", "expf"),
             strong_n=64, weak_per_core=16, cores=(1, 2, 4),
             contention_cores=4, banks_axis=(None, 2))


def _point(kernel, n_samples, n_cores, banks):
    rec = run_point(SweepPoint(kernel=kernel, policy="copiftv2",
                               n_samples=n_samples, n_cores=n_cores,
                               tcdm_banks=banks))
    if not rec.ok or not rec.equivalent or rec.fifo_violations:
        raise AssertionError(
            f"{kernel} x{n_cores} banks={banks}: cluster point failed "
            f"({rec.status}: {rec.detail or 'diverged from interpreter'})")
    return rec


def _entry(rec, base_throughput=None):
    return {
        "n_cores": rec.n_cores,
        "tcdm_banks": rec.tcdm_banks,
        "cycles": rec.cycles,
        "throughput": rec.throughput,
        "speedup": (rec.throughput / base_throughput
                    if base_throughput else 1.0),
        "ipc": rec.ipc,
        "ipc_per_core": rec.ipc_per_core,
        "energy_per_sample": rec.energy / rec.n_samples,
        "bank_stalls": rec.bank_stalls,
    }


def run(cfg=None, out_path=None):
    cfg = cfg or FULL
    out_path = out_path or OUT_PATH
    rows, report = [], {"strong_scaling": {}, "weak_scaling": {},
                        "contention": {}}
    t0 = time.time()

    # -- strong scaling: fixed total work, 1..N cores ------------------------
    for kernel in cfg["strong_kernels"]:
        pts = []
        base = None
        for nc in cfg["cores"]:
            if cfg["strong_n"] % nc:
                continue
            rec = _point(kernel, cfg["strong_n"], nc, None)
            if base is None:
                base = rec.throughput
            pts.append(_entry(rec, base))
            rows.append((f"cluster_strong_{kernel}_x{nc}", 0.0,
                         pts[-1]["speedup"]))
        report["strong_scaling"][kernel] = {
            "n_samples": cfg["strong_n"], "points": pts}

    # -- weak scaling: fixed per-core work -----------------------------------
    for kernel in (STRONG_KERNEL,):
        pts = []
        base = None
        for nc in cfg["cores"]:
            rec = _point(kernel, cfg["weak_per_core"] * nc, nc, None)
            if base is None:
                base = rec.throughput
            pts.append(_entry(rec, base))
            rows.append((f"cluster_weak_{kernel}_x{nc}", 0.0,
                         pts[-1]["speedup"]))
        report["weak_scaling"][kernel] = {
            "per_core_samples": cfg["weak_per_core"], "points": pts}

    # -- bank contention at fixed core count ---------------------------------
    nc = cfg["contention_cores"]
    pts = []
    base = None
    prev_tp = None
    for banks in cfg["banks_axis"]:
        rec = _point(CONTENTION_KERNEL, cfg["weak_per_core"] * nc, nc, banks)
        if base is None:
            base = rec.throughput
        e = _entry(rec, base)
        pts.append(e)
        tag = "inf" if banks is None else banks
        rows.append((f"cluster_contention_{CONTENTION_KERNEL}_b{tag}", 0.0,
                     e["throughput"]))
        if prev_tp is not None and e["throughput"] > prev_tp * (1 + 1e-12):
            raise AssertionError(
                f"{CONTENTION_KERNEL} x{nc}: throughput rose from "
                f"{prev_tp:.5f} to {e['throughput']:.5f} as banks shrank to "
                f"{banks} — the contention model is not binding")
        prev_tp = e["throughput"]
    if pts[-1]["bank_stalls"] == 0:
        raise AssertionError(
            f"{CONTENTION_KERNEL} x{nc} with {cfg['banks_axis'][-1]} banks "
            f"recorded no bank stalls — the arbiter never fired")
    report["contention"][CONTENTION_KERNEL] = {"n_cores": nc, "points": pts}

    # -- the acceptance gate --------------------------------------------------
    strong = report["strong_scaling"][STRONG_KERNEL]["points"]
    by_cores = {p["n_cores"]: p for p in strong}
    speedup_4c = by_cores[4]["speedup"]
    if speedup_4c < MIN_SPEEDUP_4C:
        raise AssertionError(
            f"{STRONG_KERNEL}: 1->4 core aggregate-throughput speedup "
            f"{speedup_4c:.2f}x < required {MIN_SPEEDUP_4C}x")
    report["headline"] = {"kernel": STRONG_KERNEL,
                          "speedup_4c": round(speedup_4c, 4),
                          "min_required": MIN_SPEEDUP_4C}
    us = (time.time() - t0) * 1e6 / max(len(rows), 1)
    rows = [(name, us, derived) for name, _z, derived in rows]
    rows.append((f"cluster_headline_speedup_4c_{STRONG_KERNEL}", us,
                 speedup_4c))

    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
    return rows


def main():
    for name, us, derived in run():
        print(f"{name},{us:.1f},{derived:.4f}")
    print(f"# wrote {OUT_PATH}")


def smoke():
    """Tiny grids (cores 1/2/4), separate artifact — the CI gate still
    enforces the >=3x strong-scaling bar and the contention monotonicity."""
    rows = run(cfg=SMOKE, out_path=SMOKE_OUT_PATH)
    if not rows:
        raise AssertionError("cluster scaling smoke produced no rows")
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived:.4f}")


if __name__ == "__main__":
    main()
