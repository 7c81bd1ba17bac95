"""Batch-engine scale gate, the port's counterpart of the JAX package's
``benchmarks/sweep_scale.py``: the acceptance benchmark for the
vectorized sweep pipeline and the front-guided adaptive search, over the
port's machine model.

Two sections, both written into ``artifacts/BENCH_port_sweep_scale.json``:

* **throughput** — the 2880-point asymmetric-geometry grid (every
  single-core kernel x {copift, copiftv2} x the full depth axis x
  high-visibility latencies x the i2f/f2i depth-override axes) through the
  event engine and the batched max-recurrence engine, serially, warm
  (``*_cached``) and cold (``*_uncached``).  The gate is
  ``speedup_cached >= SPEEDUP_GATE`` (>=10x points/sec): warm-cache mode is
  the steady-state of any real sweep — every rung after the first, every
  repeat of a calibration grid — and is the regime the batch engine exists
  for.  Cold rates are reported (not gated): a cold pass is dominated by
  lowering, which both engines share.  The warm passes also re-check the
  bit-identity contract end to end: the batch sweep's records must
  equal the event sweep's on every point (minus the ``engine`` column).

* **adaptive** — a 103,680-point grid (the throughput axes widened to ten
  depths, eight latencies, and three unrolls) run through
  ``adaptive_sweep`` at the default fidelity ladder, then checked against
  an exhaustive run of a 5184-point differential slice (every
  ``SLICE_STRIDE``-th grid point): the slice is a subset of the full grid,
  so the full grid's Pareto fronts dominate the slice's, and the adaptive
  fronts must therefore cover the slice's exhaustive fronts within the
  search's own dominance tolerance.  Failing either direction of that
  cover means the pruning rule dropped a front-defining point.

``--smoke`` shrinks both sections to CI scale (a 32-point throughput grid
and a 256-point adaptive grid) and drops the speedup gate — tiny grids
measure fork/alloc noise, not engine throughput — while keeping every
correctness assertion; it writes ``BENCH_port_sweep_scale_smoke.json``.
The rates are the host clock's.

  PYTHONPATH=src python -m repro_torch.benchmarks.sweep_scale [--smoke]
"""
import argparse
import dataclasses
import gc
import json
import os
import time

from ..core import (ExecutionPolicy, front_matches, grid, pareto_by_kernel,
                    run_sweep)
from ..core.search import DEFAULT_TOLERANCE, adaptive_sweep
from ..core.sweep import clear_worker_caches
from . import ART_DIR

OUT_PATH = os.path.join(ART_DIR, "BENCH_port_sweep_scale.json")
SMOKE_OUT_PATH = os.path.join(ART_DIR, "BENCH_port_sweep_scale_smoke.json")

#: acceptance threshold: warm-cache batch engine vs warm-cache event engine
SPEEDUP_GATE = 10.0

#: every single-core kernel; cluster_matmul needs n_cores >= 2 and the
#: batch engine delegates clustered points anyway
SINGLE_CORE_KERNELS = ("box_muller", "dequant_dot", "expf", "histf", "logf",
                       "poly_lcg")
POLICIES = (ExecutionPolicy.COPIFT, ExecutionPolicy.COPIFTV2)

#: the 2880-point gate grid: 6 kernels x 2 policies x 5 depths x 2 lats
#: x 4 i2f x 6 f2i asymmetric geometries at the full sample count
THROUGHPUT_GRID = dict(kernels=SINGLE_CORE_KERNELS, policies=POLICIES,
                       queue_depths=(1, 2, 4, 8, 16), queue_latencies=(4, 8),
                       unrolls=(8,), i2f_depths=(None, 2, 8, 16),
                       f2i_depths=(None, 1, 2, 4, 8, 16), n_samples=128)

#: the >=100k adaptive demonstration grid:
#: 6 kernels x 2 policies x 10 depths x 8 latencies x 3 unrolls x 6 i2f
#: x 6 f2i = 103,680 points
ADAPTIVE_GRID = dict(kernels=SINGLE_CORE_KERNELS, policies=POLICIES,
                     queue_depths=(1, 2, 3, 4, 5, 6, 8, 10, 12, 16),
                     queue_latencies=(1, 2, 3, 4, 5, 6, 7, 8),
                     unrolls=(2, 4, 8),
                     i2f_depths=(None, 1, 2, 4, 8, 16),
                     f2i_depths=(None, 1, 2, 4, 8, 16), n_samples=128)

#: every SLICE_STRIDE-th adaptive-grid point forms the differential slice
#: that also runs exhaustively (103680 / 20 = 5184 points)
SLICE_STRIDE = 20

SMOKE_THROUGHPUT_GRID = dict(kernels=("expf", "histf"), policies=POLICIES,
                             queue_depths=(1, 4), queue_latencies=(4, 8),
                             i2f_depths=(None, 2), n_samples=32)
SMOKE_ADAPTIVE_GRID = dict(kernels=("expf", "histf"), policies=POLICIES,
                           queue_depths=(1, 2, 4, 8),
                           queue_latencies=(1, 4), unrolls=(4, 8),
                           i2f_depths=(None, 2), f2i_depths=(None, 2),
                           n_samples=64)
SMOKE_SLICE_STRIDE = 3

#: timed repetitions per warm mode; best run wins (same hygiene as
#: sweep_perf — the slow repeats measure scheduler noise)
REPEATS = 3


def _jsonable_grid(grid_kw):
    def conv(v):
        if isinstance(v, (tuple, list)):
            return [x.value if isinstance(x, ExecutionPolicy) else x
                    for x in v]
        return v
    return {k: conv(v) for k, v in grid_kw.items()}


def _timed_sweep(points, *, cold):
    """One serial sweep pass under a paused GC: (wall seconds, records)."""
    if cold:
        clear_worker_caches()
    gc.collect()
    gc.disable()
    try:
        t0 = time.perf_counter()
        recs = run_sweep(points, workers=1)
        dt = time.perf_counter() - t0
    finally:
        gc.enable()
    return dt, recs


def _strip_engine(rec):
    d = dataclasses.asdict(rec)
    d.pop("engine")
    return d


def measure_throughput(grid_kw, repeats=REPEATS):
    """Warm + cold points/sec for the event and batch engines on one grid,
    with a full record-level batch-vs-event differential on the warm pass."""
    pts_event = grid(engine="event", **grid_kw)
    pts_batch = [dataclasses.replace(p, engine="batch") for p in pts_event]
    modes = {}
    warm_recs = {}
    for name, pts in (("event", pts_event), ("batch", pts_batch)):
        cold_s, recs = _timed_sweep(pts, cold=True)
        warm_best = None
        for _ in range(repeats):
            warm_s, recs = _timed_sweep(pts, cold=False)
            warm_best = warm_s if warm_best is None else min(warm_best,
                                                             warm_s)
        warm_recs[name] = recs
        bad = [r for r in recs if r.status == "deadlock"
               or (r.ok and (not r.equivalent or r.fifo_violations))]
        if bad:
            raise AssertionError(
                f"{name}: {len(bad)} points deadlocked or diverged from "
                f"the interpreter, e.g. {bad[0]}")
        n = len(pts)
        modes[f"{name}_uncached"] = dict(
            engine=name, cached=False, points=n, wall_s=round(cold_s, 4),
            points_per_sec=round(n / cold_s, 3))
        modes[f"{name}_cached"] = dict(
            engine=name, cached=True, points=n, wall_s=round(warm_best, 4),
            points_per_sec=round(n / warm_best, 3))
    mismatch = [i for i, (a, b) in
                enumerate(zip(warm_recs["event"], warm_recs["batch"]))
                if _strip_engine(a) != _strip_engine(b)]
    if mismatch:
        raise AssertionError(
            f"batch engine diverged from the event engine on "
            f"{len(mismatch)}/{len(pts_event)} records, first at index "
            f"{mismatch[0]}: {warm_recs['batch'][mismatch[0]]}")
    result = {"grid": _jsonable_grid(grid_kw), "n_points": len(pts_event),
              "modes": modes, "records_identical": True}
    for kind in ("cached", "uncached"):
        result[f"speedup_{kind}"] = round(
            modes[f"batch_{kind}"]["points_per_sec"]
            / modes[f"event_{kind}"]["points_per_sec"], 3)
    return result


def measure_adaptive(grid_kw, slice_stride, tolerance=DEFAULT_TOLERANCE):
    """Time ``adaptive_sweep`` over the full grid, then verify its fronts
    cover the exhaustive fronts of the every-``slice_stride``-th-point
    differential slice within the search tolerance."""
    points = grid(engine="batch", **grid_kw)
    clear_worker_caches()
    t0 = time.perf_counter()
    recs, meta = adaptive_sweep(points, workers=1, tolerance=tolerance)
    wall_s = time.perf_counter() - t0

    sliced = points[::slice_stride]
    ref = run_sweep(sliced, workers=1)
    ref_fronts = pareto_by_kernel(ref)
    got_fronts = pareto_by_kernel(recs)
    fronts = {}
    failures = []
    for kernel, ref_front in sorted(ref_fronts.items()):
        ok, slack = front_matches(got_fronts.get(kernel, []), ref_front,
                                  tolerance=tolerance)
        fronts[kernel] = dict(ok=ok, slack=round(slack, 6),
                              ref_front=len(ref_front),
                              adaptive_front=len(got_fronts.get(kernel, [])))
        if not ok:
            failures.append(kernel)
    if failures:
        raise AssertionError(
            f"adaptive fronts fail to cover the exhaustive slice fronts "
            f"within tolerance {tolerance}: {failures} ({fronts})")
    return {"grid": _jsonable_grid(grid_kw), "n_points": len(points),
            "wall_s": round(wall_s, 4),
            "points_per_sec": round(len(points) / wall_s, 3),
            "search": meta,
            "slice": {"stride": slice_stride, "n_points": len(sliced),
                      "tolerance": tolerance, "fronts": fronts}}


def run(*, throughput_grid=None, adaptive_grid=None, slice_stride=None,
        repeats=REPEATS, gate=True, out_path=None):
    out_path = out_path or OUT_PATH
    throughput = measure_throughput(throughput_grid or THROUGHPUT_GRID,
                                    repeats=repeats)
    if gate and throughput["speedup_cached"] < SPEEDUP_GATE:
        raise AssertionError(
            f"batch engine speedup gate: {throughput['speedup_cached']}x "
            f"cached < required {SPEEDUP_GATE}x")
    adaptive = measure_adaptive(adaptive_grid or ADAPTIVE_GRID,
                                slice_stride or SLICE_STRIDE)
    if gate and adaptive["n_points"] < 100_000:
        raise AssertionError(
            f"adaptive demonstration grid shrank below the 100k-point "
            f"contract: {adaptive['n_points']}")
    result = {"speedup_gate": SPEEDUP_GATE if gate else None,
              "throughput": throughput, "adaptive": adaptive}
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(result, f, indent=2, sort_keys=True)

    rows = []
    for name in sorted(throughput["modes"]):
        m = throughput["modes"][name]
        rows.append((f"sweep_scale_{name}_points_per_sec",
                     1e6 / m["points_per_sec"], m["points_per_sec"]))
    for kind in ("cached", "uncached"):
        rows.append((f"sweep_scale_speedup_{kind}", 0.0,
                     throughput[f"speedup_{kind}"]))
    rows.append(("sweep_scale_adaptive_points_per_sec",
                 1e6 / adaptive["points_per_sec"],
                 adaptive["points_per_sec"]))
    rows.append(("sweep_scale_adaptive_full_fidelity_frac", 0.0,
                 adaptive["search"]["n_full_fidelity"]
                 / adaptive["n_points"]))
    return rows, out_path


def main():
    rows, out_path = run()
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived:.4f}")
    print(f"# wrote {out_path}")


def smoke():
    """CI-scale grids, no speedup gate (tiny grids measure noise, not the
    engine), every correctness assertion kept, separate artifact name."""
    rows, out_path = run(throughput_grid=SMOKE_THROUGHPUT_GRID,
                         adaptive_grid=SMOKE_ADAPTIVE_GRID,
                         slice_stride=SMOKE_SLICE_STRIDE, repeats=1,
                         gate=False, out_path=SMOKE_OUT_PATH)
    if not rows:
        raise AssertionError("sweep_scale smoke produced no rows")
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived:.4f}")
    print(f"# wrote {out_path}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="CI-scale grids, no speedup gate")
    args = ap.parse_args()
    smoke() if args.smoke else main()
