"""Cluster-batch-engine scale gate, the port's counterpart of the JAX
package's ``benchmarks/cluster_sweep_scale.py``: the acceptance
benchmark for the vectorized lockstep cluster engine
(``repro_torch.core.batch_cluster``).

One headline section plus a reported-only slice, both written into
``artifacts/BENCH_port_cluster_sweep_scale.json``:

* **throughput** — a 1128-point cluster/pipeline grid over
  ``n_cores in {2, 4, 8}``: three work-partitioned kernels under the
  depth-insensitive policies across the full depth x visibility-latency
  plane, a COPIFTv2 slice, and the pipelined ``cluster_matmul``
  producer/consumer points across the channel-FIFO x DMA-buffering plane —
  through the scalar event ``ClusterStepper`` path and the batched
  max-recurrence cluster engine, serially, warm (``*_cached``) and cold
  (``*_uncached``).  The gate is ``speedup_cached >= SPEEDUP_GATE`` (>=8x
  points/sec): warm-cache mode is the steady-state of any real sweep, and
  the speedup scales with the number of configurations sharing one
  partitioned program set (the grid keeps >=8 runtime configs per group,
  32 for most).  The warm passes also re-check the bit-identity
  contract end to end: the batch sweep's records must equal the event
  sweep's on every point (minus the ``engine`` column).

* **banked** — a small finite-bank slice, reported but *not* gated: heavy
  TCDM contention trips the zero-contention oracle and delegates to the
  scalar engine by design (soundness over speed), so its speedup is
  expected to hover near 1x.  The record-level equality assertion still
  applies — delegation must be invisible in the results.

``--smoke`` shrinks the grids to CI scale and drops the speedup gate —
tiny grids measure fork/alloc noise, not engine throughput — while keeping
every correctness assertion; it writes
``BENCH_port_cluster_sweep_scale_smoke.json``.  The rates are the host
clock's.

  PYTHONPATH=src python -m repro_torch.benchmarks.cluster_sweep_scale \\
      [--smoke]
"""
import argparse
import dataclasses
import gc
import json
import os
import time

from ..core import ExecutionPolicy, grid, run_sweep
from ..core.sweep import clear_worker_caches
from . import ART_DIR

OUT_PATH = os.path.join(ART_DIR, "BENCH_port_cluster_sweep_scale.json")
SMOKE_OUT_PATH = os.path.join(ART_DIR,
                              "BENCH_port_cluster_sweep_scale_smoke.json")

#: acceptance threshold: warm-cache batch cluster engine vs the warm-cache
#: scalar event ClusterStepper path
SPEEDUP_GATE = 8.0

CORES = (2, 4, 8)
#: runtime axis shared by every sub-grid: queue-visibility latency never
#: shapes the lowered schedule, so it widens each batch group for free
QLATS = (1, 2, 3, 4, 5, 6, 8, 10)

#: work-partitioned sub-grid, depth-insensitive policies: queue depth does
#: not shape their lowering either, so one partitioned program set serves
#: the whole depth x latency plane (48 configs per group) —
#: 3 kernels x 2 policies x 6 depths x 8 lats x 3 core counts = 864 points
WORK_DI_GRID = dict(kernels=("poly_lcg", "histf", "dequant_dot"),
                    policies=(ExecutionPolicy.BASELINE,
                              ExecutionPolicy.COPIFT),
                    queue_depths=(1, 2, 3, 4, 6, 8), queue_latencies=QLATS,
                    unrolls=(4,), n_cores=CORES, n_samples=64)

#: COPIFTv2 slice: depth shapes the schedule, so each group only spans the
#: latency axis (8 configs) — 3 kernels x 8 lats x 3 core counts = 72 points
WORK_V2_GRID = dict(kernels=("poly_lcg", "histf", "dequant_dot"),
                    policies=(ExecutionPolicy.COPIFTV2,),
                    queue_depths=(4,), queue_latencies=QLATS,
                    unrolls=(4,), n_cores=CORES, n_samples=64)

#: pipelined producer/consumer sub-grid: channel depth and visibility are
#: runtime fabric properties (32 configs per group), DMA buffering shapes
#: the schedule — 8 lats x 4 cq depths x 3 core counts x 2 bufferings = 192
PIPE_GRID = dict(kernels=("cluster_matmul",),
                 policies=(ExecutionPolicy.COPIFTV2,),
                 queue_depths=(4,), queue_latencies=QLATS, unrolls=(8,),
                 n_cores=CORES, pipelines=(True,), cq_depths=(2, 4, 8, 16),
                 dma_buffers=(1, 2), n_samples=64)

GATE_GRIDS = (WORK_DI_GRID, WORK_V2_GRID, PIPE_GRID)

#: finite-bank contention slice, reported only: the zero-contention oracle
#: delegates conflicting points to the scalar engine, so this measures the
#: delegation overhead, not the lockstep engine
BANKED_GRID = dict(kernels=("histf",),
                   policies=(ExecutionPolicy.COPIFTV2,),
                   queue_depths=(4,), queue_latencies=(1, 2),
                   unrolls=(4,), n_cores=(2, 4), tcdm_banks=(8, 16),
                   n_samples=64)

SMOKE_GATE_GRIDS = (
    dict(kernels=("poly_lcg",), policies=(ExecutionPolicy.COPIFT,),
         queue_depths=(2, 4), queue_latencies=(1, 2), unrolls=(4,),
         n_cores=(2,), n_samples=32),
    dict(kernels=("cluster_matmul",), policies=(ExecutionPolicy.COPIFTV2,),
         queue_depths=(4,), queue_latencies=(1, 2), unrolls=(8,),
         n_cores=(2,), pipelines=(True,), cq_depths=(2, 4), n_samples=64),
)
SMOKE_BANKED_GRID = dict(kernels=("histf",),
                         policies=(ExecutionPolicy.COPIFTV2,),
                         queue_depths=(4,), queue_latencies=(1,),
                         unrolls=(4,), n_cores=(2,), tcdm_banks=(8,),
                         n_samples=32)

#: timed repetitions per warm mode; best run wins (same hygiene as
#: sweep_scale — the slow repeats measure scheduler noise)
REPEATS = 3


def _jsonable_grid(grid_kw):
    def conv(v):
        if isinstance(v, (tuple, list)):
            return [x.value if isinstance(x, ExecutionPolicy) else x
                    for x in v]
        return v
    return {k: conv(v) for k, v in grid_kw.items()}


def _points(grids):
    pts = []
    for grid_kw in grids:
        pts.extend(grid(engine="event", **grid_kw))
    return pts


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


def measure_throughput(grids, repeats=REPEATS):
    """Warm + cold points/sec for the scalar-cluster and batch-cluster
    paths on one grid set, with a full record-level batch-vs-event
    differential on the warm pass."""
    pts_event = _points(grids)
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
            f"batch cluster engine diverged from the event engine on "
            f"{len(mismatch)}/{len(pts_event)} records, first at index "
            f"{mismatch[0]}: {warm_recs['batch'][mismatch[0]]}")
    n_cl = sum(1 for p in pts_event if p.clustered)
    result = {"grids": [_jsonable_grid(g) for g in grids],
              "n_points": len(pts_event), "n_clustered": n_cl,
              "core_counts": sorted({p.n_cores for p in pts_event}),
              "modes": modes, "records_identical": True}
    for kind in ("cached", "uncached"):
        result[f"speedup_{kind}"] = round(
            modes[f"batch_{kind}"]["points_per_sec"]
            / modes[f"event_{kind}"]["points_per_sec"], 3)
    return result


def run(*, gate_grids=GATE_GRIDS, banked_grid=BANKED_GRID, repeats=REPEATS,
        gate=True, out_path=None):
    out_path = out_path or OUT_PATH
    throughput = measure_throughput(gate_grids, repeats=repeats)
    if gate and throughput["n_points"] < 1000:
        raise AssertionError(
            f"gate grid shrank below the 1000-point contract: "
            f"{throughput['n_points']}")
    if gate and throughput["speedup_cached"] < SPEEDUP_GATE:
        raise AssertionError(
            f"batch cluster engine speedup gate: "
            f"{throughput['speedup_cached']}x cached < required "
            f"{SPEEDUP_GATE}x")
    banked = measure_throughput([banked_grid], repeats=repeats)
    result = {"speedup_gate": SPEEDUP_GATE if gate else None,
              "throughput": throughput, "banked": banked}
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(result, f, indent=2, sort_keys=True)

    rows = []
    for section, res in (("", throughput), ("banked_", banked)):
        for name in sorted(res["modes"]):
            m = res["modes"][name]
            rows.append((f"cluster_sweep_scale_{section}{name}"
                         f"_points_per_sec",
                         1e6 / m["points_per_sec"], m["points_per_sec"]))
        for kind in ("cached", "uncached"):
            rows.append((f"cluster_sweep_scale_{section}speedup_{kind}",
                         0.0, res[f"speedup_{kind}"]))
    return rows, out_path


def main():
    rows, out_path = run()
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived:.4f}")
    print(f"# wrote {out_path}")


def smoke():
    """CI-scale grids, no speedup gate (tiny grids measure noise, not the
    engine), every correctness assertion kept, separate artifact name."""
    rows, out_path = run(gate_grids=SMOKE_GATE_GRIDS,
                         banked_grid=SMOKE_BANKED_GRID, repeats=1,
                         gate=False, out_path=SMOKE_OUT_PATH)
    if not rows:
        raise AssertionError("cluster_sweep_scale smoke produced no rows")
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived:.4f}")
    print(f"# wrote {out_path}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="CI-scale grids, no speedup gate")
    args = ap.parse_args()
    smoke() if args.smoke else main()
