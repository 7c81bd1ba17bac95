"""Sweep-throughput benchmark, the port's counterpart of the JAX package's
``benchmarks/sweep_perf.py``: points/sec for the port's DSE pipeline, per
engine.

Times the same fixed high-latency grid (the stall-heavy corner where the
event-driven time-skip core and the per-worker lowering/reference memos
matter most) through four pipeline variants:

* ``cycle_uncached`` — naive per-cycle stepper, no memos: the pre-event-core
  pipeline, kept as the speedup baseline.
* ``cycle_cached``   — naive stepper + per-worker memos (isolates caching).
* ``event_uncached`` — time-skip stepper, no memos (isolates the engine).
* ``event_cached``   — the current default pipeline.

Every variant runs serially in-process (pool fan-out would only add fork
noise to a throughput ratio) and re-validates that each point still matches
the baseline interpreter, so the benchmark doubles as an equivalence check.
Emits ``name,us_per_call,derived`` CSV rows like the other sections and
writes ``artifacts/BENCH_port_sweep.json`` (``BENCH_port_sweep_smoke.json``
from ``smoke()``); the headline ratio, which ``bench_diff`` floors, is
``speedup_event_cached`` (default pipeline vs pre-event-core pipeline).
The rates are the host clock's.

  PYTHONPATH=src python -m repro_torch.benchmarks.sweep_perf
"""
import dataclasses
import gc
import json
import os
import time

from ..core import ExecutionPolicy
from ..core.sweep import clear_worker_caches, grid, run_point
from . import ART_DIR

OUT_PATH = os.path.join(ART_DIR, "BENCH_port_sweep.json")
SMOKE_OUT_PATH = os.path.join(ART_DIR, "BENCH_port_sweep_smoke.json")

#: The acceptance grid: high visibility latencies across the full depth axis,
#: over the two queue/communication policies whose schedules the queue
#: geometry actually shapes.  BASELINE is excluded on purpose — it has no
#: queues, so a depth x latency grid of baseline points is ten copies of one
#: point and would only dilute a throughput ratio with redundant work.
FULL_GRID = dict(policies=(ExecutionPolicy.COPIFT, ExecutionPolicy.COPIFTV2),
                 queue_depths=(1, 2, 4, 8, 16), queue_latencies=(4, 8),
                 unrolls=(8,), n_samples=128)
SMOKE_GRID = dict(kernels=["expf", "box_muller"],
                  policies=(ExecutionPolicy.COPIFT, ExecutionPolicy.COPIFTV2),
                  queue_depths=(1, 4), queue_latencies=(4, 8), unrolls=(8,),
                  n_samples=16)

MODES = (
    ("cycle_uncached", "cycle", False),
    ("cycle_cached", "cycle", True),
    ("event_uncached", "event", False),
    ("event_cached", "event", True),
)

#: timing repetitions per mode; best run wins (standard throughput hygiene:
#: the slower repeats mostly measure scheduler contention and allocator/GC
#: noise, which on small shared CI hosts routinely costs 2x)
REPEATS = 4


def _time_once(points, engine, use_caches):
    """One cold serial pass of a pipeline variant: (wall seconds, records).

    GC is paused while the clock runs (collection debt from other variants
    must not land in this one) and every pass re-validates interpreter
    equivalence.
    """
    pts = [dataclasses.replace(p, engine=engine) for p in points]
    clear_worker_caches()
    gc.collect()
    gc.disable()
    try:
        t0 = time.time()
        recs = [run_point(p, use_caches=use_caches) for p in pts]
        dt = time.time() - t0
    finally:
        gc.enable()
    bad = [r for r in recs if r.status == "deadlock"
           or (r.ok and (not r.equivalent or r.fifo_violations))]
    if bad:
        raise AssertionError(
            f"{engine}/cached={use_caches}: {len(bad)} points deadlocked or "
            f"diverged from the interpreter, e.g. {bad[0]}")
    return dt, recs


def _time_modes(points):
    """Best-of-:data:`REPEATS` wall time per mode, with the repeats
    round-robined across modes so a noisy scheduling window penalizes every
    variant evenly instead of whichever mode it happened to land on."""
    best = {name: None for name, _e, _c in MODES}
    cycles = {}
    for _ in range(REPEATS):
        for name, engine, cached in MODES:
            dt, recs = _time_once(points, engine, cached)
            if best[name] is None or dt < best[name]:
                best[name] = dt
            cycles[name] = sum(r.cycles for r in recs)
    return {
        name: dict(engine=engine, cached=cached, points=len(points),
                   wall_s=round(best[name], 4),
                   points_per_sec=round(len(points) / best[name], 3),
                   cycles_total=cycles[name])
        for name, engine, cached in MODES
    }


def run(grid_kw=None, out_path=None):
    out_path = out_path or OUT_PATH
    points = grid(**(grid_kw or FULL_GRID))

    def jsonable(v):
        if isinstance(v, (tuple, list)):
            return [x.value if isinstance(x, ExecutionPolicy) else x
                    for x in v]
        return v

    result = {"grid": {k: jsonable(v)
                       for k, v in (grid_kw or FULL_GRID).items()},
              "n_points": len(points), "modes": _time_modes(points)}
    base = result["modes"]["cycle_uncached"]["points_per_sec"]
    for name, _e, _c in MODES:
        result[f"speedup_{name}"] = round(
            result["modes"][name]["points_per_sec"] / base, 3)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(result, f, indent=2, sort_keys=True)
    rows = []
    for name, _e, _c in MODES:
        m = result["modes"][name]
        us = 1e6 / m["points_per_sec"]
        rows.append((f"sweep_perf_{name}_points_per_sec", us,
                     m["points_per_sec"]))
        rows.append((f"sweep_perf_speedup_{name}", us,
                     result[f"speedup_{name}"]))
    return rows


def main():
    for name, us, derived in run():
        print(f"{name},{us:.1f},{derived:.4f}")
    print(f"# wrote {OUT_PATH}")


def smoke():
    """Tiny grid, separate artifact name: CI tracks shape, not the ratio
    (a 16-sample smoke grid is too small for a stable speedup number)."""
    rows = run(grid_kw=SMOKE_GRID, out_path=SMOKE_OUT_PATH)
    if not rows:
        raise AssertionError("sweep_perf smoke produced no rows")
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived:.4f}")


if __name__ == "__main__":
    main()
