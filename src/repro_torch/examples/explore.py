"""Design-space exploration CLI over the Snitch/FPSS machine model: the
port's counterpart of the JAX package's ``examples/explore.py``, with the
same subcommands, flags, CSVs and artifact files, on the port's copy of
the machine model (``repro_torch.core``, numpy on the host).

Sweeps (kernel x policy x queue_depth x queue_latency x unroll) grids through
the simulator, prints per-kernel Pareto fronts (IPC vs energy), writes the
full sweep and the fronts as CSV, and re-checks on *every* swept point that
the lowered program computes bit-identical outputs to the sequential baseline
interpreter — the sweep doubles as the repo's largest semantics fuzzer.

Usage (defaults sweep 22680 configurations: 7 kernels x 3 policies x
5 depths x 4 latencies x 2 unrolls x 3x3 asymmetric overrides x 3 core
counts — the cluster axis is in the default grid because the lockstep
batch engine advances clustered and pipelined points too
(``core.batch_cluster``); an estimated-cost line blending each
point's actual engine rate prints before the sweep launches):

    PYTHONPATH=src python -m repro_torch.examples.explore
    PYTHONPATH=src python -m repro_torch.examples.explore \
        --kernels expf,dequant_dot --policies copift,copiftv2 \
        --depths 1,2,4,8,16 --latencies 1,2,4 --unrolls 4,8 \
        --n-samples 64 --workers 2 --out-dir artifacts/dse

Cluster axes (``core.cluster``): ``--cores`` sweeps Snitch-cluster core
counts (the kernel is work-partitioned into disjoint per-core sample
ranges; ``n_samples`` must divide evenly) and ``--banks`` sweeps TCDM bank
counts ('inf' = conflict-free).  Cluster records report aggregate IPC /
throughput over the makespan, per-core IPC, energy including interconnect
energy, and the ``*_bank`` stall cause.  ``--cores 1`` with ``--banks inf``
is bit-identical to the single-PE machine — the contract
``tests/test_cluster.py`` gates differentially in the JAX package:

    PYTHONPATH=src python -m repro_torch.examples.explore \
        --kernels poly_lcg,histf --policies copiftv2 \
        --cores 1,2,4 --banks inf,8,2

Pipelined-cluster axes (``transform.partition_pipeline``): ``--pipeline``
adds producer/consumer points where each core *pair* splits one kernel —
the INT core streams operands through bounded inter-core channels to the
FP-heavy core, with DMA double-buffering hiding the loads.  ``--cq-depths``
sweeps the channel FIFO depth and ``--dma-buffers`` the double-buffering
degree.  Pipelined points need an even core count and the COPIFTv2 policy
(others are rejected, not errors); stall columns ``cq_stalls`` /
``dma_stalls`` report channel back-pressure and DMA waits:

    PYTHONPATH=src python -m repro_torch.examples.explore \
        --kernels cluster_matmul --policies copiftv2 --pipeline both \
        --cores 2,4 --banks 2,8 --cq-depths 2,4,8 --dma-buffers 1,2,4

``--engine`` picks the simulation core: ``batch`` (default) groups every
point sharing a lowered program (single-PE: ``core.batch_machine``) or a
partitioned program set (clustered/pipelined: ``core.batch_cluster``) and
advances the whole group in one numpy max-recurrence pass — bit-identical
to ``event`` (the per-point event-driven time-skip engine), which is in
turn bit-identical to ``cycle`` (the naive per-cycle reference stepper).
Batch-inexpressible programs and predicted bank-conflict/deadlock points
fall back to the scalar engines automatically, so the batch path is
always sound.  A timing report (wall time, points/sec, ms/config) prints
either way; ``--engine event``/``cycle`` exist for differential checking
and benchmarking.

``--strategy`` picks the search discipline: ``exhaustive`` (default)
evaluates every grid point; ``adaptive`` runs front-guided successive
halving (``core.search``) — coarse low-fidelity rungs prune points more
than ``--search-tolerance`` beyond the running per-kernel Pareto fronts,
and only survivors are re-simulated at full fidelity (their records are
exact; pruned points simply don't appear in the output CSVs).

Outputs ``sweep.csv`` (every record) and ``pareto.csv`` (front members only)
under ``--out-dir``; exits non-zero if any configuration fails the
equivalence check or deadlocks.

Calibration (the calibrate → consume flow)
------------------------------------------

    PYTHONPATH=src python -m repro_torch.examples.explore calibrate
    PYTHONPATH=src python -m repro_torch.examples.explore calibrate \
        --objective energy-bounded-ipc --energy-budget 20000 \
        --kernels expf,dequant_dot --out-dir artifacts/calibration
    PYTHONPATH=src python -m repro_torch.examples.explore calibrate \
        --objective serve-slo --slo-p99 250 --kernels expf

``calibrate`` runs the same sweep, reduces it to per-kernel Pareto fronts,
selects one operating point per kernel under ``--objective`` (``max-ipc``,
``min-energy``, ``energy-bounded-ipc`` with ``--energy-budget``, or
``serve-slo`` — max throughput s.t. estimated p99 ≤ ``--slo-p99``
cycles/token and J/token ≤ ``--energy-budget``), and
persists each selection as a versioned, schema-checked JSON artifact
``artifacts/calibration/<kernel>.json`` (grid, front, git provenance and
selection rationale embedded; since schema v5 every artifact also carries
per-traffic-level ``serve-slo`` selections, whatever the global objective).
Downstream consumers load the artifacts at
startup through ``repro_torch.core.policy.PolicyTable``:

* ``kernels/queue_matmul`` takes its ring depth / unroll from the
  ``dequant_dot`` artifact (workload proxy table in ``core.policy``);
* ``serve.ServeEngine`` and ``train.make_train_step`` resolve the ``serve``
  / ``train`` workloads' policies once, at startup;
* explicit arguments always override, and with no artifact (or a stale
  schema version) everything falls back to the paper's defaults with a
  warning — calibration can never brick a run.

Set ``REPRO_CALIBRATION_DIR`` to point consumers (and this command's
default output) at a different artifact directory.
"""
import argparse
import os
import sys
import time

from ..core import (KERNELS, STRATEGIES, SWEEP_ENGINES, ExecutionPolicy,
                    calibrate, format_front, grid, pareto_by_kernel,
                    resolve_workers, run_search, sweep_summary, write_csv)
from ..core.calibrate import OBJECTIVES, calibration_dir
from ..core.search import DEFAULT_LADDER, DEFAULT_TOLERANCE

#: rough single-worker engine rates (points/sec) for the estimated-cost
#: line, from ``artifacts/BENCH_sweep_scale.json`` (single-PE grids) and
#: ``artifacts/BENCH_cluster_sweep_scale.json`` (cluster/pipeline grids),
#: the JAX package's host-CPU runs of the same numpy engines — an
#: expectation-setter before a long sweep launches, not a promise.
#: ``batch_cluster`` is the lockstep cluster engine's rate: clustered and
#: pipelined points on ``--engine batch`` run there, not at the single-PE
#: batch rate, so the estimate blends per point.
NOMINAL_RATES = {"batch": 4000.0, "batch_cluster": 1500.0,
                 "event": 180.0, "cycle": 45.0}


def _ints(s):
    return tuple(int(x) for x in s.split(",") if x)


def _point_rate(pt, engine):
    """Nominal points/sec for one sweep point under ``engine``."""
    if engine == "batch":
        return NOMINAL_RATES["batch_cluster" if pt.clustered else "batch"]
    return NOMINAL_RATES.get(engine, NOMINAL_RATES["event"])


def _estimated_cost_line(pts, engine, workers, strategy):
    """Blended cost estimate: each point contributes at the rate of the
    engine that will actually simulate it (clustered/pipelined points on
    the batch engine run through the lockstep cluster engine), so mixed
    grids no longer quote the single-PE batch nominal for everything."""
    w = max(1, workers)
    seconds = sum(1.0 / _point_rate(pt, engine) for pt in pts) / w
    rate = len(pts) / seconds if seconds else 0.0
    n_cl = sum(1 for pt in pts if pt.clustered)
    mix = (f"; {n_cl}/{len(pts)} clustered" if 0 < n_cl < len(pts) else "")
    note = (" (adaptive search prunes dominated points after the first "
            "low-fidelity rung)" if strategy == "adaptive" else "")
    return (f"estimated cost: {len(pts)} points / ~{rate:.0f} pts/s "
            f"[{engine}, {workers} worker(s){mix}] ~= {seconds:.1f}s"
            f"{note}")


def _opt_ints(s):
    """Comma list where '-'/'none'/'inf' means the None sentinel (symmetric
    queue depth, or the conflict-free bank count).  Prefer the word forms on
    the command line: a leading '-' needs ``--flag=-,8`` argparse syntax."""
    return tuple(None if x in ("-", "none", "inf") else int(x)
                 for x in s.split(",") if x)


def calibrate_main(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.explore calibrate",
        description="Sweep, reduce to per-kernel Pareto fronts, select an "
                    "operating point per objective, and write versioned "
                    "calibration artifacts consumed by queue_matmul / serve "
                    "/ train (see the module docstring).")
    ap.add_argument("--kernels", default=None,
                    help="comma list (default: all seven)")
    ap.add_argument("--policies", default=None,
                    help="comma list of baseline,copift,copiftv2")
    ap.add_argument("--depths", type=_ints, default=(1, 2, 4, 8))
    ap.add_argument("--latencies", type=_ints, default=(1, 2))
    ap.add_argument("--unrolls", type=_ints, default=(4, 8))
    ap.add_argument("--n-samples", type=int, default=32)
    ap.add_argument("--workers", type=int, default=None)
    ap.add_argument("--engine", choices=SWEEP_ENGINES, default="batch",
                    help="simulation core (default: the vectorized batch "
                         "engine; event/cycle are the per-point steppers)")
    ap.add_argument("--strategy", choices=STRATEGIES, default="exhaustive",
                    help="search discipline: exhaustive evaluates every "
                         "grid point; adaptive prunes via front-guided "
                         "successive halving (the artifact provenance "
                         "records strategy + fidelity ladder)")
    ap.add_argument("--search-tolerance", type=float,
                    default=DEFAULT_TOLERANCE,
                    help="adaptive only: relative dominance slack a point "
                         "may have to the running front and still advance "
                         "to full fidelity")
    ap.add_argument("--fidelity-ladder", type=_ints, default=DEFAULT_LADDER,
                    help="adaptive only: comma list of n-samples divisors "
                         "per rung, strictly decreasing, ending at 1")
    ap.add_argument("--objective", choices=OBJECTIVES, default="max-ipc")
    ap.add_argument("--energy-budget", type=float, default=None,
                    help="required for --objective energy-bounded-ipc; for "
                         "serve-slo it is the joules-per-token bound")
    ap.add_argument("--slo-p99", type=float, default=None,
                    help="serve-slo p99 bound in cycles-equivalent per "
                         "work-token (default: auto-derived with headroom "
                         "from the front's best attainable estimate); the "
                         "per-traffic selections (selected_by_traffic, "
                         "schema v5) use it too")
    ap.add_argument("--tolerance", type=float, default=0.0,
                    help="dominance tolerance: candidates within this "
                         "relative distance of the best primary axis tie, "
                         "resolved on the secondary axis")
    ap.add_argument("--out-dir", default=None,
                    help="artifact directory (default: REPRO_CALIBRATION_DIR "
                         "or artifacts/calibration)")
    args = ap.parse_args(argv)
    if args.objective == "energy-bounded-ipc" and args.energy_budget is None:
        ap.error("--objective energy-bounded-ipc requires --energy-budget")

    kernels = args.kernels.split(",") if args.kernels else None
    grid_kw = dict(queue_depths=args.depths, queue_latencies=args.latencies,
                   unrolls=args.unrolls, n_samples=args.n_samples,
                   engine=args.engine)
    if args.policies:
        grid_kw["policies"] = [ExecutionPolicy.parse(p)
                               for p in args.policies.split(",")]
    out_dir = args.out_dir or calibration_dir()
    pts_est = grid(kernels=kernels, **grid_kw)
    print(_estimated_cost_line(
        pts_est, args.engine, resolve_workers(len(pts_est), args.workers),
        args.strategy))
    search_kw = (dict(tolerance=args.search_tolerance,
                      fidelity_ladder=args.fidelity_ladder)
                 if args.strategy == "adaptive" else None)
    t0 = time.time()
    recs = calibrate(kernels=kernels, objective=args.objective,
                     energy_budget=args.energy_budget,
                     tolerance=args.tolerance, slo_p99=args.slo_p99,
                     grid_kw=grid_kw,
                     workers=args.workers, out_dir=out_dir,
                     strategy=args.strategy, search_kw=search_kw)
    dt = time.time() - t0
    for kernel in sorted(recs):
        r = recs[kernel]
        s = r.selected
        print(f"== {kernel}: {r.objective} -> {s['policy']} "
              f"depth={s['queue_depth']} lat={s['queue_latency']} "
              f"unroll={s['unroll']} (ipc={s['ipc']:.3f}, "
              f"energy={s['energy']:.1f}; front {len(r.front)}; "
              f"{len(r.selected_by_latency)} latency classes, "
              f"{len(r.selected_by_traffic)} traffic levels) ==")
        print(f"   {r.rationale}")
    print(f"\ncalibrated {len(recs)} kernels in {dt:.2f}s; wrote "
          f"{out_dir}/<kernel>.json (consumers honour REPRO_CALIBRATION_DIR)")
    return 0


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "calibrate":
        return calibrate_main(argv[1:])
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0] +
        "  (Run 'python -m repro_torch.examples.explore calibrate --help' "
        "for the calibration subcommand.)")
    ap.add_argument("--kernels", default=None,
                    help="comma list (default: all seven)")
    ap.add_argument("--policies", default=None,
                    help="comma list of baseline,copift,copiftv2 (default: all)")
    ap.add_argument("--depths", type=_ints, default=(1, 2, 4, 8, 16),
                    help="queue depths to sweep")
    ap.add_argument("--latencies", type=_ints, default=(1, 2, 4, 8),
                    help="queue visibility latencies to sweep")
    ap.add_argument("--unrolls", type=_ints, default=(4, 8),
                    help="schedule interleave factors to sweep")
    ap.add_argument("--depths-i2f", type=_opt_ints, default=(None, 2, 8),
                    help="asymmetric I2F depth overrides (comma list; "
                         "'-' = symmetric)")
    ap.add_argument("--depths-f2i", type=_opt_ints, default=(None, 2, 8),
                    help="asymmetric F2I depth overrides (comma list; "
                         "'-' = symmetric)")
    ap.add_argument("--cores", type=_ints, default=(1, 2, 4),
                    help="cluster core counts to sweep (work-partitioned "
                         "disjoint sample ranges; n-samples must divide "
                         "evenly; 1 = the single-PE machine, bit-identical "
                         "to the plain stepper; multi-core points ride the "
                         "lockstep batch-cluster engine by default)")
    ap.add_argument("--banks", type=_opt_ints, default=(None,),
                    help="TCDM bank counts to sweep (comma list; 'inf' = "
                         "conflict-free/infinite banks)")
    ap.add_argument("--pipeline", choices=("off", "on", "both"),
                    default="off",
                    help="pipelined producer/consumer core pairs "
                         "(transform.partition_pipeline): 'on' sweeps only "
                         "pipelined points, 'both' adds them next to the "
                         "work-partitioned ones; needs an even --cores "
                         "value and the copiftv2 policy (other combinations "
                         "are rejected, not errors)")
    ap.add_argument("--cq-depths", type=_ints, default=(4,),
                    help="inter-core channel FIFO depths to sweep "
                         "(pipelined points; runtime property like --banks)")
    ap.add_argument("--dma-buffers", type=_ints, default=(2,),
                    help="producer DMA double-buffering degrees to sweep "
                         "(pipelined points; shapes the lowered schedule)")
    ap.add_argument("--n-samples", type=int, default=32)
    ap.add_argument("--workers", type=int, default=None,
                    help="process-pool width (0/1 = serial)")
    ap.add_argument("--engine", choices=SWEEP_ENGINES, default="batch",
                    help="simulation core: the vectorized batch engine "
                         "(default; one numpy pass per lowered program, "
                         "bit-identical to event), the per-point "
                         "event-driven time-skip engine, or the naive "
                         "per-cycle reference")
    ap.add_argument("--strategy", choices=STRATEGIES, default="exhaustive",
                    help="search discipline: exhaustive evaluates every "
                         "point; adaptive (core.search) prunes points more "
                         "than --search-tolerance beyond the running "
                         "per-kernel Pareto fronts at coarse fidelity and "
                         "only refines survivors at full fidelity")
    ap.add_argument("--search-tolerance", type=float,
                    default=DEFAULT_TOLERANCE,
                    help="adaptive only: relative dominance slack kept "
                         "alive while pruning")
    ap.add_argument("--fidelity-ladder", type=_ints, default=DEFAULT_LADDER,
                    help="adaptive only: comma list of n-samples divisors "
                         "per rung, strictly decreasing, ending at 1")
    ap.add_argument("--out-dir", default=os.path.join("artifacts", "dse"))
    args = ap.parse_args(argv)

    kernels = args.kernels.split(",") if args.kernels else None
    policies = ([ExecutionPolicy.parse(p) for p in args.policies.split(",")]
                if args.policies else None)
    pipelines = {"off": (False,), "on": (True,),
                 "both": (False, True)}[args.pipeline]
    pts = grid(kernels=kernels, policies=policies, queue_depths=args.depths,
               queue_latencies=args.latencies, unrolls=args.unrolls,
               n_samples=args.n_samples, engine=args.engine,
               i2f_depths=args.depths_i2f, f2i_depths=args.depths_f2i,
               n_cores=args.cores, tcdm_banks=args.banks,
               pipelines=pipelines, cq_depths=args.cq_depths,
               dma_buffers=args.dma_buffers)
    if not pts:
        ap.error("empty sweep grid: every axis needs at least one value")
    workers = resolve_workers(len(pts), args.workers)
    print(f"sweeping {len(pts)} configurations "
          f"({len(kernels) if kernels else len(KERNELS)} kernels x "
          f"{len(policies) if policies else len(ExecutionPolicy)} policies x "
          f"{len(args.depths)} depths x {len(args.latencies)} latencies x "
          f"{len(args.unrolls)} unrolls x {len(args.cores)} core-counts x "
          f"{len(args.banks)} bank-geometries; n_samples={args.n_samples}) "
          f"[engine={args.engine}, strategy={args.strategy}, "
          f"workers={workers}] ...")
    print(_estimated_cost_line(pts, args.engine, workers, args.strategy))
    search_kw = (dict(tolerance=args.search_tolerance,
                      fidelity_ladder=args.fidelity_ladder)
                 if args.strategy == "adaptive" else {})
    t0 = time.time()
    recs, meta = run_search(pts, strategy=args.strategy,
                            workers=args.workers, **search_kw)
    dt = time.time() - t0
    print(f"== timing ==\n  engine: {args.engine}\n  wall: {dt:.2f}s"
          f"\n  points/sec: {len(pts) / dt:.1f}"
          f"\n  ms/config: {dt / len(pts) * 1e3:.1f}")
    if args.strategy == "adaptive":
        print(f"  adaptive: {meta['n_full_fidelity']}/{meta['n_points']} "
              f"points reached full fidelity "
              f"(rungs {meta['rungs']}, tolerance {meta['tolerance']:g})")
    print()

    fronts = pareto_by_kernel(recs)
    for kernel, front in fronts.items():
        print(f"== {kernel}: Pareto front (maximize IPC, minimize energy), "
              f"{len(front)} of {sum(r.kernel == kernel for r in recs)} configs ==")
        print(format_front(front))
        print()

    s = sweep_summary(recs)
    print("== sweep summary ==")
    for k, v in sorted(s.items()):
        print(f"  {k}: {v:.4f}" if isinstance(v, float) else f"  {k}: {v}")

    os.makedirs(args.out_dir, exist_ok=True)
    sweep_csv = os.path.join(args.out_dir, "sweep.csv")
    pareto_csv = os.path.join(args.out_dir, "pareto.csv")
    write_csv(recs, sweep_csv)
    write_csv([r for front in fronts.values() for r in front], pareto_csv)
    print(f"\nwrote {sweep_csv} ({len(recs)} rows) and {pareto_csv} "
          f"({sum(len(f) for f in fronts.values())} rows)")

    bad = [r for r in recs if r.status == "deadlock"
           or (r.ok and (not r.equivalent or r.fifo_violations))]
    if bad:
        print(f"EQUIVALENCE FAILURE on {len(bad)} configurations, e.g.:\n"
              f"  {bad[0]}", file=sys.stderr)
        return 1
    n_rej = sum(r.status == "rejected" for r in recs)
    print(f"all {len(recs) - n_rej} simulated configurations match the "
          f"baseline interpreter bit-for-bit"
          + (f" ({n_rej} rejected at lowering)" if n_rej else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
