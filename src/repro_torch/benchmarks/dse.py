"""Design-space exploration section, the port's counterpart of the JAX
package's ``benchmarks/dse.py``: sweep the port's machine-model grid and
report per-policy geomean IPC/efficiency, the peak-IPC point, per-kernel
Pareto-front sizes, and the equivalence-fuzzer verdict.  Emits
``name,us_per_call,derived`` CSV rows like the other sections; returns rows
only.

  PYTHONPATH=src python -m repro_torch.benchmarks.dse
"""
import time

from ..core import grid, pareto_by_kernel, run_sweep, sweep_summary


def run(queue_depths=(1, 2, 4, 8), queue_latencies=(1, 2), unrolls=(4, 8),
        n_samples=32, kernels=None, workers=None):
    pts = grid(kernels=kernels, queue_depths=queue_depths,
               queue_latencies=queue_latencies, unrolls=unrolls,
               n_samples=n_samples)
    t0 = time.time()
    recs = run_sweep(pts, workers=workers)
    us = (time.time() - t0) * 1e6 / max(len(recs), 1)
    s = sweep_summary(recs)
    rows = [(f"dse_{k}", us, v) for k, v in sorted(s.items())]
    for kernel, front in pareto_by_kernel(recs).items():
        rows.append((f"dse_pareto_size_{kernel}", us, float(len(front))))
    bad = [r for r in recs if r.status == "deadlock"
           or (r.ok and (not r.equivalent or r.fifo_violations))]
    if bad:
        raise AssertionError(
            f"{len(bad)} swept configurations deadlocked or diverged from "
            f"the baseline interpreter, e.g. {bad[0]}")
    return rows


def main():
    for name, us, derived in run():
        print(f"{name},{us:.1f},{derived:.4f}")


def smoke():
    """Tiny CI grid: 2 kernels x 3 policies x 2 depths, serial."""
    rows = run(queue_depths=(2, 4), queue_latencies=(1,), unrolls=(4,),
               n_samples=16, kernels=["expf", "dequant_dot"], workers=1)
    if not rows:
        raise AssertionError("dse smoke produced no rows")
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived:.4f}")


if __name__ == "__main__":
    main()
