"""Paper Fig. 3 reproduction through the port's machine model, the
counterpart of the JAX package's ``benchmarks/fig3.py``: (a) IPC per
kernel per policy, (b) power, (c) speedup + energy-efficiency of COPIFTv2
over COPIFT.  Returns rows only.

  PYTHONPATH=src python -m repro_torch.benchmarks.fig3
"""
import time

from ..core import (PAPER_CLAIMS, MachineConfig, TransformConfig, run_suite,
                    summarize)
from ..core.policy import ExecutionPolicy as P


def run(n_samples: int = 512):
    t0 = time.time()
    suite = run_suite(n_samples, TransformConfig(n_samples=n_samples),
                      MachineConfig())
    elapsed = (time.time() - t0) * 1e6 / (len(suite) * 3)
    rows = []
    # --- fig 3a: IPC ---
    for name, c in suite.items():
        rows.append((f"fig3a_ipc_{name}_baseline", elapsed, c.ipc(P.BASELINE)))
        rows.append((f"fig3a_ipc_{name}_copift", elapsed, c.ipc(P.COPIFT)))
        rows.append((f"fig3a_ipc_{name}_copiftv2", elapsed, c.ipc(P.COPIFTV2)))
    # --- fig 3b: power (relative units) ---
    for name, c in suite.items():
        rows.append((f"fig3b_power_{name}_v2_over_copift", elapsed,
                     c.results[P.COPIFTV2].power / c.results[P.COPIFT].power))
    # --- fig 3c: speedup + energy gain over COPIFT ---
    for name, c in suite.items():
        rows.append((f"fig3c_speedup_{name}", elapsed,
                     c.speedup(P.COPIFTV2, P.COPIFT)))
        rows.append((f"fig3c_energy_{name}", elapsed,
                     c.energy_gain(P.COPIFTV2, P.COPIFT)))
    # --- headline claims vs paper ---
    s = summarize(suite)
    for k, v in s.items():
        rows.append((f"claims_{k}", elapsed, v))
        rows.append((f"claims_{k}_paper", 0.0, PAPER_CLAIMS[k]))
    return rows


def main():
    for name, us, derived in run():
        print(f"{name},{us:.1f},{derived:.4f}")


def smoke():
    """CI-grade: small sample count, the headline held in band."""
    rows = run(n_samples=64)
    peak = next(v for n, _, v in rows if n == "claims_peak_ipc_v2")
    if not 1.4 <= peak <= 2.0:
        raise AssertionError(f"peak IPC out of band at n=64: {peak}")
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived:.4f}")


if __name__ == "__main__":
    main()
