"""The port's benchmark entry point, the counterpart of the reference's
``benchmarks/run.py``: its sections in its order and with its titles,
except that the full prefill cell's title drops the ">=2x" wall-clock gate
the port records but does not enforce, and the last three (kernels,
collective policy, roofline) are the port's own and also run under
``--smoke``, after the reference's eleven.  The machine-model and
scheduler sections run on the host; the prefill cell, the kernels and the
collective policy on the card unless ``--device cpu`` is given.  Prints
``name,us_per_call,derived`` CSV.

  PYTHONPATH=src python -m repro_torch.benchmarks.run --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.benchmarks.run

``--smoke`` runs each section's small variant.  Failures are never
swallowed: every section still runs, a per-section ``PASS``/``FAIL``
summary prints at the end, and any failure exits non-zero.
"""
from __future__ import annotations

import argparse
import functools
import sys
import traceback
from typing import Callable, List, Optional, Tuple

from ..device import resolve_device


def run_sections(sections: List[Tuple[str, Callable[[], object]]]) -> None:
    """Run every (title, callable) section, print a per-section pass/fail
    summary, and exit non-zero if anything raised."""
    failures = []
    statuses = []
    for title, fn in sections:
        print(f"# --- {title} ---")
        try:
            fn()
            statuses.append((title, "PASS", ""))
        except Exception as e:
            traceback.print_exc()
            failures.append(title)
            statuses.append((title, "FAIL", f" ({type(e).__name__}: {e})"))
    print("# --- summary ---")
    for title, verdict, detail in statuses:
        print(f"# {verdict}: {title}{detail}")
    if failures:
        sys.exit(f"benchmark sections failed: {failures}")


def host_smoke_sections() -> List[Tuple[str, Callable[[], object]]]:
    """The reference's ten host sections under ``--smoke``, in its order
    and with its titles: the machine model and the simulated scheduler,
    no device."""
    from . import (calibration, cluster_pipeline, cluster_scaling,
                   cluster_sweep_scale, dse, fig3, front_diff, serve_slo,
                   sweep_perf, sweep_scale)
    return [
        ("fig3 smoke (machine model, small n)", fig3.smoke),
        ("dse smoke (tiny sweep grid + equivalence fuzz)", dse.smoke),
        ("sweep_perf smoke (event vs cycle engine throughput)",
         sweep_perf.smoke),
        ("sweep_scale smoke (batch engine parity + adaptive front "
         "cover)", sweep_scale.smoke),
        ("cluster_sweep_scale smoke (batch cluster engine parity on "
         "cluster/pipeline grids)", cluster_sweep_scale.smoke),
        ("calibration smoke (Pareto-selected vs hard-coded default)",
         calibration.smoke),
        ("cluster scaling smoke (weak/strong 1-4 cores + bank "
         "contention)", cluster_scaling.smoke),
        ("cluster pipeline smoke (producer/consumer pairs vs work "
         "partition on a bank-starved TCDM)", cluster_pipeline.smoke),
        ("front diff (committed Pareto-front drift gate)",
         front_diff.smoke),
        ("serve SLO smoke (continuous vs wave batching under "
         "trace-driven load)", serve_slo.smoke),
    ]


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="small variants, per-section pass/fail, non-zero "
                         "exit on any failure")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from . import (calibration, cluster_pipeline, cluster_scaling,
                   cluster_sweep_scale, collective_policy, dse, fig3,
                   front_diff, kernel_bench, roofline_table, serve_slo,
                   sweep_perf, sweep_scale)
    on = functools.partial
    device_sections = [
        ("kernels (micro-bench at the reference's shapes)",
         on(kernel_bench.main, ["--device", str(dev)])),
        ("collective policy (bulk vs ring)",
         on(collective_policy.main, ["--device", str(dev)])),
        ("roofline (from dry-run artifacts)", roofline_table.main),
    ]
    if args.smoke:
        run_sections(host_smoke_sections() + [
            ("serve prefill smoke (live chunked prefill vs token-by-token "
             "TTFT, bit-exact)", on(serve_slo.prefill_smoke, dev)),
        ] + device_sections)
        return
    run_sections([
        ("fig3 (paper Fig.3a/b/c via the machine model)", fig3.main),
        ("dse (design-space sweep + Pareto fronts)", dse.main),
        ("sweep_perf (DSE points/sec, event vs cycle engine)",
         sweep_perf.main),
        ("sweep_scale (batch engine >=10x gate + adaptive front cover)",
         sweep_scale.main),
        ("cluster_sweep_scale (batch cluster engine >=8x gate on "
         "cluster/pipeline grids)", cluster_sweep_scale.main),
        ("calibration (Pareto-selected operating points vs defaults)",
         calibration.main),
        ("cluster scaling (weak/strong 1-8 cores + bank contention)",
         cluster_scaling.main),
        ("cluster pipeline (producer/consumer pairs vs work partition)",
         cluster_pipeline.main),
        ("front diff (committed Pareto-front drift gate)", front_diff.main),
        ("serve SLO (continuous vs wave batching under trace-driven load)",
         serve_slo.main),
        ("serve prefill (live chunked prefill vs token-by-token TTFT, "
         "bit-exact)", on(serve_slo.prefill_main, dev)),
    ] + device_sections)


if __name__ == "__main__":
    main()
