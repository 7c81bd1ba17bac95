"""The port's benchmark entry point: the device-touching sections of the
reference's ``benchmarks/run.py`` — the live chunked-prefill cell, the
kernel micro-benchmarks, bulk against ring ``tp_matmul`` and the roofline
table — on the card unless ``--device cpu`` is given.  Prints
``name,us_per_call,derived`` CSV.

  PYTHONPATH=src python -m repro_torch.benchmarks.run --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.benchmarks.run

``--smoke`` runs the CPU-grade variants (the smaller prefill cell).
Failures are never swallowed: every section still runs, a per-section
``PASS``/``FAIL`` summary prints at the end, and any failure exits
non-zero.
"""
from __future__ import annotations

import argparse
import functools
import sys
import traceback
from typing import Callable, List, Optional, Tuple

from ..device import resolve_device


def _run_sections(sections: List[Tuple[str, Callable[[], object]]]) -> None:
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


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="CPU-grade variants, per-section pass/fail, "
                         "non-zero exit on any failure")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from . import collective_policy, kernel_bench, roofline_table, serve_slo
    on = functools.partial
    sections = [
        ("serve prefill smoke (live chunked prefill vs token-by-token "
         "TTFT, bit-exact)" if args.smoke else
         "serve prefill (live chunked prefill vs token-by-token TTFT, "
         "bit-exact)",
         on(serve_slo.prefill_smoke if args.smoke else serve_slo.prefill_main,
            dev)),
        ("kernels (micro-bench at the reference's shapes)",
         on(kernel_bench.main, ["--device", str(dev)])),
        ("collective policy (bulk vs ring)",
         on(collective_policy.main, ["--device", str(dev)])),
        ("roofline (from dry-run artifacts)", roofline_table.main),
    ]
    _run_sections(sections)


if __name__ == "__main__":
    main()
