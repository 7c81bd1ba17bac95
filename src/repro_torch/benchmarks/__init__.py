"""The port's counterparts of every section of the JAX package's
``benchmarks/``, run as modules (``python -m repro_torch.benchmarks.<name>``,
or all of them through ``python -m repro_torch.benchmarks.run``).

The machine-model and scheduler sections (fig3, dse, the sweeps,
calibration, cluster scaling and pipeline, the simulated serve SLO, the
drift gates) run on the host through the port's copies of ``repro.core``
and the scheduler; the live prefill cell, the kernels and the collective
policy run on the card unless ``--device cpu`` is given.

They write only ``artifacts/BENCH_port_*.json`` (and the calibration
smoke's ``artifacts/calibration_port_smoke/``), never a file the
reference's benchmark or its tests read: the reference's committed
``artifacts/BENCH_*.json`` and ``benchmarks/data/front_baseline.json``
are read only, by the drift gates.  ``REPRO_PORT_ART_DIR`` moves the
port's artifacts elsewhere (``chip_smoke.py`` puts them under ``build/``).
"""
import os
import subprocess

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
#: where the port writes its artifacts
ART_DIR = (os.environ.get("REPRO_PORT_ART_DIR", "").strip()
           or os.path.join(ROOT, "artifacts"))
#: the reference's committed artifacts, read only
REF_ART_DIR = os.path.join(ROOT, "artifacts")


def device_label(dev: torch.device) -> str:
    """What a measurement ran on: the card's name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them, or ``cpu``."""
    if dev.type != "cuda":
        return dev.type
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[dev.index or 0]
