"""The port's counterparts of the JAX package's device-touching
``benchmarks/`` sections, run as modules
(``python -m repro_torch.benchmarks.<name>``, or all of them through
``python -m repro_torch.benchmarks.run``).  They write only
``artifacts/BENCH_port_*.json``, never a file the reference's
``bench_diff`` checks."""
import os
import subprocess

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
ART_DIR = os.path.join(ROOT, "artifacts")


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
