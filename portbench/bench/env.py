"""Where the harness runs: the checkout's root, the environment it pins
before the program is imported, the process's start time, and the guard
against the JAX package.

Every cache the program or its libraries may write is pinned to a fixed
directory inside the checkout (``build/``, which git ignores), so that
only the first run of a cell in a checkout builds or compiles anything.
The policy table is pinned to the paper's default operating point by
pointing the calibration directory at a path that never exists.
"""
from __future__ import annotations

import os
import sys
import time
from pathlib import Path
from typing import List

ROOT = Path(__file__).resolve().parents[2]
PORTBENCH = ROOT / "portbench"
CACHE = ROOT / "build" / "portbench"

#: top-level module names that must not be loaded in a measured process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def pin_environment() -> None:
    """Fix every cache directory inside the checkout and keep libraries
    from loading JAX.  Called before ``torch`` or the program is imported.
    ``BENCH_RUN`` is never read."""
    os.environ["REPRO_CALIBRATION_DIR"] = str(CACHE / "no-calibration")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(CACHE / "inductor")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def process_start() -> float:
    """``time.time()`` at which this process was created, from
    ``/proc/self/stat`` (10 ms resolution); the import time of this module
    where ``/proc`` cannot be read."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / ticks          # field 22: starttime
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - started)
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.time()


def forbidden_loaded() -> List[str]:
    """The loaded modules whose top-level name, compared whole, is the JAX
    package's or one of JAX's (``repro_torch`` is not ``repro``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))
