"""Finds each metric's reader by its name: ``portbench/metrics/<name>.py``,
or, for a name with a suffix (``step_ms.chat``), the reader of its stem
(``portbench/metrics/step_ms.py``) where the whole name has none.  A
reader is a module with ``read(run) -> float | None``; None leaves the
metric out of the result's line."""
from __future__ import annotations

import importlib.util
from pathlib import Path
from types import ModuleType
from typing import Dict, Optional

from .env import PORTBENCH

_CACHE: Dict[Path, ModuleType] = {}


def reader_path(name: str) -> Path:
    whole = PORTBENCH / "metrics" / f"{name}.py"
    if whole.exists():
        return whole
    return PORTBENCH / "metrics" / f"{name.split('.', 1)[0]}.py"


def reader(name: str) -> ModuleType:
    path = reader_path(name)
    mod = _CACHE.get(path)
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            f"portbench.metrics.{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _CACHE[path] = mod
    return mod


def read(name: str, run) -> Optional[float]:
    value = reader(name).read(run)
    return None if value is None else float(value)
