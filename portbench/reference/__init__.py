"""The plain references, one module a model family, found by the
configuration file's ``reference`` key."""
from __future__ import annotations

import importlib
from types import ModuleType
from typing import Any, Dict


def family(cfg: Dict[str, Any]) -> ModuleType:
    """The reference module of ``cfg``'s family."""
    return importlib.import_module(f"{__name__}.{cfg['reference']}")
