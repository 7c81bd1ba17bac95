"""Traffic kinds, one module a kind, found by a mix file's ``kind``.

A kind module states how the requests of a run fall due and how the
window drives the engine with them:

* ``due(mix, seconds, rng) -> np.ndarray``: each request's due time, in
  seconds after the window opens (their number is the run's request
  count);
* ``drive(drv, recs, seconds, mix, tracer) -> (t_open, t_close,
  t_drained)``: the window, on the host's clock;
* ``failed(due) -> int``: how many of the requests due in the window
  failed.

A new arrival pattern of an existing kind is a new mix file; a new kind
is a new module here."""
from __future__ import annotations

import importlib
from types import ModuleType


def load(kind: str) -> ModuleType:
    try:
        return importlib.import_module(f"{__name__}.{kind}")
    except ModuleNotFoundError as e:
        raise ValueError(f"unknown traffic kind {kind!r}") from e
