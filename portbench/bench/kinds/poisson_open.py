"""Open loop: requests fall due in bursts of ``burst`` (1 by default) whose
starts are a Poisson process at ``rate_per_s / burst``, and are offered
at their due times whatever the engine's state, for the window; the
requests due in it then drain for up to ``drain_s``.

``n = floor(rate_per_s * seconds)`` requests, the first burst due as the
window opens and the gaps after it at the exponential's mid-quantiles,
summing to ``(bursts - 1) * burst / rate_per_s``, so all are due inside
the window.  A request that never finishes within the drain failed."""
from __future__ import annotations

import math
import time
from typing import List, Tuple

import numpy as np
import torch

from ..serving import Driver, Rec, clock
from ..traffic import poisson_gaps


def due(mix, seconds: float, rng: np.random.Generator) -> np.ndarray:
    rate, burst = float(mix["rate_per_s"]), int(mix.get("burst", 1))
    n = max(1, int(math.floor(rate * seconds)))
    bursts = -(-n // burst)
    starts = np.concatenate([[0.0], np.cumsum(poisson_gaps(
        bursts - 1, rate / burst, rng))])
    return np.repeat(starts, burst)[:n]


def drive(drv: Driver, recs: List[Rec], seconds: float, mix,
          tracer=None) -> Tuple[float, float, float]:
    t_open = clock()
    for r in recs:
        r.due_t = t_open + r.req.due
    i, n = 0, len(recs)
    t_end = t_open + seconds
    while True:
        now = clock()
        if now >= t_end:
            break
        if tracer is not None:
            tracer.poll(drv, now)
        while i < n and recs[i].due_t <= now:
            drv.submit(recs[i], now)
            i += 1
        if drv.busy():
            drv.step(True)
        else:
            wake = min(recs[i].due_t if i < n else t_end, t_end)
            with torch.profiler.record_function("portbench.wait"):
                time.sleep(max(0.0, wake - clock()))
    t_close = clock()
    if tracer is not None:
        tracer.stop(drv)
    deadline = t_close + float(mix.get("drain_s", 60))
    while drv.busy() and clock() < deadline:
        drv.step(False)
    return t_open, t_close, clock()


def failed(due_recs: List[Rec]) -> int:
    return sum(r.finish_t is None for r in due_recs)
