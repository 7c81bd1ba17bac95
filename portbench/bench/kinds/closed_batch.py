"""A closed offline batch: a pool of ``pool`` requests, all due at once;
the harness keeps ``queue_depth`` of them pending, so a slot refills the
step after it drains, and takes the pool again from the top once it is
spent.  Only a refused request failed: one unfinished at the close is
the batch's next work, not a failure."""
from __future__ import annotations

import itertools
from typing import List, Tuple

import numpy as np

from ..serving import Driver, Rec, clock


def due(mix, seconds: float, rng: np.random.Generator) -> np.ndarray:
    return np.zeros(int(mix["pool"]))


def drive(drv: Driver, recs: List[Rec], seconds: float, mix,
          tracer=None) -> Tuple[float, float, float]:
    depth = int(mix["queue_depth"])
    t_open = clock()
    t_end = t_open + seconds
    src = itertools.cycle(recs)
    used = []
    while True:
        now = clock()
        if now >= t_end:
            break
        if tracer is not None:
            tracer.poll(drv, now)
        while drv.pending() < depth:
            rec = next(src)
            if rec.submit_t is not None:       # the pool wrapped: a copy
                rec = Rec(rec.req)
            rec.due_t = now
            drv.submit(rec, now)
            used.append(rec)
        drv.step(True)
    t_close = clock()
    if tracer is not None:
        tracer.stop(drv)
    drv.recs[:] = used
    return t_open, t_close, t_close


def failed(due_recs: List[Rec]) -> int:
    return sum(r.refused for r in due_recs)
