"""Metric arithmetic on a run's records: percentiles, latencies with
missing requests counted, and the window's rates.

A request that was refused, or that had not produced what a latency
needs by the end of the drain, is missing: its latency is counted as the
time from its start to the drain's end, a lower bound, so it lands in the
tail and the tail grows with the backlog."""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

from .serving import Rec, Run


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """Nearest-rank ``q``-th percentile (0 < q <= 100); None when empty."""
    if not values:
        return None
    xs = sorted(values)
    return xs[max(0, math.ceil(q / 100.0 * len(xs)) - 1)]


def due(run: Run) -> List[Rec]:
    """The requests due inside the window (all the open loop offered)."""
    return [r for r in run.recs if r.due_t < run.t_close]


def ttft_s(run: Run) -> List[float]:
    return [(r.first_t if r.first_t is not None else run.t_drained)
            - r.due_t for r in due(run)]


def tpot_ms(run: Run) -> List[float]:
    out = []
    for r in due(run):
        n = r.req.max_new
        if r.finish_t is not None:
            out.append(1e3 * (r.last_t - r.first_t) / max(n - 1, 1))
        else:
            start = r.first_t if r.first_t is not None else r.due_t
            out.append(1e3 * (run.t_drained - start) / max(n - 1, 1))
    return out


def output_tokens_per_s(run: Run) -> float:
    return sum(s.new_tokens for s in run.window_steps()) / run.window_s
