"""Front-guided adaptive search over DSE grids (successive halving).

The exhaustive sweep (``core.sweep.run_sweep``) is the ground truth, but at
million-point scale even the batch engine spends most of its time on points
that are nowhere near the Pareto front.  :func:`adaptive_sweep` runs the
grid through a *fidelity ladder*: every point is first simulated at a
reduced sample count (``n_samples // divisor``), the running per-kernel
Pareto fronts are extracted from those coarse records, and only points
within a **dominance tolerance** of their kernel's front advance to the
next rung — the final rung re-simulates the survivors at full fidelity, so
every returned record is exact.  Low-fidelity IPC/energy are biased
estimates of their full-fidelity values; the tolerance is the slack that
absorbs that bias, and the exhaustive sweep stays available as a
differential oracle (``benchmarks/sweep_scale.py`` gates the recovered
front against it on a slice of the grid).

Pruning is *sound-by-construction* for everything the coarse rung cannot
rank: points that come back ``rejected`` or ``deadlock`` at reduced
fidelity advance automatically (a small ``n_samples`` can break lowering
preconditions that hold at full size), so adaptive search only ever drops
points it has positively measured as eps-dominated.

:func:`run_search` is the strategy dispatcher used by ``calibrate`` and
``repro_torch.examples.explore``; it returns ``(records, meta)`` where ``meta``
records the strategy and fidelity provenance that calibration artifacts
embed.
"""
from __future__ import annotations

import dataclasses
import operator
from typing import Dict, List, Optional, Sequence, Tuple

from .metrics import group_by
from .pareto import pareto_front
from .sweep import STRATEGIES, SweepPoint, SweepRecord, run_sweep

#: default relative dominance slack for pruning (10% on both axes)
DEFAULT_TOLERANCE = 0.10
#: default fidelity ladder: ``n_samples`` divisors per rung, last must be 1
DEFAULT_LADDER: Tuple[int, ...] = (8, 1)


def eps_dominated(rec: SweepRecord, front: Sequence[SweepRecord],
                  tolerance: float, maximize: str = "ipc",
                  minimize: str = "energy") -> bool:
    """True if some front member still dominates ``rec`` after its own
    advantage is shrunk by ``tolerance`` on both (relative) axes.

    With ``tolerance=0`` this is plain Pareto dominance; larger tolerances
    keep a band of near-front points alive (front members themselves are
    never eps-dominated, since shrinking makes the comparison strict)."""
    g, c = getattr(rec, maximize), getattr(rec, minimize)
    for f in front:
        fg = getattr(f, maximize) * (1.0 - tolerance)
        fc = getattr(f, minimize) * (1.0 + tolerance)
        if fg >= g and fc <= c and (fg > g or fc < c):
            return True
    return False


def front_matches(candidate: Sequence[SweepRecord],
                  reference: Sequence[SweepRecord],
                  tolerance: float = DEFAULT_TOLERANCE,
                  maximize: str = "ipc",
                  minimize: str = "energy") -> Tuple[bool, float]:
    """Does ``candidate`` cover ``reference`` within ``tolerance``?

    For every reference-front member there must be a candidate member whose
    gain is within ``tolerance`` (relative) below it and whose cost is
    within ``tolerance`` above it.  Returns ``(ok, worst_slack)`` where
    ``worst_slack`` is the largest relative shortfall over the reference
    members (0.0 = exact cover; ``inf`` when ``candidate`` is empty but
    ``reference`` is not).  Fronts are per-kernel objects — compare slices
    of the same kernel (e.g. via ``pareto.pareto_by_kernel``)."""
    worst = 0.0
    for r in reference:
        rg, rc = getattr(r, maximize), getattr(r, minimize)
        best: Optional[float] = None
        for cand in candidate:
            cg, cc = getattr(cand, maximize), getattr(cand, minimize)
            sg = 0.0 if cg >= rg else ((rg - cg) / rg if rg else float("inf"))
            sc = 0.0 if cc <= rc else ((cc - rc) / rc if rc else float("inf"))
            s = max(sg, sc)
            best = s if best is None else min(best, s)
        worst = max(worst, best if best is not None else float("inf"))
    return worst <= tolerance, worst


def scale_fidelity(pt: SweepPoint, divisor: int) -> SweepPoint:
    """``pt`` at reduced fidelity: ``n_samples`` divided by ``divisor`` and
    rounded up to a lowering-feasible multiple (unroll x cores), so coarse
    rungs reject only what full fidelity would also reject."""
    if divisor <= 1:
        return pt
    step = max(pt.unroll, pt.unroll_int or 1) * max(1, pt.n_cores)
    n = max(1, pt.n_samples // divisor)
    n = -(-n // step) * step                    # ceil to a feasible multiple
    if n >= pt.n_samples:
        return pt
    return dataclasses.replace(pt, n_samples=n)


def _validate_ladder(ladder: Sequence[int]) -> Tuple[int, ...]:
    lad = tuple(int(d) for d in ladder)
    if (not lad or lad[-1] != 1 or any(d < 1 for d in lad)
            or any(a <= b for a, b in zip(lad, lad[1:]))):
        raise ValueError(
            f"fidelity_ladder must be strictly decreasing divisors ending "
            f"at 1 (full fidelity), got {tuple(ladder)}")
    return lad


def adaptive_sweep(points: Sequence[SweepPoint], *,
                   tolerance: float = DEFAULT_TOLERANCE,
                   fidelity_ladder: Sequence[int] = DEFAULT_LADDER,
                   workers: Optional[int] = None,
                   maximize: str = "ipc",
                   minimize: str = "energy"
                   ) -> Tuple[List[SweepRecord], Dict]:
    """Front-guided successive halving over ``points``.

    Returns ``(records, meta)``: full-fidelity records for the points that
    survived every pruning rung (in input order — a subsequence of what the
    exhaustive sweep would return), and a provenance dict (strategy,
    tolerance, ladder, per-rung evaluated/survivor counts) for calibration
    artifacts.  The per-kernel Pareto fronts over ``records`` match the
    exhaustive fronts whenever the coarse-fidelity bias stays within
    ``tolerance`` (gated against the exhaustive oracle in
    ``benchmarks/sweep_scale.py``)."""
    if not 0.0 <= tolerance < 1.0:
        raise ValueError(f"tolerance must be in [0, 1), got {tolerance}")
    ladder = _validate_ladder(fidelity_ladder)
    points = list(points)
    survivors = list(range(len(points)))
    rungs: List[Dict] = []
    records: List[SweepRecord] = []
    for divisor in ladder:
        scaled = [scale_fidelity(points[i], divisor) for i in survivors]
        recs = run_sweep(scaled, workers=workers)
        if divisor == 1:
            records = recs
            rungs.append({"divisor": 1, "evaluated": len(survivors),
                          "survivors": len(survivors)})
            break
        fronts = {k: pareto_front(rs, maximize, minimize)
                  for k, rs in group_by(
                      (r for r in recs if r.ok),
                      operator.attrgetter("kernel")).items()}
        keep = [i for i, rec in zip(survivors, recs)
                if not rec.ok               # unrankable at this fidelity
                or not eps_dominated(rec, fronts[rec.kernel], tolerance,
                                     maximize, minimize)]
        rungs.append({"divisor": divisor, "evaluated": len(survivors),
                      "survivors": len(keep)})
        survivors = keep
    meta = {
        "strategy": "adaptive",
        "tolerance": tolerance,
        "fidelity_ladder": list(ladder),
        "maximize": maximize,
        "minimize": minimize,
        "n_points": len(points),
        "n_full_fidelity": len(survivors),
        "rungs": rungs,
    }
    return records, meta


def run_search(points: Sequence[SweepPoint], *,
               strategy: str = "exhaustive",
               workers: Optional[int] = None,
               **search_kw) -> Tuple[List[SweepRecord], Dict]:
    """Strategy dispatcher: evaluate ``points`` and return
    ``(records, meta)``.  ``"exhaustive"`` runs every point (the
    differential oracle); ``"adaptive"`` prunes via
    :func:`adaptive_sweep` (keyword arguments ``tolerance`` /
    ``fidelity_ladder`` / ``maximize`` / ``minimize`` pass through)."""
    if strategy not in STRATEGIES:
        raise ValueError(
            f"unknown strategy {strategy!r} (have {STRATEGIES})")
    if strategy == "adaptive":
        return adaptive_sweep(points, workers=workers, **search_kw)
    if search_kw:
        raise TypeError(
            f"unexpected arguments for exhaustive search: "
            f"{sorted(search_kw)}")
    records = run_sweep(points, workers=workers)
    return records, {"strategy": "exhaustive", "n_points": len(records)}
