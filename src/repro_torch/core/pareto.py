"""Pareto-front extraction and CSV emission for DSE sweep records.

The sweep trades two objectives per kernel: IPC (maximize) against energy
(minimize).  A configuration is *dominated* when another configuration is at
least as good on both axes and strictly better on one; the Pareto front is
the set of non-dominated configurations — the only hardware points worth
building.  The helpers are attribute-generic so other trade-offs (e.g.
throughput vs power) reuse the same machinery.
"""
from __future__ import annotations

import csv
import operator
from typing import Dict, Iterable, List, Sequence, TextIO, Union

from .metrics import group_by
from .sweep import (CSV_FIELDS, LEGACY_CSV_FIELDS, PRE_PIPELINE_CSV_FIELDS,
                    SweepRecord, record_to_row)


def dominates(a: SweepRecord, b: SweepRecord,
              maximize: str = "ipc", minimize: str = "energy") -> bool:
    """True if ``a`` is at least as good as ``b`` on both axes and strictly
    better on at least one."""
    ga, gb = getattr(a, maximize), getattr(b, maximize)
    ca, cb = getattr(a, minimize), getattr(b, minimize)
    return ga >= gb and ca <= cb and (ga > gb or ca < cb)


def pareto_front(records: Iterable[SweepRecord],
                 maximize: str = "ipc",
                 minimize: str = "energy") -> List[SweepRecord]:
    """Non-dominated subset of ``records``, sorted by the minimized axis.

    Only ``status == "ok"`` records participate; rejected/deadlocked points
    cannot be on a hardware trade-off curve.
    """
    ok = [r for r in records if r.ok]
    # sort: ascending cost, descending gain — then one monotone pass suffices
    ok.sort(key=lambda r: (getattr(r, minimize), -getattr(r, maximize)))
    front: List[SweepRecord] = []
    best_gain = best_gain_cost = None
    for r in ok:
        g, c = getattr(r, maximize), getattr(r, minimize)
        if best_gain is None or g > best_gain:
            front.append(r)
            best_gain, best_gain_cost = g, c
        elif g == best_gain and c == best_gain_cost:
            front.append(r)          # exact tie on both axes: also non-dominated
    return front


def pareto_by_kernel(records: Iterable[SweepRecord],
                     maximize: str = "ipc",
                     minimize: str = "energy") -> Dict[str, List[SweepRecord]]:
    """Per-kernel Pareto fronts (kernels are not comparable to each other)."""
    return {k: pareto_front(rs, maximize, minimize)
            for k, rs in sorted(group_by(records, operator.attrgetter("kernel")).items())}


def write_csv(records: Sequence[SweepRecord],
              dest: Union[str, TextIO]) -> int:
    """Write sweep records as CSV (``CSV_FIELDS`` order); returns row count."""
    def _emit(fh: TextIO) -> int:
        w = csv.DictWriter(fh, fieldnames=list(CSV_FIELDS))
        w.writeheader()
        for r in records:
            w.writerow(record_to_row(r))
        return len(records)

    if isinstance(dest, str):
        with open(dest, "w", newline="") as fh:
            return _emit(fh)
    return _emit(dest)


def _parse_stalls(packed: str) -> Dict[str, int]:
    if not packed:
        return {}
    out: Dict[str, int] = {}
    for item in packed.split(";"):
        k, _, v = item.partition("=")
        out[k] = int(v)
    return out


#: per-column parsers for :func:`read_csv`; ``None``-able ints map "" back
_OPT_INT = ("unroll_int", "queue_depth_i2f", "queue_depth_f2i", "tcdm_banks")
_INT = ("queue_depth", "queue_latency", "unroll", "n_samples", "cycles",
        "instrs_int", "instrs_fp", "max_occ_i2f", "max_occ_f2i",
        "fifo_violations", "n_cores", "bank_stalls", "cq_depth",
        "dma_buffers", "cq_stalls", "dma_stalls")
_FLOAT = ("ipc", "energy", "power", "throughput", "efficiency",
          "ipc_per_core")


def row_to_record(row: Dict[str, str]) -> SweepRecord:
    """Inverse of ``sweep.record_to_row`` — exact for every field (floats
    survive because ``str(float)`` is repr-round-trippable).

    Rows from older CSVs parse too: rows without cluster columns
    default to the single-PE machine (``n_cores=1``, conflict-free TCDM,
    per-core IPC == aggregate IPC), and rows without pipeline columns
    default to the work-partitioned cluster (``pipeline=False`` with the
    default channel/DMA geometry)."""
    kw: Dict[str, object] = dict(row)
    kw.setdefault("n_cores", "1")
    kw.setdefault("tcdm_banks", "")
    kw.setdefault("bank_stalls", "0")
    kw.setdefault("ipc_per_core", row.get("ipc", "0.0"))
    kw.setdefault("pipeline", "0")
    kw.setdefault("cq_depth", "4")
    kw.setdefault("dma_buffers", "2")
    kw.setdefault("cq_stalls", "0")
    kw.setdefault("dma_stalls", "0")
    for f in _INT:
        kw[f] = int(kw[f])
    for f in _OPT_INT:
        kw[f] = int(kw[f]) if kw[f] != "" else None
    for f in _FLOAT:
        kw[f] = float(kw[f])
    kw["equivalent"] = bool(int(row["equivalent"]))
    kw["pipeline"] = bool(int(kw["pipeline"]))
    kw["stalls"] = _parse_stalls(row["stalls"])
    return SweepRecord(**kw)     # type: ignore[arg-type]


def read_csv(src: Union[str, TextIO]) -> List[SweepRecord]:
    """Re-parse a :func:`write_csv` emission back into sweep records; the
    round trip is lossless (tested in ``tests/test_calibration.py``).
    Accepts the current header plus the two prior generations: the one
    without the pipeline columns and the older one without the
    cluster columns (older records come back with defaulted new fields)."""
    def _load(fh: TextIO) -> List[SweepRecord]:
        reader = csv.DictReader(fh)
        header = tuple(reader.fieldnames or ())
        if header not in (CSV_FIELDS, PRE_PIPELINE_CSV_FIELDS,
                          LEGACY_CSV_FIELDS):
            raise ValueError(
                f"CSV header {reader.fieldnames} != expected {CSV_FIELDS} "
                f"(or the pre-pipeline / pre-cluster legacy layouts)")
        return [row_to_record(row) for row in reader]

    if isinstance(src, str):
        with open(src, newline="") as fh:
            return _load(fh)
    return _load(src)


def format_front(front: Sequence[SweepRecord]) -> str:
    """Human-readable table for one kernel's Pareto front."""
    hdr = (f"{'policy':<10} {'depth':>5} {'lat':>3} {'unroll':>6} "
           f"{'cores':>5} {'banks':>5} "
           f"{'ipc':>6} {'energy':>10} {'cycles':>7} {'eff':>9}")
    lines = [hdr, "-" * len(hdr)]
    for r in front:
        banks = "-" if r.tcdm_banks is None else r.tcdm_banks
        lines.append(f"{r.policy:<10} {r.queue_depth:>5} {r.queue_latency:>3} "
                     f"{r.unroll:>6} {r.n_cores:>5} {banks:>5} "
                     f"{r.ipc:>6.3f} {r.energy:>10.1f} "
                     f"{r.cycles:>7} {r.efficiency:>9.2e}")
    return "\n".join(lines)
