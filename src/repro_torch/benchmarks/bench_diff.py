"""Bench-drift gate, the port's counterpart of the JAX package's
``benchmarks/bench_diff.py``: recompute the reference's committed headline
metrics through the port and fail when the port does not reproduce them.

Two classes of check, matched to how reproducible each metric is:

* **exact compares** — metrics that are pure functions of the code
  (virtual-time simulation, pinned seeds, no wall clock), against the
  reference's committed artifacts (read only):

  - the port's ``serve_slo.run(FULL)`` report is regenerated end to end
    and deep-compared field for field with ``artifacts/BENCH_serve_slo.json``:
    cycles-equivalent totals, SLO attainment, straggler weights —
    everything.  Any difference means the port's scheduler or machine
    model does not reproduce the reference's.
  - ``artifacts/BENCH_cluster.json``'s strong-scaling points are recomputed
    through the port's ``run_point`` (cycles exactly, derived floats within
    :data:`REL_TOL`), including the headline 1->4-core speedup.

* **floor checks** — metrics that embed the wall clock (the sweep engines'
  points/sec ratios) cannot be reproduced exactly on another machine, so
  the port's own ``artifacts/BENCH_port_*.json`` are checked against the
  reference's static floors (:data:`FLOORS`).  An absent artifact fails
  the gate and names the command that writes it.  The port's live
  prefill cell (``BENCH_port_serve_prefill.json``) must be bit-exact,
  keep its chunk programs bounded, reach the cycles-domain TTFT gain
  (:data:`serve_slo.MIN_PREFILL_TTFT_GAIN`) and its wall-clock TTFT gain
  its own bar (``min_required``), as the reference floors its committed
  cell.  The reference's committed headline gains are floored against
  their embedded bars, as the reference does.

A per-metric delta table prints to stdout.  Any failed row exits
non-zero.  The golden files are the reference's and the port's job is to
equal them, so there is no ``--update``.

  PYTHONPATH=src python -m repro_torch.benchmarks.bench_diff
"""
import json
import os
import tempfile
import time

from ..core import SweepPoint, run_point
from . import ART_DIR, REF_ART_DIR, serve_slo

#: relative tolerance for recomputed floats: generous only against float
#: repr round-tripping — any real model change is far bigger
REL_TOL = 1e-9

#: static floors for the port's wall-clock-dependent metrics, the
#: reference's: (artifact, key path, floor, what the metric is)
FLOORS = (
    ("BENCH_port_sweep.json", ("speedup_event_cached",), 2.0,
     "event engine cached-sweep speedup over uncached cycle engine"),
    ("BENCH_port_sweep_scale.json", ("throughput", "speedup_cached"), 10.0,
     "batch engine cached 2880-pt sweep speedup"),
    ("BENCH_port_cluster_sweep_scale.json", ("throughput", "speedup_cached"),
     8.0, "batch cluster engine cached 1128-pt sweep speedup"),
)
#: the command that writes each of the port's artifacts this gate reads
WRITTEN_BY = {
    "BENCH_port_sweep.json":
        "PYTHONPATH=src python -m repro_torch.benchmarks.sweep_perf",
    "BENCH_port_sweep_scale.json":
        "PYTHONPATH=src python -m repro_torch.benchmarks.sweep_scale",
    "BENCH_port_cluster_sweep_scale.json":
        "PYTHONPATH=src python -m repro_torch.benchmarks.cluster_sweep_scale",
    "BENCH_port_serve_prefill.json":
        "PYTHONPATH=src python -m repro_torch.benchmarks.serve_slo --prefill"
        " (add --device cpu on a host without a card)",
}
#: strong-scaling point fields compared exactly vs within :data:`REL_TOL`
_EXACT_FIELDS = ("n_cores", "tcdm_banks", "cycles", "bank_stalls")
_FLOAT_FIELDS = ("throughput", "speedup", "ipc", "ipc_per_core",
                 "energy_per_sample")


def _load_ref(name):
    """One of the reference's committed artifacts (read only)."""
    path = os.path.join(REF_ART_DIR, name)
    if not os.path.exists(path):
        raise AssertionError(
            f"the reference's committed artifacts/{name} is missing from "
            f"the checkout")
    with open(path) as f:
        return json.load(f)


def _load_port(path):
    """One of the port's artifacts; absent, the gate fails naming the
    command that writes it."""
    if not os.path.exists(path):
        name = os.path.basename(path)
        raise AssertionError(
            f"{path} is missing; write it with: "
            f"{WRITTEN_BY[name]}")
    with open(path) as f:
        return json.load(f)


def _close(a, b):
    if isinstance(a, float) or isinstance(b, float):
        ref = max(abs(a), abs(b), 1.0)
        return abs(a - b) / ref <= REL_TOL
    return a == b


def _deep_diff(base, cur, path, problems):
    """Structural + value diff; floats within REL_TOL, all else exact."""
    if isinstance(base, dict) and isinstance(cur, dict):
        for k in sorted(set(base) | set(cur)):
            if k not in cur:
                problems.append(f"{path}.{k}: vanished from recomputation")
            elif k not in base:
                problems.append(f"{path}.{k}: new field not in baseline")
            else:
                _deep_diff(base[k], cur[k], f"{path}.{k}", problems)
    elif isinstance(base, list) and isinstance(cur, list):
        if len(base) != len(cur):
            problems.append(
                f"{path}: length {len(base)} -> {len(cur)}")
        else:
            for i, (b, c) in enumerate(zip(base, cur)):
                _deep_diff(b, c, f"{path}[{i}]", problems)
    elif isinstance(base, (int, float)) and isinstance(cur, (int, float)) \
            and not isinstance(base, bool) and not isinstance(cur, bool):
        if not _close(base, cur):
            problems.append(f"{path}: {base!r} -> {cur!r}")
    elif base != cur:
        problems.append(f"{path}: {base!r} -> {cur!r}")


def _row(metric, baseline, current, check, ok, status=None):
    delta = (current - baseline
             if isinstance(baseline, (int, float))
             and isinstance(current, (int, float)) else None)
    return {"metric": metric, "baseline": baseline, "current": current,
            "delta": delta, "check": check,
            "status": status or ("ok" if ok else "FAIL")}


def check_serve_slo(rows, problems):
    """The port's full regeneration against the reference's committed
    report, field for field (floats within :data:`REL_TOL`)."""
    committed = _load_ref("BENCH_serve_slo.json")
    with tempfile.TemporaryDirectory() as td:
        tmp = os.path.join(td, "regen.json")
        serve_slo.run(cfg=serve_slo.FULL, out_path=tmp)
        with open(tmp) as f:
            regen = json.load(f)
    local = []
    _deep_diff(committed, regen, "serve_slo", local)
    problems.extend(local)
    for k in sorted(committed.get("headline", {})):
        b = committed["headline"][k]
        c = regen.get("headline", {}).get(k)
        rows.append(_row(f"serve_slo.headline.{k}", b, c,
                         f"exact (rtol {REL_TOL:g})", _close(b, c)))
    rows.append(_row("serve_slo.full_report_fields_drifted", 0,
                     len(local), "== 0", not local))


def check_cluster_strong(rows, problems):
    """Recompute every committed strong-scaling point through the port's
    ``run_point``."""
    committed = _load_ref("BENCH_cluster.json")
    strong = committed.get("strong_scaling", {})
    n_drift = 0
    for kernel in sorted(strong):
        n_samples = strong[kernel]["n_samples"]
        base_tp = None
        for i, pt in enumerate(strong[kernel]["points"]):
            rec = run_point(SweepPoint(
                kernel=kernel, policy="copiftv2", n_samples=n_samples,
                n_cores=pt["n_cores"], tcdm_banks=pt["tcdm_banks"]))
            if not rec.ok or not rec.equivalent:
                problems.append(
                    f"cluster.{kernel}.x{pt['n_cores']}: recompute failed "
                    f"({rec.status}: {rec.detail or 'diverged'})")
                continue
            if base_tp is None:
                base_tp = rec.throughput
            cur = {"n_cores": rec.n_cores, "tcdm_banks": rec.tcdm_banks,
                   "cycles": rec.cycles, "bank_stalls": rec.bank_stalls,
                   "throughput": rec.throughput,
                   "speedup": rec.throughput / base_tp,
                   "ipc": rec.ipc, "ipc_per_core": rec.ipc_per_core,
                   "energy_per_sample": rec.energy / rec.n_samples}
            for field in _EXACT_FIELDS + _FLOAT_FIELDS:
                exact = field in _EXACT_FIELDS
                same = (pt[field] == cur[field] if exact
                        else _close(pt[field], cur[field]))
                if not same:
                    n_drift += 1
                    problems.append(
                        f"cluster.{kernel}.x{pt['n_cores']}.{field}: "
                        f"{pt[field]!r} -> {cur[field]!r}")
            if i == 0 and pt["speedup"] != 1.0:
                problems.append(
                    f"cluster.{kernel}: first strong-scaling point is not "
                    f"the 1x baseline (speedup={pt['speedup']!r})")
    head = committed.get("headline", {})
    if head:
        kernel = head["kernel"]
        pts = {p["n_cores"]: p for p in strong[kernel]["points"]}
        c = round(pts[4]["speedup"], 4)
        rows.append(_row(f"cluster.headline.speedup_4c[{kernel}]",
                         head["speedup_4c"], c,
                         f"exact (rtol {REL_TOL:g})",
                         _close(head["speedup_4c"], c)))
    rows.append(_row("cluster.strong_scaling_fields_drifted", 0, n_drift,
                     "== 0", n_drift == 0))


def check_serve_prefill(rows, problems, path):
    """The port's live chunked-prefill cell.  The cycles-domain TTFT gain
    is floored at the reference's bar and the wall-clock gain at the cell's
    own (``min_required``: 2.0, or 1.2 for the smoke cell); the
    bit-exactness flag and the bounded chunk-program count must hold
    outright."""
    art = _load_port(path)
    head = art["headline"]
    bar = serve_slo.MIN_PREFILL_TTFT_GAIN
    wall_bar, wall = head["min_required"], head["ttft_wall_gain"]
    ok = wall >= wall_bar
    if not ok:
        problems.append(
            f"{path}:headline.ttft_wall_gain = {wall} fell below the "
            f"{wall_bar} floor")
    rows.append(_row("serve_prefill.headline.ttft_wall_gain", wall_bar,
                     wall, f">= {wall_bar}", ok))
    cycles = head["ttft_cycles_gain"]
    ok = cycles >= bar
    if not ok:
        problems.append(
            f"{path}:headline.ttft_cycles_gain = {cycles} fell below the "
            f"{bar} floor")
    rows.append(_row("serve_prefill.headline.ttft_cycles_gain", bar, cycles,
                     f">= {bar}", ok))
    ok = head["bit_exact"] is True
    if not ok:
        problems.append(
            f"{path}: chunked prefill is not bit-exact with the "
            f"token-by-token path")
    rows.append(_row("serve_prefill.headline.bit_exact", True,
                     head["bit_exact"], "== True", ok))
    compiles, bound = art["prefill_compiles"], art["max_prefill_compiles"]
    ok = compiles <= bound
    if not ok:
        problems.append(
            f"{path}: {compiles} chunk programs exceed the log2(chunk)+1 = "
            f"{bound} bound")
    rows.append(_row("serve_prefill.prefill_compiles", bound, compiles,
                     f"<= {bound}", ok))


def _floor(rows, problems, metric, value, floor):
    ok = value >= floor
    if not ok:
        problems.append(f"{metric} = {value} fell below the {floor} floor")
    rows.append(_row(metric, floor, value, f">= {floor}", ok))


def check_floors(rows, problems, sweep_floors=True):
    """The port's wall-clock ratios (``BENCH_port_*.json`` in
    :data:`ART_DIR`) above the reference's floors, and the reference's
    committed gated gains above their embedded bars.  With
    ``sweep_floors`` off the port's rows say they were not checked."""
    for name, keys, floor, _what in FLOORS:
        metric = (f"{name.removeprefix('BENCH_').removesuffix('.json')}"
                  f".{'.'.join(keys)}")
        if not sweep_floors:
            rows.append(_row(metric, floor, None, f">= {floor}", False,
                             "not checked (sweep floors off)"))
            continue
        try:
            node = _load_port(os.path.join(ART_DIR, name))
        except AssertionError as e:
            problems.append(str(e))
            rows.append(_row(metric, floor, None, f">= {floor}", False))
            continue
        for k in keys:
            node = node[k]
        _floor(rows, problems, metric, node, floor)
    serve = _load_ref("BENCH_serve_slo.json")["headline"]
    _floor(rows, problems, "serve_slo.headline.throughput_at_slo_gain_bursty",
           serve["throughput_at_slo_gain_bursty"], serve["min_required"])
    cluster = _load_ref("BENCH_cluster.json")["headline"]
    _floor(rows, problems, "cluster.headline.speedup_4c",
           cluster["speedup_4c"], cluster["min_required"])


def _fmt_cell(v):
    if isinstance(v, float):
        return f"{v:.4f}"
    return "" if v is None else str(v)


def render_table(rows):
    head = ("metric", "baseline", "current", "delta", "check", "status")
    lines = ["| " + " | ".join(head) + " |",
             "|" + "---|" * len(head)]
    for r in rows:
        lines.append("| " + " | ".join(_fmt_cell(r[k]) for k in head) + " |")
    return "\n".join(lines)


def run(prefill_path=None, sweep_floors=True):
    """Every check, over the port's artifacts in :data:`ART_DIR` and its
    prefill cell at ``prefill_path`` (default
    ``BENCH_port_serve_prefill.json`` there): prints the table, raises on
    any failed row, returns the reference's two summary rows."""
    prefill_path = prefill_path or os.path.join(
        ART_DIR, "BENCH_port_serve_prefill.json")
    t0 = time.time()
    rows, problems = [], []
    for check in (check_serve_slo, check_cluster_strong,
                  lambda r, p: check_serve_prefill(r, p, prefill_path),
                  lambda r, p: check_floors(r, p, sweep_floors)):
        try:
            check(rows, problems)
        except AssertionError as e:
            problems.append(str(e))
    print(render_table(rows))
    if problems:
        raise AssertionError(
            "the port does not reproduce the committed benchmark "
            "baselines:\n  " + "\n  ".join(problems))
    us = (time.time() - t0) * 1e6
    return [("bench_diff_metrics_checked", us, float(len(rows))),
            ("bench_diff_drift_findings", us, 0.0)]


def main():
    for name, us, derived in run():
        print(f"{name},{us:.1f},{derived:.4f}")


if __name__ == "__main__":
    main()
