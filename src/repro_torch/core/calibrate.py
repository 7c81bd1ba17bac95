"""DSE calibration: sweep → Pareto front → operating-point selection →
versioned JSON artifacts that the kernel/serve/train layers consume.

The DSE engine (``core.sweep`` + ``core.pareto``) finds the Pareto-optimal
(IPC, energy) configurations per kernel; this module closes the loop the
roadmap names ("feed Pareto fronts back into the kernel-layer policy
choices"):

1. :func:`calibrate` runs a sweep grid (exhaustively, or pruned by the
   front-guided adaptive search in ``core.search`` — the artifact provenance
   records which), reduces it to per-kernel fronts, and
   :func:`select_operating_point` picks one front member under a declared
   objective — ``max-ipc``, ``min-energy`` or ``energy-bounded-ipc`` — with
   deterministic tie-breaking and an optional dominance tolerance (points
   within ``tolerance`` of the best primary axis count as ties, resolved on
   the secondary axis: a 0.1% IPC win never buys a 2x energy cost).  Since
   v4 the same objective is also re-applied per queue-latency class
   (``selected_by_latency``), so consumers whose interconnect pins the
   visibility latency read the best point *at that latency*.
2. Each selection is persisted as ``artifacts/calibration/<kernel>.json`` —
   a schema-checked (:func:`validate_artifact`), versioned
   (:data:`SCHEMA_VERSION`) artifact embedding the swept grid, the full
   front, git-describable provenance and the selection rationale.
3. ``core.policy.PolicyTable`` loads the artifacts (honouring the
   ``REPRO_CALIBRATION_DIR`` override) and hands per-workload
   :class:`~.policy.OperatingPoint`\\ s to ``kernels/queue_matmul``,
   ``serve.engine`` and ``train.step`` at startup.  Stale or malformed
   artifacts are skipped with a warning and consumers fall back to the
   paper's hard-coded headline point, so calibration can never brick a run.

Per-kernel selection (not one global setting) is where the win lives — the
COPIFT predecessor (arXiv:2503.20590) reports the 1.49x speedup only when
each kernel picks its own configuration.
"""
from __future__ import annotations

import datetime
import json
import math
import os
import subprocess
import types
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .pareto import dominates, pareto_by_kernel, pareto_front
from .policy import TRAFFIC_LEVELS, ExecutionPolicy, OperatingPoint
from .search import run_search
from .sweep import SweepRecord, grid

#: bump on any incompatible artifact-layout change; loaders treat a mismatch
#: as *stale* and fall back to defaults rather than guessing at old layouts.
#: v2: cluster-aware points (n_cores / tcdm_banks / throughput /
#: ipc_per_core) — v1 single-PE artifacts are stale, consumers fall
#: back to defaults until recalibrated.
#: v3: pipelined-cluster points (pipeline / cq_depth / dma_buffers) — v2
#: artifacts are stale in turn.
#: v4: per (kernel x queue-latency class) operating points
#: (``selected_by_latency``) + search-strategy/fidelity provenance — v3
#: artifacts load as stale (``PolicyTable`` warns and falls back to
#: defaults) until recalibrated.
#: v5: the ``serve-slo`` objective ("max throughput s.t. p99 < X
#: cycles-equivalent and J/token < Y") + per-traffic-level selections
#: (``selected_by_traffic``, one per :data:`~repro_torch.core.policy.TRAFFIC_LEVELS`
#: entry, embedded rationale included) — v4 artifacts load as stale with the
#: usual fallback warning until recalibrated.
SCHEMA_VERSION = 5

OBJECTIVES = ("max-ipc", "min-energy", "energy-bounded-ipc", "serve-slo")

#: the configuration + measured-metric fields persisted per front point
POINT_FIELDS = (
    "policy", "queue_depth", "queue_latency", "unroll", "unroll_int",
    "queue_depth_i2f", "queue_depth_f2i", "n_cores", "tcdm_banks",
    "pipeline", "cq_depth", "dma_buffers",
    "ipc", "ipc_per_core", "energy", "cycles", "throughput", "efficiency",
)

ARTIFACT_FIELDS = ("schema_version", "kernel", "objective", "selected",
                   "selected_by_latency", "selected_by_traffic", "front",
                   "grid", "provenance", "rationale")

#: per latency-class entry layout inside ``selected_by_latency``
LATENCY_CLASS_FIELDS = ("selected", "rationale")

#: per traffic-level entry layout inside ``selected_by_traffic`` (v5):
#: ``traffic`` records the level's offered-load fraction at selection time
TRAFFIC_CLASS_FIELDS = ("selected", "rationale", "traffic")

OBJECTIVE_FIELDS = ("name", "energy_budget", "tolerance", "slo_p99")

_REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".."))


class CalibrationError(ValueError):
    """A calibration artifact is malformed (schema violation)."""


class StaleArtifactError(CalibrationError):
    """A calibration artifact was written under a different schema version."""


def calibration_dir() -> str:
    """Artifact directory: ``REPRO_CALIBRATION_DIR`` wins, else the repo's
    ``artifacts/calibration``."""
    env = os.environ.get("REPRO_CALIBRATION_DIR", "").strip()
    return env or os.path.join(_REPO_ROOT, "artifacts", "calibration")


def point_to_dict(rec: SweepRecord) -> Dict[str, Any]:
    return {f: getattr(rec, f) for f in POINT_FIELDS}


def _op_from_point(s: Dict[str, Any]) -> OperatingPoint:
    return OperatingPoint(
        policy=ExecutionPolicy.parse(s["policy"]),
        queue_depth=s["queue_depth"], queue_latency=s["queue_latency"],
        unroll=s["unroll"], unroll_int=s["unroll_int"],
        queue_depth_i2f=s["queue_depth_i2f"],
        queue_depth_f2i=s["queue_depth_f2i"],
        n_cores=s["n_cores"], tcdm_banks=s["tcdm_banks"],
        pipeline=s["pipeline"], cq_depth=s["cq_depth"],
        dma_buffers=s["dma_buffers"],
        source="calibrated")


@dataclass
class CalibrationRecord:
    """One kernel's persisted calibration: the selected operating point, the
    front it was chosen from, per queue-latency-class selections (v4), and
    everything needed to reproduce the choice."""
    kernel: str
    objective: str
    selected: Dict[str, Any]
    front: List[Dict[str, Any]]
    grid: Dict[str, Any]
    provenance: Dict[str, Any]
    rationale: str
    energy_budget: Optional[float] = None
    tolerance: float = 0.0
    #: v5: the ``serve-slo`` p99 bound (cycles-equivalent per work-token);
    #: None for other objectives or when the bound was auto-derived
    slo_p99: Optional[float] = None
    #: v4: ``str(queue_latency) -> {"selected": point, "rationale": str}`` —
    #: the objective re-applied to each latency class's own Pareto front, so
    #: a consumer whose fabric pins the visibility latency gets the best
    #: point *at that latency* instead of the global winner
    selected_by_latency: Dict[str, Dict[str, Any]] = None  # type: ignore
    #: v5: ``traffic level -> {"selected": point, "rationale": str,
    #: "traffic": offered-load fraction}`` — the serve-slo selection applied
    #: per :data:`~repro_torch.core.policy.TRAFFIC_LEVELS` entry, so the serve
    #: path picks the best point *for its offered load* (light traffic
    #: affords the lowest-energy feasible point; near saturation only the
    #: highest-throughput points hold p99)
    selected_by_traffic: Dict[str, Dict[str, Any]] = None  # type: ignore
    schema_version: int = SCHEMA_VERSION

    def __post_init__(self):
        if self.selected_by_latency is None:
            self.selected_by_latency = {}
        if self.selected_by_traffic is None:
            self.selected_by_traffic = {}

    def operating_point(self) -> OperatingPoint:
        return _op_from_point(self.selected)

    def operating_point_for(self,
                            queue_latency: int) -> OperatingPoint:
        """The operating point for a pinned queue-latency class, falling
        back to the global selection when the class was never swept."""
        cls_ = self.selected_by_latency.get(str(queue_latency))
        if cls_ is None:
            return self.operating_point()
        return _op_from_point(cls_["selected"])

    def operating_point_for_traffic(
            self, traffic: str) -> Optional[OperatingPoint]:
        """The serve-slo operating point for a pinned traffic level, or
        None when the level was never analysed (the caller then falls back
        through the latency-class / global selections)."""
        entry = self.selected_by_traffic.get(traffic)
        if entry is None:
            return None
        return _op_from_point(entry["selected"])

    def to_dict(self) -> Dict[str, Any]:
        return {
            "schema_version": self.schema_version,
            "kernel": self.kernel,
            "objective": {"name": self.objective,
                          "energy_budget": self.energy_budget,
                          "tolerance": self.tolerance,
                          "slo_p99": self.slo_p99},
            "selected": dict(self.selected),
            "selected_by_latency": {
                lat: {"selected": dict(e["selected"]),
                      "rationale": e["rationale"]}
                for lat, e in self.selected_by_latency.items()},
            "selected_by_traffic": {
                lvl: {"selected": dict(e["selected"]),
                      "rationale": e["rationale"],
                      "traffic": e["traffic"]}
                for lvl, e in self.selected_by_traffic.items()},
            "front": [dict(p) for p in self.front],
            "grid": dict(self.grid),
            "provenance": dict(self.provenance),
            "rationale": self.rationale,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CalibrationRecord":
        validate_artifact(d)
        obj = d["objective"]
        return cls(kernel=d["kernel"], objective=obj["name"],
                   energy_budget=obj["energy_budget"],
                   tolerance=obj["tolerance"], slo_p99=obj["slo_p99"],
                   selected=d["selected"],
                   selected_by_latency=d["selected_by_latency"],
                   selected_by_traffic=d["selected_by_traffic"],
                   front=d["front"], grid=d["grid"],
                   provenance=d["provenance"], rationale=d["rationale"],
                   schema_version=d["schema_version"])


def _check_exact_fields(d: Dict[str, Any], expected: Sequence[str],
                        where: str) -> None:
    missing = [f for f in expected if f not in d]
    extra = [f for f in d if f not in expected]
    if missing or extra:
        raise CalibrationError(
            f"{where}: missing fields {missing}, unexpected fields {extra}")


def validate_artifact(d: Dict[str, Any]) -> None:
    """Strict schema check: exact field sets at every level, a known
    objective, and the current :data:`SCHEMA_VERSION` (mismatch raises
    :class:`StaleArtifactError` so loaders can fall back to defaults)."""
    if not isinstance(d, dict):
        raise CalibrationError(f"artifact must be an object, got {type(d)}")
    version = d.get("schema_version")
    if version != SCHEMA_VERSION:
        raise StaleArtifactError(
            f"artifact schema_version {version!r} != current "
            f"{SCHEMA_VERSION} (stale artifact; re-run calibrate)")
    _check_exact_fields(d, ARTIFACT_FIELDS, "artifact")
    _check_exact_fields(d["objective"], OBJECTIVE_FIELDS, "objective")
    name = d["objective"]["name"]
    if name not in OBJECTIVES:
        raise CalibrationError(
            f"unknown objective {name!r} (have {OBJECTIVES})")
    _check_exact_fields(d["selected"], POINT_FIELDS, "selected")
    ExecutionPolicy.parse(d["selected"]["policy"])
    if not isinstance(d["front"], list) or not d["front"]:
        raise CalibrationError("front must be a non-empty list")
    for i, p in enumerate(d["front"]):
        _check_exact_fields(p, POINT_FIELDS, f"front[{i}]")
    if d["selected"] not in d["front"]:
        raise CalibrationError("selected point is not a front member")
    if not isinstance(d["selected_by_latency"], dict):
        raise CalibrationError("selected_by_latency must be an object")
    for lat, entry in d["selected_by_latency"].items():
        where = f"selected_by_latency[{lat!r}]"
        try:
            lat_val = int(lat)
        except (TypeError, ValueError):
            raise CalibrationError(
                f"{where}: key must be an integer queue latency") from None
        _check_exact_fields(entry, LATENCY_CLASS_FIELDS, where)
        _check_exact_fields(entry["selected"], POINT_FIELDS,
                            f"{where}.selected")
        ExecutionPolicy.parse(entry["selected"]["policy"])
        if entry["selected"]["queue_latency"] != lat_val:
            raise CalibrationError(
                f"{where}: selected point has queue_latency "
                f"{entry['selected']['queue_latency']} != class {lat_val}")
    if not isinstance(d["selected_by_traffic"], dict):
        raise CalibrationError("selected_by_traffic must be an object")
    for lvl, entry in d["selected_by_traffic"].items():
        where = f"selected_by_traffic[{lvl!r}]"
        if lvl not in TRAFFIC_LEVELS:
            raise CalibrationError(
                f"{where}: unknown traffic level "
                f"(have {sorted(TRAFFIC_LEVELS)})")
        _check_exact_fields(entry, TRAFFIC_CLASS_FIELDS, where)
        _check_exact_fields(entry["selected"], POINT_FIELDS,
                            f"{where}.selected")
        ExecutionPolicy.parse(entry["selected"]["policy"])
        if not isinstance(entry["traffic"], (int, float)) or \
                not 0.0 < entry["traffic"] < 1.0:
            raise CalibrationError(
                f"{where}: traffic must be an offered-load fraction in "
                f"(0, 1), got {entry['traffic']!r}")


# -- objective-aware selection ----------------------------------------------

def _cheap_hw_key(r: SweepRecord) -> Tuple:
    """Final tie-break: prefer the cheaper hardware/schedule realization —
    fewer cores, a plain work-partitioned cluster over a pipelined one (no
    channel fabric / DMA engine to build), shallower FIFOs (intra-core and
    inter-core), fewer DMA buffers, lower visibility latency, smaller
    unroll."""
    d_i2f = r.queue_depth_i2f or r.queue_depth
    d_f2i = r.queue_depth_f2i or r.queue_depth
    return (r.n_cores, int(r.pipeline), max(d_i2f, d_f2i), r.cq_depth,
            r.dma_buffers, r.queue_latency, r.unroll,
            r.unroll_int or r.unroll, r.policy)


#: exponential-tail multiplier for the queueing estimate:
#: p99 sojourn ~ -ln(0.01) x mean sojourn
_P99_TAIL = -math.log(0.01)
#: auto-derived serve-slo bound when none is declared: this multiple of the
#: best attainable p99 estimate at the traffic level (keeps the per-traffic
#: selections meaningful for artifacts calibrated under other objectives)
_DEFAULT_SLO_HEADROOM = 3.0


def estimated_p99_sojourn(rec: SweepRecord, offered_load: float) -> float:
    """Analytic p99 sojourn estimate (cycles per work-token) for a swept
    point serving a Poisson arrival stream of ``offered_load`` tokens/cycle.

    M/D/1-flavoured: service is near-deterministic (one token's worth of the
    proxy kernel at a fixed configuration, service rate = the point's
    measured ``throughput``), so mean sojourn is ``S + rho*S/(2(1-rho))``
    and the p99 is approximated with an exponential tail
    (:data:`_P99_TAIL` x mean).  Saturated points (``rho >= 1``) return
    ``inf`` — the queue grows without bound, no SLO holds.
    """
    mu = rec.throughput
    if mu <= 0.0:
        return math.inf
    rho = offered_load / mu
    if rho >= 1.0:
        return math.inf
    service = 1.0 / mu
    mean_sojourn = service + rho * service / (2.0 * (1.0 - rho))
    return _P99_TAIL * mean_sojourn


def _select_serve_slo(cands: Sequence[SweepRecord], traffic: float,
                      slo_p99: Optional[float],
                      energy_budget: Optional[float],
                      tolerance: float) -> Tuple[SweepRecord, str]:
    """The ``serve-slo`` discipline: max throughput s.t. the estimated p99
    sojourn fits ``slo_p99`` (cycles-equivalent per work-token) and
    joules-per-token fits ``energy_budget``.  ``traffic`` is the offered
    load as a fraction of the front's best service rate.  An infeasible SLO
    degrades to the closest-to-feasible point (min estimated p99) and the
    rationale says so.
    """
    served = [r for r in cands if r.throughput > 0]
    if not served:
        raise CalibrationError(
            "serve-slo: no front point has positive throughput")
    lam = traffic * max(r.throughput for r in served)
    est = {id(r): estimated_p99_sojourn(r, lam) for r in served}
    auto = ""
    if slo_p99 is None:
        best_est = min(est.values())
        slo_p99 = _DEFAULT_SLO_HEADROOM * best_est
        auto = (f" (auto bound: {_DEFAULT_SLO_HEADROOM:g}x best attainable "
                f"{best_est:.1f})")

    def jpt(r: SweepRecord) -> float:
        return r.energy / max(r.n_samples, 1)

    feasible = [r for r in served if est[id(r)] <= slo_p99
                and (energy_budget is None or jpt(r) <= energy_budget)]
    bounds = f"p99<={slo_p99:g}cyc/tok{auto}"
    if energy_budget is not None:
        bounds += f", J/tok<={energy_budget:g}"
    if feasible:
        best = max(r.throughput for r in feasible)
        tied = [r for r in feasible if r.throughput >= best * (1.0 - tolerance)]
        pick = min(tied, key=lambda r: (est[id(r)], r.energy)
                   + _cheap_hw_key(r))
        how = (f"serve-slo(load={traffic:g}, {bounds}): "
               f"throughput={pick.throughput:.4f} tok/cyc "
               f"(front best {best:.4f}), est p99={est[id(pick)]:.1f}, "
               f"J/tok={jpt(pick):.1f}; {len(feasible)} of {len(served)} "
               f"points feasible ({len(tied)} within tolerance "
               f"{tolerance:g})")
    else:
        pick = min(served, key=lambda r: (est[id(r)], -r.throughput)
                   + _cheap_hw_key(r))
        how = (f"serve-slo(load={traffic:g}, {bounds}): INFEASIBLE — no "
               f"point meets the bounds (best attainable est "
               f"p99={est[id(pick)]:.1f}, J/tok={jpt(pick):.1f}); degraded "
               f"to the closest point, throughput={pick.throughput:.4f}")
    rationale = (f"{how}; picked {pick.policy} depth={pick.queue_depth} "
                 f"lat={pick.queue_latency} unroll={pick.unroll} "
                 f"cores={pick.n_cores}")
    return pick, rationale


def select_operating_point(front: Sequence[SweepRecord], objective: str,
                           energy_budget: Optional[float] = None,
                           tolerance: float = 0.0,
                           slo_p99: Optional[float] = None,
                           traffic: Optional[float] = None
                           ) -> Tuple[SweepRecord, str]:
    """Pick one front member under ``objective``; returns ``(record,
    rationale)``.

    ``tolerance`` is the dominance tolerance: candidates within that relative
    distance of the best primary-axis value are treated as tied and the tie
    is broken on the secondary axis (then on :func:`_cheap_hw_key`).
    ``energy-bounded-ipc`` maximizes IPC subject to ``energy <=
    energy_budget``; an infeasible budget degrades to ``min-energy`` and the
    rationale says so.  ``serve-slo`` maximizes throughput subject to an
    estimated p99 sojourn bound (``slo_p99``, cycles-equivalent per token —
    auto-derived with headroom when omitted) and a joules-per-token bound
    (``energy_budget``) at an offered load of ``traffic`` (fraction of the
    front's best service rate, default the "medium"
    :data:`~repro_torch.core.policy.TRAFFIC_LEVELS` entry).
    """
    if objective not in OBJECTIVES:
        raise ValueError(f"unknown objective {objective!r} "
                         f"(have {OBJECTIVES})")
    cands = [r for r in front if r.ok]
    if not cands:
        raise CalibrationError("cannot select from an empty Pareto front")
    note = ""
    if objective == "serve-slo":
        if traffic is None:
            traffic = TRAFFIC_LEVELS["medium"]
        return _select_serve_slo(cands, traffic, slo_p99, energy_budget,
                                 tolerance)
    if objective == "energy-bounded-ipc":
        if energy_budget is None:
            raise ValueError("energy-bounded-ipc requires energy_budget")
        feasible = [r for r in cands if r.energy <= energy_budget]
        if feasible:
            cands, note = feasible, f" within energy budget {energy_budget:g}"
        else:
            objective_eff = "min-energy"
            note = (f"; budget {energy_budget:g} infeasible "
                    f"(front min energy {min(r.energy for r in cands):g}), "
                    f"degraded to min-energy")
            return _select(cands, objective_eff, tolerance, note)
        return _select(cands, "max-ipc", tolerance, note)
    return _select(cands, objective, tolerance, note)


def _select(cands: Sequence[SweepRecord], objective: str, tolerance: float,
            note: str) -> Tuple[SweepRecord, str]:
    if objective == "max-ipc":
        best = max(r.ipc for r in cands)
        tied = [r for r in cands if r.ipc >= best * (1.0 - tolerance)]
        pick = min(tied, key=lambda r: (r.energy,) + _cheap_hw_key(r))
        how = f"max-ipc{note}: ipc={pick.ipc:.4f} (front best {best:.4f})"
    else:                                   # min-energy
        best = min(r.energy for r in cands)
        tied = [r for r in cands if r.energy <= best * (1.0 + tolerance)]
        pick = min(tied, key=lambda r: (-r.ipc,) + _cheap_hw_key(r))
        how = (f"min-energy{note}: energy={pick.energy:.1f} "
               f"(front best {best:.1f})")
    rationale = (f"{how}; picked {pick.policy} depth={pick.queue_depth} "
                 f"lat={pick.queue_latency} unroll={pick.unroll} from "
                 f"{len(cands)} candidates ({len(tied)} within tolerance "
                 f"{tolerance:g})")
    return pick, rationale


# -- provenance + artifact IO ------------------------------------------------

def git_describe() -> str:
    try:
        out = subprocess.run(
            ["git", "describe", "--always", "--dirty", "--tags"],
            cwd=_REPO_ROOT, capture_output=True, text=True, timeout=10)
        if out.returncode == 0:
            return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return "unknown"


def artifact_path(kernel: str, directory: Optional[str] = None) -> str:
    return os.path.join(directory or calibration_dir(), f"{kernel}.json")


def write_artifact(rec: CalibrationRecord,
                   directory: Optional[str] = None) -> str:
    path = artifact_path(rec.kernel, directory)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(rec.to_dict(), fh, indent=2, sort_keys=True)
        fh.write("\n")
    return path


def load_artifact(path: str) -> CalibrationRecord:
    """Parse + validate one artifact file; raises :class:`CalibrationError`
    (or :class:`StaleArtifactError`) on any schema violation."""
    try:
        with open(path) as fh:
            d = json.load(fh)
    except OSError as e:
        raise CalibrationError(f"unreadable artifact {path}: {e}") from e
    except json.JSONDecodeError as e:
        raise CalibrationError(f"artifact {path} is not JSON: {e}") from e
    return CalibrationRecord.from_dict(d)


def load_calibration(kernel: str,
                     directory: Optional[str] = None
                     ) -> Optional[CalibrationRecord]:
    """The artifact for ``kernel``, or None (missing artifacts are normal —
    consumers fall back to defaults)."""
    path = artifact_path(kernel, directory)
    if not os.path.exists(path):
        return None
    return load_artifact(path)


# -- the end-to-end calibration run ------------------------------------------

#: the default calibration grid — the same 336-configuration space
#: ``python -m repro_torch.examples.explore`` sweeps by default
DEFAULT_GRID = dict(queue_depths=(1, 2, 4, 8), queue_latencies=(1, 2),
                    unrolls=(4, 8), n_samples=32)


def _select_by_latency(records: List[SweepRecord], objective: str,
                       energy_budget: Optional[float], tolerance: float,
                       slo_p99: Optional[float] = None
                       ) -> Dict[str, Dict[str, Any]]:
    """The v4 per-class selections: re-apply the objective to each queue-
    latency class's own Pareto front (a class whose front is empty — every
    point rejected — is simply absent)."""
    classes: Dict[int, List[SweepRecord]] = {}
    for r in records:
        if r.ok:
            classes.setdefault(r.queue_latency, []).append(r)
    out: Dict[str, Dict[str, Any]] = {}
    for lat in sorted(classes):
        front = pareto_front(classes[lat])
        if not front:
            continue
        pick, rationale = select_operating_point(
            front, objective, energy_budget=energy_budget,
            tolerance=tolerance, slo_p99=slo_p99)
        out[str(lat)] = {"selected": point_to_dict(pick),
                         "rationale": f"latency class {lat}: {rationale}"}
    return out


def _select_by_traffic(records: List[SweepRecord],
                       energy_budget: Optional[float], tolerance: float,
                       slo_p99: Optional[float]
                       ) -> Dict[str, Dict[str, Any]]:
    """The v5 per-traffic-level selections: the ``serve-slo`` discipline
    applied to the kernel's front at every :data:`TRAFFIC_LEVELS` offered
    load — computed for *every* calibration (whatever its global objective),
    so the serve path can always resolve a point for its traffic level.  The
    energy budget is treated as a per-token bound here (serve-slo
    semantics), independent of how the global objective interprets it."""
    ok = [r for r in records if r.ok]
    front = pareto_front(ok) if ok else []
    out: Dict[str, Dict[str, Any]] = {}
    if not front:
        return out
    for level, util in TRAFFIC_LEVELS.items():
        try:
            pick, rationale = _select_serve_slo(
                front, util, slo_p99, energy_budget, tolerance)
        except CalibrationError:
            continue
        out[level] = {"selected": point_to_dict(pick),
                      "rationale": f"traffic {level}: {rationale}",
                      "traffic": util}
    return out


def calibrate(kernels: Optional[Sequence[str]] = None,
              objective: str = "max-ipc",
              energy_budget: Optional[float] = None,
              tolerance: float = 0.0,
              slo_p99: Optional[float] = None,
              grid_kw: Optional[Dict[str, Any]] = None,
              workers: Optional[int] = None,
              out_dir: Optional[str] = None,
              write: bool = True,
              strategy: str = "exhaustive",
              search_kw: Optional[Dict[str, Any]] = None
              ) -> Dict[str, CalibrationRecord]:
    """Sweep → per-kernel fronts → objective selection → artifacts.

    Returns kernel → :class:`CalibrationRecord`; with ``write=True`` (the
    default) each record is also persisted under ``out_dir`` (defaulting to
    :func:`calibration_dir`).  Raises if any swept point deadlocks or
    diverges from the baseline interpreter — a calibration produced by a
    broken simulation must never be written.

    ``strategy`` selects the search discipline (``core.search``):
    ``"adaptive"`` prunes the grid by front-guided successive halving
    (``search_kw`` passes ``tolerance`` / ``fidelity_ladder`` through) and
    the artifact's provenance embeds the full search meta — strategy,
    fidelity ladder, per-rung survivor counts — so a consumer can tell a
    pruned calibration from an exhaustive one.  Besides the global
    selection, each artifact carries per queue-latency-class selections
    (``selected_by_latency``, v4): the objective re-applied to each latency
    class's own front; and per-traffic-level ``serve-slo`` selections
    (``selected_by_traffic``, v5) — always computed, whatever the global
    objective, with ``slo_p99`` as the p99 bound (auto-derived with headroom
    when omitted) and ``energy_budget`` read as a joules-per-token bound.
    """
    gk = dict(DEFAULT_GRID)
    gk.update(grid_kw or {})
    points = grid(kernels=kernels, **gk)
    records, search_meta = run_search(points, strategy=strategy,
                                      workers=workers, **(search_kw or {}))
    bad = [r for r in records if r.status == "deadlock"
           or (r.ok and (not r.equivalent or r.fifo_violations))]
    if bad:
        raise CalibrationError(
            f"{len(bad)} swept points deadlocked or diverged from the "
            f"baseline interpreter, e.g. {bad[0]}; refusing to calibrate")
    grid_desc: Dict[str, Any] = {
        "kernels": sorted({p.kernel for p in points}), **{
            k: (list(v) if isinstance(v, (tuple, list)) else v)
            for k, v in gk.items()},
    }
    if "policies" in grid_desc:
        grid_desc["policies"] = [
            ExecutionPolicy.parse(p).value for p in grid_desc["policies"]]
    provenance = {
        "git": git_describe(),
        "created": datetime.datetime.now(datetime.timezone.utc).isoformat(),
        "engine": points[0].engine if points else "event",
        "n_points": len(points),
        "n_ok": sum(r.ok for r in records),
        "search": search_meta,
    }
    by_kernel: Dict[str, List[SweepRecord]] = {}
    for r in records:
        by_kernel.setdefault(r.kernel, []).append(r)
    out: Dict[str, CalibrationRecord] = {}
    for kernel, front in pareto_by_kernel(records).items():
        pick, rationale = select_operating_point(
            front, objective, energy_budget=energy_budget,
            tolerance=tolerance, slo_p99=slo_p99)
        rec = CalibrationRecord(
            kernel=kernel, objective=objective, energy_budget=energy_budget,
            tolerance=tolerance, slo_p99=slo_p99,
            selected=point_to_dict(pick),
            selected_by_latency=_select_by_latency(
                by_kernel.get(kernel, []), objective, energy_budget,
                tolerance, slo_p99=slo_p99),
            selected_by_traffic=_select_by_traffic(
                by_kernel.get(kernel, []), energy_budget, tolerance,
                slo_p99),
            front=[point_to_dict(r) for r in front], grid=grid_desc,
            provenance=provenance, rationale=rationale)
        validate_artifact(rec.to_dict())     # never persist a bad artifact
        if write:
            write_artifact(rec, out_dir)
        out[kernel] = rec
    return out


def never_dominated_by(rec: CalibrationRecord,
                       baseline: SweepRecord) -> bool:
    """True iff ``baseline`` does not dominate the selected point — the
    calibrated choice can never be strictly worse than a hard-coded one."""
    sel = types.SimpleNamespace(ipc=rec.selected["ipc"],
                                energy=rec.selected["energy"])
    return not dominates(baseline, sel)
