"""The port's simulated benchmark sections (``repro_torch.benchmarks``:
serve_slo's simulated sections, cluster_scaling, cluster_pipeline,
front_diff and bench_diff) against the JAX package's ``benchmarks/`` on
the CPU.

Everything here is a pure function of the code (virtual-time simulation,
pinned seeds), so rows and artifacts are compared with ``==``, and the
port's FULL serve report with the reference's committed
``artifacts/BENCH_serve_slo.json`` field for field.  Only the rows'
``us_per_call`` (the host clock) is left out of the comparisons.  Every
artifact goes to ``tmp_path``."""
import dataclasses
import hashlib
import json
import os

import pytest

torch = pytest.importorskip("torch")

from _calibration_isolation import isolated_calibration  # noqa: F401
from _port_artifacts import default_outputs, redirect

from benchmarks import bench_diff as ref_bench_diff
from benchmarks import cluster_pipeline as ref_pipeline
from benchmarks import cluster_scaling as ref_scaling
from benchmarks import front_diff as ref_front_diff
from benchmarks import serve_slo as ref_slo
from repro_torch.benchmarks import (REF_ART_DIR, bench_diff, cluster_pipeline,
                                    cluster_scaling, front_diff, serve_slo)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _port_artifacts_in_tmp(monkeypatch, tmp_path):
    redirect(monkeypatch, tmp_path / "port_artifacts")


def _load(path):
    with open(path) as f:
        return json.load(f)


def _names_and_values(rows):
    """A section's rows without the host clock's ``us_per_call``."""
    return [(name, derived) for name, _us, derived in rows]


# --- constants, grids and gates --------------------------------------------

CONSTANTS = [
    (serve_slo, ref_slo, name) for name in (
        "MIN_CONTINUOUS_GAIN", "MIN_STRAGGLER_GAIN", "SLO_P99_PER_TOKEN",
        "SLO_BASE_CYCLES", "N_SLOTS", "PREFILL_CHUNK", "PROMPT_LENS",
        "MAX_NEWS", "FULL", "SMOKE")
] + [
    (cluster_scaling, ref_scaling, name) for name in (
        "MIN_SPEEDUP_4C", "STRONG_KERNEL", "CONTENTION_KERNEL", "FULL",
        "SMOKE")
] + [
    (cluster_pipeline, ref_pipeline, name) for name in (
        "KERNEL", "BANK_CONFLICT_PENALTY", "MIN_IPC_RATIO",
        "MAX_BACKPRESSURE_SHARE", "MIN_PARTITION_SHARE", "FULL", "SMOKE")
] + [
    (front_diff, ref_front_diff, name) for name in (
        "PINNED_GRID", "REL_TOL", "CONFIG_KEYS", "METRIC_KEYS")
] + [
    (bench_diff, ref_bench_diff, name) for name in (
        "REL_TOL", "_EXACT_FIELDS", "_FLOAT_FIELDS")
]


@pytest.mark.parametrize("port,ref,name", CONSTANTS,
                         ids=[f"{p.__name__.rsplit('.', 1)[1]}.{n}"
                              for p, _, n in CONSTANTS])
def test_constants_equal_reference(port, ref, name):
    assert getattr(port, name) == getattr(ref, name)


def test_floors_are_the_reference_floors_on_the_port_artifacts():
    """The reference's floors, each on the port's own artifact, and each
    artifact named with the command that writes it."""
    assert [(name.replace("BENCH_port_", "BENCH_"), keys, floor, what)
            for name, keys, floor, what in bench_diff.FLOORS] == \
        list(ref_bench_diff.FLOORS)
    for name, *_ in bench_diff.FLOORS:
        assert name.startswith("BENCH_port_")
        assert bench_diff.WRITTEN_BY[name].startswith(
            "PYTHONPATH=src python -m repro_torch.benchmarks.")


def test_traces_equal_reference():
    """The pinned-seed poisson and bursty traces, request for request."""
    cost, ref_cost = serve_slo._cost_model(), ref_slo._cost_model()
    for port_fn, ref_fn, args in (
            (serve_slo.poisson_trace, ref_slo.poisson_trace,
             (160, 7, 0.7)),
            (serve_slo.bursty_trace, ref_slo.bursty_trace, (160, 7, 16, 40))):
        got = [dataclasses.astuple(r) for r in port_fn(cost, *args)]
        want = [dataclasses.astuple(r) for r in ref_fn(ref_cost, *args)]
        assert got == want


# --- each section's smoke run against the reference's ----------------------

SECTIONS = {
    "serve_slo": (lambda out: serve_slo.run(cfg=serve_slo.SMOKE,
                                            out_path=out),
                  lambda out: ref_slo.run(cfg=ref_slo.SMOKE, out_path=out)),
    "cluster_scaling": (
        lambda out: cluster_scaling.run(cfg=cluster_scaling.SMOKE,
                                        out_path=out),
        lambda out: ref_scaling.run(cfg=ref_scaling.SMOKE, out_path=out)),
    "cluster_pipeline": (
        lambda out: cluster_pipeline.run(cfg=cluster_pipeline.SMOKE,
                                         out_path=out),
        lambda out: ref_pipeline.run(cfg=ref_pipeline.SMOKE, out_path=out)),
}


@pytest.mark.parametrize("section", sorted(SECTIONS))
def test_smoke_run_equals_reference(section, tmp_path):
    """Rows (names and derived values) and the whole artifact equal the
    reference's with ``==``."""
    port_run, ref_run = SECTIONS[section]
    rows = port_run(str(tmp_path / "port.json"))
    want = ref_run(str(tmp_path / "ref.json"))
    assert rows and _names_and_values(rows) == _names_and_values(want)
    assert all(us >= 0 for _, us, _ in rows)
    assert _load(tmp_path / "port.json") == _load(tmp_path / "ref.json")


@pytest.mark.parametrize("section", ["serve_slo", "cluster_scaling",
                                     "cluster_pipeline"])
def test_smoke_writes_its_port_artifact(section, tmp_path, capsys):
    """``smoke()`` writes ``BENCH_port_*_smoke.json`` (here under the test's
    directory) and prints the rows as ``name,us_per_call,derived``."""
    mod = {"serve_slo": serve_slo, "cluster_scaling": cluster_scaling,
           "cluster_pipeline": cluster_pipeline}[section]
    mod.smoke()
    out = mod.SMOKE_OUT_PATH
    assert os.path.basename(out).startswith("BENCH_port_")
    assert out.startswith(str(tmp_path)) and os.path.exists(out)
    lines = capsys.readouterr().out.splitlines()
    assert lines and all(len(line.split(",")) == 3 for line in lines)


def test_serve_slo_full_equals_committed_artifact(tmp_path):
    """The port's FULL simulated report equals the reference's committed
    ``artifacts/BENCH_serve_slo.json`` field for field."""
    out = tmp_path / "full.json"
    serve_slo.run(cfg=serve_slo.FULL, out_path=str(out))
    assert _load(out) == _load(os.path.join(REF_ART_DIR,
                                            "BENCH_serve_slo.json"))


def test_cluster_scaling_full_equals_reference_and_committed(tmp_path):
    """The port's FULL run (1-8 cores) equals the reference's FULL run with
    ``==``, and the reference's committed ``artifacts/BENCH_cluster.json``
    within ``bench_diff``'s rtol of 1e-9: six of the committed floats
    (energy a sample and IPC a core at 8 cores, the contention points)
    differ from both packages' runs here in their last bits."""
    cluster_scaling.run(cfg=cluster_scaling.FULL,
                        out_path=str(tmp_path / "port.json"))
    ref_scaling.run(cfg=ref_scaling.FULL, out_path=str(tmp_path / "ref.json"))
    got = _load(tmp_path / "port.json")
    assert got == _load(tmp_path / "ref.json")
    problems = []
    bench_diff._deep_diff(
        _load(os.path.join(REF_ART_DIR, "BENCH_cluster.json")), got,
        "cluster", problems)
    assert problems == []


# --- the gates are hard ------------------------------------------------------

GATES = [
    (serve_slo, "MIN_CONTINUOUS_GAIN", "throughput-at-SLO",
     lambda out: serve_slo.run(cfg=serve_slo.SMOKE, out_path=out)),
    (serve_slo, "MIN_STRAGGLER_GAIN", "straggler-aware dispatch gains only",
     lambda out: serve_slo.run(cfg=serve_slo.SMOKE, out_path=out)),
    (serve_slo, "SLO_P99_PER_TOKEN", "missed the p99 bound",
     lambda out: serve_slo.run(cfg=serve_slo.SMOKE, out_path=out)),
    (cluster_scaling, "MIN_SPEEDUP_4C", "speedup",
     lambda out: cluster_scaling.run(cfg=cluster_scaling.SMOKE,
                                     out_path=out)),
    (cluster_pipeline, "MIN_IPC_RATIO", "pipelined IPC",
     lambda out: cluster_pipeline.run(cfg=cluster_pipeline.SMOKE,
                                      out_path=out)),
    (cluster_pipeline, "MIN_PARTITION_SHARE", "comparison is vacuous",
     lambda out: cluster_pipeline.run(cfg=cluster_pipeline.SMOKE,
                                      out_path=out)),
]


@pytest.mark.parametrize("mod,name,match,call", GATES,
                         ids=[g[1] for g in GATES])
def test_gate_out_of_reach_raises(mod, name, match, call, monkeypatch,
                                  tmp_path):
    """A bar moved out of reach fails the section (the p99 bound moved to
    1 cycle a token)."""
    monkeypatch.setattr(mod, name, 1.0 if name == "SLO_P99_PER_TOKEN"
                        else 1e9)
    with pytest.raises(AssertionError, match=match):
        call(str(tmp_path / "gate.json"))


# --- front_diff --------------------------------------------------------------

def test_front_diff_fronts_equal_reference_and_pass():
    """The port's pinned-grid fronts equal the reference's recomputation
    and its committed baseline; the gate's rows equal the reference's."""
    assert front_diff.compute_fronts() == ref_front_diff.compute_fronts()
    assert front_diff.BASELINE_PATH == ref_front_diff.BASELINE_PATH
    assert _names_and_values(front_diff.run()) == \
        _names_and_values(ref_front_diff.run())


def test_front_diff_fails_on_a_moved_front(monkeypatch, tmp_path):
    """One front point's cycles moved in a copy of the baseline: the gate
    names it."""
    base = _load(front_diff.BASELINE_PATH)
    kernel = sorted(base["fronts"])[0]
    base["fronts"][kernel][0]["cycles"] += 1
    moved = tmp_path / "front_baseline.json"
    moved.write_text(json.dumps(base))
    monkeypatch.setattr(front_diff, "BASELINE_PATH", str(moved))
    with pytest.raises(AssertionError, match=f"{kernel}: cycles moved"):
        front_diff.run()


# --- bench_diff --------------------------------------------------------------

def _floor_artifacts(directory, monkeypatch, factor=1.0, wall_gain=1.1):
    """The port's floor-checked artifacts, each at ``factor`` x its floor,
    and a prefill cell with the given wall-clock gain, in ``directory``,
    which becomes the port's artifact directory."""
    os.makedirs(directory, exist_ok=True)
    monkeypatch.setattr(bench_diff, "ART_DIR", str(directory))
    for name, keys, floor, _ in bench_diff.FLOORS:
        node = value = {}
        for k in keys[:-1]:
            node[k] = {}
            node = node[k]
        node[keys[-1]] = floor * factor
        with open(os.path.join(directory, name), "w") as f:
            json.dump(value, f)
    prefill = {"prefill_compiles": 1, "max_prefill_compiles": 5,
               "headline": {"ttft_wall_gain": wall_gain,
                            "ttft_cycles_gain": 7.3368,
                            "bit_exact": True, "min_required": 2.0,
                            "meets_wall_bar": wall_gain >= 2.0}}
    with open(os.path.join(directory, "BENCH_port_serve_prefill.json"),
              "w") as f:
        json.dump(prefill, f)
    return str(directory)


def _rows(capsys):
    table = capsys.readouterr().out
    return {line.split(" | ")[0].lstrip("| "): line
            for line in table.splitlines()[2:] if line.startswith("| ")}


def test_bench_diff_passes_against_committed_artifacts(tmp_path, capsys,
                                                       monkeypatch):
    """The exact compares find 0 drifted fields in the regenerated FULL
    serve report and the recomputed strong-scaling points; the wall bar's
    row shows 2.0 and names queue C without failing."""
    _floor_artifacts(tmp_path / "art", monkeypatch, factor=1.5)
    rows = bench_diff.run()
    assert _names_and_values(rows)[1] == ("bench_diff_drift_findings", 0.0)
    table = _rows(capsys)
    assert "| 0 | 0 | 0 | == 0 | ok |" in \
        table["serve_slo.full_report_fields_drifted"]
    assert "| 0 | 0 | 0 | == 0 | ok |" in \
        table["cluster.strong_scaling_fields_drifted"]
    wall = table["serve_prefill.headline.ttft_wall_gain"]
    assert "| 2.0000 | 1.1000 |" in wall and "ROADMAP queue C" in wall
    assert all(line.endswith("| ok |") for metric, line in table.items()
               if metric != "serve_prefill.headline.ttft_wall_gain")


def test_bench_diff_fails_when_an_slo_constant_moves_a_field(monkeypatch,
                                                             tmp_path):
    """A monkeypatched SLO budget moves the regenerated report's SLO fields
    away from the committed ones: the gate fails and names them."""
    _floor_artifacts(tmp_path / "art", monkeypatch, factor=1.5)
    monkeypatch.setattr(serve_slo, "SLO_BASE_CYCLES",
                        serve_slo.SLO_BASE_CYCLES + 100.0)
    with pytest.raises(AssertionError, match=r"serve_slo\.slo\.base_cycles"):
        bench_diff.run()


@pytest.mark.parametrize("case", ["absent", "below_floor", "not_bit_exact"])
def test_bench_diff_floors_are_hard(case, tmp_path, monkeypatch):
    """An absent floor artifact fails naming the command that writes it; a
    ratio below its floor fails; so does a prefill cell that is not
    bit-exact."""
    art = _floor_artifacts(tmp_path / "art", monkeypatch,
                           factor=0.5 if case == "below_floor" else 1.5)
    name = bench_diff.FLOORS[0][0]
    if case == "absent":
        os.remove(os.path.join(art, name))
        match = "repro_torch.benchmarks.sweep_perf"
    elif case == "below_floor":
        match = "speedup_event_cached = 1.0 fell below the 2.0 floor"
    else:
        path = os.path.join(art, "BENCH_port_serve_prefill.json")
        cell = _load(path)
        cell["headline"]["bit_exact"] = False
        with open(path, "w") as f:
            json.dump(cell, f)
        match = "not bit-exact"
    with pytest.raises(AssertionError, match=match):
        bench_diff.run()


def test_bench_diff_without_sweep_floors_says_so(tmp_path, capsys,
                                                  monkeypatch):
    """With the sweep floors off (the card's smoke run, which writes no
    full sweep artifact) their rows say they were not checked."""
    art = _floor_artifacts(tmp_path / "art", monkeypatch, factor=1.5)
    for name, *_ in bench_diff.FLOORS:
        os.remove(os.path.join(art, name))
    bench_diff.run(sweep_floors=False)
    table = _rows(capsys)
    for name, keys, *_ in bench_diff.FLOORS:
        metric = (name.removeprefix("BENCH_").removesuffix(".json") + "."
                  + ".".join(keys))
        assert "not checked" in table[metric]


# --- the reference's files are read, never written ---------------------------

#: the reference's committed golden files (``.gitignore`` lets these in)
GOLDEN = [os.path.join(REPO, "artifacts", f"BENCH_{name}.json")
          for name in ("sweep", "sweep_scale", "cluster",
                       "cluster_sweep_scale", "serve_slo", "serve_prefill")]
GOLDEN.append(os.path.join(REPO, "benchmarks", "data", "front_baseline.json"))


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_port_never_writes_the_reference_files(tmp_path, monkeypatch):
    """Every default output of the port is a ``BENCH_port_*`` file or
    ``calibration_port_smoke`` under its own names; the reference's
    committed files keep their bytes through the port's simulated smoke
    sections and its drift gate."""
    for _mod, attr, path in default_outputs():
        base = os.path.basename(path)
        assert base.startswith("BENCH_port_") or base in (
            "calibration_port_smoke", "dryrun_port"), (attr, path)
    before = {p: _digest(p) for p in GOLDEN}
    for mod in (serve_slo, cluster_scaling, cluster_pipeline, front_diff):
        mod.smoke()
    _floor_artifacts(tmp_path / "art", monkeypatch, factor=1.5)
    bench_diff.run()
    assert {p: _digest(p) for p in GOLDEN} == before
