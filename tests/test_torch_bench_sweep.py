"""The port's machine-model benchmark sections (``repro_torch.benchmarks``:
fig3, dse, sweep_perf, sweep_scale, cluster_sweep_scale, calibration and
report) against the JAX package's ``benchmarks/`` on the CPU.

Rows and artifact fields that are pure functions of the code are compared
with ``==``.  The wall-clock fields (each row's ``us_per_call``,
``wall_s``, ``points_per_sec``, ``speedup_*``) are only checked finite
and positive: no test here holds a wall-clock bar.  The gates are checked
hard with their inputs monkeypatched, never against the clock.  Every
artifact goes to ``tmp_path``."""
import enum
import json
import math
import os

import pytest

torch = pytest.importorskip("torch")

from _calibration_isolation import isolated_calibration  # noqa: F401
from _port_artifacts import redirect

from benchmarks import calibration as ref_calibration
from benchmarks import cluster_sweep_scale as ref_css
from benchmarks import dse as ref_dse
from benchmarks import fig3 as ref_fig3
from benchmarks import report as ref_report
from benchmarks import sweep_perf as ref_sweep_perf
from benchmarks import sweep_scale as ref_sweep_scale
from repro_torch.benchmarks import (calibration, cluster_sweep_scale, dse,
                                    fig3, report, sweep_perf, sweep_scale)
from repro_torch.launch import dryrun

#: the fields that carry the host clock
WALL = ("wall_s", "points_per_sec", "speedup_cached", "speedup_uncached")


@pytest.fixture(autouse=True)
def _port_artifacts_in_tmp(monkeypatch, tmp_path):
    redirect(monkeypatch, tmp_path / "port_artifacts")


def _load(path):
    with open(path) as f:
        return json.load(f)


def _plain(value):
    """Grids with either package's ``ExecutionPolicy`` compared by value."""
    if isinstance(value, enum.Enum):
        return value.value
    if isinstance(value, (tuple, list)):
        return [_plain(v) for v in value]
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    return value


def _split_wall(node, wall):
    """``node`` without its wall-clock fields, which go to ``wall``."""
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            if k in WALL or (k.startswith("speedup_")
                             and k != "speedup_gate"):
                wall.append(v)
            else:
                out[k] = _split_wall(v, wall)
        return out
    if isinstance(node, list):
        return [_split_wall(v, wall) for v in node]
    return node


def _names_and_values(rows):
    return [(name, derived) for name, _us, derived in rows]


# --- constants, grids and gates --------------------------------------------

CONSTANTS = [
    (sweep_perf, ref_sweep_perf, name) for name in (
        "FULL_GRID", "SMOKE_GRID", "MODES", "REPEATS")
] + [
    (sweep_scale, ref_sweep_scale, name) for name in (
        "SPEEDUP_GATE", "SINGLE_CORE_KERNELS", "POLICIES", "THROUGHPUT_GRID",
        "ADAPTIVE_GRID", "SLICE_STRIDE", "SMOKE_THROUGHPUT_GRID",
        "SMOKE_ADAPTIVE_GRID", "SMOKE_SLICE_STRIDE", "REPEATS")
] + [
    (cluster_sweep_scale, ref_css, name) for name in (
        "SPEEDUP_GATE", "CORES", "QLATS", "WORK_DI_GRID", "WORK_V2_GRID",
        "PIPE_GRID", "GATE_GRIDS", "BANKED_GRID", "SMOKE_GATE_GRIDS",
        "SMOKE_BANKED_GRID", "REPEATS")
] + [
    (calibration, ref_calibration, name) for name in (
        "DEFAULT_POINTS", "DEFAULT_POINT")
] + [
    (mod, ref, "run.__defaults__") for mod, ref in (
        (fig3, ref_fig3), (dse, ref_dse))
]


def _get(mod, name):
    value = mod
    for part in name.split("."):
        value = getattr(value, part)
    return value


@pytest.mark.parametrize("port,ref,name", CONSTANTS,
                         ids=[f"{p.__name__.rsplit('.', 1)[1]}.{n}"
                              for p, _, n in CONSTANTS])
def test_constants_equal_reference(port, ref, name):
    assert _plain(_get(port, name)) == _plain(_get(ref, name))


# --- each section's smoke run against the reference's ----------------------

def test_fig3_smoke_rows_equal_reference(capsys):
    rows = fig3.run(n_samples=64)
    assert _names_and_values(rows) == _names_and_values(
        ref_fig3.run(n_samples=64))
    fig3.smoke()
    assert len(capsys.readouterr().out.splitlines()) == len(rows)


def test_dse_smoke_rows_equal_reference():
    kw = dict(queue_depths=(2, 4), queue_latencies=(1,), unrolls=(4,),
              n_samples=16, kernels=["expf", "dequant_dot"], workers=1)
    rows = dse.run(**kw)
    assert rows and _names_and_values(rows) == _names_and_values(
        ref_dse.run(**kw))


SWEEPS = {
    "sweep_perf": (
        lambda out: sweep_perf.run(grid_kw=sweep_perf.SMOKE_GRID,
                                   out_path=out),
        lambda out: ref_sweep_perf.run(grid_kw=ref_sweep_perf.SMOKE_GRID,
                                       out_path=out)),
    "sweep_scale": (
        lambda out: sweep_scale.run(
            throughput_grid=sweep_scale.SMOKE_THROUGHPUT_GRID,
            adaptive_grid=sweep_scale.SMOKE_ADAPTIVE_GRID,
            slice_stride=sweep_scale.SMOKE_SLICE_STRIDE, repeats=1,
            gate=False, out_path=out)[0],
        lambda out: ref_sweep_scale.run(
            throughput_grid=ref_sweep_scale.SMOKE_THROUGHPUT_GRID,
            adaptive_grid=ref_sweep_scale.SMOKE_ADAPTIVE_GRID,
            slice_stride=ref_sweep_scale.SMOKE_SLICE_STRIDE, repeats=1,
            gate=False, out_path=out)[0]),
    "cluster_sweep_scale": (
        lambda out: cluster_sweep_scale.run(
            gate_grids=cluster_sweep_scale.SMOKE_GATE_GRIDS,
            banked_grid=cluster_sweep_scale.SMOKE_BANKED_GRID, repeats=1,
            gate=False, out_path=out)[0],
        lambda out: ref_css.run(
            gate_grids=ref_css.SMOKE_GATE_GRIDS,
            banked_grid=ref_css.SMOKE_BANKED_GRID, repeats=1, gate=False,
            out_path=out)[0]),
}


@pytest.mark.parametrize("section", sorted(SWEEPS))
def test_sweep_smoke_equals_reference(section, tmp_path):
    """Row names equal; every artifact field but the host clock's equal
    with ``==`` (grids, point counts, cycle totals, record identity, the
    adaptive search's counts and the slice's fronts); the clock's fields
    finite and positive."""
    port_run, ref_run = SWEEPS[section]
    rows = port_run(str(tmp_path / "port.json"))
    want = ref_run(str(tmp_path / "ref.json"))
    assert [n for n, _, _ in rows] == [n for n, _, _ in want]
    port_wall, ref_wall = [], []
    assert _split_wall(_load(tmp_path / "port.json"), port_wall) == \
        _split_wall(_load(tmp_path / "ref.json"), ref_wall)
    assert len(port_wall) == len(ref_wall) > 0
    assert all(math.isfinite(v) and v > 0 for v in port_wall)
    assert all(math.isfinite(us) and us >= 0 and math.isfinite(d)
               for _, us, d in rows)


def test_calibration_smoke_equals_reference(tmp_path):
    """The report (selected points, defaults, gains, front sizes and
    rationales) and the rows equal the reference's; the smoke writes its
    artifacts to its own directory, never the live table."""
    kw = dict(kernels=["expf", "dequant_dot"],
              grid_kw=dict(queue_depths=(1, 2, 4), queue_latencies=(1,),
                           unrolls=(4, 8), n_samples=16), workers=1)
    rows = calibration.run(out_path=str(tmp_path / "port.json"),
                           artifact_dir=str(tmp_path / "port_cal"), **kw)
    want = ref_calibration.run(out_path=str(tmp_path / "ref.json"),
                               artifact_dir=str(tmp_path / "ref_cal"), **kw)
    assert _names_and_values(rows) == _names_and_values(want)
    assert _load(tmp_path / "port.json") == _load(tmp_path / "ref.json")
    assert sorted(os.listdir(tmp_path / "port_cal")) == sorted(
        os.listdir(tmp_path / "ref_cal"))
    assert os.path.basename(calibration.SMOKE_ARTIFACT_DIR) == \
        "calibration_port_smoke"


@pytest.mark.parametrize("section", ["fig3", "dse", "sweep_perf",
                                     "sweep_scale", "cluster_sweep_scale",
                                     "calibration"])
def test_smoke_prints_rows_and_writes_port_artifacts(section, tmp_path,
                                                     capsys):
    """``smoke()`` runs its gates, prints ``name,us_per_call,derived``
    rows and writes nothing but its ``BENCH_port_*`` files (here under the
    test's directory)."""
    mod = {"fig3": fig3, "dse": dse, "sweep_perf": sweep_perf,
           "sweep_scale": sweep_scale,
           "cluster_sweep_scale": cluster_sweep_scale,
           "calibration": calibration}[section]
    mod.smoke()
    rows = [line for line in capsys.readouterr().out.splitlines()
            if not line.startswith("#")]
    assert rows and all(len(line.split(",")) == 3 for line in rows)
    written = sorted(os.listdir(tmp_path / "port_artifacts")) if \
        os.path.exists(tmp_path / "port_artifacts") else []
    assert all(name.startswith("BENCH_port_")
               or name == "calibration_port_smoke" for name in written)
    if section in ("fig3", "dse"):
        assert written == []


# --- the gates are hard ------------------------------------------------------

def _fake_throughput(speedup, n_points):
    return {"n_points": n_points, "speedup_cached": speedup,
            "speedup_uncached": speedup, "modes": {}}


@pytest.mark.parametrize("mod,n_points,match", [
    (sweep_scale, 2880, "batch engine speedup gate"),
    (cluster_sweep_scale, 1128, "batch cluster engine speedup gate"),
    (cluster_sweep_scale, 999, "1000-point contract"),
], ids=["sweep_scale", "cluster_sweep_scale", "cluster_sweep_scale_points"])
def test_sweep_speedup_gate_is_hard(mod, n_points, match, monkeypatch,
                                    tmp_path):
    """With the gate on, a speedup under ``SPEEDUP_GATE`` (or a grid under
    the point contract) raises; the measurement is replaced, not timed."""
    monkeypatch.setattr(mod, "measure_throughput",
                        lambda *a, **k: _fake_throughput(
                            mod.SPEEDUP_GATE * 0.5, n_points))
    with pytest.raises(AssertionError, match=match):
        mod.run(gate=True, out_path=str(tmp_path / "gate.json"))


def test_fig3_band_is_hard(monkeypatch):
    monkeypatch.setattr(fig3, "run", lambda n_samples=512: [
        ("claims_peak_ipc_v2", 0.0, 2.5)])
    with pytest.raises(AssertionError, match="peak IPC out of band"):
        fig3.smoke()


def test_dse_equivalence_gate_is_hard(monkeypatch):
    """A swept record that diverged from the interpreter fails the
    section."""
    real = dse.run_sweep

    def diverged(pts, workers=None):
        recs = real(pts, workers=workers)
        recs[0].equivalent = False
        return recs
    monkeypatch.setattr(dse, "run_sweep", diverged)
    with pytest.raises(AssertionError, match="diverged from the baseline"):
        dse.run(queue_depths=(2,), queue_latencies=(1,), unrolls=(4,),
                n_samples=16, kernels=["expf"], workers=1)


def test_calibration_never_dominated_gate_is_hard(monkeypatch, tmp_path):
    monkeypatch.setattr(calibration, "never_dominated_by",
                        lambda rec, pt: False)
    with pytest.raises(AssertionError, match="dominates the calibrated"):
        calibration.run(kernels=["expf"],
                        grid_kw=dict(queue_depths=(2,), queue_latencies=(1,),
                                     unrolls=(4,), n_samples=16),
                        workers=1, out_path=str(tmp_path / "c.json"),
                        artifact_dir=str(tmp_path / "cal"))


# --- report ------------------------------------------------------------------

@pytest.fixture(scope="module")
def dryrun_cells(tmp_path_factory):
    """phi3-mini-3.8b's decode_32k cell counted by the port's dry run:
    its analysis cell and its deploy cell on both meshes."""
    out = tmp_path_factory.mktemp("dryrun_port")
    for multi_pod, analysis in ((False, True), (False, False),
                                (True, False)):
        dryrun.run_cell("phi3-mini-3.8b", "decode_32k", multi_pod,
                        analysis=analysis, out_dir=str(out))
    return str(out)


def test_report_renders_the_port_cells(dryrun_cells, tmp_path, capsys,
                                       monkeypatch):
    """The reference's rows over the port's cells (its cell rows with the
    step-vs-baseline column left out), the baseline table's one line, and
    the H100's 80 GB where the reference names v5e's 16 GB."""
    text = report.render(dryrun_cells)
    cells = report.load("analysis", art_dir=dryrun_cells)
    (arch, shape), a = next(iter(cells.items()))
    r = a["roofline"]
    assert (f"| {arch} | {shape} | {r['t_compute']:.2e} | "
            f"{r['t_memory']:.2e} | {r['t_collective']:.2e} | "
            f"{r['bottleneck']} | {r['useful_flops_ratio']:.3f} | "
            f"{r['mfu']:.4f} |") in text.splitlines()
    deploy = [line for line in text.splitlines()
              if line.startswith(f"| {arch} | {shape} | ")]
    assert len(deploy) == 2
    assert "H100 HBM = 80 GB" in text and "16 GB" not in text
    assert "v5e" not in text
    assert "`artifacts/dryrun_baseline`" in text
    assert text.startswith(ref_report.MARKER)
    out = tmp_path / "tables.md"
    monkeypatch.setattr(report, "ART_DIR", dryrun_cells)
    report.main(["--out", str(out)])
    assert out.read_text() == text + "\n"
    report.main([])
    assert text in capsys.readouterr().out
