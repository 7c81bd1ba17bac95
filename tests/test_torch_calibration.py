"""The port's calibration path against the JAX package's, on the CPU, with
exact equality: the same grid calibrates to the same artifacts (apart from
their provenance, which carries ``git describe`` and a timestamp), each
package loads the other's artifacts and resolves the same operating point
for every workload x traffic level x latency class, a stale artifact warns
and falls back in both, the scheduler's step costs come from the port's
own machine model and equal the reference's on every point tried, the
port's ``explore`` CLI writes the reference CLI's files, and a reduced
phi3 engine in measured-traffic mode on a calibrated table gives the JAX
engine's report, timestamps and traffic history.  Every test runs against
a calibration directory under its own ``tmp_path``."""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from _calibration_isolation import isolated_calibration  # noqa: F401

import jax
import numpy as np

from repro.config import RunConfig as JRC
from repro.configs import get_reduced as jax_reduced
from repro.core import calibrate as jax_calibrate
from repro.core import clear_policy_table_cache as jax_clear
from repro.core import default_table as jax_default_table
from repro.core.calibrate import SCHEMA_VERSION as JAX_SCHEMA_VERSION
from repro.core.policy import ExecutionPolicy as JEP
from repro.core.policy import OperatingPoint as JOP
from repro.core.policy import PolicyTable as JPolicyTable
from repro.models import init_model_params as jax_init_params
from repro.serve import ServeEngine as JaxEngine
from repro.serve import ServeSLO as JSLO
from repro.serve import StepCostModel as JStepCostModel
from repro_torch import bridge
from repro_torch.config import RunConfig
from repro_torch.configs import get_reduced
from repro_torch.core import calibrate, clear_policy_table_cache, default_table
from repro_torch.core.calibrate import SCHEMA_VERSION, calibration_dir
from repro_torch.core.policy import (TRAFFIC_LEVELS, WORKLOAD_PROXIES,
                                     ExecutionPolicy, OperatingPoint,
                                     PolicyTable)
from repro_torch.examples import explore
from repro_torch.kernels.moe_gemm import ops as mg_ops
from repro_torch.kernels.queue_matmul import ops as qm_ops
from repro_torch.serve import ServeEngine, ServeSLO, StepCostModel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "phi3-mini-3.8b"

#: the smoke grid ``chip_smoke.py``'s policy phase calibrates on the card's
#: host, and a wider one with two latency classes and the serve-slo
#: objective
GRIDS = {
    "smoke": dict(kernels=["dequant_dot", "expf"], grid_kw=dict(
        queue_depths=(1, 2), queue_latencies=(1,), unrolls=(4, 8),
        n_samples=16)),
    "latency-classes": dict(kernels=["dequant_dot", "expf", "histf"],
                            objective="serve-slo", grid_kw=dict(
                                queue_depths=(1, 2, 4, 8),
                                queue_latencies=(1, 2), unrolls=(4, 8),
                                n_samples=16)),
}
#: every workload the table resolves (a name outside the proxy table too)
WORKLOADS = sorted(WORKLOAD_PROXIES) + ["other"]


def _calibrate_both(tmp_path, grid_name):
    """Calibrate ``GRIDS[grid_name]`` through both packages, in-process,
    into ``tmp_path/jax`` and ``tmp_path/port``."""
    kw = GRIDS[grid_name]
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jax_calibrate(workers=1, out_dir=str(jdir), **kw)
    calibrate(workers=1, out_dir=str(tdir), **kw)
    return jdir, tdir


def _artifacts(directory):
    """Every artifact in ``directory``, its provenance removed."""
    out = {}
    for name in sorted(os.listdir(directory)):
        with open(directory / name) as f:
            d = json.load(f)
        assert set(d["provenance"]) == {"git", "created", "engine",
                                        "n_points", "n_ok", "search"}
        d.pop("provenance")
        out[name] = d
    return out


def _point(op):
    """An operating point as plain data (the enums compared by value)."""
    d = dataclasses.asdict(op)
    d["policy"] = op.policy.value
    return d


def _resolutions(table):
    return {(w, t, lat): _point(table.resolve(w, traffic=t,
                                              queue_latency=lat))
            for w in WORKLOADS for t in (None, *TRAFFIC_LEVELS)
            for lat in (None, 1, 2, 4)}


# --- artifacts and their resolution -------------------------------------------

@pytest.mark.parametrize("grid_name", sorted(GRIDS))
def test_calibration_artifacts_equal_the_reference(tmp_path, grid_name):
    jdir, tdir = _calibrate_both(tmp_path, grid_name)
    port = _artifacts(tdir)
    assert sorted(port) == [f"{k}.json" for k in GRIDS[grid_name]["kernels"]]
    assert port == _artifacts(jdir)
    assert SCHEMA_VERSION == JAX_SCHEMA_VERSION


@pytest.mark.parametrize("grid_name", sorted(GRIDS))
def test_each_package_resolves_the_others_artifacts(tmp_path, grid_name):
    """Every workload x traffic level x latency class, through either
    package's table over either package's artifacts."""
    jdir, tdir = _calibrate_both(tmp_path, grid_name)
    want = _resolutions(JPolicyTable.load(str(jdir)))
    assert {p["source"] for p in want.values()} == {"calibrated", "default"}
    for directory in (jdir, tdir):
        assert _resolutions(PolicyTable.load(str(directory))) == want
        assert _resolutions(JPolicyTable.load(str(directory))) == want


def test_default_table_reads_the_calibration_directory(
        tmp_path, monkeypatch, isolated_calibration):
    """``REPRO_CALIBRATION_DIR`` steers both packages' default tables, one
    cached table per directory, and the kernels' wrappers take their
    points from it."""
    assert calibration_dir() == str(isolated_calibration)
    assert default_table().entries == {}
    assert qm_ops.operating_point() == OperatingPoint()
    calibrate(workers=1, out_dir=str(isolated_calibration),
              **GRIDS["smoke"])
    assert default_table().entries == {}          # cached until cleared
    clear_policy_table_cache()
    jax_clear()
    table = default_table()
    assert table is default_table()
    assert table.directory == str(isolated_calibration)
    assert _resolutions(table) == _resolutions(jax_default_table())
    op = qm_ops.operating_point()
    assert op.source == "calibrated" and op.effective_depths() != (4, 4)
    assert mg_ops.operating_point() == op
    monkeypatch.setenv("REPRO_CALIBRATION_DIR", str(tmp_path / "elsewhere"))
    assert default_table().entries == {}


def test_stale_artifacts_warn_and_fall_back_in_both(tmp_path):
    jdir, tdir = _calibrate_both(tmp_path, "smoke")
    for directory in (jdir, tdir):
        path = directory / "dequant_dot.json"
        d = json.loads(path.read_text())
        d["schema_version"] = SCHEMA_VERSION + 1
        path.write_text(json.dumps(d))
        for table_cls in (PolicyTable, JPolicyTable):
            with pytest.warns(UserWarning, match="stale"):
                table = table_cls.load(str(directory))
            # the stale kernel's workloads fall back to the defaults, the
            # other kernel's stays calibrated
            for w in ("queue_matmul", "moe_gemm", "train"):
                assert _point(table.resolve(w)) == _point(OperatingPoint())
            assert table.resolve("serve").source == "calibrated"


# --- step costs from the port's machine model ---------------------------------

def _calibrated_serve_point(tmp_path):
    calibrate(workers=1, out_dir=str(tmp_path), **GRIDS["smoke"])
    op = PolicyTable.load(str(tmp_path)).resolve("serve", traffic="high")
    assert op.source == "calibrated"
    return op


@pytest.mark.parametrize("case", ["none", "default", "depth-2",
                                  "rejected-geometry", "calibrated",
                                  "pinned-copift"])
def test_step_costs_equal_the_reference(tmp_path, case):
    """The port's ``StepCostModel.from_operating_point`` runs its own
    ``core.sweep.run_point`` and never raises: the candidate point, then
    the default point when the machine model rejects the candidate's
    geometry, then flat constants."""
    op = {"none": None, "default": OperatingPoint(),
          "depth-2": OperatingPoint(queue_depth=2),
          # three cores cannot split 32 samples: the model rejects it
          "rejected-geometry": OperatingPoint(n_cores=3, source="override"),
          "pinned-copift": OperatingPoint(policy=ExecutionPolicy.COPIFT,
                                          source="override"),
          }.get(case) if case != "calibrated" else \
        _calibrated_serve_point(tmp_path)
    jop = None if op is None else JOP(**{**dataclasses.asdict(op),
                                         "policy": JEP(op.policy.value)})
    got = StepCostModel.from_operating_point(op)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        JStepCostModel.from_operating_point(jop))
    assert got.source == {"none": "default", "rejected-geometry": "default",
                          }.get(case, "default" if op is None else op.source)
    assert got.cycles_decode_token > got.cycles_prefill_token > 0
    for workload in ("queue_matmul", "train"):
        assert dataclasses.asdict(StepCostModel.from_operating_point(
            op, workload=workload, n_samples=16)) == dataclasses.asdict(
            JStepCostModel.from_operating_point(jop, workload=workload,
                                                n_samples=16))


# --- the explore CLI ----------------------------------------------------------

SMOKE_ARGS = ["--kernels", "dequant_dot,expf", "--depths", "1,2",
              "--latencies", "1", "--unrolls", "4,8", "--n-samples", "16",
              "--workers", "1"]


def _reference_cli(args, cwd):
    return subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "explore.py"), *args],
        cwd=cwd, capture_output=True, text=True, check=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu"}).stdout


def _without_timing(out):
    skip = ("calibrated ", "  wall:", "  points/sec:", "  ms/config:",
            "wrote ")
    return [line for line in out.splitlines() if not line.startswith(skip)]


def test_explore_calibrate_writes_the_reference_artifacts(tmp_path, capsys):
    assert explore.main(["calibrate", *SMOKE_ARGS, "--out-dir",
                         str(tmp_path / "port")]) == 0
    out = capsys.readouterr().out
    ref = _reference_cli(["calibrate", *SMOKE_ARGS, "--out-dir",
                          str(tmp_path / "jax")], str(tmp_path))
    assert _without_timing(out) == _without_timing(ref)
    assert _artifacts(tmp_path / "port") == _artifacts(tmp_path / "jax")


def test_explore_sweep_writes_the_reference_csvs(tmp_path, capsys):
    args = ["--kernels", "expf,cluster_matmul", "--depths", "1,4",
            "--latencies", "1", "--unrolls", "4", "--n-samples", "16",
            "--workers", "1", "--cores", "1,2", "--banks", "inf,2",
            "--pipeline", "both"]
    assert explore.main([*args, "--out-dir", str(tmp_path / "port")]) == 0
    out = capsys.readouterr().out
    ref = _reference_cli([*args, "--out-dir", str(tmp_path / "jax")],
                         str(tmp_path))
    assert _without_timing(out) == _without_timing(ref)
    assert "match the baseline interpreter bit-for-bit" in out
    for name in ("sweep.csv", "pareto.csv"):
        assert (tmp_path / "port" / name).read_text() == \
            (tmp_path / "jax" / name).read_text()


# --- the calibrated serve path ------------------------------------------------

@pytest.mark.parametrize("grid_name", sorted(GRIDS))
def test_calibrated_measured_traffic_engine_matches_jax(isolated_calibration,
                                                        grid_name):
    """Both engines on the same bridged weights, each package's default
    table over the port's artifacts, no pinned point or level: the same
    tokens, report, per-request timestamps and traffic retargets, each
    retarget to a calibrated point priced by the port's machine model."""
    calibrate(workers=1, out_dir=str(isolated_calibration),
              **GRIDS[grid_name])
    clear_policy_table_cache()
    jax_clear()
    cfg = jax_reduced(ARCH)
    pj = jax_init_params(jax.random.PRNGKey(0), cfg)
    pt = bridge.from_numpy_tree(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    rng = np.random.default_rng(9)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab, n)]
               for n in (3, 9, 5, 2, 7)]
    jeng = JaxEngine(pj, cfg, JRC(remat=False, dtype="float32"),
                     batch_slots=2, max_len=64, prefill_chunk=4)
    teng = ServeEngine(pt, get_reduced(ARCH),
                       RunConfig(remat=False, dtype="float32"),
                       batch_slots=2, max_len=64, prefill_chunk=4,
                       device="cpu")
    assert teng.operating_point.source == "calibrated"
    assert _point(teng.operating_point) == _point(jeng.operating_point)
    for p in prompts[:3]:
        jeng.submit(p, max_new=4)
        teng.submit(p, max_new=4)
    for _ in range(3):
        jeng.step()
        teng.step()
    for p in prompts[3:]:
        jeng.submit(p, max_new=3)
        teng.submit(p, max_new=3)
    dj, dt = jeng.run(), teng.run()
    assert sorted(dt) == sorted(dj) == list(range(5))
    for rid in dj:
        assert dt[rid].generated == dj[rid].generated, rid
        assert dataclasses.asdict(teng.sched.requests[rid]) == \
            dataclasses.asdict(jeng.sched.requests[rid]), rid
    report = teng.metrics(slo=ServeSLO(p99_cycles_per_token=200.0))
    assert report.to_dict() == jeng.metrics(
        slo=JSLO(p99_cycles_per_token=200.0)).to_dict()
    assert report.cost_source == "calibrated"
    assert teng.traffic_history == jeng.traffic_history
    assert teng.traffic_history
    table = PolicyTable.load(str(isolated_calibration))
    for h in teng.traffic_history:
        assert h["source"] == "calibrated"
        op = table.resolve("serve", traffic=h["level"])
        assert op.policy.value == h["policy"]
    # the last retarget's point prices the engine's steps
    assert dataclasses.asdict(teng._cost) == dataclasses.asdict(
        StepCostModel.from_operating_point(teng.operating_point))
