"""The manifest (``BENCHMARK.json``) and the data files it names: the
contract's names, units and limits, every per-layer metric reported where
it says, every part found by name."""
import json
import re

import pytest

from portbench.bench import kinds, manifest, readers
from portbench.reference import family
from portbench.bench.env import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return manifest.load_manifest()


def test_top_level_keys_and_size(bench):
    assert set(bench) == TOP
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= bench["run_seconds"] <= 51
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= len(bench["command"]) <= 32
    for word in bench["command"]:
        assert 1 <= len(word) <= 200 and not word.startswith("/")
        assert ".." not in word.split("/")
    for p in bench["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert (ROOT / p).is_dir()


def test_names_and_units(bench):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    for group in ("configs", "workloads"):
        got = [n for g, n in names if g == group]
        assert len(got) == len(set(got))
    metrics = [n for g, n in names if g in ("end_to_end", "per_layer")]
    assert len(metrics) == len(set(metrics))


def test_cells(bench):
    configs = {c["name"] for c in bench["configs"]}
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = manifest.load_cell(w["name"], bench)
        assert kinds.load(cell.traffic["kind"])
        assert check_limits(cell.check)
    assert {w["config"] for w in bench["workloads"]} == configs


def check_limits(check):
    limits = {k: v["limit"] for k, v in check.items() if isinstance(v, dict)}
    return limits and all(isinstance(v, (int, float)) for v in
                          limits.values())


def test_configs(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"]
        assert data["reduced"] == c["reduced"]
        assert all(key in data for key in c["reduced"]), c["reduced"]
        fam = family(data)
        for part in ("layout", "products", "token_flops", "pair_flops",
                     "logits_at"):
            assert callable(getattr(fam, part)), (data["reference"], part)
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))


def test_configs_are_the_programs():
    """Each configuration file's sizes are the program's registry entry
    for its arch: no width cut."""
    from portbench.bench.serving import port_config
    for c in manifest.load_manifest()["configs"]:
        port_config(json.loads((ROOT / c["file"]).read_text()))


def test_end_to_end(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = [w["name"] for w in bench["workloads"]]
    for cell in cells:
        reported = [n for n, m in e2e.items()
                    if cell in m.get("workloads", cells)]
        assert "setup_s" in reported and len(reported) >= 2


def test_per_layer_moves_reported(bench):
    """Every per-layer metric moves an end-to-end metric that each cell it
    lists reports, and has a reader; every cell has one."""
    cells = [w["name"] for w in bench["workloads"]]
    e2e = {m["name"]: m.get("workloads", cells) for m in bench["end_to_end"]}
    layers = {}
    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]], (m["name"], cell)
        assert readers.reader_path(m["name"]).exists(), m["name"]
        layers.setdefault(m["layer"], []).append(m["name"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        assert any(cell in m["workloads"] for m in bench["per_layer"])
