"""The benchmark's manifest (``BENCHMARK.json`` at the checkout's root) and
the data files it names: a cell's configuration
(``portbench/configs/<config>.json``), its traffic mix
(``portbench/traffic/<traffic>.json``) and its correctness limits
(``portbench/checks/<cell>.json``).  Everything is found by name, so a
new cell is new files and entries, never an edit."""
from __future__ import annotations

import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Optional

from .env import PORTBENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclass
class Cell:
    name: str
    workload: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    check: Dict[str, Any]
    end_to_end: list
    per_layer: list


def load_manifest(root: Path = ROOT) -> Dict[str, Any]:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _load(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def config_path(config: Dict[str, Any]) -> Path:
    return ROOT / config["file"]


def load_cell(name: str, manifest: Optional[Dict[str, Any]] = None) -> Cell:
    """The cell ``name`` of the manifest with its data files loaded, and
    the metrics it reports: the end-to-end ones without a ``workloads`` key
    or listing it, the per-layer ones likewise."""
    manifest = manifest or load_manifest()
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; the manifest has "
                         f"{sorted(cells)}")
    work = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = _load(config_path(configs[work["config"]]))
    traffic = _load(PORTBENCH / "traffic" / f"{work['traffic']}.json")
    check = _load(PORTBENCH / "checks" / f"{name}.json")

    def mine(m):
        return name in m.get("workloads", [name])
    return Cell(name, work, config, traffic, check,
                [m for m in manifest["end_to_end"] if mine(m)],
                [m for m in manifest["per_layer"] if mine(m)])
