"""What the benchmark may load: no module of ``portbench`` imports JAX or
the JAX package (top-level names compared whole: ``repro_torch`` is not
``repro``), nor the repo's ``benchmarks`` or the program's; the plain
reference imports nothing of the program; and the command refuses to
measure where it cannot."""
import ast
import os
import shutil
import subprocess
import sys

import pytest

from portbench.bench.env import FORBIDDEN, PORTBENCH, ROOT

MODULES = sorted(p for p in PORTBENCH.rglob("*.py")
                 if "__pycache__" not in p.parts)


def imported(path):
    """Top-level names of every module ``path`` imports (relative imports
    resolved to ``portbench``)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            out.add("portbench" if node.level else node.module)
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            out.add(node.args[0].value)
    return out


@pytest.mark.parametrize("path", MODULES,
                         ids=[str(p.relative_to(ROOT)) for p in MODULES])
def test_no_jax_no_benchmarks(path):
    for name in imported(path):
        top = name.split(".", 1)[0]
        assert top not in FORBIDDEN, (path, name)
        assert top != "benchmarks", (path, name)
        assert not name.startswith("repro_torch.benchmarks"), (path, name)


def test_forbidden_compares_whole_names():
    assert "repro" in FORBIDDEN and "repro_torch" not in FORBIDDEN
    from portbench.bench.env import forbidden_loaded
    sys.modules.setdefault("repro_torch_like_name", sys)
    assert "repro_torch_like_name" not in forbidden_loaded()


def test_reference_is_plain():
    for path in (PORTBENCH / "reference").glob("*.py"):
        for name in imported(path):
            top = name.split(".", 1)[0]
            assert top in ("torch", "math", "typing", "__future__",
                           "importlib", "types", "portbench"), (path, name)
            if top == "portbench":
                assert name in ("portbench", "portbench.reference"), name


def _run(cwd, *extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "phi3-chat-poisson", "--seed", "2147483999", "--seconds", "1",
         "--trace", "0", *extra], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300)


def test_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for a machine "
                    "without one")
    proc = _run(ROOT)
    assert proc.returncode != 0 and proc.stdout == ""


def test_refuses_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, the command exits non-zero and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(PORTBENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path)
    assert proc.returncode != 0 and proc.stdout == ""
