"""The port's benchmark artifacts redirected into a test's ``tmp_path``.

Every module of ``repro_torch.benchmarks`` names its default outputs in
module-level ``*_PATH`` / ``*_DIR`` strings under
``repro_torch.benchmarks.ART_DIR`` (and ``kernel_bench.OUT_PATHS``).
:func:`redirect` moves each of them under a directory of the test's, so
no port test writes ``artifacts/``, where the reference's benchmark and
its tests write and read their own files.
"""
import importlib
import os

#: every module of the port's benchmark package
MODULES = ("bench_diff", "calibration", "cluster_pipeline", "cluster_scaling",
           "cluster_sweep_scale", "collective_policy", "dse", "fig3",
           "front_diff", "kernel_bench", "report", "roofline_table", "run",
           "serve_slo", "sweep_perf", "sweep_scale")


def port_modules():
    return [importlib.import_module(f"repro_torch.benchmarks.{name}")
            for name in MODULES]


def default_outputs():
    """(module, attribute, path) of every default output the port's
    benchmark modules name."""
    from repro_torch.benchmarks import ART_DIR
    out = []
    for mod in port_modules():
        for attr, value in vars(mod).items():
            if (attr.endswith(("_PATH", "_DIR")) and isinstance(value, str)
                    and os.path.abspath(value).startswith(
                        os.path.abspath(ART_DIR) + os.sep)):
                out.append((mod, attr, value))
        for key, value in getattr(mod, "OUT_PATHS", {}).items():
            out.append((mod, ("OUT_PATHS", key), value))
    return out


def redirect(monkeypatch, directory) -> None:
    """Every default output of :func:`default_outputs` moved under
    ``directory``, its file name kept."""
    for mod, attr, path in default_outputs():
        new = os.path.join(str(directory), os.path.basename(path))
        if isinstance(attr, tuple):
            monkeypatch.setitem(getattr(mod, attr[0]), attr[1], new)
        else:
            monkeypatch.setattr(mod, attr, new)
