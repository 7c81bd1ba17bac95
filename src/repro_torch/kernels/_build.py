"""Build and load the hand-written CUDA kernels.

Each kernel's source is one ``.cu`` file with a plain C interface
(``kernels/<package>/csrc/<name>.cu``, the package named as the kernel but
for a second source of one package, :data:`PACKAGE`), which may include the
shared headers under ``kernels/_csrc/``.  It is compiled with ``nvcc`` for
``sm_90a`` into a shared library under ``build/kernels/`` at the root of
the checkout, at first use, and loaded with :mod:`ctypes`.  The library's
name carries a hash of the source, of every ``.cuh`` header of the
package and of the flags, so an edited source or header is rebuilt and a
stale library is never loaded.  :func:`build_all` starts one ``nvcc`` per
source at once, which is how ``chip_smoke.py`` builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

KERNELS_DIR = Path(__file__).resolve().parent
REPO_ROOT = KERNELS_DIR.parents[2]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: the package of a kernel whose source sits beside another kernel's
PACKAGE = {"flash_attention_bwd": "flash_attention",
           "ssm_scan_bwd": "ssm_scan"}

_LOADED: Dict[str, ctypes.CDLL] = {}


def source_path(name: str) -> Path:
    return KERNELS_DIR / PACKAGE.get(name, name) / "csrc" / f"{name}.cu"


def nvcc_path() -> str:
    """``nvcc`` from ``CUDA_HOME``, ``/usr/local/cuda`` or ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256(source_path(name).read_bytes())
    for header in sorted(KERNELS_DIR.rglob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str) -> Tuple[Path, Path, subprocess.Popen]:
    lib = library_path(name)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source_path(name))]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return lib, tmp, proc


def build_all(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named kernel that has no current library, all ``nvcc``
    processes at once.  Returns ``{name: compiler output}`` for the kernels
    built now (``-Xptxas -v`` prints registers, shared memory and spills);
    raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs: List[Tuple[str, Path, Path, subprocess.Popen]] = []
    for name in names:
        if not library_path(name).exists():
            jobs.append((name, *_start(name)))
    logs: Dict[str, str] = {}
    failed = []
    for name, lib, tmp, proc in jobs:
        out, _ = proc.communicate()
        logs[name] = out
        (BUILD_DIR / f"{name}.log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build_all([name])
        lib = _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return lib
