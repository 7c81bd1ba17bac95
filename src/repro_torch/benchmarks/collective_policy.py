"""Mesh-level policy experiment: bulk all-gather (COPIFT) against the
COPIFTv2 ring, ``tp_matmul`` on the reference's fp32 2048 x 1024 @
1024 x 2048.

  PYTHONPATH=src python -m repro_torch.benchmarks.collective_policy
  PYTHONPATH=src python -m repro_torch.benchmarks.collective_policy \\
      --device cpu

The processes run in a child (``python -m ... --child``), as the
reference runs its 8 host devices in a subprocess, so the caller never
holds a process group.  On the CPU the child spawns 8 gloo processes over
a 2 x 4 ``(data, model)`` mesh; on the card it is one NCCL rank over the
1 x 1 mesh, the only mesh one card has.  Each policy's result must be
within fp32 2e-4 (``allclose``, rtol = atol) of ``x @ w``, or the section
fails; a child that fails fails the section.

Rows ``collective_{policy}_us`` (mean of 5 calls: device time from CUDA
events on the card, the host clock on the CPU), ``_allgather_ops`` and
``_permute_ops``.  The op counts are the collectives
``collective_matmul.recording()`` saw issued in one call, where the
reference counts the ops in its compiled HLO text: its ring is one
``collective-permute`` in a loop body, the port's ring issues n - 1 sends.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
#: x (M, K) @ w (K, N), fp32, the reference's shape
M, K, N = 2048, 1024, 2048
TOL = 2e-4
REPS = 5
#: the mesh by device type: (data, model)
MESHES = {"cpu": (2, 4), "cuda": (1, 1)}

Row = Tuple[str, float, float]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(rank: int, world: int, port: int, device: str) -> None:
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from ..core.policy import ExecutionPolicy as EP
    from ..distributed.collective_matmul import recording, tp_matmul
    from ..launch.mesh import make_local_mesh
    from .timing import event_ms, host_us
    if device == "cuda":
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        torch.set_num_threads(1)           # 8 processes share the cores
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        data, model = MESHES[device]
        mesh = make_local_mesh(data, model, device=device)
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.standard_normal((M, K), np.float32)).to(
            device)
        w = torch.from_numpy(rng.standard_normal((K, N), np.float32)).to(
            device)
        ref = x @ w
        i = mesh.get_local_rank("model")
        # DTensors from local shards: no collective precedes the product
        xd = DTensor.from_local(x.chunk(model)[i], mesh,
                                (Replicate(), Shard(0)), run_check=False)
        wd = DTensor.from_local(w.chunk(model, dim=1)[i], mesh,
                                (Replicate(), Shard(1)), run_check=False)
        out = {}
        for pol in (EP.COPIFT, EP.COPIFTV2):
            with recording() as recs:
                y = tp_matmul(xd, wd, mesh, policy=pol)
            full = y.full_tensor()
            err = float((full - ref).abs().max())
            ok = bool(((full - ref).abs() <= TOL + TOL * ref.abs()).all())

            def call(p=pol):
                return tp_matmul(xd, wd, mesh, policy=p)
            if device == "cuda":
                us = event_ms(call, REPS) * 1e3
            else:
                us = host_us(call, REPS, barrier=dist.barrier)
            out[pol.value] = {
                "us": us, "max_abs_err": err, "within_tol": ok,
                "all_gather_ops": sum(k == "all-gather" for k, _ in recs),
                "permute_ops": sum(k == "collective-permute"
                                   for k, _ in recs),
                "records": recs}
        if rank == 0:
            print(json.dumps({"mesh": [data, model], "world": world,
                              "device": device, "policies": out}),
                  flush=True)
    finally:
        dist.destroy_process_group()


def _child(device: str, port: int) -> None:
    data, model = MESHES[device]
    world = data * model
    if world == 1:
        _worker(0, 1, port, device)
    else:
        import importlib
        import torch.multiprocessing as mp
        # by its package name, not ``__main__``, so each spawned process
        # imports it as a module
        mod = importlib.import_module(
            "repro_torch.benchmarks.collective_policy")
        mp.spawn(mod._worker, args=(world, port, device), nprocs=world,
                 join=True)


def measure(device: DeviceLike = None, timeout: float = 600.0) -> dict:
    """Run the child on ``device`` and return its report; raises if the
    child fails or a policy misses the tolerance."""
    dev = resolve_device(device)
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.collective_policy",
         "--child", "--device", dev.type, "--port", str(_free_port())],
        env=env, capture_output=True, text=True, timeout=timeout)
    if res.returncode != 0:
        raise RuntimeError(f"collective_policy child failed "
                           f"({res.returncode}):\n{res.stderr[-4000:]}")
    data = json.loads(res.stdout.strip().splitlines()[-1])
    for pol, d in data["policies"].items():
        if not d["within_tol"]:
            raise AssertionError(f"tp_matmul {pol}: max abs err "
                                 f"{d['max_abs_err']:.3e} beyond rtol = "
                                 f"atol = {TOL} of x @ w")
    return data


def rows(data: dict) -> List[Row]:
    """The reference's rows of a :func:`measure` report."""
    out = []
    for pol, d in data["policies"].items():
        out.append((f"collective_{pol}_us", d["us"], 0.0))
        out.append((f"collective_{pol}_allgather_ops", 0.0,
                    d["all_gather_ops"]))
        out.append((f"collective_{pol}_permute_ops", 0.0, d["permute_ops"]))
    return out


def run(device: DeviceLike = None) -> List[Row]:
    return rows(measure(device))


def main(argv: Optional[List[str]] = None) -> List[Row]:
    ap = argparse.ArgumentParser(description="Bulk against ring tp_matmul")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "8 gloo processes on the CPU)")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        _child(resolve_device(args.device).type, args.port)
        return []
    out = run(args.device)
    for name, us, derived in out:
        print(f"{name},{us:.1f},{derived:.4f}")
    return out


if __name__ == "__main__":
    main()
