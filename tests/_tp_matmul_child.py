"""Child of ``tests/test_torch_collective.py``: ``tp_matmul`` on 8 gloo
processes of the CPU over a 2 x 4 ``(data, model)`` mesh.

  python tests/_tp_matmul_child.py PORT

Rank 0 prints one JSON line: per policy, the largest distance from the
one-device ``x @ w``, the collectives ``CommDebugMode`` saw and the
port's records, whether ring and bulk gave the same bits, and the
sharding rules resolved on the ``DeviceMesh`` against its
``AbstractMesh`` with one leaf placed by :func:`to_placements`."""
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

WORLD = 8


def worker(rank: int, port: int) -> None:
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    from repro_torch.config import RunConfig
    from repro_torch.configs import get_reduced
    from repro_torch.distributed.sharding import param_pspecs, to_placements
    from repro_torch.launch.mesh import AbstractMesh
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.core.policy import ExecutionPolicy as EP
    from repro_torch.distributed.collective_matmul import (
        collective_bytes_estimate, recording, tp_matmul)
    from repro_torch.launch.mesh import make_local_mesh
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=WORLD, rank=rank)
    try:
        mesh = make_local_mesh(2, 4, device="cpu")
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.standard_normal((64, 32), np.float32))
        w = torch.from_numpy(rng.standard_normal((32, 48), np.float32))
        ref = x @ w
        n = mesh.size(1)
        i = mesh.get_local_rank("model")
        # DTensors made from local shards, so no collective precedes the
        # product inside the counted block
        xd = DTensor.from_local(x.chunk(n)[i], mesh, (Replicate(), Shard(0)),
                                run_check=False)
        wd = DTensor.from_local(w.chunk(n, dim=1)[i], mesh,
                                (Replicate(), Shard(1)), run_check=False)
        out = {}
        for pol in (EP.COPIFT, EP.COPIFTV2):
            with CommDebugMode() as comm, recording() as recs:
                y = tp_matmul(xd, wd, mesh, policy=pol)
            full = y.full_tensor()
            out[pol.value] = {
                "err": float((full - ref).abs().max()),
                "full": full.tolist(),
                "comm": {str(k): v for k, v in
                         comm.get_comm_counts().items()},
                "records": recs,
                "placements": [repr(p) for p in y.placements]}
        out["estimate"] = collective_bytes_estimate(64, 32, n, 4)
        # the rules resolve on the DeviceMesh as on its AbstractMesh, and
        # their specs place a tensor where DTensor puts it
        cfg = get_reduced("phi3-mini-3.8b")
        specs = param_pspecs(cfg, mesh, RunConfig(fsdp=True))
        out["same_specs"] = specs == param_pspecs(
            cfg, AbstractMesh(("data", "model"), (2, 4)), RunConfig(fsdp=True))
        spec = specs["blocks"]["attn"]["wq"]
        full = torch.arange(2 * 64 * 8 * 4, dtype=torch.float32).reshape(
            2, 64, 8, 4)
        placed = distribute_tensor(full, mesh, to_placements(spec, mesh))
        out["wq"] = {"spec": list(spec),
                     "placements": [repr(p) for p in placed.placements],
                     "local": list(placed.to_local().shape),
                     "round_trip": bool(torch.equal(placed.full_tensor(),
                                                    full))}
        out["bit_equal"] = out["copift"]["full"] == out["copiftv2"]["full"]
        for pol in ("copift", "copiftv2"):
            del out[pol]["full"]
        if rank == 0:
            print(json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(worker, args=(int(sys.argv[1]),), nprocs=WORLD, join=True)
