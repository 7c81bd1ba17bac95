"""End-to-end driver: train a ~100M-parameter LM for a few hundred steps
through the full stack — fault-tolerant trainer, async checkpointing,
straggler monitor — on the card unless ``--device cpu`` is given.

The ``100m`` preset trains a phi3-style model (the reference's "train
~100M for a few hundred steps" deliverable, 65.0 M parameters by
``ModelConfig.n_params()``); on the CPU use ``--preset small`` (8.1 M)
for a quick demonstration.

  PYTHONPATH=src python -m repro_torch.examples.train_lm --preset small \\
      --steps 20 --device cpu
  PYTHONPATH=src python -m repro_torch.examples.train_lm --preset 100m \\
      --steps 300

The port's counterpart of the JAX package's ``examples/train_lm.py``: the
same presets, lr and checkpoint cadence, fp32.  The port's trainer takes
a device where the reference's takes a mesh factory, so no mesh and no
process group is made.  Weights are random, drawn from seed 0;
checkpoints go to ``--ckpt-dir`` (default: a directory under the system's
temporary directory).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Any, Dict, List, Optional

import torch

from ..config import ModelConfig, RunConfig, ShapeConfig
from ..device import DeviceLike, resolve_device
from ..models import init_model_params
from ..runtime import FaultTolerantTrainer

PRESETS = {
    # quick CPU demo
    "small": dict(n_layers=4, d_model=256, n_heads=8, n_kv_heads=4,
                  d_ff=1024, vocab=8192, seq=256, batch=8),
    # the "train ~100M for a few hundred steps" deliverable
    "100m": dict(n_layers=8, d_model=512, n_heads=8, n_kv_heads=4,
                 d_ff=2048, vocab=32768, seq=512, batch=8),
}


def model_config(preset: str) -> ModelConfig:
    p = PRESETS[preset]
    return ModelConfig(name=f"lm-{preset}", family="dense",
                       n_layers=p["n_layers"], d_model=p["d_model"],
                       n_heads=p["n_heads"], n_kv_heads=p["n_kv_heads"],
                       d_ff=p["d_ff"], vocab=p["vocab"])


def run(preset: str = "small", steps: int = 200, lr: float = 1e-3,
        ckpt_dir: Optional[str] = None,
        device: DeviceLike = None) -> Dict[str, Any]:
    """Train ``preset`` for ``steps`` steps; raises unless the mean loss
    of the last tenth of the steps is below the first tenth's.  Returns
    the trainer's output, the wall time and the two mean losses."""
    dev = resolve_device(device)
    p = PRESETS[preset]
    cfg = model_config(preset)
    print(f"model: {cfg.n_params()/1e6:.1f}M params")
    rc = RunConfig(dtype="float32", param_dtype="float32", remat=False,
                   lr=lr, warmup_steps=steps // 20 + 1, total_steps=steps)
    shape = ShapeConfig("train", p["seq"], p["batch"], "train")
    params = init_model_params(0, cfg, device=dev)
    ckpt_dir = ckpt_dir or os.path.join(tempfile.gettempdir(),
                                        "repro_torch_train_lm")

    trainer = FaultTolerantTrainer(cfg, shape, rc, dev, ckpt_dir,
                                   ckpt_every=50)
    t0 = time.time()
    out = trainer.run(params, num_steps=steps)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    trainer.ckpt.close()
    losses = [l for _, l in out["metrics"]]
    k = max(len(losses) // 10, 1)
    tok = p["seq"] * p["batch"] * steps
    first, last = sum(losses[:k]) / k, sum(losses[-k:]) / k
    print(f"{steps} steps / {tok/1e6:.2f}M tokens in {dt:.0f}s")
    print(f"loss: {first:.4f} -> {last:.4f}")
    if not last < first:
        raise AssertionError("loss did not improve")
    return {**out, "wall_s": dt, "tokens": tok, "first": first,
            "last": last, "params_count": cfg.n_params()}


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description="Train a ~100M-parameter LM "
                                             "through the full stack")
    ap.add_argument("--preset", default="small", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    return run(args.preset, args.steps, args.lr, args.ckpt_dir, args.device)


if __name__ == "__main__":
    main()
