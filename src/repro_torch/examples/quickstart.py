"""Quickstart: train a tiny assigned-architecture model for a few steps and
greedily decode from it — the public API in a few lines, on the card
unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--arch glm4-9b]
  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

The port's counterpart of the JAX package's ``examples/quickstart.py``:
the reduced config, fp32, lr 1e-2, the synthetic stream's 8 x 64 token
batches, then two decode slots.  Weights are random, drawn from seed 0.
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional

import torch

from ..config import ModelConfig, RunConfig
from ..configs import ARCHS, get_reduced
from ..data import SyntheticLMStream
from ..device import DeviceLike, resolve_device
from ..models import init_model_params
from ..optim import init_opt_state
from ..serve import ServeEngine
from ..train import train_step


def run(params: Dict[str, Any], cfg: ModelConfig, steps: int,
        device: DeviceLike = None) -> Dict[str, Optional[List]]:
    """Train ``params`` (on ``device``; updated in place) for ``steps``
    AdamW steps, then decode 8 tokens after ``[1, 2, 3, 4]`` when the
    config is causal.  Returns each step's loss and the generated tokens
    (``None`` for an encoder)."""
    dev = resolve_device(device)
    rc = RunConfig(dtype="float32", param_dtype="float32", remat=False,
                   lr=1e-2, warmup_steps=2, total_steps=steps)
    opt = init_opt_state(params)
    stream = SyntheticLMStream(cfg.vocab, seq_len=64, global_batch=8)
    losses = []
    for i in range(steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in stream.batch_at(i).items()}
        params, opt, metrics = train_step(params, opt, batch, cfg, rc)
        losses.append(float(metrics["loss"]))
        if i % 5 == 0 or i == steps - 1:
            print(f"step {i:>3}  loss={losses[-1]:.4f}  "
                  f"acc={float(metrics['accuracy']):.3f}")

    generated = None
    if cfg.causal:
        eng = ServeEngine(params, cfg, rc, batch_slots=2, max_len=64,
                          device=dev)
        rid = eng.submit([1, 2, 3, 4], max_new=8)
        generated = eng.run()[rid].generated
        print("generated:", generated)
    return {"losses": losses, "generated": generated}


def main(argv: Optional[List[str]] = None) -> Dict[str, Optional[List]]:
    ap = argparse.ArgumentParser(description="Train a reduced model, then "
                                             "decode from it")
    ap.add_argument("--arch", default="phi3-mini-3.8b", choices=ARCHS)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_reduced(args.arch)
    return run(init_model_params(0, cfg, device=dev), cfg, args.steps, dev)


if __name__ == "__main__":
    main()
