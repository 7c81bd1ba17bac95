"""Training launcher: end-to-end driver over the fault-tolerant runtime, on
the card unless ``--device cpu`` is given.  The JAX package's
``launch/train.py`` flags and printed lines, on one device (no mesh),
plus ``--dtype`` and ``--remat``.  Every family trains: on the card
through the kernels and their backward passes (``queue_matmul``,
``flash_attention`` and ``flash_attention_bwd``; ``moe_gemm``,
``ssm_scan`` and ``ssm_scan_bwd``, ``rglru_scan``), on the CPU through
the plain versions.  Examples:

  PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b \\
      --reduced --device cpu --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch granite-moe-3b-a800m --steps 10 --batch 2 --seq 512 \\
      --dtype bfloat16 --remat
  PYTHONPATH=src python -m repro_torch.launch.train --arch falcon-mamba-7b \\
      --layers 32 --steps 10 --batch 2 --seq 512 --dtype bfloat16 --remat

At full width a model's fp32 parameters, gradients and AdamW moments take
16 bytes a parameter: phi3-mini-3.8b, granite-moe-3b-a800m and
recurrentgemma-2b fit one 80 GB card at full depth, olmoe-1b-7b and
falcon-mamba-7b with ``--layers`` cut (falcon-mamba-7b at 32 of 64).

Weights are random, drawn from ``--seed``; batches come from the seeded
synthetic stream, which gives tokens and labels only, as the reference's
does: pixtral-12b (patches) and hubert-xlarge (frames) exit with an error
that names the input the stream lacks.  Checkpoints go to ``--ckpt-dir``
(default: a directory under the system's temporary directory).
"""
import argparse
import dataclasses
import os
import tempfile
import time

from ..config import RunConfig, ShapeConfig
from ..configs import ARCHS, get_config, get_reduced
from ..core.policy import ExecutionPolicy, default_table
from ..device import resolve_device
from ..models import init_model_params, input_specs
from ..runtime import FaultTolerantTrainer


def main() -> None:
    ap = argparse.ArgumentParser(description="Train an assigned architecture")
    ap.add_argument("--arch", required=True, choices=ARCHS)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-friendly)")
    ap.add_argument("--width", type=int, default=0,
                    help="override d_model (scales a custom mid-size model)")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="compute dtype (parameters stay fp32)")
    ap.add_argument("--remat", action="store_true",
                    help="recompute each layer's activations in the "
                         "backward")
    ap.add_argument("--policy", default=None,
                    help="pin the execution policy (default: resolve the "
                         "'train' workload from the policy table)")
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain PyTorch versions of the kernels)")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if args.width:
        cfg = dataclasses.replace(cfg, d_model=args.width)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    # a CLI pin overrides only the policy field: the table's queue
    # geometry (depth/unroll) for the train workload still applies
    op = (default_table().resolve(
              "train", policy=ExecutionPolicy.parse(args.policy))
          if args.policy else None)
    rc = RunConfig(dtype=args.dtype, param_dtype="float32",
                   remat=args.remat,
                   lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                   total_steps=args.steps, microbatch=args.microbatch,
                   seed=args.seed)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    lacking = sorted(set(input_specs(cfg, shape, rc)) - {"tokens", "labels"})
    if lacking:
        raise SystemExit(f"{cfg.name} trains on {lacking}, which the "
                         f"synthetic stream (tokens and labels) does not "
                         f"give")

    n = cfg.n_params()
    print(f"arch={cfg.name} params={n/1e6:.1f}M layers={cfg.n_layers} "
          f"d_model={cfg.d_model} batch={args.batch} seq={args.seq}")
    params = init_model_params(args.seed, cfg, device=device)

    trainer = FaultTolerantTrainer(cfg, shape, rc, device, args.ckpt_dir,
                                   ckpt_every=args.ckpt_every,
                                   operating_point=op)
    top = trainer.operating_point
    print(f"policy={top.policy.value} (source={top.source}, "
          f"depth={top.queue_depth}, unroll={top.unroll}, "
          f"cores={top.n_cores}, banks={top.tcdm_banks or 'inf'})")
    t0 = time.time()
    out = trainer.run(params, num_steps=args.steps)
    dt = time.time() - t0
    losses = out["metrics"]
    print(f"finished {out['step']} steps in {dt:.1f}s "
          f"({dt/max(len(losses),1):.2f}s/step)")
    k = max(len(losses) // 10, 1)
    first = sum(l for _, l in losses[:k]) / k
    last = sum(l for _, l in losses[-k:]) / k
    print(f"loss: first~{first:.4f} -> last~{last:.4f}")


if __name__ == "__main__":
    main()
