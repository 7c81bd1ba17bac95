"""Serving launcher: batched decode over the continuous-batching engine, on
the card unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3-mini-3.8b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b \\
      --reduced --device cpu --requests 6 --max-new 12 --traffic high
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b \\
      --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm3-4b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch pixtral-12b \
      --reduced --device cpu

``--arch`` takes every architecture of the registry; pixtral-12b decodes
tokens (its patches enter only a full-sequence ``forward``, as in the
reference) and hubert-xlarge, an encoder, exits: it has no decode.

Weights are random, drawn from ``--seed``; prompts come from a numpy
generator seeded with ``--seed + 1``.
"""
import argparse
import time

import numpy as np
import torch

from ..config import RunConfig
from ..configs import ARCHS, get_config, get_reduced
from ..core.policy import TRAFFIC_LEVELS
from ..device import resolve_device
from ..models import init_model_params
from ..serve import ServeEngine


def main() -> None:
    ap = argparse.ArgumentParser(description="Serve an assigned architecture")
    ap.add_argument("--arch", required=True, choices=ARCHS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain PyTorch versions of the kernels)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--slots", type=int, default=None,
                    help="decode batch slots (default: 4 per cluster core "
                         "of the resolved 'serve' operating point)")
    ap.add_argument("--mode", choices=("continuous", "static"),
                    default="continuous",
                    help="slot refill discipline: continuous (refill per "
                         "step as sequences finish) or static (wave "
                         "batching, the measurable baseline)")
    ap.add_argument("--traffic", choices=sorted(TRAFFIC_LEVELS),
                    default=None,
                    help="OVERRIDE the measured offered-load level: pins "
                         "the per-traffic serve operating point. Without it "
                         "the engine estimates the level from the arrival "
                         "stream and re-resolves at refill boundaries")
    ap.add_argument("--prefill", choices=("chunked", "token"),
                    default="chunked",
                    help="prompt ingestion: chunked (prefill_step, C tokens "
                         "per call) or token (one-token steps, the "
                         "measurable TTFT baseline)")
    ap.add_argument("--prefill-chunk", type=int, default=8,
                    help="max prompt tokens per prefilling slot per step")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if not cfg.causal:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode serving")
    rc = RunConfig(dtype="float32", param_dtype="float32", remat=False)
    params = init_model_params(args.seed, cfg, device=device)
    eng = ServeEngine(params, cfg, rc, batch_slots=args.slots, max_len=256,
                      mode=args.mode, traffic=args.traffic,
                      prefill=args.prefill, prefill_chunk=args.prefill_chunk,
                      device=device)
    del params
    op = eng.operating_point
    traffic = (f"traffic={args.traffic} (pinned)" if args.traffic
               else "traffic=measured")
    print(f"policy={op.policy.value} (source={op.source}, "
          f"cores={op.n_cores}, slots={len(eng.slots)}, mode={args.mode}, "
          f"prefill={args.prefill}, {traffic})")

    rng = np.random.default_rng(args.seed + 1)
    rids = []
    for _ in range(args.requests):
        plen = 3 + int(rng.integers(0, 6))
        prompt = [int(t) for t in rng.integers(0, cfg.vocab, plen)]
        rids.append((eng.submit(prompt, max_new=args.max_new), prompt))

    t0 = time.time()
    done = eng.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    total_tokens = sum(len(r.generated) for r in done.values())
    print(f"served {len(done)} requests, {total_tokens} tokens "
          f"in {dt:.1f}s ({total_tokens/dt:.1f} tok/s) on {device}")
    rep = eng.metrics()
    print(f"calibrated accounting ({rep.cost_source}): "
          f"{rep.throughput:.5f} tok/cycle, "
          f"{rep.energy_per_token:.1f} J-equiv/token, "
          f"p50/p99 latency {rep.p50_latency:.1f}/{rep.p99_latency:.1f} "
          f"cyc/tok, p50 TTFT {rep.p50_ttft:.0f} cyc")
    if args.traffic is None:
        level = eng.traffic_level or "still cold (too few arrivals)"
        print(f"measured traffic: {level}; "
              f"{len(eng.traffic_history)} retarget(s)")
        for h in eng.traffic_history:
            print(f"  @{h['clock']:.0f} cyc -> {h['level']} "
                  f"(rho~{h['offered_load']:.2f}, policy={h['policy']}, "
                  f"source={h['source']})")
    for rid, prompt in rids:
        r = done[rid]
        print(f"  req{rid}: prompt={prompt} -> {r.generated}")


if __name__ == "__main__":
    main()
