"""Batched serving: continuous batching over a reduced model, several
concurrent requests of different lengths, with chunked prefill and
measured-traffic operating points, on the card unless ``--device cpu`` is
given.

No ``traffic`` argument is passed to the engine, so it runs in
measured-traffic mode: a TrafficEstimator watches the arrival stream and,
once warm, re-resolves the calibrated per-traffic operating point at the
next refill boundary.  The burst of same-clock submissions below saturates
the estimate, so the engine retargets to the "high" traffic point mid-run
— watch the traffic history it prints.

  PYTHONPATH=src python -m repro_torch.examples.serve_batch \\
      --arch recurrentgemma-2b --device cpu
  PYTHONPATH=src python -m repro_torch.examples.serve_batch --full

``--full`` serves the architecture at full width and depth in bf16
(``get_config``) instead of its reduced config in fp32; nothing else
differs.  The port's counterpart of the JAX package's
``examples/serve_batch.py``.  Weights are random, drawn from seed 0.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional

import torch

from ..config import ModelConfig, RunConfig
from ..configs import ARCHS, get_config, get_reduced
from ..device import DeviceLike, resolve_device, torch_dtype
from ..models import init_model_params
from ..serve import ServeEngine


def prompts(n: int) -> List[List[int]]:
    """The same-clock burst: request ``i`` has prompt ``1+i .. 4+2i``."""
    return [list(range(1 + i, 5 + 2 * i)) for i in range(n)]


def run(params: Dict[str, Any], cfg: ModelConfig, rc: RunConfig,
        requests: int = 6, max_new: int = 10, prefill: str = "chunked",
        device: DeviceLike = None) -> Dict[str, Any]:
    """Serve the burst through a 3-slot engine (``max_len`` 128) in
    measured-traffic mode and print what it did.  Returns the engine's
    steps, prefill programs and traffic history, the tokens of each
    request in order, and the serving wall time."""
    dev = resolve_device(device)
    eng = ServeEngine(params, cfg, rc, batch_slots=3, max_len=128,
                      prefill=prefill, device=dev)
    print(f"measured-traffic mode: level starts {eng.traffic_level} "
          f"(estimator cold), prefill={prefill}")

    # a same-clock burst: offered load saturates -> the estimator reads
    # "high" and the engine retargets at the first refill boundary
    rids = [eng.submit(p, max_new=max_new) for p in prompts(requests)]

    t0 = time.time()
    done = eng.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    n_tok = sum(len(r.generated) for r in done.values())
    print(f"{cfg.name}: {len(done)} requests, {n_tok} tokens, "
          f"{n_tok/dt:.1f} tok/s, {eng._n_steps} engine steps "
          f"({eng.prefill_compiles} prefill chunk programs)")
    print(f"measured traffic level: {eng.traffic_level}; "
          f"{len(eng.traffic_history)} retarget(s)")
    for h in eng.traffic_history:
        print(f"  @{h['clock']:.0f} cyc -> {h['level']} "
              f"(rho~{h['offered_load']:.2f}, policy={h['policy']})")
    for rid in sorted(done):
        r = done[rid]
        print(f"  req{rid} prompt[:4]={r.prompt[:4]} -> {r.generated}")
    return {"steps": eng._n_steps, "prefill_compiles": eng.prefill_compiles,
            "traffic_history": list(eng.traffic_history),
            "traffic_level": eng.traffic_level,
            "tokens": [done[r].generated for r in rids], "wall_s": dt,
            "engine": eng}


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description="Continuous batching in "
                                             "measured-traffic mode")
    ap.add_argument("--arch", default="glm4-9b",
                    choices=[a for a in ARCHS if a != "hubert-xlarge"])
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=10)
    ap.add_argument("--prefill", choices=("chunked", "token"),
                    default="chunked")
    ap.add_argument("--full", action="store_true",
                    help="serve the full-width config in bf16 (default: "
                         "the reduced config in fp32)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    dtype = "bfloat16" if args.full else "float32"
    cfg = get_config(args.arch) if args.full else get_reduced(args.arch)
    rc = RunConfig(dtype=dtype, param_dtype=dtype, remat=False)
    params = init_model_params(0, cfg, dtype=torch_dtype(dtype),
                               device=dev)
    return run(params, cfg, rc, args.requests, args.max_new, args.prefill,
               dev)


if __name__ == "__main__":
    main()
