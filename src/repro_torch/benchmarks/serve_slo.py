"""Serve-SLO benchmark, the port's counterpart of the JAX package's
``benchmarks/serve_slo.py``: its two sections.

**Simulated** (``run``, ``main``, ``smoke``): a trace-driven load
generator over the port's virtual-time serving simulation
(``repro_torch.serve.scheduler.simulate_serve``, a copy of the
reference's).  Two pinned-seed arrival traces with mixed prompt and output
lengths drive the continuous-batching scheduler against the static (wave)
baseline: **poisson** (memoryless arrivals at ~70% of the best decode
service rate) and **bursty** (groups of near-simultaneous arrivals
separated by long lulls, where wave batching hurts most).  Everything is
simulated in cycles-equivalent over the pinned paper-default operating
point (never the live policy table), so the report is exactly
deterministic, and ``bench_diff`` holds the port's FULL report to the
reference's committed ``artifacts/BENCH_serve_slo.json`` field for field.
Gates, as the reference's (smoke and full):

* continuous batching delivers >= :data:`MIN_CONTINUOUS_GAIN` x the static
  baseline's throughput-at-SLO on the bursty trace;
* continuous batching meets the p99 bound (:data:`SLO_P99_PER_TOKEN`
  cycles a work-token) on both traces;
* continuous energy per token beats static on the bursty trace;
* straggler-aware dispatch flags exactly the injected slow host, declares
  no host dead, and beats rigid equal-share dispatch by
  >= :data:`MIN_STRAGGLER_GAIN` x on wall cycles;
* two runs of the same trace give identical reports.

Writes ``artifacts/BENCH_port_serve_slo.json``
(``BENCH_port_serve_slo_smoke.json`` under ``--smoke``).

**Live prefill cell** (``run_prefill``, ``--prefill``): the port's serving
engine, not the simulation, twice on the same weights, prompt and pinned
cost model: chunked prefill (``ServeEngine(prefill="chunked")``, up to
``prefill_chunk`` prompt tokens a step) against the token-by-token
reference (``prefill="token"``).  Hard gates, as in the reference:

* generated tokens AND the serving slot's final cache rows are equal bit
  for bit between the two paths (the chunk runs the same decode body
  column by column, so any difference is a fault, not float noise);
* the cycles-equivalent TTFT (deterministic: pinned cost model, fixed
  prompt, the reference's scheduler copied) improves at least
  :data:`MIN_PREFILL_TTFT_GAIN` x;
* the engine keeps at most log2(prefill_chunk) + 1 chunk programs.

The wall-clock TTFT gain (median over warm trials) is measured and
written beside the reference's bar (:data:`MIN_PREFILL_TTFT_GAIN`, or
:data:`MIN_PREFILL_TTFT_GAIN_SMOKE` under ``--smoke``) as
``ttft_wall_gain``, ``min_required`` and ``meets_wall_bar``, but not
enforced: the bar measures host dispatch per chunk, which the reference
gets from one jitted scan a chunk and the port, which launches each chunk
column as its own decode body, matches only once a chunk is one program
on the card.  The bar is not lowered.

:data:`PREFILL_CARD` is the full cell's prompt, slots, chunk and trials on
phi3-mini-3.8b at full width in bf16 (``run_prefill(PREFILL_CARD)``, as
``chip_smoke.py`` runs it).  Writes
``artifacts/BENCH_port_serve_prefill{,_smoke,_card}.json`` with the
device's name and power limit.

  PYTHONPATH=src python -m repro_torch.benchmarks.serve_slo [--smoke]
  PYTHONPATH=src python -m repro_torch.benchmarks.serve_slo --prefill \\
      [--smoke] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import RunConfig
from ..configs import get_config, get_reduced
from ..core.policy import OperatingPoint
from ..device import DeviceLike, resolve_device, torch_dtype
from ..models import init_model_params
from ..serve import ServeEngine
from ..serve.scheduler import (AdmissionControl, HostDispatch, ServeSLO,
                               StepCostModel, TraceRequest, simulate_serve)
from . import ART_DIR, device_label

OUT_PATH = os.path.join(ART_DIR, "BENCH_port_serve_slo.json")
SMOKE_OUT_PATH = os.path.join(ART_DIR, "BENCH_port_serve_slo_smoke.json")
PREFILL_OUT_PATH = os.path.join(ART_DIR, "BENCH_port_serve_prefill.json")
PREFILL_SMOKE_OUT_PATH = os.path.join(ART_DIR,
                                      "BENCH_port_serve_prefill_smoke.json")
PREFILL_CARD_OUT_PATH = os.path.join(ART_DIR,
                                     "BENCH_port_serve_prefill_card.json")

Row = Tuple[str, float, float]

#: the acceptance bar: continuous batching must beat wave batching by this
#: factor on bursty-trace throughput-at-SLO
MIN_CONTINUOUS_GAIN = 1.3
#: straggler-aware dispatch must beat rigid equal-share dispatch by this
#: factor on total cycles when one of four hosts runs 3x slow
MIN_STRAGGLER_GAIN = 1.5

#: the SLO: p99 normalized latency (cycles per work-token, queueing
#: included) and the per-request budget slack (absolute cycles)
SLO_P99_PER_TOKEN = 700.0
SLO_BASE_CYCLES = 800.0

N_SLOTS = 8
PREFILL_CHUNK = 8
#: mixed request shapes (drawn per request from the pinned seed)
PROMPT_LENS = (4, 8, 16)
MAX_NEWS = (4, 8, 16, 48)

FULL = dict(n_requests=160, seed=7, poisson_util=0.7,
            burst_size=16, burst_gap_steps=40)
SMOKE = dict(n_requests=48, seed=7, poisson_util=0.7,
             burst_size=12, burst_gap_steps=40)


def _cost_model() -> StepCostModel:
    """The pinned paper-default operating point's step costs (hermetic:
    never reads the live calibration artifacts)."""
    return StepCostModel.from_operating_point(OperatingPoint())


def _shapes(rng: np.random.RandomState, n: int):
    prompts = rng.choice(PROMPT_LENS, size=n)
    news = rng.choice(MAX_NEWS, size=n)
    return prompts, news


def poisson_trace(cost: StepCostModel, n: int, seed: int,
                  util: float) -> List[TraceRequest]:
    """Memoryless arrivals at ``util`` x the best decode service rate."""
    rng = np.random.RandomState(seed)
    prompts, news = _shapes(rng, n)
    step_cycles, _ = cost.step_cost(N_SLOTS, 0)
    token_rate = N_SLOTS / step_cycles              # tokens/cycle, all busy
    req_rate = util * token_rate / float(np.mean(MAX_NEWS))
    gaps = rng.exponential(1.0 / req_rate, size=n)
    arrivals = np.cumsum(gaps)
    return [TraceRequest(i, float(arrivals[i]), int(prompts[i]),
                         int(news[i])) for i in range(n)]


def bursty_trace(cost: StepCostModel, n: int, seed: int, burst_size: int,
                 burst_gap_steps: int) -> List[TraceRequest]:
    """Bursts of near-simultaneous arrivals separated by multi-wave lulls."""
    rng = np.random.RandomState(seed + 1)
    prompts, news = _shapes(rng, n)
    step_cycles, _ = cost.step_cost(N_SLOTS, 0)
    out, t = [], 0.0
    for i in range(n):
        if i and i % burst_size == 0:
            t += burst_gap_steps * step_cycles      # lull between bursts
        t += float(rng.exponential(0.2 * step_cycles))
        out.append(TraceRequest(i, t, int(prompts[i]), int(news[i])))
    return out


def _simulate(trace, cost, mode, dispatch=None):
    slo = ServeSLO(p99_cycles_per_token=SLO_P99_PER_TOKEN,
                   base_cycles=SLO_BASE_CYCLES)
    return simulate_serve(
        trace, N_SLOTS, cost, mode=mode, slo=slo,
        admission=AdmissionControl(max_pending=256),
        prefill_chunk=PREFILL_CHUNK, dispatch=dispatch)


def run(cfg: Optional[Dict[str, Any]] = None,
        out_path: Optional[str] = None) -> List[Row]:
    """The simulated section at ``cfg`` (default :data:`FULL`): raises
    unless every gate holds, writes the report to ``out_path`` (default
    :data:`OUT_PATH`) and returns the reference's rows."""
    cfg = cfg or FULL
    out_path = out_path or OUT_PATH
    t0 = time.time()
    cost = _cost_model()
    traces = {
        "poisson": poisson_trace(cost, cfg["n_requests"], cfg["seed"],
                                 cfg["poisson_util"]),
        "bursty": bursty_trace(cost, cfg["n_requests"], cfg["seed"],
                               cfg["burst_size"], cfg["burst_gap_steps"]),
    }
    rows, results = [], {}
    for name, trace in traces.items():
        results[name] = {}
        for mode in ("continuous", "static"):
            rep = _simulate(trace, cost, mode)
            if rep.n_unfinished:
                raise AssertionError(
                    f"{name}/{mode}: {rep.n_unfinished} admitted requests "
                    f"never completed (scheduler stuck or max_steps hit)")
            results[name][mode] = rep.to_dict()
            rows.append((f"serve_slo_{name}_{mode}_tput_at_slo", 0.0,
                         rep.slo["throughput_at_slo"]))
            rows.append((f"serve_slo_{name}_{mode}_p99", 0.0,
                         rep.p99_latency))

    # determinism: the whole pipeline must be replayable bit-for-bit
    again = _simulate(traces["bursty"], cost, "continuous").to_dict()
    if again != results["bursty"]["continuous"]:
        raise AssertionError("serve simulation is not deterministic: two "
                             "runs of the pinned bursty trace differ")

    # gate: continuous meets the p99 bound on both traces
    for name in traces:
        cont = results[name]["continuous"]
        if not cont["slo"]["p99_met"]:
            raise AssertionError(
                f"{name}: continuous batching missed the p99 bound "
                f"({cont['p99_latency']:.1f} > {SLO_P99_PER_TOKEN} "
                f"cyc/tok)")

    # gate: >=1.3x throughput-at-SLO over wave batching on the bursty trace
    gain = (results["bursty"]["continuous"]["slo"]["throughput_at_slo"]
            / max(results["bursty"]["static"]["slo"]["throughput_at_slo"],
                  1e-12))
    if gain < MIN_CONTINUOUS_GAIN:
        raise AssertionError(
            f"continuous batching gains only {gain:.2f}x throughput-at-SLO "
            f"over the static baseline on the bursty trace "
            f"(required {MIN_CONTINUOUS_GAIN}x)")
    rows.append(("serve_slo_bursty_tput_at_slo_gain", 0.0, gain))

    # gate: fewer idle padded slots = lower J/token
    e_cont = results["bursty"]["continuous"]["energy_per_token"]
    e_stat = results["bursty"]["static"]["energy_per_token"]
    if e_cont >= e_stat:
        raise AssertionError(
            f"continuous J/token {e_cont:.1f} did not beat static "
            f"{e_stat:.1f} on the bursty trace")
    rows.append(("serve_slo_bursty_energy_gain", 0.0, e_stat / e_cont))

    # gate: straggler-aware dispatch adapts (and declares nobody dead)
    slow_host = 3
    adaptive = HostDispatch(4, min_samples=8)
    adaptive.set_speed(slow_host, 3.0)
    rep_adapt = _simulate(traces["bursty"], cost, "continuous",
                          dispatch=adaptive)
    rigid = HostDispatch(4, min_samples=8, threshold=float("inf"))
    rigid.set_speed(slow_host, 3.0)
    rep_rigid = _simulate(traces["bursty"], cost, "continuous",
                          dispatch=rigid)
    if rep_adapt.straggler["flagged_hosts"] != [slow_host]:
        raise AssertionError(
            f"straggler dispatch flagged "
            f"{rep_adapt.straggler['flagged_hosts']}, expected "
            f"[{slow_host}]")
    if rep_adapt.straggler["dead_hosts"]:
        raise AssertionError(
            f"slow-but-beating hosts declared dead: "
            f"{rep_adapt.straggler['dead_hosts']}")
    straggler_gain = rep_rigid.total_cycles / rep_adapt.total_cycles
    if straggler_gain < MIN_STRAGGLER_GAIN:
        raise AssertionError(
            f"straggler-aware dispatch gains only {straggler_gain:.2f}x "
            f"over rigid dispatch (required {MIN_STRAGGLER_GAIN}x)")
    rows.append(("serve_slo_straggler_gain", 0.0, straggler_gain))

    report = {
        "cost_model": {
            "cycles_decode_token": cost.cycles_decode_token,
            "energy_decode_token": cost.energy_decode_token,
            "cycles_prefill_token": cost.cycles_prefill_token,
            "energy_prefill_token": cost.energy_prefill_token,
            "overhead_cycles": cost.overhead_cycles,
            "source": cost.source,
        },
        "slo": {"p99_cycles_per_token": SLO_P99_PER_TOKEN,
                "base_cycles": SLO_BASE_CYCLES},
        "config": {"n_slots": N_SLOTS, "prefill_chunk": PREFILL_CHUNK,
                   "prompt_lens": list(PROMPT_LENS),
                   "max_news": list(MAX_NEWS), **cfg},
        "results": results,
        "straggler": {"slow_host": slow_host, "slowdown": 3.0,
                      "adaptive": rep_adapt.straggler,
                      "adaptive_cycles": rep_adapt.total_cycles,
                      "rigid_cycles": rep_rigid.total_cycles,
                      "gain": straggler_gain},
        "headline": {"throughput_at_slo_gain_bursty": gain,
                     "min_required": MIN_CONTINUOUS_GAIN,
                     "p99_met": True,
                     "straggler_gain": straggler_gain},
    }
    us = (time.time() - t0) * 1e6 / max(len(rows), 1)
    rows = [(name, us, derived) for name, _z, derived in rows]

    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
        f.write("\n")
    return rows


def main() -> None:
    for name, us, derived in run():
        print(f"{name},{us:.1f},{derived:.4f}")
    print(f"# wrote {OUT_PATH}")


def smoke() -> None:
    """Smaller trace, separate artifact — every gate still enforced."""
    rows = run(cfg=SMOKE, out_path=SMOKE_OUT_PATH)
    if not rows:
        raise AssertionError("serve_slo smoke produced no rows")
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived:.4f}")


# ---------------------------------------------------------------------------
# live-engine chunked-prefill cell
# ---------------------------------------------------------------------------

#: the reference's bar: chunked prefill must at least halve TTFT at
#: prompt_len >= 64
MIN_PREFILL_TTFT_GAIN = 2.0
#: the reference's softer wall-clock bar under --smoke; the deterministic
#: cycles-domain gate stays at MIN_PREFILL_TTFT_GAIN
MIN_PREFILL_TTFT_GAIN_SMOKE = 1.2

PREFILL_FULL = dict(arch="phi3-mini-3.8b", prompt_len=64, max_new=8,
                    batch_slots=2, prefill_chunk=16, trials=5, seed=0)
PREFILL_SMOKE = dict(arch="phi3-mini-3.8b", prompt_len=64, max_new=4,
                     batch_slots=2, prefill_chunk=16, trials=3, seed=0)
#: the full cell on the card: phi3-mini-3.8b at full width, bf16
PREFILL_CARD = dict(PREFILL_FULL, full=True, dtype="bfloat16")


def _prefill_engines(cfg: Dict[str, Any], device: DeviceLike = None):
    """A maker of engines (chunked or token) over shared weights drawn from
    ``cfg["seed"]`` and the pinned paper-default operating point, and the
    prompt, drawn from ``np.random.RandomState(seed + 1)`` as the
    reference draws it.  The reduced config in fp32, or with ``full`` the
    full-width config in ``cfg["dtype"]``."""
    dev = resolve_device(device)
    dtype = cfg.get("dtype", "float32")
    mcfg = (get_config if cfg.get("full") else get_reduced)(cfg["arch"])
    rc = RunConfig(dtype=dtype, param_dtype=dtype, remat=False)
    params = init_model_params(cfg["seed"], mcfg, dtype=torch_dtype(dtype),
                               device=dev)
    rng = np.random.RandomState(cfg["seed"] + 1)
    prompt = [int(t) for t in rng.randint(0, mcfg.vocab,
                                          size=cfg["prompt_len"])]
    max_len = cfg["prompt_len"] + cfg["max_new"] + 8
    cost = _cost_model()

    def mk(prefill):
        return ServeEngine(params, mcfg, rc,
                           batch_slots=cfg["batch_slots"], max_len=max_len,
                           operating_point=OperatingPoint(),
                           cost_model=cost, prefill=prefill,
                           prefill_chunk=cfg["prefill_chunk"], device=dev)
    return mk, prompt


def _sync(eng: ServeEngine) -> None:
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)


def _measure_ttft(eng: ServeEngine, prompt: List[int], max_new: int,
                  trials: int):
    """Warm run + ``trials`` timed runs; returns the warm run's generated
    tokens, the cycles-domain TTFT, and per-trial wall TTFTs (the first
    token is on the host when ``step`` returns: the argmax is copied
    there)."""
    rid0 = eng.submit(prompt, max_new=max_new)
    eng.run(max_steps=100_000)
    tokens = list(eng.finished[rid0].generated)
    sreq = eng.sched.requests[rid0]
    ttft_cycles = sreq.first_token - sreq.arrival
    walls = []
    for _ in range(trials):
        rid = eng.submit(prompt, max_new=max_new)
        _sync(eng)
        t0 = time.time()
        while not eng.requests[rid].generated:
            eng.step()
        walls.append(time.time() - t0)
        eng.run(max_steps=100_000)           # drain before the next trial
    if not math.isfinite(ttft_cycles):
        raise AssertionError(f"TTFT {ttft_cycles} cycles is not finite")
    return tokens, ttft_cycles, walls


def _slot_rows(cache: Dict[str, torch.Tensor], i: int):
    """Slot ``i``'s rows of every cache leaf (batch is axis 0 of ``len``,
    axis 1 of the stacked leaves)."""
    return {k: (v if v.ndim == 0 else v[i] if v.ndim == 1 else v[:, i])
            for k, v in cache.items()}


def run_prefill(cfg: Optional[Dict[str, Any]] = None,
                out_path: str = PREFILL_OUT_PATH,
                min_wall_gain: float = MIN_PREFILL_TTFT_GAIN,
                device: DeviceLike = None) -> List[Row]:
    """The cell at ``cfg`` (default :data:`PREFILL_FULL`) on ``device``:
    raises unless the hard gates hold, records the wall-clock gain beside
    ``min_wall_gain``, writes the report to ``out_path`` and returns the
    reference's rows."""
    cfg = cfg or PREFILL_FULL
    t0 = time.time()
    mk, prompt = _prefill_engines(cfg, device)

    chunked = mk("chunked")
    token = mk("token")
    tok_c, cyc_c, walls_c = _measure_ttft(chunked, prompt, cfg["max_new"],
                                          cfg["trials"])
    tok_t, cyc_t, walls_t = _measure_ttft(token, prompt, cfg["max_new"],
                                          cfg["trials"])

    # gate: equal generated tokens and final cache rows.  Only the serving
    # slot's rows are compared: free-slot rows are junk by design (the
    # unmasked token-by-token reference advances them every step, the
    # masked chunk path never touches them) and are zeroed before reuse.
    rows_c = _slot_rows(chunked.cache, 0)
    rows_t = _slot_rows(token.cache, 0)
    tokens_exact = tok_c == tok_t
    cache_exact = (set(rows_c) == set(rows_t) and all(
        torch.equal(rows_c[k], rows_t[k]) for k in rows_c))
    if not (tokens_exact and cache_exact):
        raise AssertionError(
            f"chunked prefill is not bit-exact with the token-by-token "
            f"path: tokens_exact={tokens_exact} cache_exact={cache_exact} "
            f"(chunked={tok_c} token={tok_t})")

    # gate: bounded chunk-program cache
    max_compiles = int(math.log2(cfg["prefill_chunk"])) + 1
    if chunked.prefill_compiles > max_compiles:
        raise AssertionError(
            f"chunk-program cache unbounded: {chunked.prefill_compiles} "
            f"programs > log2({cfg['prefill_chunk']})+1 = {max_compiles}")

    # gate: deterministic cycles-domain TTFT gain (pinned cost model)
    cycles_gain = cyc_t / max(cyc_c, 1e-9)
    if cycles_gain < MIN_PREFILL_TTFT_GAIN:
        raise AssertionError(
            f"chunked prefill gains only {cycles_gain:.2f}x cycles-domain "
            f"TTFT at prompt_len={cfg['prompt_len']} "
            f"(required {MIN_PREFILL_TTFT_GAIN}x)")

    # recorded, not enforced: the wall-clock TTFT gain (median over warm
    # trials) against the reference's bar
    wall_c = float(np.median(walls_c))
    wall_t = float(np.median(walls_t))
    wall_gain = wall_t / max(wall_c, 1e-12)

    report = {
        "config": dict(cfg),
        "device": device_label(chunked.device),
        "ttft": {
            "cycles_chunked": cyc_c, "cycles_token": cyc_t,
            "wall_s_chunked": walls_c, "wall_s_token": walls_t,
            "wall_s_chunked_median": wall_c, "wall_s_token_median": wall_t,
        },
        "steps": {"chunked": chunked._n_steps, "token": token._n_steps},
        "prefill_compiles": chunked.prefill_compiles,
        "max_prefill_compiles": max_compiles,
        "headline": {
            "ttft_wall_gain": wall_gain,
            "ttft_cycles_gain": cycles_gain,
            "bit_exact": bool(tokens_exact and cache_exact),
            "min_required": min_wall_gain,
            "meets_wall_bar": bool(wall_gain >= min_wall_gain),
        },
    }
    rows = [
        ("serve_prefill_ttft_wall_gain", 0.0, wall_gain),
        ("serve_prefill_ttft_cycles_gain", 0.0, cycles_gain),
        ("serve_prefill_compiles", 0.0, float(chunked.prefill_compiles)),
    ]
    us = (time.time() - t0) * 1e6 / len(rows)
    rows = [(name, us, derived) for name, _z, derived in rows]

    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
        f.write("\n")
    return rows


def _print(rows: List[Row], out_path: str) -> None:
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived:.4f}")
    with open(out_path) as f:
        head = json.load(f)["headline"]
    print(f"# wall-clock TTFT gain {head['ttft_wall_gain']:.2f}x against "
          f"the reference's bar {head['min_required']}x: "
          f"{'met' if head['meets_wall_bar'] else 'missed'} (recorded, not "
          f"enforced)")
    print(f"# wrote {out_path}")


def prefill_main(device: DeviceLike = None) -> None:
    _print(run_prefill(device=device), PREFILL_OUT_PATH)


def prefill_smoke(device: DeviceLike = None) -> None:
    """Smaller run, separate artifact, the reference's softer wall bar
    recorded; bit-exactness, the cycles-domain gain and the bounded
    program cache are still hard gates."""
    rows = run_prefill(cfg=PREFILL_SMOKE, out_path=PREFILL_SMOKE_OUT_PATH,
                       min_wall_gain=MIN_PREFILL_TTFT_GAIN_SMOKE,
                       device=device)
    _print(rows, PREFILL_SMOKE_OUT_PATH)


def cli(argv: Optional[List[str]] = None) -> None:
    """The reference's command line: the simulated section by default,
    the live prefill cell under ``--prefill`` (on the card unless
    ``--device cpu``); ``--smoke`` picks either's small variant."""
    ap = argparse.ArgumentParser(description="The serve-SLO benchmark")
    ap.add_argument("--prefill", action="store_true",
                    help="the live chunked-prefill cell, not the simulation")
    ap.add_argument("--smoke", action="store_true",
                    help="the small variant (SMOKE, or PREFILL_SMOKE)")
    ap.add_argument("--device", default=None,
                    help="with --prefill: torch device (default: the CUDA "
                         "card; 'cpu' runs the plain PyTorch versions of "
                         "the kernels)")
    args = ap.parse_args(argv)
    if args.prefill:
        (prefill_smoke if args.smoke else prefill_main)(args.device)
    elif args.device is not None:
        ap.error("--device applies to --prefill only: the simulated "
                 "section runs on the host")
    else:
        (smoke if args.smoke else main)()


if __name__ == "__main__":
    cli()
