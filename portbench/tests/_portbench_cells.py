"""Cells of the benchmark at the port's reduced widths, for CPU tests: the
manifest's cell with its configuration's sizes replaced by the registry's
reduced ones, fewer slots and shorter requests."""
from __future__ import annotations

import copy
from typing import Any, Dict, Optional

from portbench.bench import manifest

REDUCED = {
    "phi3-mini-3.8b": {"n_layers": 2, "d_model": 64, "n_heads": 4,
                       "n_kv_heads": 4, "head_dim": 16, "d_ff": 128,
                       "vocab": 128},
    "olmoe-1b-7b": {"n_layers": 2, "d_model": 64, "n_heads": 4,
                    "n_kv_heads": 4, "head_dim": 16, "vocab": 128,
                    "moe": {"num_experts": 8, "top_k": 2,
                            "d_ff_expert": 64}},
}


def reduced_cell(name: str, dtype: str = "bfloat16",
                 rate: Optional[float] = None) -> manifest.Cell:
    cell = copy.deepcopy(manifest.load_cell(name))
    cfg: Dict[str, Any] = cell.config
    cfg.update(copy.deepcopy(REDUCED[cfg["arch"]]))
    cfg.update(registry="reduced", dtype=dtype)
    cfg["serving"] = dict(cfg["serving"], slots=4, max_len=96,
                          prefill_chunk=8)
    mix = cell.traffic
    mix["prompt_tokens"] = dict(mix["prompt_tokens"], min=4, max=48)
    mix["output_tokens"] = dict(mix["output_tokens"], min=4, max=24)
    if mix["kind"] == "poisson_open":
        mix["rate_per_s"] = rate or 60.0
        mix["drain_s"] = 30
    else:
        mix["pool"], mix["queue_depth"] = 64, 4
    return cell
