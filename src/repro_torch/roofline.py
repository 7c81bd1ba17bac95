"""Roofline terms of a step on NVIDIA H100 cards.

Three terms per (arch x shape x mesh) cell, in seconds, as in the JAX
package:

  compute    = FLOPs      / peak FLOP/s          (per device)
  memory     = bytes      / HBM bytes/s          (per device)
  collective = coll_bytes / (link bytes/s x links)  (per device)

The constants are an H100 SXM's, from NVIDIA's data sheet: 989e12 dense
bf16 FLOP/s (67e12 in fp32 outside the tensor cores), 3.35e12 B/s and 80e9
bytes of HBM, and NVLink 4's 18 links of 25e9 B/s each way (450 GB/s a
direction).  Those rates assume the card's full 700 W; a card set lower
runs slower under load.

The port has no compiled module to parse, so :func:`collective_bytes`
takes records of the collectives a step issues, or that a placement
implies for it: ``(kind, bytes moved for one device)`` pairs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Tuple

import torch

#: one H100 SXM
PEAK_FLOPS = 989e12          # bf16, dense tensor cores
PEAK_FLOPS_BY_DTYPE = {torch.bfloat16: PEAK_FLOPS,
                       torch.float32: 67e12}  # fp32 outside the tensor cores
HBM_BW = 3.35e12             # bytes/s
HBM_BYTES = 80e9
LINK_BW = 25e9               # bytes/s per NVLink 4 link, each direction
LINKS = 18

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


def collective_bytes(records: Iterable[Tuple[str, float]]) -> Dict[str, int]:
    """Bytes moved for one device by kind, from ``(kind, bytes)`` records,
    with ``total`` their sum; every kind present, zero where none ran."""
    out = dict.fromkeys(KINDS, 0)
    for kind, nbytes in records:
        if kind not in out:
            raise ValueError(f"unknown collective kind {kind!r}")
        out[kind] += int(nbytes)
    out["total"] = sum(out[k] for k in KINDS)
    return out


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    per_device_flops: float
    per_device_bytes: float
    per_device_coll_bytes: float
    model_flops: float                  # 6·N(active)·D, whole step
    per_device_hbm_peak: Optional[float] = None

    @property
    def t_compute(self) -> float:
        return self.per_device_flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.per_device_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.per_device_coll_bytes / (LINK_BW * LINKS)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Roofline-optimistic step time: max of the three terms (perfect
        overlap); the dominant term is the floor."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (global counted FLOPs) — remat/redundancy waste."""
        total = self.per_device_flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline-optimistic step time."""
        denom = self.step_time * self.chips * PEAK_FLOPS
        return self.model_flops / denom if denom else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "per_device_flops": self.per_device_flops,
            "per_device_bytes": self.per_device_bytes,
            "per_device_coll_bytes": self.per_device_coll_bytes,
            "model_flops": self.model_flops,
            "per_device_hbm_peak": self.per_device_hbm_peak,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck, "step_time": self.step_time,
            "useful_flops_ratio": self.useful_flops_ratio, "mfu": self.mfu,
        }


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS per step: 6·N_active·D for training (fwd+bwd), 2·N_active·D
    for inference forward; decode processes one token per sequence."""
    n = cfg.n_active_params()
    if shape.mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch          # decode: 1 token/seq
