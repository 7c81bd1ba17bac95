"""Mixture-of-Experts FFN with top-k routing (granite-moe / olmoe).

The port of ``repro.models.moe``.  Every expert product runs through the
port's ``moe_gemm`` op (the CUDA kernel on the card, its plain version on
the CPU) at the depth of the policy table's ``moe_gemm`` point, under the
run's execution policy; the router's product runs through ``queue_matmul``
in fp32.

* :func:`moe_apply` is the reference's dense dispatch: every token goes
  through every expert and a one-hot combine keeps the routed ones.  x is
  handed to ``moe_gemm`` as one (T, d) matrix seen by every expert (expert
  stride 0), so row t of every expert's product is token t.  That keeps a
  token's result independent of its neighbours' routing, which is what
  makes chunked prefill bit-exact with token prefill on the card.  The
  experts no token routes to are masked out (``active``, built on the
  device from the top-k indices), so a decode body reads only the routed
  experts' weights: their rows would have been multiplied by a combine
  weight of 0, and are now zeros times 0, so the mask changes no bit.
* :func:`moe_apply_grouped` is the capacity-bounded sort-based dispatch,
  rule for rule as the reference's, with tokens over capacity dropped.
  Experts whose buffers are empty are masked out.  Its combine gathers
  each token's k expert rows back and sums them in a fixed order, with no
  atomics, so it gives the same bits from run to run.

``moe_gemm`` returns fp32; each product is cast to the compute dtype where
the reference's einsums round.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..core.policy import ExecutionPolicy
from ..device import upcast
from ..kernels.moe_gemm import moe_gemm
from ..kernels.moe_gemm.ops import operating_point
from .layers import ParamSpec, matmul


def moe_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, e = cfg.d_model, cfg.moe
    specs = {
        "router": ParamSpec((d, e.num_experts), ("embed", "experts")),
        "wi": ParamSpec((e.num_experts, d, e.d_ff_expert),
                        ("experts", "embed", "expert_ff")),
        "wo": ParamSpec((e.num_experts, e.d_ff_expert, d),
                        ("experts", "expert_ff", "embed")),
    }
    if cfg.ffn_act == "swiglu":
        specs["wg"] = ParamSpec((e.num_experts, d, e.d_ff_expert),
                                ("experts", "embed", "expert_ff"))
    return specs


def router_probs(p, x: torch.Tensor, cfg: ModelConfig,
                 policy: Optional[ExecutionPolicy] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routing.  x: (B, S, d) -> (weights (B, S, k) fp32 (fp64 for
    fp64), idx (B, S, k)).  Ties go to the lower expert index, as ``jax.lax.top_k``
    breaks them: a stable descending sort keeps equal logits in index
    order."""
    logits = matmul(upcast(x), upcast(p["router"]), policy)
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    k = cfg.moe.top_k
    return torch.softmax(vals[..., :k], dim=-1), idx[..., :k]


def _expert_gemm(x: torch.Tensor, w: torch.Tensor,
                 policy: Optional[ExecutionPolicy],
                 active: Optional[torch.Tensor]) -> torch.Tensor:
    """``moe_gemm`` at the table's ``moe_gemm`` point (its ring carries the
    weight stream, so it takes the F2I depth) over the ``active`` experts,
    cast to ``x.dtype``."""
    pt = operating_point()
    return moe_gemm(x, w, depth=pt.effective_depths()[1],
                    policy=policy if policy is not None else pt.policy,
                    active=active).to(x.dtype)


def _expert_ffn(p, buf: torch.Tensor, act: str,
                policy: Optional[ExecutionPolicy],
                active: Optional[torch.Tensor]) -> torch.Tensor:
    """The experts' FFN over (E, C, d) rows -> (E, C, d) in ``buf.dtype``;
    an expert outside ``active`` (``None``: every expert) gives zeros."""
    h = _expert_gemm(buf, p["wi"], policy, active)
    if act == "swiglu":
        h = F.silu(_expert_gemm(buf, p["wg"], policy, active)) * h
    elif act == "relu2":
        h = torch.square(F.relu(h))
    else:
        h = F.gelu(h, approximate="tanh")
    return _expert_gemm(h, p["wo"], policy, active)


def moe_apply(p, x: torch.Tensor, cfg: ModelConfig,
              policy: Optional[ExecutionPolicy] = None) -> torch.Tensor:
    """Dense-dispatch MoE: one-hot combine (exact reference), over the
    routed experts only."""
    e = cfg.moe
    B, S, d = x.shape
    T = B * S
    w, idx = router_probs(p, x, cfg, policy)
    # combine[t, E] = w[t, k] where idx[t, k] == E: the one-hot sum of the
    # reference, in x.dtype (the top-k indices of a token are distinct)
    combine = torch.zeros((T, e.num_experts), dtype=x.dtype, device=x.device)
    combine.scatter_(1, idx.reshape(T, -1), w.reshape(T, -1).to(x.dtype))
    # the experts some token routes to, on the device (no host copy)
    active = torch.zeros(e.num_experts, dtype=torch.int8, device=x.device)
    active.scatter_(0, idx.reshape(-1), 1)
    xe = x.reshape(T, d).expand(e.num_experts, T, d)     # expert stride 0
    y = _expert_ffn(p, xe, cfg.ffn_act, policy, active)   # (E, T, d)
    return torch.einsum("etd,te->td", y, combine).reshape(B, S, d)


def moe_apply_grouped(p, x: torch.Tensor, cfg: ModelConfig,
                      capacity_factor: float = 1.25,
                      policy: Optional[ExecutionPolicy] = None
                      ) -> torch.Tensor:
    """Capacity-bounded sort-based dispatch into (E, C, d) buffers, as the
    reference's: ``C = max(int(capacity_factor * k * T / E), 1)``,
    assignments sorted stably by expert, slots from per-expert counts,
    assignments past C dropped.  Matches :func:`moe_apply` up to the
    dropped tokens."""
    e = cfg.moe
    B, S, d = x.shape
    T, k, E = B * S, e.top_k, e.num_experts
    xt = x.reshape(T, d)
    w, idx = router_probs(p, x, cfg, policy)
    w = w.reshape(T * k)
    eid = idx.reshape(T * k)
    C = max(int(capacity_factor * k * T / E), 1)

    # --- integer stream: sort by expert, per-expert slot offsets ----------
    order = torch.argsort(eid, stable=True)
    eid_s = eid[order]
    tok_s = order // k
    w_s = w[order]
    counts = torch.bincount(eid, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(T * k, device=x.device) - starts[eid_s]
    keep = slot < C
    slot_c = torch.where(keep, slot, 0)
    eid_c = torch.where(keep, eid_s, 0)

    # --- dispatch: kept assignments into per-expert buffers ---------------
    # each kept (expert, slot) is unique; dropped ones all land on a spare
    # row past the buffers, which is thrown away
    dest = torch.where(keep, eid_s * C + slot, E * C)
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    buf[dest] = xt[tok_s]
    buf = buf[:E * C].reshape(E, C, d)

    # --- FP stream: expert GEMMs ------------------------------------------
    y = _expert_ffn(p, buf, cfg.ffn_act, policy, counts > 0)  # (E, C, d)

    # --- combine: gather back into (T, k) order, sum over k in order ------
    y_tok = y[eid_c, slot_c] * (w_s * keep).to(x.dtype)[:, None]
    per_tok = torch.empty_like(y_tok)
    per_tok[order] = y_tok
    per_tok = per_tok.reshape(T, k, d)
    out = per_tok[:, 0]
    for j in range(1, k):
        out = out + per_tok[:, j]
    return out.reshape(B, S, d)
