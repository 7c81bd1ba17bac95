"""Plain float32 reference of the MoE decoder (olmoe-1b-7b): the dense
reference's attention, norms and head (:mod:`.dense`), with a top-k
routed FFN worked out again from the harness's weights.

Routing as the port states it: router logits ``h R`` in float32, the k
largest taken (ties to the lower expert index), their softmax the
weights; each routed expert's ``(silu(h W_g[e]) * (h W_i[e])) W_o[e]``
summed with its weight.  Each expert runs over the tokens routed to it.
Under ``quant="fp8"`` every expert product's operands are rounded to
float8 e4m3 (an expert's matrix under its own scale); the router stays
float32, as the program runs it.

Its layout, products and operations (:mod:`.dense` says what each is) are
the dense family's attention with a router and ``num_experts`` experts in
place of the FFN; of the experts a token touches only its ``top_k``."""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

from . import dense
from .dense import Leaf, fp8

pair_flops = dense.pair_flops


def layout(cfg: Dict[str, Any]) -> Iterator[Leaf]:
    L, d = cfg["n_layers"], cfg["d_model"]
    E, ff = cfg["moe"]["num_experts"], cfg["moe"]["d_ff_expert"]
    yield from dense.attention_layout(cfg)
    yield ("blocks", "ffn", "router"), (L, d, E), "matrix", d
    yield ("blocks", "ffn", "wi"), (L, E, d, ff), "matrix", d
    yield ("blocks", "ffn", "wg"), (L, E, d, ff), "matrix", d
    yield ("blocks", "ffn", "wo"), (L, E, ff, d), "matrix", ff


def products(cfg: Dict[str, Any]) -> List[Tuple[int, int, str]]:
    """The attention's products and the router's, in float32 (the experts
    run on ``moe_gemm``)."""
    return dense.attention_products(cfg) + [
        (cfg["d_model"], cfg["moe"]["num_experts"], "float32")]


def token_flops(cfg: Dict[str, Any]) -> float:
    m = cfg["moe"]
    routed = m["top_k"] * 3 * cfg["d_model"] * m["d_ff_expert"]
    return 2.0 * (sum(K * N for K, N, _ in products(cfg)) + routed)


def moe_ffn(h: torch.Tensor, p: Dict[str, torch.Tensor], l: int,
            cfg: Dict[str, Any], quant: Optional[str]) -> torch.Tensor:
    k = cfg["moe"]["top_k"]
    logits = h @ p["router"][l].float()
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    w = torch.softmax(vals[:, :k], dim=-1)
    idx = idx[:, :k]
    out = torch.zeros_like(h)
    for e in torch.unique(idx).tolist():
        tok, slot = (idx == e).nonzero(as_tuple=True)
        x = h[tok]
        wi, wg, wo = (p[n][l, e].float() for n in ("wi", "wg", "wo"))
        if quant == "fp8":
            x, wi, wg = fp8(x), fp8(wi), fp8(wg)
        y = F.silu(x @ wg) * (x @ wi)
        if quant == "fp8":
            y, wo = fp8(y), fp8(wo)
        out.index_add_(0, tok, (y @ wo) * w[tok, slot, None])
    return out


def logits_at(weights: Dict[str, Any], cfg: Dict[str, Any],
              tokens: torch.Tensor, rows: torch.Tensor,
              quant: Optional[str] = None) -> torch.Tensor:
    return dense.logits_at(weights, cfg, tokens, rows, quant, ffn=moe_ffn)
