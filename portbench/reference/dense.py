"""Plain float32 reference of the dense decoder (phi3-mini-3.8b), in plain
PyTorch: no kernel, no cache, no batching, one sequence at a time.

The equations are the port's, as the configuration file states them (its
``departures`` list where they leave the published model):

* RMS norm ``x * rsqrt(mean(x^2) + eps) * (1 + gain)``;
* attention: q, k, v = h W (per head), RoPE on q and k in the
  half-split form with angles ``pos / theta^(2i / head_dim)``, causal
  softmax of ``q k^T / sqrt(head_dim)``, GQA by repeating each K/V head
  over its group, output W_o;
* FFN ``(silu(h W_g) * (h W_i)) W_o``; the residual adds after each;
* final norm, then the head ``x head^T``.

Weights are the harness's tensors in the port's layout (``blocks``
stacked over layers, ``attn.wq`` (L, d, H, hd), ``attn.wo`` (L, H, hd,
d), ``ffn.wi``/``wg`` (L, d, ff), ``ffn.wo`` (L, ff, d), ``head`` (V, d))
and are read, never changed: each layer's leaves are taken to float32 as
they are used.  TF32 is switched off, so every product is a float32 one.

``quant="fp8"`` is the control: every product's two operands rounded to
float8 e4m3 with one scale a tensor (an expert's matrix its own), the
step that would tempt a bf16 program; everything else stays float32.

A family module also states, from the configuration file alone, what the
harness needs of the family: :func:`layout` (the leaves the harness draws,
in the port's parameter layout), :func:`products` (the ``queue_matmul``
products of one layer, for the roofline), :func:`token_flops` and
:func:`pair_flops` (the model's operations, for ``mfu``).  A new family is
a new module beside this one, named by the file's ``reference`` key.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

FP8_MAX = 448.0

#: ``(path, shape, kind, fan_in)``: kind is ``embed``, ``gain`` or ``matrix``
Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], str, int]


def attention_layout(cfg: Dict[str, Any]) -> Iterator[Leaf]:
    """The embedding, the final norm, the head and every layer's norms and
    attention, in draw order."""
    L, d, V = cfg["n_layers"], cfg["d_model"], cfg["vocab"]
    H, Hkv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    yield ("embed",), (V, d), "embed", 1
    yield ("final_norm",), (d,), "gain", 1
    yield ("head",), (V, d), "matrix", d
    yield ("blocks", "ln1"), (L, d), "gain", 1
    yield ("blocks", "ln2"), (L, d), "gain", 1
    yield ("blocks", "attn", "wq"), (L, d, H, hd), "matrix", d
    yield ("blocks", "attn", "wk"), (L, d, Hkv, hd), "matrix", d
    yield ("blocks", "attn", "wv"), (L, d, Hkv, hd), "matrix", d
    yield ("blocks", "attn", "wo"), (L, H, hd, d), "matrix", H * hd


def layout(cfg: Dict[str, Any]) -> Iterator[Leaf]:
    """Every leaf of the dense decoder, in draw order."""
    L, d, ff = cfg["n_layers"], cfg["d_model"], cfg["d_ff"]
    yield from attention_layout(cfg)
    yield ("blocks", "ffn", "wi"), (L, d, ff), "matrix", d
    yield ("blocks", "ffn", "wg"), (L, d, ff), "matrix", d
    yield ("blocks", "ffn", "wo"), (L, ff, d), "matrix", ff


def attention_products(cfg: Dict[str, Any]) -> List[Tuple[int, int, str]]:
    """(K, N, dtype) of one layer's q, k, v and o products."""
    d, hd, dt = cfg["d_model"], cfg["head_dim"], cfg["dtype"]
    q, kv = cfg["n_heads"] * hd, cfg["n_kv_heads"] * hd
    return [(d, q, dt), (d, kv, dt), (d, kv, dt), (q, d, dt)]


def products(cfg: Dict[str, Any]) -> List[Tuple[int, int, str]]:
    """(K, N, dtype) of each ``queue_matmul`` product of one layer."""
    d, ff, dt = cfg["d_model"], cfg["d_ff"], cfg["dtype"]
    return attention_products(cfg) + [(d, ff, dt), (d, ff, dt), (ff, d, dt)]


def token_flops(cfg: Dict[str, Any]) -> float:
    """Operations of one token through one layer's products: 2 x the
    parameters it touches."""
    return 2.0 * sum(K * N for K, N, _ in products(cfg))


def pair_flops(cfg: Dict[str, Any]) -> float:
    """Operations of one (query, position) pair of one layer's attention:
    a score and a weighted value, over every head."""
    return 4.0 * cfg["head_dim"] * cfg["n_heads"]


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8(t: torch.Tensor, dims=None) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a scale that takes its largest
    magnitude (over ``dims``, or the whole tensor) to 448, back in
    float32."""
    amax = (t.abs().amax() if dims is None
            else t.abs().amax(dim=dims, keepdim=True)).clamp(min=1e-30)
    s = FP8_MAX / amax
    return (t * s).to(torch.float8_e4m3fn).to(torch.float32) / s


def mm(x: torch.Tensor, w: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    if quant == "fp8":
        return fp8(x) @ fp8(w)
    return x @ w


def rms_norm(x: torch.Tensor, gain: torch.Tensor, eps: float) -> torch.Tensor:
    return (x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
            * (1.0 + gain.float()))


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, hd) at positions 0..S-1, half-split rotation."""
    S, _, hd = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=x.device) / hd))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(h: torch.Tensor, p: Dict[str, torch.Tensor], l: int,
              cfg: Dict[str, Any], quant: Optional[str]) -> torch.Tensor:
    S, d = h.shape
    H, Hkv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    q = mm(h, p["wq"][l].float().reshape(d, H * hd), quant).reshape(S, H, hd)
    k = mm(h, p["wk"][l].float().reshape(d, Hkv * hd), quant).reshape(
        S, Hkv, hd)
    v = mm(h, p["wv"][l].float().reshape(d, Hkv * hd), quant).reshape(
        S, Hkv, hd)
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    g = H // Hkv
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    o = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v)
    return mm(o.reshape(S, H * hd), p["wo"][l].float().reshape(H * hd, d),
              quant)


def dense_ffn(h: torch.Tensor, p: Dict[str, torch.Tensor], l: int,
              cfg: Dict[str, Any], quant: Optional[str]) -> torch.Tensor:
    g = F.silu(mm(h, p["wg"][l].float(), quant))
    return mm(g * mm(h, p["wi"][l].float(), quant), p["wo"][l].float(), quant)


FFN = Callable[[torch.Tensor, Dict[str, torch.Tensor], int, Dict[str, Any],
                Optional[str]], torch.Tensor]


@torch.no_grad()
def logits_at(weights: Dict[str, Any], cfg: Dict[str, Any],
              tokens: torch.Tensor, rows: torch.Tensor,
              quant: Optional[str] = None, ffn: FFN = dense_ffn
              ) -> torch.Tensor:
    """The float32 logits (len(rows), vocab) after the positions ``rows``
    of the sequence ``tokens`` (S,), which starts at position 0."""
    no_tf32()
    eps = cfg["norm_eps"]
    blocks = weights["blocks"]
    x = weights["embed"][tokens].float()
    for l in range(cfg["n_layers"]):
        x = x + attention(rms_norm(x, blocks["ln1"][l], eps), blocks["attn"],
                          l, cfg, quant)
        x = x + ffn(rms_norm(x, blocks["ln2"][l], eps), blocks["ffn"], l,
                    cfg, quant)
    x = rms_norm(x[rows], weights["final_norm"], eps)
    return mm(x, weights["head"].float().t(), quant)
