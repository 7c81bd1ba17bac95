"""Which ops of a decode body give a row other bits when they run over more
rows: each candidate op over a chunk's B x C rows against the same op over
each column's B rows alone, on the card, at phi3-mini-3.8b's full widths
(an MoE layer's at olmoe-1b-7b's).

A chunk of C columns can run as one batched body (``models.model``'s
``prefill_step``) and keep token prefill's bits only if every op it runs
gives a row the bits that the decode body, over B rows, gives it.  This
reports, for every candidate, whether the rows are bit-equal and the
largest difference where they are not: the products in each regime of
``queue_matmul`` and run row by row (``slab``), the norm and decode
attention in their plain PyTorch form and as the port's kernels, RoPE, the
embedding gather and the FFN's elementwise ops, and an MoE layer's expert
products (``moe_gemm`` in each regime and row by row) and its row-wise
combine (``models.moe.combine_rows``); and, at falcon-mamba-7b's and
recurrentgemma-2b's full widths, the recurrent blocks' conv over a chunk's
columns (``models.layers.conv_columns``, against one column at a time from
the state the columns before it leave), their coefficients
(``models.ssm.ssm_coeffs`` with the softplus before it,
``models.rglru.gate_coeffs``), the recurrence steps and the SSM readout;
and, at minicpm3-4b's, an MLA layer's latent attention kernel, its two
per-head absorb products (``moe_gemm`` row by row, the heads as experts)
and its clamped write of a chunk's latent rows
(``models.attention._write_clamped_rows``, against one column at a time).

  PYTHONPATH=src python -m repro_torch.benchmarks.row_bits [--out PATH]

On the card unless ``--device cpu``; prints one JSON object a
candidate, then the device's name.
"""
from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, List

import torch
import torch.nn.functional as F

from ..device import resolve_device

#: phi3-mini-3.8b's decode widths: d, heads of 96 (as many K/V heads), vocab
D, HEADS, HD, VOCAB = 3072, 32, 96, 32064
#: what a chunk's batched body runs, each of which must keep a row's bits
BODY_OPS = ("queue_matmul row by row", "rms_norm (kernel)", "apply_rope",
            "silu(a) * b, residual add", "relu(a)^2, gelu(a)",
            "embedding gather", "decode_attention (kernel)",
            "moe_gemm row by row", "moe combine", "conv over columns",
            "ssm coefficients", "rglru gates", "ssm recurrence step",
            "rglru recurrence step", "ssm readout",
            "latent_attention (kernel)", "mla absorb", "mla clamped write")
#: olmoe-1b-7b's MoE widths: experts, top-k, d, the expert's d_ff
EXPERTS, TOP_K, MOE_D, MOE_F = 64, 8, 2048, 1024
#: a chunk: B slots of C columns, a cache of T positions
B, C, T = 4, 8, 256
#: falcon-mamba-7b's widths: d_inner, state, conv width; and
#: recurrentgemma-2b's RG-LRU width
SSM_D, SSM_N, CONV_K = 8192, 16, 4
LRU_W = 2560
#: minicpm3-4b's MLA widths: heads, latent, rope key, q/k nope part, v
MLA_H, MLA_R, MLA_DR, MLA_NOPE, MLA_V = 40, 256, 32, 64, 64


def _rows_equal(name: str, dtype: torch.dtype,
                op: Callable[[slice], torch.Tensor], rows: int,
                slab: int) -> Dict[str, object]:
    """``op`` over rows ``[0, rows)`` at once against ``op`` over each
    ``slab`` of them alone (``op`` takes the rows as a slice)."""
    full = op(slice(0, rows))
    parts = torch.cat([op(slice(i, i + slab)) for i in range(0, rows,
                                                             slab)])
    diff = (full.float() - parts.float()).abs().max().item()
    return {"op": name, "dtype": str(dtype).replace("torch.", ""),
            "rows": rows, "slab": slab,
            "bit_equal": bool(torch.equal(full, parts)), "max_abs": diff}


def _attention_batched(q, k, v, valid):
    """``decode_attention_ref``'s arithmetic over C queries a slot at once:
    q (B, H, C, D), valid (B, C)."""
    from ..device import upcast
    from ..kernels.decode_attention.ref import NEG_INF
    scale = 1.0 / q.shape[-1] ** 0.5
    s = torch.einsum("bhcd,bhtd->bhct", upcast(q), upcast(k)) * scale
    pos = torch.arange(k.shape[2], device=q.device)
    mask = pos[None, None] < valid[:, :, None]
    s = torch.where(mask[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhct,bhtd->bhcd", p, upcast(v)).to(v.dtype)


def _conv_columns(name: str, dtype: torch.dtype, randn, width: int
                  ) -> Dict[str, object]:
    """``conv_columns`` over a chunk's C columns against one column at a
    time, each from the state the columns before it leave: the outputs and
    the last state."""
    from ..models.layers import conv_columns
    p = {"conv_w": randn(CONV_K, width).to(dtype),
         "conv_b": randn(width).to(dtype)}
    x = randn(C, B, width).to(dtype)
    state = randn(B, CONV_K - 1, width).to(dtype)
    full, last = conv_columns(p, x, state)
    cols = []
    for j in range(C):
        out, state = conv_columns(p, x[j:j + 1], state)
        cols.append(out)
    cols = torch.cat(cols)
    equal = torch.equal(full, cols) and torch.equal(last, state)
    diff = max((full.float() - cols.float()).abs().max().item(),
               (last.float() - state.float()).abs().max().item())
    return {"op": name, "dtype": str(dtype).replace("torch.", ""),
            "rows": B * C, "slab": B, "bit_equal": bool(equal),
            "max_abs": diff}


def _recurrent(dtype: torch.dtype, randn, rand) -> List[Dict[str, object]]:
    """The recurrent blocks' ops at falcon-mamba-7b's and
    recurrentgemma-2b's full widths, over a chunk's B x C rows against B
    rows: the conv, the coefficients (from the products' outputs), the
    recurrence steps and the SSM readout."""
    import torch.nn.functional as F
    from ..models.rglru import gate_coeffs, rglru_step
    from ..models.ssm import ssm_coeffs, ssm_step
    n = B * C
    out = [_conv_columns("conv over columns (falcon-mamba)", dtype, randn,
                         SSM_D),
           _conv_columns("conv over columns (recurrentgemma)", dtype,
                         randn, LRU_W)]
    # Mamba: the conv's output through silu, dt's product plus its bias
    # through softplus, then dA and dBx
    xi = F.silu(randn(n, SSM_D).to(dtype))
    dt_lin = randn(n, SSM_D).to(dtype)
    dt_bias = randn(SSM_D).to(dtype)
    Bc = randn(n, SSM_N).to(dtype)
    A = -torch.exp(0.5 * randn(SSM_D, SSM_N))

    def coeffs(r):
        dt = F.softplus(dt_lin[r] + dt_bias)
        dA, dBx = ssm_coeffs(dt, A, Bc[r], xi[r])
        return torch.cat([dA.flatten(1), dBx.flatten(1)], dim=1)

    out.append(_rows_equal("ssm coefficients (softplus, dA, dBx)", dtype,
                           coeffs, n, B))
    state = randn(n, SSM_D, SSM_N)
    dA = torch.exp(-rand(n, SSM_D, SSM_N))
    dBx = randn(n, SSM_D, SSM_N)
    Cc = randn(n, SSM_N).to(dtype)
    for i, what in enumerate(("recurrence step (dA * s + dBx)",
                              "readout (einsum bdn,bn->bd)")):
        out.append(_rows_equal(
            f"ssm {what}", dtype,
            lambda r, i=i: ssm_step(state[r], dA[r], dBx[r], Cc[r])[i], n,
            B))
    # RG-LRU: the gates from the products' outputs, then h = a * h + bx
    p = {"rg_b": randn(LRU_W).to(dtype), "ig_b": randn(LRU_W).to(dtype),
         "lam": randn(LRU_W)}
    u = randn(n, LRU_W).to(dtype)
    rg, ig = randn(n, LRU_W).to(dtype), randn(n, LRU_W).to(dtype)
    out.append(_rows_equal(
        "rglru gates (sigmoids, log_a, a, beta * i * u)", dtype,
        lambda r: torch.cat(gate_coeffs(p, u[r], rg[r], ig[r]), dim=1),
        n, B))
    h = randn(n, LRU_W)
    a = rand(n, LRU_W)
    bx = randn(n, LRU_W)
    out.append(_rows_equal("rglru recurrence step (a * h + bx)", dtype,
                           lambda r: rglru_step(h[r], a[r], bx[r])[0], n, B))
    return out


def _mla(dtype: torch.dtype, randn) -> List[Dict[str, object]]:
    """An MLA layer's ops at minicpm3-4b's full widths over a chunk's
    B x C rows against B rows: the latent attention kernel (column c's
    queries read rows [0, min(len + c, T - 1)) and their own new row), the
    two per-head absorb products row by row, and the clamped write of the
    columns' latent rows (slots at lengths that reach T - 1, several
    columns clamping onto it) against one column at a time."""
    from ..kernels import latent_attention, moe_gemm
    from ..models.attention import _write_clamped_rows
    n, H = B * C, MLA_H
    q = randn(C, B, H, MLA_R).to(dtype)
    qr = randn(C, B, H, MLA_DR).to(dtype)
    lat, rope = randn(B, T, MLA_R).to(dtype), randn(B, T, MLA_DR).to(dtype)
    own, own_r = randn(C, B, MLA_R).to(dtype), randn(C, B, MLA_DR).to(dtype)
    lens = torch.tensor([5, 17, 250, 200], device=lat.device)
    pos = lens[None] + torch.arange(C, device=lat.device)[:, None]
    rows = pos.clamp(max=T - 1)
    scale = 1.0 / (MLA_NOPE + MLA_DR) ** 0.5

    def attend(r):
        cs = slice(r.start // B, r.stop // B)
        return latent_attention(q[cs], qr[cs], lat, rope, rows[cs], own[cs],
                                own_r[cs], scale).reshape(-1, H, MLA_R)

    out = [_rows_equal("latent_attention (kernel), C queries against 1",
                       dtype, attend, n, B)]
    for what, k, m in (("q_nope W_uk", MLA_NOPE, MLA_R),
                       ("o_lat W_uv", MLA_R, MLA_V)):
        w = (randn(H, k, m) / k ** 0.5).to(dtype)
        x = randn(H, n, k).to(dtype)
        out.append(_rows_equal(
            f"mla absorb {what} row by row (slab {B}), {n} rows against "
            f"{B}", dtype,
            lambda r: moe_gemm(x[:, r], w, slab=B).transpose(0, 1), n, B))
    active = (torch.arange(C, device=lat.device)[:, None]
              < torch.tensor([8, 3, 5, 0], device=lat.device)[None])
    full = lat.clone()
    _write_clamped_rows(full, pos, own, active)
    cols = lat.clone()
    for j in range(C):
        _write_clamped_rows(cols, pos[j:j + 1], own[j:j + 1],
                            active[j:j + 1])
    out.append({"op": "mla clamped write, C columns against 1",
                "dtype": str(dtype).replace("torch.", ""), "rows": n,
                "slab": B, "bit_equal": bool(torch.equal(full, cols)),
                "max_abs": (full.float() - cols.float()).abs().max()
                .item()})
    return out


def candidates(device: torch.device, seed: int = 0,
               dtypes=(torch.float32, torch.bfloat16)
               ) -> List[Dict[str, object]]:
    """Every candidate op at B x C rows against B rows, in each of
    ``dtypes``."""
    from ..kernels import decode_attention, moe_gemm, queue_matmul
    from ..kernels import rms_norm as rms_norm_kernel
    from ..kernels.decode_attention.ref import decode_attention_ref
    from ..models.layers import apply_rope, rms_norm, rope_angles
    from ..models.moe import combine_rows
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    out = []
    for dtype in dtypes:
        w = (randn(D, D) / D ** 0.5).to(dtype)
        x = randn(B * C, D).to(dtype)
        # the products: thin (bf16, M <= 16) within 16 rows, and the
        # regime B x C rows take (wide in bf16) against the slabs' (thin)
        n = B * C
        out.append(_rows_equal("queue_matmul, 16 rows against 4", dtype,
                               lambda r: queue_matmul(x[r], w), 16, B))
        out.append(_rows_equal("queue_matmul, 32 rows against 4", dtype,
                               lambda r: queue_matmul(x[r], w), n, B))
        xx = randn(4 * n, D).to(dtype)
        for rows in (n, 4 * n):
            out.append(_rows_equal(
                f"queue_matmul row by row (slab {B}), {rows} rows against "
                f"{B}", dtype, lambda r: queue_matmul(xx[r], w, slab=B),
                rows, B))
        gamma = (0.1 * randn(D)).to(dtype)
        out.append(_rows_equal("rms_norm (plain)", dtype,
                               lambda r: rms_norm(x[r], gamma), n, B))
        out.append(_rows_equal("rms_norm (kernel)", dtype,
                               lambda r: rms_norm_kernel(x[r], gamma), n, B))
        # RoPE at positions len + j, one row a (column, slot)
        cos, sin = rope_angles(torch.arange(n, device=device) + 3, HD,
                               10000.0)
        qh = x.reshape(n, HEADS, HD)
        out.append(_rows_equal(
            "apply_rope", dtype,
            lambda r: apply_rope(qh[r], cos[r, None], sin[r, None]), n, B))
        out.append(_rows_equal("silu(a) * b, residual add", dtype,
                               lambda r: F.silu(x[r]) * x[r] + x[r], n, B))
        out.append(_rows_equal("relu(a)^2, gelu(a)", dtype,
                               lambda r: torch.square(F.relu(x[r]))
                               + F.gelu(x[r], approximate="tanh"), n, B))
        table = randn(VOCAB, D).to(dtype)
        toks = torch.randint(0, VOCAB, (n,), generator=gen, device=device)
        out.append(_rows_equal("embedding gather", dtype,
                               lambda r: table[toks[r]], n, B))
        # decode attention: C queries a slot in one call against one
        # column's queries (the decode body's call) at a time
        kc, vc = randn(B, HEADS, T, HD).to(dtype), randn(B, HEADS, T,
                                                         HD).to(dtype)
        q = randn(B, HEADS, C, HD).to(dtype)
        lens = torch.tensor([5, 17, 100, 200], device=device)
        valid = lens[:, None] + torch.arange(C, device=device)[None] + 1
        full = _attention_batched(q, kc, vc, valid)
        cols = torch.stack([decode_attention_ref(
            q[:, :, j:j + 1], kc, vc, valid[:, j])[:, :, 0]
            for j in range(C)], dim=2)
        out.append({"op": "decode_attention_ref, C queries against 1",
                    "dtype": str(dtype).replace("torch.", ""),
                    "rows": B * C, "slab": B,
                    "bit_equal": bool(torch.equal(full, cols)),
                    "max_abs": (full.float() - cols.float()).abs().max()
                    .item()})
        # the kernel, queries (C, B, H, D): column c's rows are slab c
        qk = q.permute(2, 0, 1, 3).contiguous()
        vk = valid.t().contiguous()
        out.append(_rows_equal(
            "decode_attention (kernel), C queries against 1", dtype,
            lambda r: decode_attention(
                qk[r.start // B:r.stop // B], kc, vc,
                vk[r.start // B:r.stop // B]).reshape(-1, HEADS, HD),
            n, B))
        # an MoE layer: the expert products (x shared by every expert, as
        # the dense dispatch hands it) in their regime and row by row, rows
        # first so that the slabs are concatenated along them
        we = (randn(EXPERTS, MOE_D, MOE_F) / MOE_D ** 0.5).to(dtype)
        xe = randn(2 * n, MOE_D).to(dtype)
        out.append(_rows_equal(
            f"moe_gemm, {n} rows against {B}", dtype,
            lambda r: moe_gemm(xe[r], we).transpose(0, 1), n, B))
        for rows in (n, 2 * n):
            out.append(_rows_equal(
                f"moe_gemm row by row (slab {B}), {rows} rows against {B}",
                dtype, lambda r: moe_gemm(xe[r], we, slab=B).transpose(0, 1),
                rows, B))
        del we
        y = randn(EXPERTS, n, MOE_D).to(dtype)
        logits = randn(n, EXPERTS)
        top, idx = logits.topk(TOP_K, dim=-1)
        wt = torch.softmax(top, dim=-1)
        out.append(_rows_equal(
            "moe combine (combine_rows)", dtype,
            lambda r: combine_rows(y[:, r], wt[r], idx[r]), n, B))
        del y
        out.extend(_recurrent(dtype, randn, rand))
        out.extend(_mla(dtype, randn))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the rows here")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' "
                         "checks the plain versions there)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = candidates(dev)
    for r in rows:
        print(json.dumps(r))
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else dev.type)
    print(f"# {name}; torch {torch.__version__}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": name, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
