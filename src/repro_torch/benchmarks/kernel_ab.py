"""A/B of the port's fp32 kernels, ``rglru_scan`` and the serve bodies'
row-wise kernels against another checkout's, on one card.

  python -m repro_torch.benchmarks.kernel_ab --other DIR [--out FILE]

``DIR`` is the root of another checkout of this repository (a ``git
archive`` of an earlier commit unpacked under ``build/``, say).  Its
``queue_matmul``, ``moe_gemm``, ``flash_attention``, ``rglru_scan``,
``rms_norm``, ``decode_attention`` and ``latent_attention`` sources are
built into ``DIR/build/kernels/`` and launched through this checkout's
wrappers, whose C interfaces the two must share; none of ``DIR``'s Python
runs.

- Bits: every fp32 product ``chip_smoke.py``'s phase 2 checks
  (``queue_matmul`` over the served, trained and scored models and the entry
  paths, ``moe_gemm`` over olmoe-1b-7b's experts) through both builds, on
  the same inputs: equal bits or not and, where not, each build's max abs
  distance from an fp64 product.
- Times: the fp32 products of train_lm's 100m preset (its head's dX and dW
  too), quickstart's, nemotron-4-340b's head, two decode products, olmoe's
  experts (C = 4, 128 as in ``chip_smoke.py``'s phase 3, and 512), and the
  fp32 attention of train_lm, quickstart and phi3-mini-3.8b: each build's
  device time taken in turns (other, this, this, other), beside one
  library call's (``torch.matmul`` and ``torch.bmm`` in full fp32, SDPA)
  and the work's bound on an H100 (``repro_torch.roofline``).
- ``rglru_scan``: the bits of every forward output at ``chip_smoke.py``'s
  phase 2 shapes (``RGLRU_CASES`` and ``RGLRU_TRAIN``, a and bx in fp32
  and in bf16) through both builds; the reverse walk at phase 5 (a)'s
  shape (``RGLRU_TRAIN``, a in fp32 and in bf16) timed in turns, back to
  back (its inputs partly in L2) and with the L2 flushed before each call
  (``timing.cold_ms``), each build's max abs distance from the plain
  version beside its byte bound; this build's forward at that shape in
  fp32 timed both ways too.
- bf16 ``moe_gemm`` at olmoe-1b-7b's expert products (``MOE_PRODUCTS``):
  the bits of every launch of at most 16 rows an expert (1, 4 and 16,
  every expert and routed top-8) through both builds; then a chunk of 8
  columns of 4 slots (``MOE_CHUNK``), each column's rows routed top-8:
  this build's one row-by-row launch over the 32 rows (the union of the
  columns' masks) against the other's 8 launches of 4 rows (a column's
  mask each, as its decode body ran a chunk), every column's routed rows
  compared bit for bit, timed in turns beside ``torch.bmm`` (x broadcast
  over every expert) and the byte bound of the experts each side reads.
- ``rms_norm`` at every ``NORM_CASES`` row and ``decode_attention`` at
  every ``ATTN_CASES`` row of ``chip_smoke.py``'s phase 2, on its inputs:
  each build's max abs distance from the plain version, whether their
  bits agree, their device times in turns beside the library call
  (``F.rms_norm``, masked SDPA) and the bound phase 2 computes; and the
  floor of one launch (a one-element in-place add) timed the same way.
- ``latent_attention`` at every ``LATENT_CASES`` row of phase 2, on its
  inputs: each build's max abs distance from the plain version, whether
  their bits agree (the fp32 rows must: their path is unchanged), their
  device times in turns beside masked SDPA and the bound phase 2 computes
  (at the inputs' dtype's peak).

Prints one line a case and, with ``--out``, writes the rows as JSON with
the card's name and power limit.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import math
import subprocess
import sys
import types
from pathlib import Path
from typing import Dict, List

import torch

from ..kernels.decode_attention import ops as da_ops
from ..kernels.decode_attention.ref import decode_attention_rows_ref
from ..kernels.flash_attention import ops as fa_ops
from ..kernels.latent_attention import ops as la_ops
from ..kernels.latent_attention.ref import latent_attention_ref
from ..kernels.moe_gemm import ops as mg_ops
from ..kernels.queue_matmul import ops as qm_ops
from ..kernels.rglru_scan import ops as rg_ops
from ..kernels.rglru_scan.ref import rglru_scan_bwd_ref
from ..kernels.rms_norm import ops as rn_ops
from ..kernels.rms_norm.ref import rms_norm_ref
from ..roofline import HBM_BW, PEAK_FLOPS_BY_DTYPE
from .timing import cold_ms, event_ms

ROOT = Path(__file__).resolve().parents[3]
#: the wrapper module of each kernel, whose ``_library`` is swapped
WRAPPERS = {"queue_matmul": qm_ops, "moe_gemm": mg_ops,
            "flash_attention": fa_ops, "rglru_scan": rg_ops,
            "rms_norm": rn_ops, "decode_attention": da_ops,
            "latent_attention": la_ops}
#: olmoe-1b-7b's expert products (E, d, f, x shared by every expert) and
#: a chunk's (columns, slots): phase 4's chunks of 8 over 4 slots
MOE_PRODUCTS = ((64, 2048, 1024, True), (64, 1024, 2048, False))
MOE_CHUNK = (8, 4)


def other_libraries(other: Path) -> Dict[str, object]:
    """The other checkout's kernel libraries, built from its sources with
    its own ``_build`` module and typed by this checkout's wrappers."""
    spec = importlib.util.spec_from_file_location(
        "other_build", other / "src" / "repro_torch" / "kernels" / "_build.py")
    build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(build)
    build.build_all(WRAPPERS)
    load = build.load
    build.load = lambda name: _Lenient(load(name))
    libs = {}
    for name, ops in WRAPPERS.items():
        own = ops._build
        ops._build = build
        try:
            libs[name] = ops._library.__wrapped__()
        finally:
            ops._build = own
    return libs


class _Lenient:
    """A library whose functions this checkout's wrapper types: one the
    other build lacks (a newer export, never launched) is typed on a
    stand-in."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        try:
            return getattr(self._lib, name)
        except AttributeError:
            return types.SimpleNamespace()


@contextlib.contextmanager
def launching(name: str, lib):
    """Launch kernel ``name`` from ``lib`` (None: this checkout's)."""
    ops = WRAPPERS[name]
    own = ops._library
    if lib is not None:
        ops._library = lambda: lib
    try:
        yield
    finally:
        ops._library = own


def turns(fn_other, fn_this, iters: int, timer=event_ms):
    """Device ms of each, taken in turns: other, this, this, other."""
    a1 = timer(fn_other, iters)
    b1 = timer(fn_this, iters)
    b2 = timer(fn_this, iters)
    a2 = timer(fn_other, iters)
    return (a1 + a2) / 2, (b1 + b2) / 2


def bound_ms(flops: float, nbytes: float,
             dtype: torch.dtype = torch.float32) -> float:
    """The least time of the work on an H100: its operations at the peak
    rate of ``dtype`` (fp32: the FMA rate; bf16: the tensor cores') or its
    bytes at the HBM rate, whichever is longer."""
    return max(flops / PEAK_FLOPS_BY_DTYPE[dtype], nbytes / HBM_BW) * 1e3


def fp64_distance(x, w, out) -> float:
    """Max abs distance of ``out`` from x @ w in fp64, 8192 columns at a
    time (nemotron's head weight is 38 GB in fp64)."""
    worst = 0.0
    for c in range(0, w.shape[-1], 8192):
        ref = torch.matmul(x.double(), w[..., c:c + 8192].double())
        worst = max(worst, (out[..., c:c + 8192].double() - ref
                            ).abs().max().item())
    return worst


def product_cases(cs) -> List[tuple]:
    """(label, M, K, N) of every fp32 ``queue_matmul`` product of
    ``chip_smoke.check_queue_matmul``, in its order."""
    cases, seen = [], set()
    for arch in (cs.SERVED + ("granite-moe-3b-a800m",) + cs.ENCODERS
                 + (cs.ENTRY_ARCH,)):
        for name, k, n, dtypes in cs.matmul_shapes(arch):
            if torch.float32 not in dtypes:
                continue
            ms = (4, 512)
            if arch == "phi3-mini-3.8b" and name != "head":
                ms = (4, 64, 128, 512)
            elif name == "wuk/wuv" or arch in cs.ENCODERS:
                ms = (512,)
            for m in ms:
                if (m, k, n) not in seen:
                    seen.add((m, k, n))
                    cases.append((f"{arch.split('-')[0]} {name}", m, k, n))
    for path, cfg, rows, dtype, _ in cs.entry_paths():
        if dtype != torch.float32:
            continue
        for name, k, n, _ in cs.matmul_shapes(cfg):
            for m in rows:
                if (m, k, n) not in seen:
                    seen.add((m, k, n))
                    cases.append((f"{path} {name}", m, k, n))
    return cases


#: products timed in turns: train_lm 100m's (and its head's dX and dW),
#: quickstart's, nemotron-4-340b's head, and two decode products (M = 4:
#: phi3-mini-3.8b's q/k/v/o, recurrentgemma-2b's head)
TIMED = {(4096, 512, 512), (4096, 512, 256), (4096, 512, 2048),
         (4096, 512, 32768), (4096, 2048, 512), (4096, 32768, 512),
         (512, 4096, 32768), (512, 64, 64), (512, 64, 128), (512, 128, 64),
         (2, 64, 64), (512, 18432, 256000), (4, 3072, 3072),
         (4, 2560, 256000)}
#: attention timed in turns, fp32: (B, Hq, Hkv, S, D), causal
ATTENTION = ((8, 8, 4, 512, 64), (8, 4, 4, 64, 16), (1, 32, 32, 512, 96),
             (1, 32, 8, 512, 128), (1, 10, 1, 512, 256))


def rglru_forward_cases(cs) -> List[tuple]:
    """(B, T, w) of every ``rglru_scan`` forward case of ``chip_smoke.py``'s
    phase 2, each compared in fp32 and in bf16."""
    return list(cs.RGLRU_CASES) + [cs.RGLRU_TRAIN]


def rglru_bwd_cases(cs) -> List[tuple]:
    """(B, T, w) of the reverse walk timed in turns: phase 5 (a)'s."""
    return [cs.RGLRU_TRAIN]


def rglru_ab(cs, lib, g, report) -> int:
    """The ``rglru_scan`` rows: forward bits of both builds, then the
    reverse walk in turns.  Returns the forward outputs that differ."""
    differ = 0
    for dtype in (torch.float32, torch.bfloat16):
        for b, t, w in rglru_forward_cases(cs):
            a, bx = cs.rglru_inputs(g, (b, t, w), dtype)
            with launching("rglru_scan", lib):
                other = rg_ops.rglru_scan(a, bx)
            equal = bool(torch.equal(other, rg_ops.rglru_scan(a, bx)))
            differ += not equal
            row = {"kernel": "rglru_scan", "case": f"{b},{t},{w} "
                   f"{str(dtype)[6:]}", "equal": equal}
            if (b, t, w) in rglru_bwd_cases(cs) and dtype == torch.float32:
                # the training shape's forward, this build, warm and cold
                row["this_ms"] = event_ms(lambda: rg_ops.rglru_scan(a, bx),
                                          50)
                row["this_cold_ms"] = cold_ms(
                    lambda: rg_ops.rglru_scan(a, bx), 50)
                row["bound_ms"] = b * t * w * (2 * a.element_size() + 4) \
                    / HBM_BW * 1e3
            report(row)
    for dtype in (torch.float32, torch.bfloat16):
        for b, t, w in rglru_bwd_cases(cs):
            a, bx = cs.rglru_inputs(g, (b, t, w), dtype)
            gr = torch.randn((b, t, w), generator=g, device="cuda")
            h = rg_ops.rglru_scan(a, bx)

            def other():
                with launching("rglru_scan", lib):
                    return rg_ops.rglru_scan_bwd(a, h, gr)
            ref = rglru_scan_bwd_ref(a, h, gr)
            outs = other(), rg_ops.rglru_scan_bwd(a, h, gr)
            errs = [max((x - r).abs().max().item() for x, r in zip(o, ref))
                    for o in outs]
            again = rg_ops.rglru_scan_bwd(a, h, gr)
            row = {"kernel": "rglru_scan_bwd", "case": f"{b},{t},{w} a "
                   f"{str(dtype)[6:]}", "other_err": errs[0],
                   "this_err": errs[1],
                   "deterministic": all(torch.equal(x, y) for x, y
                                        in zip(outs[1], again))}
            row["other_ms"], row["this_ms"] = turns(
                other, lambda: rg_ops.rglru_scan_bwd(a, h, gr), 50)
            row["other_cold_ms"], row["this_cold_ms"] = turns(
                other, lambda: rg_ops.rglru_scan_bwd(a, h, gr), 50,
                timer=cold_ms)
            # a (its dtype), g and h read, dh and da written (fp32)
            row["bound_ms"] = b * t * w * (a.element_size() + 16) \
                / HBM_BW * 1e3
            row["this_of_bound"] = row["bound_ms"] / row["this_ms"]
            report(row)
            del outs, again, ref
    return differ


def _err(out, ref) -> float:
    return (out.float() - ref.float()).abs().max().item()


def row_kernels_ab(cs, libs, g, report) -> None:
    """The launch floor, then ``rms_norm`` at ``NORM_CASES`` and
    ``decode_attention`` at ``ATTN_CASES`` through both builds: distances
    from the plain version, bits, times in turns beside the library and
    the bound."""
    import torch.nn.functional as F
    one = torch.zeros(1, device="cuda")
    report({"kernel": "floor", "case": "one-element in-place add",
            "this_ms": event_ms(lambda: one.add_(1), 50)})
    for model, rows, d, dtype, gdt in cs.NORM_CASES:
        x, gm = cs.norm_inputs(g, rows, d, dtype, gdt)

        def other():
            with launching("rms_norm", libs["rms_norm"]):
                return rn_ops.rms_norm(x, gm)
        ref = rms_norm_ref(x, gm)
        outs = other(), rn_ops.rms_norm(x, gm)
        row = {"kernel": "rms_norm", "case": f"{model} {rows}x{d} "
               f"{str(dtype)[6:]} gamma {str(gdt)[6:]}",
               "other_err": _err(outs[0], ref), "this_err": _err(outs[1], ref),
               "equal": bool(torch.equal(*outs))}
        row["other_ms"], row["this_ms"] = turns(
            other, lambda: rn_ops.rms_norm(x, gm), 50)
        weight = (1.0 + gm.float()).to(dtype)
        row["library_ms"] = event_ms(
            lambda: F.rms_norm(x, (d,), weight, 1e-5), 50)
        row["bound_ms"] = bound_ms(*cs.norm_work(x, gm))
        report(row)
    def call_other(q, k, v, valid):
        with launching("decode_attention", libs["decode_attention"]):
            return da_ops.decode_attention(q, k, v, valid)
    for model, b, c, hq, hkv, t, d, dtype, lens in cs.ATTN_CASES:
        q, k, v, valid = cs.attn_inputs(g, b, c, hq, hkv, t, d, dtype, lens)
        ref = decode_attention_rows_ref(q, k, v, valid)
        outs = (call_other(q, k, v, valid),
                da_ops.decode_attention(q, k, v, valid))
        row = {"kernel": "decode_attention", "case": f"{model} {b},{c},"
               f"{hq}/{hkv},{t},{d} {str(dtype)[6:]}",
               "other_err": _err(outs[0], ref), "this_err": _err(outs[1], ref),
               "equal": bool(torch.equal(*outs))}
        row["other_ms"], row["this_ms"] = turns(
            lambda: call_other(q, k, v, valid),
            lambda: da_ops.decode_attention(q, k, v, valid), 20)
        row["library_ms"] = event_ms(cs.attn_library(q, k, v, valid), 20)
        row["bound_ms"] = bound_ms(*cs.attn_work(q, k, valid))
        row["this_of_bound"] = row["bound_ms"] / row["this_ms"]
        report(row)
        del q, k, v, ref, outs
        torch.cuda.empty_cache()


def latent_ab(cs, lib, g, report) -> int:
    """``latent_attention`` at every ``LATENT_CASES`` row through both
    builds: distances from the plain version, bits, times in turns beside
    SDPA and the bound.  Returns the fp32 rows whose bits differ."""
    scale = 1.0 / math.sqrt(cs.LATENT_QK)
    differ = 0
    for case, b, c, h, t, r, dr, dtype, lens in cs.LATENT_CASES:
        args = cs.latent_inputs(g, b, c, h, t, r, dr, dtype, lens)
        q, qr, lat, _, rows, _, _ = args

        def other():
            with launching("latent_attention", lib):
                return la_ops.latent_attention(*args, scale)

        def this():
            return la_ops.latent_attention(*args, scale)
        ref = latent_attention_ref(*args, scale)
        outs = other(), this()
        row = {"kernel": "latent_attention", "case": f"{case} {b},{c},{h},"
               f"{t},{r}/{dr} {str(dtype)[6:]}",
               "other_err": _err(outs[0], ref), "this_err": _err(outs[1], ref),
               "equal": bool(torch.equal(*outs))}
        differ += dtype == torch.float32 and not row["equal"]
        row["other_ms"], row["this_ms"] = turns(other, this, 20)
        row["library_ms"] = event_ms(cs.latent_library(*args), 20)
        row["bound_ms"] = bound_ms(
            *cs.latent_work(q, qr, rows, lat.element_size()), dtype)
        row["this_of_bound"] = row["bound_ms"] / row["this_ms"]
        report(row)
        del args, q, qr, lat, rows, ref, outs
        torch.cuda.empty_cache()
    return differ


def moe_rows_ab(cs, lib, g, report) -> int:
    """The bf16 ``moe_gemm`` rows: the bits of every launch of at most 16
    rows an expert through both builds, then a chunk row by row (this
    build) against its columns (the other) in turns.  Returns the launches
    and chunks whose bits differ."""
    differ = 0
    cols, slots = MOE_CHUNK
    n = cols * slots
    for e, d, f, bcast in MOE_PRODUCTS:
        w = (torch.randn((e, d, f), generator=g, device="cuda")
             / d ** 0.5).bfloat16()
        x = torch.randn((n, d) if bcast else (e, n, d), generator=g,
                        device="cuda").bfloat16()
        if bcast:
            x = x.expand(e, n, d)
        label = f"olmoe bf16 E={e} d={d} f={f}"
        for c in (1, 4, 16):
            for routed in (False, True):
                active = cs.routed_mask(g, c, e, 8) if routed else None
                with launching("moe_gemm", lib):
                    a = mg_ops.moe_gemm(x[:, :c], w, active=active)
                equal = bool(torch.equal(
                    a, mg_ops.moe_gemm(x[:, :c], w, active=active)))
                differ += not equal
                report({"kernel": "moe_gemm", "case": f"{label} C={c}"
                        + (" routed" if routed else ""), "equal": equal})
        masks = [cs.routed_mask(g, slots, e, 8) for _ in range(cols)]
        union = torch.stack(masks).amax(0)

        def other():
            with launching("moe_gemm", lib):
                return [mg_ops.moe_gemm(x[:, j * slots:(j + 1) * slots], w,
                                        active=masks[j])
                        for j in range(cols)]

        def this():
            return mg_ops.moe_gemm(x, w, active=union, slab=slots)
        columns, rows = other(), this()
        equal = all(torch.equal(
            rows[masks[j] != 0][:, j * slots:(j + 1) * slots],
            columns[j][masks[j] != 0]) for j in range(cols))
        differ += not equal
        row = {"kernel": "moe_gemm", "case": f"{label} chunk {cols}x{slots}"
               f" row by row (this) against {cols} columns (other)",
               "equal": equal, "active": int((union != 0).sum()),
               "column_active": [int((m != 0).sum()) for m in masks]}
        row["other_ms"], row["this_ms"] = turns(other, this, 20)
        xf = x.contiguous()
        row["library_ms"] = event_ms(lambda: torch.bmm(xf, w), 20)
        # the bytes each side must move: x once (once per column's active
        # experts for a per-expert x), the active experts' weights and the
        # fp32 output; the other side reads each column's experts again
        out_b, w_b = e * n * f * 4, d * f * w.element_size()

        def nbytes(active, rows_):
            x_b = (rows_ if bcast else active * rows_) * d * x.element_size()
            return x_b + active * w_b
        row["bound_ms"] = nbytes(row["active"], n) / HBM_BW * 1e3 + \
            out_b / HBM_BW * 1e3
        row["other_bound_ms"] = sum(
            nbytes(a, slots) for a in row["column_active"]) / HBM_BW * 1e3 \
            + out_b / HBM_BW * 1e3
        report(row)
        del x, w, columns, rows
        torch.cuda.empty_cache()
    return differ


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="root of the other checkout")
    ap.add_argument("--out", default=None, help="write the rows as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    libs = other_libraries(args.other.resolve())
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    rows, differ = [], 0

    def report(row):
        rows.append(row)
        print("[ab] " + " ".join(f"{k}={v:.4f}" if isinstance(v, float)
                                 else f"{k}={v}" for k, v in row.items()),
              flush=True)

    for label, m, k, n in (product_cases(cs) + [
            ("train_lm head dX", 4096, 32768, 512),
            ("train_lm head dW", 512, 4096, 32768)]):
        x = torch.randn((m, k), generator=g, device="cuda")
        w = torch.randn((k, n), generator=g, device="cuda").div_(math.sqrt(k))
        with launching("queue_matmul", libs["queue_matmul"]):
            a = qm_ops.queue_matmul(x, w)
        b = qm_ops.queue_matmul(x, w)
        row = {"kernel": "queue_matmul", "case": label, "M": m, "K": k,
               "N": n, "equal": bool(torch.equal(a, b))}
        if not row["equal"]:
            differ += 1
            row["other_fp64"] = fp64_distance(x, w, a)
            row["this_fp64"] = fp64_distance(x, w, b)
        del a, b
        if (m, k, n) in TIMED:
            iters = 3 if 2.0 * m * k * n > 1e12 else 20

            def other():
                with launching("queue_matmul", libs["queue_matmul"]):
                    qm_ops.queue_matmul(x, w)
            row["other_ms"], row["this_ms"] = turns(
                other, lambda: qm_ops.queue_matmul(x, w), iters)
            row["library_ms"] = event_ms(lambda: torch.matmul(x, w), iters)
            row["bound_ms"] = bound_ms(2.0 * m * k * n,
                                       4.0 * (m * k + k * n + m * n))
            row["this_tflops"] = 2.0 * m * k * n / row["this_ms"] / 1e9
        report(row)
        del x, w
        torch.cuda.empty_cache()

    for c, routed in ((4, False), (4, True), (128, False), (512, False)):
        for d, f, bcast in ((2048, 1024, True), (1024, 2048, False)):
            e = 64
            x = (torch.randn((c, d), generator=g, device="cuda")
                 .expand(e, c, d) if bcast
                 else torch.randn((e, c, d), generator=g, device="cuda"))
            w = torch.randn((e, d, f), generator=g, device="cuda") / d ** 0.5
            active = cs.routed_mask(g, c, e, 8) if routed else None
            with launching("moe_gemm", libs["moe_gemm"]):
                a = mg_ops.moe_gemm(x, w, active=active)
            b = mg_ops.moe_gemm(x, w, active=active)
            row = {"kernel": "moe_gemm", "case": f"olmoe E={e} C={c} d={d} "
                   f"f={f}" + (" routed" if routed else ""),
                   "equal": bool(torch.equal(a, b))}
            if not row["equal"]:
                differ += 1
            if not routed:
                def other():
                    with launching("moe_gemm", libs["moe_gemm"]):
                        mg_ops.moe_gemm(x, w)
                row["other_ms"], row["this_ms"] = turns(
                    other, lambda: mg_ops.moe_gemm(x, w), 20)
                row["library_ms"] = event_ms(lambda: torch.bmm(x, w), 20)
                x_elems = (c if bcast else e * c) * d
                row["bound_ms"] = bound_ms(
                    2.0 * e * c * d * f,
                    4.0 * (x_elems + e * d * f + e * c * f))
            report(row)

    for b, hq, hkv, s, d in ATTENTION:
        q = torch.randn((b, hq, s, d), generator=g, device="cuda")
        k = torch.randn((b, hkv, s, d), generator=g, device="cuda")
        v = torch.randn((b, hkv, s, d), generator=g, device="cuda")

        def other():
            with launching("flash_attention", libs["flash_attention"]):
                return fa_ops.flash_attention(q, k, v, causal=True)
        ref = fa_ops._plain(q, k, v, True, None, 0)
        errs = [(o - ref).abs().max().item()
                for o in (other(), fa_ops.flash_attention(q, k, v))]
        row = {"kernel": "flash_attention", "case": f"{b},{hq}/{hkv},{s},{d}"
               " causal", "other_err": errs[0], "this_err": errs[1]}
        row["other_ms"], row["this_ms"] = turns(
            other, lambda: fa_ops.flash_attention(q, k, v, causal=True), 20)
        row["library_ms"] = event_ms(lambda: cs._sdpa(q, k, v, True, None, 0),
                                     20)
        # as chip_smoke.py bounds it: QK^T and PV over the causal pairs;
        # q and k, then v and the output, read or written once
        pairs = b * hq * s * (s + 1) / 2
        row["bound_ms"] = bound_ms(2.0 * pairs * 2 * d,
                                   4.0 * b * (hq + hkv) * s * 2 * d)
        report(row)

    differ += moe_rows_ab(cs, libs["moe_gemm"], g, report)
    products = sum(r["kernel"] in ("queue_matmul", "moe_gemm") for r in rows)
    print(f"[ab] {differ} of {products} products differ in bits", flush=True)
    scans = rglru_ab(cs, libs["rglru_scan"], g, report)
    forward = sum(r["kernel"] == "rglru_scan" for r in rows)
    print(f"[ab] {scans} of {forward} rglru_scan forward outputs differ in "
          f"bits", flush=True)
    row_kernels_ab(cs, libs, g, report)
    latent = latent_ab(cs, libs["latent_attention"], g, report)
    fp32 = sum(case[7] == torch.float32 for case in cs.LATENT_CASES)
    print(f"[ab] {latent} of {fp32} fp32 latent_attention rows differ in "
          f"bits", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": smi, "rows": rows},
                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
