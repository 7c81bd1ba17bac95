"""``repro_torch.benchmarks.kernel_ab`` without a card: the fp32 products
it compares are those ``chip_smoke.py``'s phase 2 checks, each once, the
shapes it times are among them, its ``rglru_scan`` cases are phase 2's and
phase 5 (a)'s, its ``rms_norm``, ``decode_attention`` and
``latent_attention`` rows are phase 2's on phase 2's inputs and bounds
(whose 4K rows' tolerance sees a lost group or span position), its
``moe_gemm`` chunk is phase 4's, and it refuses to run without a card."""
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from _calibration_isolation import isolated_calibration  # noqa: F401

from repro_torch.benchmarks import kernel_ab

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def test_the_cases_are_phase_2s_fp32_products_once(smoke):
    cases = kernel_ab.product_cases(smoke)
    shapes = [(m, k, n) for _, m, k, n in cases]
    assert len(shapes) == len(set(shapes))
    # train_lm 100m's five products over 4096 tokens and quickstart's
    # three at 512 tokens and 2 slots
    for shape in [(4096, 512, 512), (4096, 512, 256), (4096, 512, 2048),
                  (4096, 2048, 512), (4096, 512, 32768), (512, 64, 64),
                  (2, 64, 128), (512, 128, 64)]:
        assert shape in shapes
    # nemotron-4-340b's head and ffn wo at full width, decode and forward
    for shape in [(4, 18432, 256000), (512, 18432, 256000),
                  (512, 73728, 18432)]:
        assert shape in shapes
    # the router runs in fp32 only; every bf16-only product is absent
    assert (4, 2048, 64) in shapes
    timed_extra = {(4096, 32768, 512), (512, 4096, 32768)}
    assert kernel_ab.TIMED <= set(shapes) | timed_extra


def test_it_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kernel_ab.main(["--other", str(ROOT)]) == 1
    assert "needs a CUDA card" in capsys.readouterr().err


def _names_in(smoke, fn):
    """The module-level names a function of chip_smoke.py reads."""
    import ast
    import inspect
    tree = ast.parse(inspect.getsource(getattr(smoke, fn)))
    return {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}


def test_the_rglru_cases_are_phase_2s_and_phase_5as(smoke):
    """The forward bits are compared at phase 2's ``rglru_scan`` shapes
    and the reverse walk timed at phase 5 (a)'s: recurrentgemma-2b's width
    at its training shape (2 x 512 tokens)."""
    from repro_torch.configs import get_config
    assert "rglru_scan" in kernel_ab.WRAPPERS
    assert {"RGLRU_CASES", "RGLRU_TRAIN"} <= _names_in(smoke,
                                                      "check_rglru_scan")
    assert "RGLRU_TRAIN" in _names_in(smoke, "check_rglru_scan_bwd")
    fwd = kernel_ab.rglru_forward_cases(smoke)
    assert fwd == list(smoke.RGLRU_CASES) + [smoke.RGLRU_TRAIN]
    assert len(set(fwd)) == len(fwd)
    assert kernel_ab.rglru_bwd_cases(smoke) == [smoke.RGLRU_TRAIN]
    cfg = get_config("recurrentgemma-2b")
    width = cfg.rglru.lru_width or cfg.d_model
    assert smoke.RGLRU_TRAIN == (2, 512, width)
    assert all(w == width for _, _, w in smoke.RGLRU_CASES)



def test_the_row_kernels_are_phase_2s_rows(smoke):
    """``rms_norm`` and ``decode_attention`` are compared at every
    ``NORM_CASES`` and ``ATTN_CASES`` row, on the inputs, library call and
    bound phase 2 draws and computes (the same functions of chip_smoke.py),
    the 4K rows included."""
    import inspect
    assert {"rms_norm", "decode_attention"} <= set(kernel_ab.WRAPPERS)
    assert {"NORM_CASES", "norm_inputs", "norm_work"} <= _names_in(
        smoke, "check_rms_norm")
    assert {"ATTN_CASES", "attn_inputs", "attn_library", "attn_work"} <= \
        _names_in(smoke, "check_decode_attention")
    src = inspect.getsource(kernel_ab.row_kernels_ab)
    for name in ("NORM_CASES", "norm_inputs", "norm_work", "ATTN_CASES",
                 "attn_inputs", "attn_library", "attn_work"):
        assert f"cs.{name}" in src
    models = [case[0] for case in smoke.ATTN_CASES]
    assert {"phi3 4k", "phi3 4k chunk", "glm4 4k"} <= set(models)
    for case in smoke.ATTN_CASES:
        if "4k" in case[0]:
            assert case[5] == 4096 and len(case[8]) == case[1]


def _attention(q, k, v, seen):
    """Softmax attention in fp32 over the positions ``seen`` (C, B, T)
    marks: q (C, B, Hq, D), caches (B, Hkv, T, D)."""
    G = q.shape[2] // k.shape[1]
    kk, vv = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
    s = torch.einsum("cbhd,bhtd->cbht", q, kk) / q.shape[3] ** 0.5
    s = torch.where(seen[:, :, None], s, torch.tensor(-1e30))
    return torch.einsum("cbht,bhtd->cbhd", torch.softmax(s, -1), vv)


@pytest.mark.parametrize("row", ["phi3 4k", "phi3 4k chunk", "glm4 4k"])
def test_the_long_attention_rows_see_a_lost_group_or_span(smoke, row):
    """At phase 2's 4K rows, drawn as ``attn_inputs`` draws them (q scaled
    by ``LONG_Q_SCALE``; here from numpy, in bf16), the outputs stand well
    above the bf16 tolerance, the output's own bf16 rounding passes it,
    and an attention that loses each crossing row's last 256-position
    group, or one position of every 64-position span, fails it."""
    import numpy as np
    (_, b, c, hq, hkv, t, d, dtype, lens), = [
        case for case in smoke.ATTN_CASES if case[0] == row]
    assert t > 256 and dtype == torch.bfloat16
    rng = np.random.default_rng(t + c)

    def rnd(*shape, scale=1.0):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return (scale * x).to(dtype).float()
    q = rnd(c, b, hq, d, scale=smoke.LONG_Q_SCALE)
    k, v = rnd(b, hkv, t, d), rnd(b, hkv, t, d)
    valid = (torch.tensor(lens)[None] + 1
             + torch.arange(c)[:, None]).clamp(max=t)
    pos = torch.arange(t)
    seen = pos < valid[..., None]                         # (C, B, T)
    ref = _attention(q, k, v, seen)
    tol = smoke.TOL[dtype]

    def passes(out):
        return bool(((out - ref).abs() <= tol + tol * ref.abs()).all())
    assert ref.pow(2).mean().sqrt() > 10 * tol
    assert passes(ref.to(dtype).float())
    last = (valid - 1) // 256 * 256
    lost_group = seen & ~((pos >= last[..., None]) & (valid > 256)[..., None])
    assert not passes(_attention(q, k, v, lost_group))
    assert not passes(_attention(q, k, v, seen & (pos % 64 != 63)))


def test_the_latent_rows_are_phase_2s_latent_cases(smoke):
    """``latent_attention`` is compared at every ``LATENT_CASES`` row, on
    the inputs, library call and work phase 2 draws and counts (the same
    functions of chip_smoke.py), its bound at the inputs' dtype's peak as
    phase 2 takes it: bf16's tensor-core rate for the bf16 rows (the
    bytes, at minicpm3's widths), fp32's FMA rate for the fp32 ones."""
    import inspect
    from repro_torch.roofline import HBM_BW, PEAK_FLOPS_BY_DTYPE
    assert "latent_attention" in kernel_ab.WRAPPERS
    phase2 = _names_in(smoke, "check_latent_attention")
    assert {"LATENT_CASES", "latent_inputs", "latent_library",
            "latent_work", "dtype"} <= phase2
    src = inspect.getsource(kernel_ab.latent_ab)
    for name in ("LATENT_CASES", "latent_inputs", "latent_library",
                 "latent_work", "LATENT_QK"):
        assert f"cs.{name}" in src
    cases = {case[0] for case in smoke.LATENT_CASES}
    assert {"minicpm3", "clamped", "minicpm3 4k", "fp32",
            "reduced"} <= cases
    dtypes = {case[7] for case in smoke.LATENT_CASES}
    assert dtypes == {torch.float32, torch.bfloat16}
    for flops, nbytes in [(1e9, 1e6), (1e6, 1e9)]:
        for dtype in dtypes:
            want = max(flops / PEAK_FLOPS_BY_DTYPE[dtype],
                       nbytes / HBM_BW) * 1e3
            assert kernel_ab.bound_ms(flops, nbytes, dtype) == want
    assert kernel_ab.bound_ms(1e9, 1e6) == kernel_ab.bound_ms(
        1e9, 1e6, torch.float32)


def test_the_moe_rows_are_phase_4s_chunk(smoke):
    """The chunk timed row by row is phase 4's (8 columns of 4 slots) at
    olmoe-1b-7b's expert widths, x shared for wi/wg and per expert for
    wo."""
    from repro_torch.configs import get_config
    cfg = get_config("olmoe-1b-7b")
    e, f, d = cfg.moe.num_experts, cfg.moe.d_ff_expert, cfg.d_model
    assert kernel_ab.MOE_PRODUCTS == ((e, d, f, True), (e, f, d, False))
    assert kernel_ab.MOE_CHUNK == (smoke.SERVE_ENGINE["prefill_chunk"],
                                   smoke.SERVE_ENGINE["batch_slots"])
