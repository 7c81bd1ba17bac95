"""The PyTorch port's CUDA kernels and model on the card, against their
plain versions.  These need a CUDA card and the CUDA toolkit; without a
card each test skips with a reason.  On a machine with one:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: fp32 2e-4 (no TF32: the kernels' fp32 path is plain FMA and
the references run with ``allow_tf32`` off), bf16 2e-2, logits 2e-3.
``moe_gemm`` must give the same bits at every ring depth and for a row
whatever rows come with it (what keeps chunked prefill bit-exact with token
prefill on the card) and whatever experts its ``active`` mask drops; in
bf16 it has two kernels, thin (C <= 16) and wide, and a row's bits may
differ between them, never within one.  ``rglru_scan`` is a chunked scan
that composes the chunks' decays, so it rounds unlike its plain version's
sequential walk and is held to the same tolerances, at the edges of its
chunks (16 steps) and segments (256).
bf16 ``queue_matmul`` has two kernels, thin (M <= 16) and wide; each must
give the same bits at every depth pair and for a row whatever rows come
with it.  Training: ``flash_attention_bwd`` against its plain version on
the same inputs (fp32 2e-4, bf16 2e-2) and equal to itself across calls,
rows that see no key with zero gradients; so are the backward passes of
``rglru_scan`` (its kernel's reverse walk), ``ssm_scan`` (its backward
kernel, on the chunk states its forward writes without changing y's bits)
and ``moe_gemm`` (two grouped products through its kernels, an inactive
expert's dW exact zeros); the autograd Functions run the kernels in their
backward; ``moe_apply``'s gradients keep their bits with the expert mask,
and remat's recomputed router picks the same experts; a train step on the
card agrees with the CPU's for every family (loss 2e-3, weights after one
AdamW step within 3 lr).  The registry's largest shapes: nemotron-4-340b's
head (a weight past 2^32 elements) and K = 73728 product over whole
outputs, attention and its backward at head dims 80 (non-causal) and
192, and a full-width hubert-xlarge step that decays its unread
embedding alone."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro_torch.config import RunConfig
from repro_torch.configs import get_reduced
from repro_torch.core.policy import ExecutionPolicy as EP
from repro_torch.kernels import (flash_attention, moe_gemm, queue_matmul,
                                 rglru_scan, ssm_scan)
from repro_torch.kernels.flash_attention import flash_attention_bwd
from repro_torch.kernels.moe_gemm import moe_gemm_bwd
from repro_torch.kernels.moe_gemm.ref import moe_gemm_bwd_ref
from repro_torch.kernels.rglru_scan import rglru_scan_bwd
from repro_torch.kernels.rglru_scan.ref import rglru_scan_bwd_ref
from repro_torch.kernels.ssm_scan import ssm_scan_bwd, ssm_scan_states
from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ops import _plain
from repro_torch.kernels.moe_gemm import ops as mg_ops
from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref
from repro_torch.kernels.queue_matmul import ops as qm_ops
from repro_torch.kernels.queue_matmul.ref import matmul_ref
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
from repro_torch.models import (decode_step, forward, init_cache,
                                init_model_params, prefill_step)
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import tree_map
from repro_torch.serve import ServeEngine

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _close(out, ref, tol):
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(5, 33, 17), (70, 100, 130), (16, 64, 64),
                                   (17, 4096, 96)])
def test_queue_matmul_kernel_on_ragged_shapes(card, m, k, n, dtype):
    x = torch.randn((m, k), generator=card, device="cuda").to(dtype)
    w = (torch.randn((k, n), generator=card, device="cuda")
         / k ** 0.5).to(dtype)
    before = queue_matmul.launches
    outs = [queue_matmul(x, w, depth_x=a, depth_w=b)
            for a, b in ((1, 1), (3, 3), (2, 5))]
    torch.cuda.synchronize()
    assert queue_matmul.launches == before + 3
    for o in outs:
        assert o.dtype == dtype and o.shape == (m, n)
        assert torch.equal(o, outs[0])           # depth never changes bits
    _close(outs[0], matmul_ref(x, w).to(dtype), TOL[dtype])


def test_queue_matmul_baseline_runs_no_kernel(card):
    x = torch.randn((4, 64), generator=card, device="cuda")
    before = queue_matmul.launches
    out = queue_matmul(x, x.t().contiguous(), policy=EP.BASELINE)
    assert queue_matmul.launches == before
    _close(out, matmul_ref(x, x.t()), 2e-4)


@pytest.mark.parametrize("m", [4, 16, 17, 64, 65, 512])
def test_queue_matmul_bf16_bits_across_depth_pairs(card, m):
    """K = 2120 (16.6 stages of the thin kernel's 128, split 4: parts of
    5, 5, 5 and 1.6; 33.1 of the wide kernel's 64-deep units, split 2:
    parts of 17 and 16.1) and N = 200 (3.1 thin tiles, 0.78 of a wide
    one): every ring and tile has a ragged edge.  (8, 8) runs the wide
    kernel's 32-deep stages, the other pairs its 64-deep ones."""
    k, n = 2120, 200
    assert qm_ops.split_k(k, n) == 4 and qm_ops.split_k(k, n, wide=True) == 2
    x = torch.randn((m, k), generator=card, device="cuda").bfloat16()
    w = (torch.randn((k, n), generator=card, device="cuda")
         / k ** 0.5).bfloat16()
    before = queue_matmul.launches
    outs = [queue_matmul(x, w, depth_x=a, depth_w=b)
            for a, b in ((1, 1), (4, 4), (8, 8), (2, 5))]
    torch.cuda.synchronize()
    assert queue_matmul.launches == before + 4
    for o in outs:
        assert o.dtype == torch.bfloat16 and o.shape == (m, n)
        assert torch.equal(o, outs[0])
    _close(outs[0], matmul_ref(x, w).bfloat16(), TOL[torch.bfloat16])


def test_queue_matmul_bf16_rows_do_not_depend_on_their_neighbours(card):
    """Within a regime a row's bits are the same whatever the other rows:
    the first 64 of 512 rows alone (wide), and one of 4 rows alone (thin)."""
    x = torch.randn((512, 768), generator=card, device="cuda").bfloat16()
    w = (torch.randn((768, 384), generator=card, device="cuda")
         / 768 ** 0.5).bfloat16()
    full = queue_matmul(x, w)
    assert torch.equal(queue_matmul(x[:64], w), full[:64])
    assert torch.equal(queue_matmul(x[64:81], w), full[64:81])
    four = queue_matmul(x[:4], w)
    assert torch.equal(queue_matmul(x[2:3], w), four[2:3])
    assert torch.equal(queue_matmul(x[:16], w)[:4], four)


def test_queue_matmul_refuses_rings_that_do_not_fit(card):
    """Rings at (16, 16) need 394752 bytes of shared memory in the wide
    kernel and 327936 in the thin one: refused before any launch.  Deep x
    rings beside shallow w rings fit both."""
    x = torch.randn((64, 256), generator=card, device="cuda").bfloat16()
    w = torch.randn((256, 128), generator=card, device="cuda").bfloat16()
    before = queue_matmul.launches
    with pytest.raises(ValueError, match="need 394752 bytes of shared memory"):
        queue_matmul(x, w, depth=16)
    with pytest.raises(ValueError, match="need 327936 bytes of shared memory"):
        queue_matmul(x[:4], w, depth=16)
    assert queue_matmul.launches == before
    for rows in (x, x[:4]):
        _close(queue_matmul(rows, w, depth_x=16, depth_w=4),
               matmul_ref(rows, w), TOL[torch.bfloat16])


def test_queue_matmul_wrapper_and_kernels_agree_on_shared_memory(card):
    lib = qm_ops._library()
    for m in (4, 512):
        for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
            for dx, dw in ((1, 1), (4, 4), (2, 8), (16, 16)):
                assert lib.queue_matmul_smem_bytes(m, dx, dw, code) == \
                    qm_ops.smem_bytes(m, dx, dw, dtype)


@pytest.mark.parametrize("hq,hkv,sq,sk,d,causal,window,q_offset", [
    (4, 2, 100, 100, 80, True, None, 0),
    (8, 2, 70, 300, 80, True, 64, 230),
    (4, 4, 64, 130, 80, False, None, 66),
    (4, 1, 129, 129, 200, True, 50, 0),
    (6, 2, 40, 200, 200, True, None, 160),
    (10, 1, 150, 150, 256, True, 48, 0),
    (10, 1, 65, 400, 256, True, 200, 335),
    (2, 2, 33, 33, 36, True, None, 0),       # D % 8 != 0: padded to 40
])
def test_flash_attention_bf16_on_the_tensor_cores(card, hq, hkv, sq, sk, d,
                                                  causal, window, q_offset):
    """Head dims 80, 200 and 256 (and 36), Sk != Sq with q_offset, windows
    and GQA, against the plain version."""
    q = torch.randn((2, hq, sq, d), generator=card, device="cuda").bfloat16()
    k = torch.randn((2, hkv, sk, d), generator=card, device="cuda").bfloat16()
    v = torch.randn((2, hkv, sk, d), generator=card, device="cuda").bfloat16()
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window,
                          q_offset=q_offset)
    assert flash_attention.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    _close(out, _plain(q, k, v, causal, window, q_offset),
           TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,sq,sk,d,causal,window,q_offset", [
    (4, 2, 100, 100, 80, True, None, 0),
    (4, 4, 33, 97, 16, True, 24, 64),
    (2, 1, 65, 65, 128, False, 20, 0),
    (10, 1, 150, 150, 256, True, 48, 0),     # recurrentgemma's MQA heads
    (10, 1, 40, 170, 256, True, 64, 130),
    (4, 2, 70, 70, 200, True, None, 0),
])
def test_flash_attention_kernel_against_plain(card, hq, hkv, sq, sk, d,
                                              causal, window, q_offset,
                                              dtype):
    q = torch.randn((2, hq, sq, d), generator=card, device="cuda").to(dtype)
    k = torch.randn((2, hkv, sk, d), generator=card, device="cuda").to(dtype)
    v = torch.randn((2, hkv, sk, d), generator=card, device="cuda").to(dtype)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window,
                          q_offset=q_offset)
    assert flash_attention.launches == before + 1
    _close(out, _plain(q, k, v, causal, window, q_offset), TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,sq,sk,d,dv,q_offset", [
    (40, 40, 128, 128, 96, 64, 0),           # minicpm3's MLA heads
    (4, 2, 70, 200, 96, 64, 130),
    (4, 4, 33, 33, 12, 8, 0),                # reduced MLA; bf16 pads D to 16
    (2, 1, 50, 50, 128, 40, 0),
])
def test_flash_attention_with_a_narrower_v_against_plain(card, hq, hkv, sq,
                                                         sk, d, dv, q_offset,
                                                         dtype):
    """v's head dim below q's and k's: one launch, the output Dv wide."""
    q = torch.randn((2, hq, sq, d), generator=card, device="cuda").to(dtype)
    k = torch.randn((2, hkv, sk, d), generator=card, device="cuda").to(dtype)
    v = torch.randn((2, hkv, sk, dv), generator=card, device="cuda").to(dtype)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=True, q_offset=q_offset)
    assert flash_attention.launches == before + 1
    assert out.shape == (2, hq, sq, dv)
    _close(out, _plain(q, k, v, True, None, q_offset), TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,c,d,f", [(3, 5, 33, 17), (2, 70, 100, 130),
                                     (4, 4, 256, 64), (5, 17, 4096, 96)])
def test_moe_gemm_kernel_on_ragged_shapes(card, e, c, d, f, dtype):
    x = torch.randn((e, c, d), generator=card, device="cuda").to(dtype)
    w = (torch.randn((e, d, f), generator=card, device="cuda")
         / d ** 0.5).to(dtype)
    before = moe_gemm.launches
    outs = [moe_gemm(x, w, depth=depth) for depth in (1, 2, 4)]
    torch.cuda.synchronize()
    assert moe_gemm.launches == before + 3
    for o in outs:
        assert o.dtype == torch.float32 and o.shape == (e, c, f)
        assert torch.equal(o, outs[0])           # depth never changes bits
    _close(outs[0], moe_gemm_ref(x, w), TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gemm_rows_do_not_depend_on_their_neighbours(card, dtype):
    """A broadcast x (expert stride 0) reads the one matrix; within a
    kernel each row's result is the same bits whatever rows come with it.
    fp32 has one kernel for every C (40 rows against 4 and 1); bf16 has
    two, so rows are compared within each: the wide one (C > 16: 130 rows
    against a 64-row prefix, the first 40 and 17 rows from row 40) and the
    thin one (C <= 16: 4 rows against 1, and against the first 4 of 16)."""
    x = torch.randn((130, 512), generator=card, device="cuda").to(dtype)
    w = (torch.randn((6, 512, 128), generator=card, device="cuda")
         / 512 ** 0.5).to(dtype)

    def run(rows):
        return moe_gemm(rows.expand(6, *rows.shape), w)
    if dtype == torch.float32:
        full = run(x[:40])
        assert torch.equal(full, moe_gemm(x[:40].expand(6, 40, 512)
                                          .contiguous(), w))
        assert torch.equal(run(x[:4]), full[:, :4])
        assert torch.equal(run(x[2:3]), full[:, 2:3])
        return
    full = run(x)
    assert torch.equal(full, moe_gemm(x.expand(6, 130, 512).contiguous(), w))
    assert torch.equal(run(x[:64]), full[:, :64])
    assert torch.equal(run(x[:40]), full[:, :40])
    assert torch.equal(run(x[40:57]), full[:, 40:57])
    four = run(x[:4])
    assert torch.equal(run(x[2:3]), four[:, 2:3])
    assert torch.equal(run(x[:16])[:, :4], four)


@pytest.mark.parametrize("e,c,d,f,bcast", [(3, 17, 100, 130, False),
                                           (64, 70, 264, 72, True),
                                           (5, 130, 520, 300, False),
                                           (8, 512, 1000, 264, True),
                                           (2, 512, 64, 1032, False)])
def test_moe_gemm_wide_kernel_on_ragged_shapes(card, e, c, d, f, bcast):
    """bf16 with C > 16 (TMA + wgmma): C not a multiple of the 128-row
    tile, d and f not multiples of the stage or the 256-column tile, a
    broadcast or a per-expert x; every depth gives the same bits, up to the
    deepest that fits (9, with 32-deep stages)."""
    x = torch.randn((c, d) if bcast else (e, c, d), generator=card,
                    device="cuda").bfloat16()
    if bcast:
        x = x.expand(e, c, d)
    w = (torch.randn((e, d, f), generator=card, device="cuda")
         / d ** 0.5).bfloat16()
    before = moe_gemm.launches
    outs = [moe_gemm(x, w, depth=depth) for depth in (1, 2, 4, 5, 9)]
    torch.cuda.synchronize()
    assert moe_gemm.launches == before + 5
    assert mg_ops.regime(c, torch.bfloat16) == "wide"
    for o in outs:
        assert o.dtype == torch.float32 and o.shape == (e, c, f)
        assert torch.equal(o, outs[0])
    _close(outs[0], moe_gemm_ref(x, w), TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [4, 70])
@pytest.mark.parametrize("mask_dtype", [torch.bool, torch.int8])
def test_moe_gemm_mask_skips_experts_and_keeps_the_bits(card, c, dtype,
                                                       mask_dtype):
    """An inactive expert's block is exact zeros; an active one's is the
    unmasked call's, bit for bit, in each kernel (C = 4: thin in bf16; C =
    70: wide in bf16; fp32 at both)."""
    e, d, f = 16, 264, 200
    x = torch.randn((c, d), generator=card, device="cuda").to(dtype)
    w = (torch.randn((e, d, f), generator=card, device="cuda")
         / d ** 0.5).to(dtype)
    xe = x.expand(e, c, d)
    on = torch.zeros(e, dtype=torch.bool, device="cuda")
    on[[0, 3, 4, 9, 15]] = True
    full = moe_gemm(xe, w)
    out = moe_gemm(xe, w, active=on.to(mask_dtype))
    assert torch.equal(out[on], full[on])
    assert bool((out[~on] == 0).all())
    assert torch.equal(moe_gemm(xe, w, active=torch.ones_like(on)), full)
    _close(out, moe_gemm_ref(xe, w, on), TOL[dtype])


def test_moe_gemm_refuses_rings_that_do_not_fit(card):
    """Depth 16 fits only the fp32 kernel at C <= 16; the largest depths
    that fit are 11 (thin), 9 (wide) and 14 (fp32, C > 16).  Refused
    before any launch."""
    x = torch.randn((2, 4, 256), generator=card, device="cuda")
    w = torch.randn((2, 256, 128), generator=card, device="cuda")
    xb, wb = x.bfloat16(), w.bfloat16()
    xw = torch.randn((2, 40, 256), generator=card, device="cuda")
    before = moe_gemm.launches
    for a, b, depth in ((xb, wb, 12), (xw.bfloat16(), wb, 10), (xw, w, 15)):
        with pytest.raises(ValueError, match="bytes of shared memory"):
            moe_gemm(a, b, depth=depth)
    assert moe_gemm.launches == before
    for a, b, depth in ((x, w, 16), (xb, wb, 11), (xw.bfloat16(), wb, 9),
                        (xw, w, 14)):
        _close(moe_gemm(a, b, depth=depth), moe_gemm_ref(a, b),
               TOL[a.dtype])


def test_moe_gemm_wrapper_and_kernels_agree_on_shared_memory(card):
    lib = mg_ops._library()
    for c in (4, 512):
        for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
            for depth in (1, 2, 4, 5, 9, 16):
                assert lib.moe_gemm_smem_bytes(c, depth, code) == \
                    mg_ops.smem_bytes(c, depth, dtype)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "granite-moe-3b-a800m"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tokens", [1, 4, 40])
def test_moe_apply_mask_keeps_the_bits(card, monkeypatch, arch, dtype,
                                      tokens):
    """The routed dispatch gives the same bits as the dense one with every
    expert computed: the dropped experts' rows were multiplied by a
    combine weight of 0 and are now zeros times 0.  1 and 4 tokens take
    the thin kernel in bf16 (few of the 8 experts routed), 40 the wide
    one."""
    cfg = get_reduced(arch)
    p = tree_map(lambda a: a.cuda().to(dtype),
                 init_model_params(0, cfg, device="cpu")["blocks"]["ffn"])
    p = {k: v[0] for k, v in p.items()}            # the first layer
    x = (torch.randn((1, tokens, cfg.d_model), generator=card,
                     device="cuda") * 0.3).to(dtype)
    before = moe_gemm.launches
    routed = moe_mod.moe_apply(p, x, cfg)
    assert moe_gemm.launches == before + 3
    real = moe_mod.moe_gemm
    monkeypatch.setattr(moe_mod, "moe_gemm",
                        lambda *a, active=None, **k: real(*a, **k))
    assert torch.equal(routed, moe_mod.moe_apply(p, x, cfg))


def test_moe_gemm_baseline_runs_no_kernel(card):
    x = torch.randn((2, 4, 64), generator=card, device="cuda")
    w = torch.randn((2, 64, 32), generator=card, device="cuda")
    before = moe_gemm.launches
    out = moe_gemm(x, w, policy=EP.BASELINE)
    assert moe_gemm.launches == before
    _close(out, moe_gemm_ref(x, w), 2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,d,n", [(2, 37, 20, 4), (1, 150, 70, 16),
                                     (3, 9, 300, 8), (1, 700, 64, 16)])
def test_ssm_scan_kernel_against_plain(card, b, t, d, n, dtype):
    x = (torch.randn((b, t, d), generator=card, device="cuda") * 0.5
         ).to(dtype)
    dt = (torch.nn.functional.softplus(
        torch.randn((b, t, d), generator=card, device="cuda")) * 0.1
          ).to(dtype)
    A = -torch.randn((d, n), generator=card, device="cuda").abs()
    Bm = torch.randn((b, t, n), generator=card, device="cuda").to(dtype)
    C = torch.randn((b, t, n), generator=card, device="cuda").to(dtype)
    before = ssm_scan.launches
    out = ssm_scan(x, dt, A, Bm, C)
    torch.cuda.synchronize()
    assert ssm_scan.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == (b, t, d)
    _close(out, ssm_scan_ref(x, dt, A, Bm, C), TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 5, 16, 32])
@pytest.mark.parametrize("t", [1, 63, 64, 65, 200, 512])
def test_ssm_scan_chunks_against_plain(card, t, n, dtype):
    """The chunked scan at T below, at and past one chunk, ragged, and
    cut into the most chunks; every state size up to ``MAX_STATE``."""
    b, d = 2, 70
    x = (torch.randn((b, t, d), generator=card, device="cuda") * 0.5
         ).to(dtype)
    dt = (torch.nn.functional.softplus(
        torch.randn((b, t, d), generator=card, device="cuda") - 1.0)
          ).to(dtype)
    A = -torch.exp(torch.randn((d, n), generator=card, device="cuda") * 0.5)
    Bm = torch.randn((b, t, n), generator=card, device="cuda").to(dtype)
    C = torch.randn((b, t, n), generator=card, device="cuda").to(dtype)
    out = ssm_scan(x, dt, A, Bm, C)
    assert out.dtype == torch.float32 and out.shape == (b, t, d)
    _close(out, ssm_scan_ref(x, dt, A, Bm, C), TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,w", [(2, 37, 20), (1, 150, 70), (3, 9, 300),
                                   (1, 700, 64), (1, 33, 2560)])
def test_rglru_scan_kernel_against_plain(card, b, t, w, dtype):
    """Odd T and w: no padding, any T >= 1 and any w."""
    a = torch.sigmoid(torch.randn((b, t, w), generator=card, device="cuda")
                      + 2.0).to(dtype)
    bx = torch.randn((b, t, w), generator=card, device="cuda").to(dtype)
    before = rglru_scan.launches
    out = rglru_scan(a, bx)
    torch.cuda.synchronize()
    assert rglru_scan.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == (b, t, w)
    _close(out, rglru_scan_ref(a, bx), TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,w", [(1, 1, 16), (1, 15, 32), (1, 16, 32),
                                   (1, 17, 32), (3, 255, 37), (3, 256, 37),
                                   (3, 257, 37), (2, 511, 2560),
                                   (1, 513, 40)])
def test_rglru_scan_chunk_and_segment_edges(card, b, t, w, dtype):
    """T at the chunk length (16) and the segment length (256) and one
    either side, T = 1, B = 3 with an odd w, and recurrentgemma's width."""
    a = torch.sigmoid(torch.randn((b, t, w), generator=card, device="cuda")
                      + 2.0).to(dtype)
    bx = torch.randn((b, t, w), generator=card, device="cuda").to(dtype)
    before = rglru_scan.launches
    out = rglru_scan(a, bx)
    torch.cuda.synchronize()
    assert rglru_scan.launches == before + 1
    _close(out, rglru_scan_ref(a, bx), TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_scan_carries_a_slow_decay_across_segments(card, dtype):
    """a = 1 - 1e-3 over 4096 steps (16 segments): h sums hundreds of
    inputs, so every chunk's start state comes mostly from the carry."""
    a = torch.full((2, 4096, 300), 1.0 - 1e-3, device="cuda").to(dtype)
    bx = torch.randn((2, 4096, 300), generator=card, device="cuda").to(dtype)
    out = rglru_scan(a, bx)
    ref = rglru_scan_ref(a, bx)
    assert ref.abs().max() > 20.0
    _close(out, ref, TOL[dtype])


def test_float64_on_the_card_raises_instead_of_falling_back(card):
    """fp64 is the CPU's witness only: the kernels refuse it on the card
    rather than hand it to a plain version."""
    x = torch.randn((4, 64), generator=card, device="cuda").double()
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        queue_matmul(x, x.t().contiguous())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        moe_gemm(x[None], x.t().contiguous()[None])
    q = x.reshape(1, 1, 4, 64)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q, q, q)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ssm_scan(x[None], x[None], -x.t()[:, :4].abs(), x[None, :, :4],
                 x[None, :, :4])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rglru_scan(x[None], x[None])


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "glm4-9b", "olmoe-1b-7b",
                                  "granite-moe-3b-a800m", "falcon-mamba-7b",
                                  "recurrentgemma-2b", "minicpm3-4b"])
def test_model_and_engine_on_the_card_match_the_cpu(card, arch):
    cfg = get_reduced(arch)
    rc = RunConfig(dtype="float32", remat=False)
    p_cpu = init_model_params(0, cfg, device="cpu")
    p_gpu = tree_map(lambda a: a.cuda(), p_cpu)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 40)))
    _close(forward(p_gpu, {"tokens": toks.cuda()}, cfg, rc).cpu(),
           forward(p_cpu, {"tokens": toks}, cfg, rc), 2e-3)
    out = {}
    for dev, p in (("cuda", p_gpu), ("cpu", p_cpu)):
        eng = ServeEngine(p, cfg, rc, batch_slots=2, max_len=64, device=dev)
        rids = [eng.submit([1 + i, 5, 9, 2], max_new=4) for i in range(3)]
        done = eng.run()
        out[dev] = [done[r].generated for r in rids]
    assert out["cuda"] == out["cpu"]


def test_hybrid_decode_through_a_wrapped_ring_matches_the_cpu(card):
    """recurrentgemma-smoke (window 16): a 20-token chunked prefill wraps
    the K/V ring, then 4 decode steps, on the card and on the CPU."""
    cfg = get_reduced("recurrentgemma-2b")
    rc = RunConfig(dtype="float32", remat=False)
    p_cpu = init_model_params(1, cfg, device="cpu")
    p_gpu = tree_map(lambda a: a.cuda(), p_cpu)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 24)))
    n = torch.tensor([20, 20, 17], dtype=torch.int32)
    out = {}
    for dev, p in (("cuda", p_gpu), ("cpu", p_cpu)):
        cache = init_cache(cfg, 3, 32, torch.float32, device=dev)
        logits, cache = prefill_step(p, cache, {
            "tokens": toks[:, :20].to(dev), "n_tokens": n.to(dev)}, cfg, rc)
        steps = [logits.cpu()]
        for j in range(20, 24):
            logits, cache = decode_step(p, cache, {
                "tokens": toks[:, j:j + 1].to(dev)}, cfg, rc)
            steps.append(logits.cpu())
        out[dev] = (steps, {k: v.cpu() for k, v in cache.items()})
    for a, b in zip(out["cuda"][0], out["cpu"][0]):
        _close(a, b, 2e-3)
    for k, v in out["cpu"][1].items():
        _close(out["cuda"][1][k], v, 2e-3)


def test_mla_decode_past_max_len_matches_the_cpu(card):
    """minicpm3-smoke (2 layers): an 8-token chunked prefill into caches of
    12 rows, then 8 decode steps, so the latent and rope writes clamp to
    the last row (never past it, which would be a device-side fault), on
    the card and on the CPU."""
    cfg = get_reduced("minicpm3-4b")
    rc = RunConfig(dtype="float32", remat=False)
    p_cpu = init_model_params(2, cfg, device="cpu")
    p_gpu = tree_map(lambda a: a.cuda(), p_cpu)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 16)))
    n = torch.tensor([8, 6], dtype=torch.int32)
    out = {}
    for dev, p in (("cuda", p_gpu), ("cpu", p_cpu)):
        cache = init_cache(cfg, 2, 12, torch.float32, device=dev)
        logits, cache = prefill_step(p, cache, {
            "tokens": toks[:, :8].to(dev), "n_tokens": n.to(dev)}, cfg, rc)
        steps = [logits.cpu()]
        for j in range(8, 16):
            logits, cache = decode_step(p, cache, {
                "tokens": toks[:, j:j + 1].to(dev)}, cfg, rc)
            steps.append(logits.cpu())
        torch.cuda.synchronize()
        out[dev] = (steps, {k: v.cpu() for k, v in cache.items()})
    assert out["cuda"][1]["len"].tolist() == [16, 14]
    for a, b in zip(out["cuda"][0], out["cpu"][0]):
        _close(a, b, 2e-3)
    for k, v in out["cpu"][1].items():
        _close(out["cuda"][1][k], v, 2e-3)


# --- training -----------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,dv,causal,window", [
    (2, 4, 2, 100, 100, 96, 96, True, None),
    (1, 4, 4, 70, 70, 80, 80, False, None),
    (1, 4, 1, 130, 130, 128, 128, True, 48),
    (1, 2, 1, 90, 90, 256, 256, True, 40),
    (1, 2, 2, 65, 65, 200, 200, False, 30),
    (2, 4, 4, 77, 77, 96, 64, True, None),     # MLA: v under q/k
    (1, 2, 2, 33, 33, 36, 36, True, None),     # bf16 pads D to 40
    (1, 2, 1, 120, 40, 64, 64, False, 16),     # rows 55.. see no key
])
def test_flash_attention_bwd_kernel_against_plain(card, b, hq, hkv, sq, sk,
                                                  d, dv, causal, window,
                                                  dtype):
    def rnd(*shape):
        return torch.randn(shape, generator=card, device="cuda").to(dtype)
    q, k, v, do = rnd(b, hq, sq, d), rnd(b, hkv, sk, d), rnd(b, hkv, sk, dv), \
        rnd(b, hq, sq, dv)
    o, lse = fa_ops._launch(q, k, v, causal, window, 0, with_lse=True)
    _close(lse, fa_ops._plain_lse(q, k, causal, window, 0), 2e-4 if dtype
           == torch.float32 else 2e-2)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                              window=window)
    again = flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                window=window)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 2
    ref = fa_ops._plain_bwd(q, k, v, o, lse, do, causal, window)
    for x, y, r, t in zip(got, again, ref, (q, k, v)):
        assert x.dtype == dtype and x.shape == t.shape
        assert torch.equal(x, y)                 # no atomics
        assert bool(torch.isfinite(x).all())
        _close(x, r, TOL[dtype])
    i = torch.arange(sq, device="cuda")[:, None]
    j = torch.arange(sk, device="cuda")[None]
    keep = (j > i - window) if window else torch.ones_like(i == j)
    keep = keep & (j <= i) if causal else keep
    empty = ~keep.any(-1)
    assert bool((got[0][:, :, empty] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_runs_the_backward_kernels(card, dtype):
    """A loss through ``flash_attention`` and ``queue_matmul`` on the card:
    the backward launches ``flash_attention_bwd`` once and
    ``queue_matmul`` twice (dX and dW), and the gradients match the CPU's
    plain path."""
    def rnd(*shape):
        return torch.randn(shape, generator=card, device="cuda").to(dtype)
    q, k, v = rnd(1, 4, 64, 32), rnd(1, 2, 64, 32), rnd(1, 2, 64, 32)
    w = (rnd(128, 48) / 12).requires_grad_()
    grads = {}
    for dev in ("cuda", "cpu"):
        leaves = [t.detach().to(dev).requires_grad_() for t in (q, k, v, w)]
        fa0, fb0, qm0 = (flash_attention.launches,
                         flash_attention_bwd.launches, queue_matmul.launches)
        o = flash_attention(*leaves[:3], causal=True)
        y = queue_matmul(o.transpose(1, 2).reshape(64, 128), leaves[3])
        grads[dev] = torch.autograd.grad(y.float().square().sum(), leaves)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert flash_attention.launches == fa0 + 1
            assert flash_attention_bwd.launches == fb0 + 1
            assert queue_matmul.launches == qm0 + 3
    for a, b in zip(grads["cuda"], grads["cpu"]):
        _close(a.cpu(), b, 2e-3 if dtype == torch.float32 else 5e-2)


def _grad_inputs(card, kind, dtype, shape):
    """Seeded operands of one backward case on the card."""
    def rnd(*s):
        return torch.randn(s, generator=card, device="cuda")
    if kind == "rglru":
        b, t, w = shape
        a = torch.sigmoid(rnd(b, t, w) + 2.0).to(dtype)
        return a, rnd(b, t, w).to(dtype), rnd(b, t, w)
    b, t, d, n = shape
    x = (rnd(b, t, d) * 0.5).to(dtype)
    dt = torch.nn.functional.softplus(rnd(b, t, d) - 1.0).to(dtype)
    A = -torch.exp(rnd(d, n) * 0.5)
    return (x, dt, A, rnd(b, t, n).to(dtype), rnd(b, t, n).to(dtype),
            rnd(b, t, d))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,w", [(1, 1, 16), (2, 37, 20), (1, 16, 32),
                                   (1, 17, 32), (3, 257, 37), (1, 700, 64),
                                   (2, 512, 2560)])
def test_rglru_scan_bwd_kernel_against_plain(card, b, t, w, dtype):
    """The reverse walk against the plain backward on the forward kernel's
    h, at the chunk (16) and segment (256) edges; equal across calls."""
    a, bx, g = _grad_inputs(card, "rglru", dtype, (b, t, w))
    h = rglru_scan(a, bx)
    before = (rglru_scan.launches, rglru_scan_bwd.launches)
    got, again = rglru_scan_bwd(a, h, g), rglru_scan_bwd(a, h, g)
    torch.cuda.synchronize()
    assert (rglru_scan.launches, rglru_scan_bwd.launches) == \
        (before[0], before[1] + 2)
    for x, y, r in zip(got, again, rglru_scan_bwd_ref(a, h, g)):
        assert x.dtype == torch.float32 and x.shape == (b, t, w)
        assert torch.equal(x, y)
        _close(x, r, TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,d,n", [(2, 37, 20, 4), (1, 150, 70, 16),
                                     (2, 1, 33, 5), (1, 65, 64, 1),
                                     (2, 200, 40, 32), (2, 512, 96, 16)])
def test_ssm_scan_bwd_kernel_against_plain(card, b, t, d, n, dtype):
    """The forward with its chunk states keeps y's bits; the backward
    kernel against the plain backward, equal across calls."""
    x, dt, A, Bm, C, dy = _grad_inputs(card, "ssm", dtype, (b, t, d, n))
    y, states = ssm_scan_states(x, dt, A, Bm, C)
    assert torch.equal(y, ssm_scan(x, dt, A, Bm, C))
    before = ssm_scan_bwd.launches
    got = ssm_scan_bwd(x, dt, A, Bm, C, dy, states)
    again = ssm_scan_bwd(x, dt, A, Bm, C, dy, states)
    torch.cuda.synchronize()
    assert ssm_scan_bwd.launches == before + 2
    ref = ssm_scan_bwd_ref(x, dt, A, Bm, C, dy)
    for g, h, r, t_ in zip(got, again, ref, (x, dt, A, Bm, C)):
        assert g.dtype == torch.float32 and g.shape == t_.shape
        assert torch.equal(g, h)
        _close(g, r, TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("e,c,d,f", [(3, 40, 64, 48), (4, 8, 96, 64),
                                     (2, 130, 100, 130)])
def test_moe_gemm_bwd_against_plain(card, e, c, d, f, shared, masked,
                                    dtype):
    """dX and dW against the plain backward, per-expert and shared x, with
    and without a mask (an inactive expert's dW exact zeros); equal across
    calls."""
    x = torch.randn((c, d) if shared else (e, c, d), generator=card,
                    device="cuda").to(dtype)
    w = (torch.randn((e, d, f), generator=card, device="cuda")
         / d ** 0.5).to(dtype)
    dy = torch.randn((e, c, f), generator=card, device="cuda").to(dtype)
    active = (torch.arange(e, device="cuda") % 2 == 0).to(torch.int8) \
        if masked else None
    before = (moe_gemm.launches, moe_gemm_bwd.launches)
    got = mg_ops.moe_gemm_bwd(x, w, dy, active=active)
    again = mg_ops.moe_gemm_bwd(x, w, dy, active=active)
    torch.cuda.synchronize()
    assert (moe_gemm.launches, moe_gemm_bwd.launches) == \
        (before[0] + 4, before[1] + 2)
    for g, h, r, t in zip(got, again, moe_gemm_bwd_ref(x, w, dy, active),
                          (x, w)):
        assert g.dtype == torch.float32 and g.shape == t.shape
        assert torch.equal(g, h)
        _close(g, r, TOL[dtype])
    if masked:
        assert bool((got[1][1::2] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_runs_the_scan_and_expert_backward_kernels(card, dtype):
    """Losses through ``rglru_scan``, ``ssm_scan`` and ``moe_gemm`` on the
    card: each backward launches its kernel, and the gradients match the
    CPU's autograd of the plain versions."""
    a, bx, _ = _grad_inputs(card, "rglru", dtype, (2, 40, 24))
    x, dt, A, Bm, C, _ = _grad_inputs(card, "ssm", dtype, (2, 70, 40, 16))
    xm = torch.randn((20, 32), generator=card, device="cuda").to(dtype)
    wm = (torch.randn((3, 32, 16), generator=card, device="cuda") / 6
          ).to(dtype)
    cases = ((rglru_scan, (a, bx), rglru_scan_bwd),
             (ssm_scan, (x, dt, A, Bm, C), ssm_scan_bwd),
             (moe_gemm, (xm, wm), moe_gemm_bwd))
    for fn, args, bwd in cases:
        grads = {}
        for dev in ("cuda", "cpu"):
            leaves = [t.detach().to(dev).requires_grad_() for t in args]
            before = bwd.launches
            y = fn(*leaves)
            grads[dev] = torch.autograd.grad(y.square().sum(), leaves)
            if dev == "cuda":
                torch.cuda.synchronize()
                assert bwd.launches == before + 1
        for g, r, t in zip(grads["cuda"], grads["cpu"], args):
            assert g.dtype == t.dtype
            _close(g.cpu(), r, 2e-3 if dtype == torch.float32 else 5e-2)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "granite-moe-3b-a800m"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_apply_gradients_keep_the_bits_with_the_mask(card, monkeypatch,
                                                        arch, dtype):
    """The gradients of the routed dense dispatch equal those with every
    expert computed: an unrouted expert's dY is zeros, so its dW is zeros
    and it adds nothing to dX either way."""
    cfg = get_reduced(arch)
    p = tree_map(lambda a: a.cuda().to(dtype),
                 init_model_params(0, cfg, device="cpu")["blocks"]["ffn"])
    p = {k: v[0].clone().requires_grad_() for k, v in p.items()}
    x = (torch.randn((1, 3, cfg.d_model), generator=card, device="cuda")
         * 0.3).to(dtype).requires_grad_()
    dout = torch.randn((1, 3, cfg.d_model), generator=card, device="cuda"
                       ).to(dtype)
    leaves = [x, *p.values()]

    def grads():
        return torch.autograd.grad(moe_mod.moe_apply(p, x, cfg), leaves,
                                   dout)
    before = moe_gemm_bwd.launches
    routed = grads()
    assert moe_gemm_bwd.launches == before + 3
    real = moe_mod.moe_gemm
    monkeypatch.setattr(moe_mod, "moe_gemm",
                        lambda *a, active=None, **k: real(*a, **k))
    for g, h in zip(routed, grads()):
        assert torch.equal(g, h)


def test_remat_recomputes_the_same_experts(card, monkeypatch):
    """Under remat every MoE layer's router runs twice, in the forward and
    in the recomputed one; both must pick the same experts (the checkpoint
    checks only shapes)."""
    from repro_torch.train.step import _grads
    cfg = get_reduced("olmoe-1b-7b")
    p = tree_map(lambda a: a.cuda(), init_model_params(5, cfg, device="cpu"))
    toks = torch.randint(0, cfg.vocab, (2, 33), generator=card,
                         device="cuda")
    seen = []
    real = moe_mod.router_probs

    def spy(*args, **kwargs):
        w, idx = real(*args, **kwargs)
        seen.append(idx.clone())
        return w, idx
    monkeypatch.setattr(moe_mod, "router_probs", spy)
    _grads(p, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}, cfg,
           RunConfig(dtype="bfloat16", remat=True))
    assert len(seen) == 2 * cfg.n_layers
    first, again = seen[:cfg.n_layers], seen[cfg.n_layers:]
    for i in range(cfg.n_layers):          # the recompute runs in reverse
        assert torch.equal(first[i], again[cfg.n_layers - 1 - i])


def test_train_step_on_the_card_matches_the_cpu(card):
    """phi3-smoke, fp32, remat on: one AdamW step on the card and on the
    CPU from the same weights and batch."""
    from repro_torch.data import SyntheticLMStream
    from repro_torch.models.layers import tree_leaves
    from repro_torch.optim import init_opt_state
    from repro_torch.train import train_step
    cfg = get_reduced("phi3-mini-3.8b")
    rc = RunConfig(dtype="float32", remat=True, lr=1e-3)
    batch = SyntheticLMStream(cfg.vocab, 32, 2, seed=3).batch_at(0)
    out = {}
    for dev in ("cuda", "cpu"):
        p = init_model_params(4, cfg, device="cpu")
        p = tree_map(lambda a: a.to(dev), p)
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        before = flash_attention_bwd.launches
        p, opt, m = train_step(p, init_opt_state(p), b, cfg, rc)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert flash_attention_bwd.launches == before + cfg.n_layers
        out[dev] = (float(m["loss"]), [t.cpu() for t in tree_leaves(p)])
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 2e-3
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        assert float((a - b).abs().max()) <= 3 * rc.lr


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "falcon-mamba-7b",
                                  "recurrentgemma-2b"])
def test_train_step_on_the_card_matches_the_cpu_for_every_family(card,
                                                                 arch):
    """The MoE, SSM and hybrid families' reduced configs, fp32, remat on:
    one AdamW step on the card (every backward kernel of the path) and on
    the CPU from the same weights and batch."""
    from repro_torch.data import SyntheticLMStream
    from repro_torch.models.layers import tree_leaves
    from repro_torch.optim import init_opt_state
    from repro_torch.train import train_step
    cfg = get_reduced(arch)
    rc = RunConfig(dtype="float32", remat=True, lr=1e-3)
    batch = SyntheticLMStream(cfg.vocab, 32, 2, seed=3).batch_at(0)
    counters = {"moe": moe_gemm_bwd, "ssm": ssm_scan_bwd,
                "hybrid": rglru_scan_bwd}
    out = {}
    for dev in ("cuda", "cpu"):
        p = init_model_params(4, cfg, device="cpu")
        p = tree_map(lambda a: a.to(dev), p)
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        before = counters[cfg.family].launches
        p, opt, m = train_step(p, init_opt_state(p), b, cfg, rc)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert counters[cfg.family].launches > before
        out[dev] = (float(m["loss"]), [t.cpu() for t in tree_leaves(p)])
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 2e-3
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        assert float((a - b).abs().max()) <= 3 * rc.lr


# --- the registry's largest shapes and the frontends ------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(4, 18432, 256000), (4, 73728, 18432),
                                   (512, 73728, 18432)])
def test_queue_matmul_at_nemotron_shapes(card, m, k, n, dtype):
    """nemotron-4-340b's head (a 18432 x 256000 weight: 4.72e9 elements,
    past 2^32, so an index or byte offset kept in 32 bits would wrap from
    row 8389 on) and its ffn wo (K = 73728, the deepest sum of the
    registry) against the plain version over the whole output."""
    x = torch.randn((m, k), generator=card, device="cuda").to(dtype)
    w = torch.randn((k, n), generator=card, device="cuda")
    w = w.mul_(k ** -0.5).to(dtype)
    before = queue_matmul.launches
    out = queue_matmul(x, w)
    torch.cuda.synchronize()
    assert queue_matmul.launches == before + 1
    ref = matmul_ref(x, w)
    _close(out, ref.to(dtype), TOL[dtype])
    del w, ref
    torch.cuda.empty_cache()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,s,d,causal", [
    (2, 16, 16, 256, 80, False),       # hubert's heads, both ways
    (1, 12, 2, 200, 192, True),        # nemotron's head dim, GQA
    (1, 8, 8, 130, 192, False)])
def test_flash_attention_and_backward_at_new_head_dims(card, b, hq, hkv, s,
                                                       d, causal, dtype):
    """The forward kernel and ``flash_attention_bwd`` at head dim 80
    without a causal mask (hubert) and at 192 (nemotron, which no case
    compiles in: the generic 256-wide code), against their plain
    versions."""
    def rnd(*shape):
        return torch.randn(shape, generator=card, device="cuda").to(dtype)
    q, k, v, do = rnd(b, hq, s, d), rnd(b, hkv, s, d), rnd(b, hkv, s, d), \
        rnd(b, hq, s, d)
    _close(flash_attention(q, k, v, causal=causal),
           _plain(q, k, v, causal, None, 0), TOL[dtype])
    o, lse = fa_ops._launch(q, k, v, causal, None, 0, with_lse=True)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    ref = fa_ops._plain_bwd(q, k, v, o, lse, do, causal, None)
    torch.cuda.synchronize()
    for x, r in zip(got, ref):
        _close(x, r, TOL[dtype])


def test_hubert_training_step_decays_the_unread_embedding(card):
    """hubert-xlarge at full width, 2 layers, bf16 with remat: one AdamW
    step on frames.  Its loss never reads ``embed``, so the step moves it
    by the weight decay alone (p (1 - lr wd), its moments zero), while
    every other leaf moves with its gradient."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.optim import init_opt_state
    from repro_torch.train import train_step
    cfg = dataclasses.replace(get_config("hubert-xlarge"), n_layers=2)
    rc = RunConfig(dtype="bfloat16", remat=True, lr=1e-3, warmup_steps=1)
    p = init_model_params(5, cfg, device="cuda")
    before = tree_map(lambda a: a.clone(), p)
    rng = np.random.default_rng(7)
    batch = {"frames": torch.from_numpy((rng.standard_normal(
                 (2, 256, cfg.d_model)) * 0.1).astype(np.float32)).cuda(),
             "labels": torch.from_numpy(rng.integers(
                 0, cfg.vocab, (2, 256))).cuda()}
    launches = flash_attention_bwd.launches
    p, opt, m = train_step(p, init_opt_state(p), batch, cfg, rc)
    torch.cuda.synchronize()
    assert np.isfinite(float(m["loss"]))
    assert flash_attention_bwd.launches == launches + cfg.n_layers
    assert torch.count_nonzero(opt.mu["embed"]) == 0
    decayed = before["embed"] * (1 - float(m["lr"]) * rc.weight_decay)
    torch.testing.assert_close(p["embed"], decayed, rtol=1e-6, atol=0)
    assert not torch.equal(p["embed"], before["embed"])
    assert not torch.equal(p["head"], before["head"])
    assert not torch.equal(p["blocks"]["attn"]["wq"],
                           before["blocks"]["attn"]["wq"])
