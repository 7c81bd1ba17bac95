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
chunks (16 steps) and segments (256); its reverse walk, a kernel of its
own, also at a slow decay over 4096 steps, T = 1, and a grid past one wave.
bf16 ``queue_matmul`` has two kernels, thin (M <= 16) and wide; each must
give the same bits at every depth pair and for a row whatever rows come
with it.  fp32 ``queue_matmul`` has one sum order for every M, tile and
depth pair, so its rows keep their bits across all of them; the fp32
attention forward is held to its plain version (output and log-sum-exp)
at every head-dim class, gives 0 and a log-sum-exp of +inf on rows that
see no key, and the same bits on two calls.  Training: ``flash_attention_bwd`` against its plain version on
the same inputs (fp32 2e-4, bf16 2e-2) and equal to itself across calls,
rows that see no key with zero gradients; so are the backward passes of
``rglru_scan`` (its reverse walk's kernel), ``ssm_scan`` (its backward
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
embedding alone.  A chunk's columns as one batched body: every op it runs
(``row_bits.BODY_OPS``) gives a row the bits it gets among fewer rows; the
row-wise ``rms_norm``, ``decode_attention`` and ``latent_attention``
kernels against their plain versions (2e-4, 2e-2), each row or column equal
to itself computed alone (``latent_attention`` also past ``max_len``,
across its 256-position groups, by heads, and over a longer cache);
bf16 ``queue_matmul`` run row by row keeps the thin kernel's bits at any
M; and a replayed chunk of each batched family (falcon-mamba's and
recurrentgemma's too, only their recurrences walking the columns, and
recurrentgemma's attention by column over a ring of its window and at
once over a shorter one) equals token prefill bit for bit, no product of
it on the wide kernel, over a 200-token prompt at full width too (queries
across several of ``decode_attention``'s spans); minicpm3's MLA chunk
too."""
import math

import pytest

torch = pytest.importorskip("torch")

from _calibration_isolation import isolated_calibration  # noqa: F401

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
                                init_model_params, prefill_step,
                                prepare_params)
from repro_torch.models import model as model_mod
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


@pytest.mark.parametrize("m", [4, 16, 17, 64, 65, 512])
def test_queue_matmul_fp32_bits_across_depth_pairs(card, m):
    """fp32 on a ragged K and N: K = 2120 (132.5 of the 16-deep stages
    above M = 16, 66.25 of the 32-deep ones at M <= 16 and of the 32-deep
    summing units) and N = 200 (1.6 tiles of 128 columns, 3.1 of 64).
    Every depth pair gives the same bits, and they are the first m rows of
    the 512-row product's."""
    k, n = 2120, 200
    x = torch.randn((512, k), generator=card, device="cuda")
    w = torch.randn((k, n), generator=card, device="cuda") / k ** 0.5
    full = queue_matmul(x, w, depth_x=4, depth_w=4)
    before = queue_matmul.launches
    outs = [queue_matmul(x[:m], w, depth_x=a, depth_w=b)
            for a, b in ((1, 1), (4, 4), (8, 8), (2, 5), (1, 8))]
    torch.cuda.synchronize()
    assert queue_matmul.launches == before + 5
    for o in outs:
        assert o.dtype == torch.float32 and o.shape == (m, n)
        assert torch.equal(o, outs[0])
    assert torch.equal(outs[0], full[:m])
    _close(outs[0], matmul_ref(x[:m], w), TOL[torch.float32])


def test_queue_matmul_fp32_bits_do_not_depend_on_the_tile(card):
    """1200 x 1800 outputs take 150 tiles of 128 x 128; its first 640
    rows take 128 x 64 tiles (75 wide ones would leave SMs idle, 145
    narrow ones do not), its first 65 rows 64 x 64 tiles, its first 16 the
    16 x 64 block: every row keeps its bits."""
    x = torch.randn((1200, 264), generator=card, device="cuda")
    w = torch.randn((264, 1800), generator=card, device="cuda") / 264 ** 0.5
    full = queue_matmul(x, w)
    for rows in (slice(0, 640), slice(0, 65), slice(0, 16), slice(100, 101),
                 slice(1000, 1200)):
        assert torch.equal(queue_matmul(x[rows], w), full[rows])
    _close(full, matmul_ref(x, w), TOL[torch.float32])


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
    """Both regimes, and the thin kernel run row by row at any M, its
    16-row tiles a block included."""
    lib = qm_ops._library()
    for m in (4, 33, 64, 512):
        for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
            for dx, dw in ((1, 1), (4, 4), (2, 8), (8, 8), (16, 16)):
                for rowwise in (False, True):
                    assert lib.queue_matmul_smem_bytes(
                        m, dx, dw, code, int(rowwise)) == \
                        qm_ops.smem_bytes(m, dx, dw, dtype, rowwise)
                assert lib.queue_matmul_thin_tiles(m, dx, dw) == \
                    qm_ops.thin_tiles(m, dx, dw)


@pytest.mark.parametrize("m", [17, 33, 64, 100, 130])
def test_queue_matmul_row_by_row_keeps_decode_bits(card, m):
    """bf16 run row by row (``slab``): the thin kernel at any M, up to
    four 16-row tiles a block (two at depths (8, 8)), over K = 2120 and N =
    200 (ragged tiles, split 4).  Every depth pair gives the same bits, and
    every row those of the thin kernel over 4 rows (a decode body's), in
    one launch; within 2e-2 of the plain version."""
    k, n = 2120, 200
    x = torch.randn((m, k), generator=card, device="cuda").bfloat16()
    w = (torch.randn((k, n), generator=card, device="cuda")
         / k ** 0.5).bfloat16()
    before = queue_matmul.launches
    outs = [queue_matmul(x, w, depth_x=a, depth_w=b, slab=4)
            for a, b in ((4, 4), (1, 1), (8, 8), (2, 5))]
    torch.cuda.synchronize()
    assert queue_matmul.launches == before + 4
    for o in outs:
        assert torch.equal(o, outs[0])
    slabs = torch.cat([queue_matmul(x[i:i + 4], w)
                       for i in range(0, m, 4)])
    assert torch.equal(outs[0], slabs)
    _close(outs[0], matmul_ref(x, w).bfloat16(), TOL[torch.bfloat16])


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


@pytest.mark.parametrize("d", [16, 64, 80, 96, 128, 200, 256])
@pytest.mark.parametrize("hq,hkv,sq,sk,causal,window,q_offset", [
    (4, 4, 130, 130, True, None, 0),
    (6, 2, 70, 200, True, 64, 130),          # GQA, Sk != Sq, q_offset
    (4, 2, 97, 97, False, 40, 0),            # a window without the mask
    (2, 1, 33, 150, False, None, 0),         # Sk > Sq, every key
])
def test_flash_attention_fp32_forward_against_plain(card, d, hq, hkv, sq, sk,
                                                   causal, window, q_offset):
    """The fp32 forward at every head-dim class and between them, its
    output and log-sum-exp against the plain version's, the same bits on
    a second call."""
    q = torch.randn((2, hq, sq, d), generator=card, device="cuda")
    k = torch.randn((2, hkv, sk, d), generator=card, device="cuda")
    v = torch.randn((2, hkv, sk, d), generator=card, device="cuda")
    before = flash_attention.launches
    out, lse = fa_ops._launch(q, k, v, causal, window, q_offset,
                              with_lse=True)
    again, lse2 = fa_ops._launch(q, k, v, causal, window, q_offset,
                                 with_lse=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2
    assert torch.equal(out, again) and torch.equal(lse, lse2)
    _close(out, _plain(q, k, v, causal, window, q_offset),
           TOL[torch.float32])
    _close(lse, fa_ops._plain_lse(q, k, causal, window, q_offset),
           TOL[torch.float32])


def test_flash_attention_fp32_rows_with_no_key(card):
    """A window of 64 without the causal mask over 128 keys: query rows
    from 191 on see no key, so they give 0 and a log-sum-exp of +inf; the
    rows before them are the plain version's."""
    q = torch.randn((1, 4, 300, 80), generator=card, device="cuda")
    k = torch.randn((1, 2, 128, 80), generator=card, device="cuda")
    v = torch.randn((1, 2, 128, 80), generator=card, device="cuda")
    out, lse = fa_ops._launch(q, k, v, False, 64, 0, with_lse=True)
    torch.cuda.synchronize()
    assert bool((out[:, :, 191:] == 0).all())
    assert bool((lse[:, :, 191:] == float("inf")).all())
    assert bool(torch.isfinite(lse[:, :, :191]).all())
    _close(out[:, :, :191], _plain(q, k, v, False, 64, 0)[:, :, :191],
           TOL[torch.float32])


def test_flash_attention_wrapper_and_kernel_agree_on_shared_memory(card):
    lib = fa_ops._library()
    for d in range(1, fa_ops.MAX_HEAD_DIM + 1):
        assert lib.flash_attention_smem_bytes(d, 0) == \
            fa_ops.fp32_geometry(d)[2]


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
    """The shared memory of each kernel, and the thin kernel's 16-row
    tiles a block row by row (1, 2 and 4 tiles; halved where the rings
    would not fit, 0 at depth 12), as the wrapper counts them."""
    lib = mg_ops._library()
    for c in (4, 17, 32, 64, 80, 512):
        for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
            for depth in (1, 2, 4, 5, 8, 9, 11, 12, 16):
                for rowwise in (False, True):
                    assert lib.moe_gemm_smem_bytes(
                        c, depth, code, int(rowwise)) == \
                        mg_ops.smem_bytes(c, depth, dtype, rowwise)
                if dtype == torch.bfloat16:
                    assert lib.moe_gemm_thin_tiles(c, depth) == \
                        mg_ops.thin_tiles(c, depth)


@pytest.mark.parametrize("c", [17, 32, 64, 80])
@pytest.mark.parametrize("bcast", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_moe_gemm_row_by_row_on_the_thin_kernel(card, c, bcast, masked):
    """bf16 run row by row (``slab`` 4): the thin kernel at C past 16 (2
    and 4 tiles a block, 80 rows a ragged group of 4 tiles), a shared or a
    per-expert x, with and without a routed mask: one launch, within 2e-2
    of the plain version, every depth the same bits, and every slab of 4
    rows the bits of a call over that slab alone (the decode body's)."""
    e, d, f = 12, 520, 200
    x = torch.randn((c, d) if bcast else (e, c, d), generator=card,
                    device="cuda").bfloat16()
    if bcast:
        x = x.expand(e, c, d)
    w = (torch.randn((e, d, f), generator=card, device="cuda")
         / d ** 0.5).bfloat16()
    active = None
    if masked:
        active = torch.zeros(e, dtype=torch.int8, device="cuda")
        active[[0, 2, 3, 7, 11]] = 1
    assert mg_ops.regime(c, torch.bfloat16, rowwise=True) == "thin"
    before = moe_gemm.launches
    outs = [moe_gemm(x, w, depth=depth, active=active, slab=4)
            for depth in (1, 2, 4)]
    torch.cuda.synchronize()
    assert moe_gemm.launches == before + 3
    for o in outs:
        assert o.dtype == torch.float32 and o.shape == (e, c, f)
        assert torch.equal(o, outs[0])
    _close(outs[0], moe_gemm_ref(x, w, active), TOL[torch.bfloat16])
    for i in range(0, c, 4):
        alone = moe_gemm(x[:, i:i + 4], w, active=active, slab=4)
        assert torch.equal(outs[0][:, i:i + 4], alone), i


@pytest.mark.parametrize("c", [1, 4, 16])
@pytest.mark.parametrize("bcast", [True, False])
def test_moe_gemm_row_by_row_keeps_the_small_launchs_bits(card, c, bcast):
    """At C <= 16 the row-by-row launch is today's: the same bits with
    and without ``slab`` (so the decode body keeps its bits), and, bf16,
    the wide kernel still takes C > 16 without it."""
    e, d, f = 8, 2048, 1024
    x = torch.randn((c, d) if bcast else (e, c, d), generator=card,
                    device="cuda").bfloat16()
    if bcast:
        x = x.expand(e, c, d)
    w = (torch.randn((e, d, f), generator=card, device="cuda")
         / d ** 0.5).bfloat16()
    assert torch.equal(moe_gemm(x, w, slab=c), moe_gemm(x, w))
    assert mg_ops.regime(17, torch.bfloat16) == "wide"


def test_moe_gemm_row_by_row_refuses_rings_that_do_not_fit(card):
    """Row by row the tiles a block halve until the rings fit (depth 11
    takes one tile); depth 12 fits no thin block and is refused before any
    launch."""
    x = torch.randn((2, 64, 256), generator=card, device="cuda").bfloat16()
    w = torch.randn((2, 256, 128), generator=card, device="cuda").bfloat16()
    before = moe_gemm.launches
    with pytest.raises(ValueError, match="bytes of shared memory"):
        moe_gemm(x, w, depth=12, slab=4)
    assert moe_gemm.launches == before
    _close(moe_gemm(x, w, depth=11, slab=4), moe_gemm_ref(x, w),
           TOL[torch.bfloat16])


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
    (1, 32, 2, 130, 130, 128, 128, True, None),  # glm4's GQA group of 16
    (1, 4, 2, 96, 160, 64, 64, True, None),    # Sk > Sq: keys 96.. unseen
    (1, 4, 4, 150, 70, 80, 80, False, None),   # Sq > Sk
    (2, 4, 2, 150, 150, 256, 256, True, 50),   # D = 256, a window, GQA
    (1, 4, 2, 130, 100, 96, 96, False, None),  # 100 keys: a ragged tile
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


def _bwd_walk(a, h, g, dtype, hold_da=True):
    """The reverse walk twice, one launch each: equal bits across the two
    calls, and (da, dh) against the plain version (da only if
    ``hold_da``).  Returns the kernel's (da, dh) and the plain version's."""
    before = rglru_scan_bwd.launches
    got, again = rglru_scan_bwd(a, h, g), rglru_scan_bwd(a, h, g)
    torch.cuda.synchronize()
    assert rglru_scan_bwd.launches == before + 2
    ref = rglru_scan_bwd_ref(a, h, g)
    for x, y, r, held in zip(got, again, ref, (hold_da, True)):
        assert x.dtype == torch.float32 and x.shape == a.shape
        assert torch.equal(x, y)
        if held:
            _close(x, r, TOL[dtype])
    return got, ref


#: the slow decays: 1 - 1e-3 in fp32; bf16 rounds that to 1.0, so there
#: the slowest decay under 1 it holds, 1 - 2^-8
SLOW_DECAY = {torch.float32: 1.0 - 1e-3, torch.bfloat16: 1.0 - 2.0 ** -8}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_scan_bwd_carries_a_slow_decay_across_segments(card, dtype):
    """A slow decay over 4096 steps: dh sums hundreds of g's, so every
    chunk's start state comes mostly from the carry (the backward twin of
    the forward's slow-decay test).  h sums hundreds of inputs too, so
    ``da = dh h_{t-1}`` magnifies dh's rounding, the kernel's and the
    plain walk's alike, some 30 times where dh crosses zero: dh is held to
    the plain version, da to the kernel's own dh times h_{t-1} (one
    rounded product) bit for bit, and dh's and da's RMS distances from
    the walk in fp64 each to at most twice the plain fp32 walk's (phase
    3's ratio)."""
    a = torch.full((2, 4096, 300), SLOW_DECAY[dtype], device="cuda").to(dtype)
    assert (a < 1.0).all()
    bx = torch.randn((2, 4096, 300), generator=card, device="cuda").to(dtype)
    h = rglru_scan(a, bx)
    g = torch.randn((2, 4096, 300), generator=card, device="cuda")
    (da, dh), (da_ref, dh_ref) = _bwd_walk(a, h, g, dtype, hold_da=False)
    assert dh.abs().max() > 20.0
    assert torch.equal(da[:, 0], torch.zeros_like(da[:, 0]))
    assert torch.equal(da[:, 1:], dh[:, 1:] * h[:, :-1])
    da64, dh64 = rglru_scan_bwd_ref(a.double(), h.double(), g.double())

    def rms(x, ref):
        return (x.double() - ref).pow(2).mean().sqrt().item()
    assert rms(dh, dh64) <= 2.0 * rms(dh_ref, dh64)
    assert rms(da, da64) <= 2.0 * rms(da_ref, da64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_scan_bwd_past_one_wave(card, dtype):
    """recurrentgemma's width at the least B >= 8 whose launch needs more
    than one wave on this card: blocks past the resident ones run after
    them and are still right."""
    from repro_torch.kernels.rglru_scan.ops import bwd_geometry
    t, w = 128, 2560
    b = 8
    while bwd_geometry(b, t, w, dtype).waves < 2:
        b *= 2
    a, bx, g = _grad_inputs(card, "rglru", dtype, (b, t, w))
    _bwd_walk(a, rglru_scan(a, bx), g, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_scan_bwd_single_step(card, dtype):
    """T = 1 at B = 3 and an odd w: dh = g and da = 0."""
    a, bx, g = _grad_inputs(card, "rglru", dtype, (3, 1, 37))
    (da, dh), _ = _bwd_walk(a, rglru_scan(a, bx), g, dtype)
    assert torch.equal(dh, g)
    assert torch.equal(da, torch.zeros_like(da))


def test_rglru_scan_bwd_launch_is_the_plan(card):
    """The launch the library sizes equals ``plan.geometry`` at the card's
    own residency, and recurrentgemma's training shape is one wave."""
    from repro_torch.kernels.rglru_scan import plan
    from repro_torch.kernels.rglru_scan.ops import (bwd_geometry,
                                                    bwd_residency)
    for dtype in (torch.float32, torch.bfloat16):
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for b, t, w in [(1, 1, 1), (3, 1, 37), (2, 37, 20), (3, 257, 37),
                        (1, 700, 64), (2, 512, 2560), (8, 512, 2560),
                        (1, 4096, 300), (64, 64, 2560)]:
            got = bwd_geometry(b, t, w, dtype)
            assert got == plan.geometry(
                b, t, w, sms, lambda n: bwd_residency(dtype, n)), (b, t, w)
        assert bwd_geometry(2, 512, 2560, dtype).waves == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,d,n", [(2, 37, 20, 4), (1, 150, 70, 16),
                                     (2, 1, 33, 5), (1, 65, 64, 1),
                                     (2, 200, 40, 32), (2, 512, 96, 16),
                                     # T off the 16-step window and the
                                     # chunk; D off a block's channels
                                     (1, 100, 50, 1), (2, 130, 70, 5),
                                     (2, 96, 33, 32),
                                     # chunks of 88 and 129 steps: more
                                     # than one 64-step segment each
                                     (1, 700, 40, 16), (1, 1030, 24, 8)])
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


# --- the entry scripts on the card --------------------------------------------

def test_kernel_bench_main_shapes_keep_the_bits_across_depths(card, tmp_path):
    """``kernel_bench --shapes main``: phi3's decode and ``forward``
    products in bf16 at depths 1, 2 and 4, each depth's output equal bit
    for bit to depth 4's (``run`` raises otherwise), over 2 rounds."""
    import json
    from repro_torch.benchmarks import kernel_bench
    out = tmp_path / "main.json"
    rows = kernel_bench.run("cuda", "main", rounds=2, out_path=str(out))
    names = [name for name, _, _ in rows]
    for m, k, n in kernel_bench.MAIN_SHAPES:
        for call in ("depth1", "depth2", "depth4", "torch_matmul"):
            assert f"kernel_queue_matmul_{m}x{k}x{n}_{call}" in names
    assert all(us > 0 for _, us, _ in rows)
    art = json.loads(out.read_text())
    assert art["timer"] == "cuda events" and "H100" in art["device"]
    assert all(len(r["rounds_us"]) == 2 for r in art["rounds"])


def test_prefill_smoke_cell_on_the_card(card, tmp_path):
    """``run_prefill(PREFILL_SMOKE)`` on the card: tokens and the serving
    slot's cache rows equal between chunked and token prefill, the
    cycles-domain gain, the chunk-program bound and the reference's smoke
    wall bar (1.2, enforced); every program a captured CUDA graph."""
    import json
    from repro_torch.benchmarks import serve_slo
    out = tmp_path / "prefill.json"
    serve_slo.run_prefill(dict(serve_slo.PREFILL_SMOKE), out_path=str(out),
                          min_wall_gain=serve_slo.MIN_PREFILL_TTFT_GAIN_SMOKE,
                          device="cuda")
    rep = json.loads(out.read_text())
    head = rep["headline"]
    assert head["bit_exact"] is True
    assert head["ttft_cycles_gain"] >= serve_slo.MIN_PREFILL_TTFT_GAIN
    assert head["meets_wall_bar"] is True
    assert rep["program_kind"] == "cuda_graph"
    assert all(p["captured"] for p in rep["programs"]["chunked"].values())


@pytest.mark.parametrize("prefill", ["chunked", "token"])
def test_serve_batch_on_the_card_matches_the_cpu(card, prefill):
    """serve_batch on glm4-smoke (fp32): the card's tokens, steps and
    traffic history equal the CPU's on the same weights."""
    from repro_torch.examples import serve_batch
    cfg = get_reduced("glm4-9b")
    rc = RunConfig(dtype="float32", param_dtype="float32", remat=False)
    p_cpu = init_model_params(0, cfg, device="cpu")
    p_gpu = tree_map(lambda a: a.cuda(), p_cpu)
    got = {dev: serve_batch.run(p, cfg, rc, 6, 10, prefill, dev)
           for dev, p in (("cuda", p_gpu), ("cpu", p_cpu))}
    for key in ("tokens", "steps", "prefill_compiles", "traffic_history"):
        assert got["cuda"][key] == got["cpu"][key], key


# --- the serve step as one CUDA graph per chunk width ---------------------------

PROGRAM_ARCHS = ["phi3-mini-3.8b", "olmoe-1b-7b", "falcon-mamba-7b",
                 "recurrentgemma-2b", "minicpm3-4b"]


def _program(step, params, cache, cfg, rc, width, slots):
    from repro_torch.serve.graphs import CapturedStep, graph_pool
    inputs = {"tokens": ((slots, width), torch.int64)}
    if step is prefill_step:
        inputs["n_tokens"] = ((slots,), torch.int32)
    return CapturedStep(lambda b: step(params, cache, b, cfg, rc)[0], inputs,
                        torch.device("cuda"), graph_pool(torch.device("cuda")))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", PROGRAM_ARCHS)
def test_replay_equals_the_eager_call(card, arch, dtype):
    """A chunk at each width 1-16 and a decode step, each as a captured
    program over one cache and as eager calls over a copy: after the
    warm-up and after two replays, the logits and every cache leaf are
    equal bit for bit (counts mix 0, 1, a partial and a whole chunk)."""
    cfg = get_reduced(arch)
    rc = RunConfig(dtype=dtype, param_dtype=dtype, remat=False)
    params = prepare_params(init_model_params(0, cfg, device="cuda"), cfg,
                            rc)
    rng = np.random.default_rng(0)
    for width in (1, 2, 4, 8, 16, "decode"):
        graph_cache = init_cache(cfg, 4, 64, rc.dtype, device="cuda")
        eager_cache = {k: v.clone() for k, v in graph_cache.items()}
        decode = width == "decode"
        w = 1 if decode else width
        step = decode_step if decode else prefill_step
        prog = _program(step, params, graph_cache, cfg, rc, w, 4)
        for call in range(3):
            toks = rng.integers(0, cfg.vocab, (4, w))
            n = np.array([0, 1, max(w // 2, 1), w], np.int32)
            arrays = {"tokens": toks} if decode else {"tokens": toks,
                                                      "n_tokens": n}
            got = prog(**arrays)
            batch = {k: torch.from_numpy(v).cuda() for k, v in arrays.items()}
            want, _ = step(params, eager_cache, batch, cfg, rc)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (width, call)
            for k in eager_cache:
                assert torch.equal(graph_cache[k], eager_cache[k]), (
                    width, call, k)
        assert prog.graph is not None and prog.replays == 2


def test_replays_add_the_captured_launches(card):
    """The warm-up launches k kernels; the capture adds none to the
    counters; each of N replays adds k."""
    from repro_torch.kernels import launch_counters
    cfg = get_reduced("olmoe-1b-7b")
    rc = RunConfig(dtype="bfloat16", param_dtype="bfloat16", remat=False)
    params = prepare_params(init_model_params(0, cfg, device="cuda"), cfg,
                            rc)
    cache = init_cache(cfg, 4, 32, rc.dtype, device="cuda")
    prog = _program(prefill_step, params, cache, cfg, rc, 4, 4)
    counters = launch_counters()
    for c in counters.values():
        c.launches = 0
    toks = np.ones((4, 4), np.int64)
    n = np.array([4, 2, 0, 1], np.int32)
    prog(tokens=toks, n_tokens=n)                # warm-up, then capture
    eager = {k: c.launches for k, c in counters.items() if c.launches}
    assert eager["queue_matmul"] > 0 and eager["moe_gemm"] > 0
    assert prog.per_replay == eager
    for _ in range(5):
        prog(tokens=toks, n_tokens=n)
    torch.cuda.synchronize()
    assert {k: c.launches for k, c in counters.items() if c.launches} == {
        k: 6 * v for k, v in eager.items()}


def test_engine_graphs_launch_the_calibrated_depths(card, monkeypatch,
                                                    isolated_calibration):
    """An engine built under the calibrated table of ``chip_smoke.py``'s
    phase 4b (the port's smoke calibration: COPIFTv2 at ring depth 2)
    captures its steps with every ``queue_matmul`` at depths (2, 2), and
    its counters count each replay's launches."""
    from repro_torch.core import calibrate, clear_policy_table_cache
    from repro_torch.kernels import launch_counters
    calibrate(workers=1, out_dir=str(isolated_calibration),
              kernels=["dequant_dot", "expf"],
              grid_kw=dict(queue_depths=(1, 2), queue_latencies=(1,),
                           unrolls=(4, 8), n_samples=16))
    clear_policy_table_cache()
    assert qm_ops.operating_point().effective_depths() == (2, 2)
    launch, captured = qm_ops._launch, {}

    def recording(x, w, depth_x, depth_w, **kw):
        if torch.cuda.is_current_stream_capturing():
            captured[(depth_x, depth_w)] = captured.get(
                (depth_x, depth_w), 0) + 1
        return launch(x, w, depth_x, depth_w, **kw)

    monkeypatch.setattr(qm_ops, "_launch", recording)
    cfg = get_reduced("phi3-mini-3.8b")
    rc = RunConfig(dtype="bfloat16", param_dtype="bfloat16", remat=False)
    eng = ServeEngine(init_model_params(0, cfg, device="cuda"), cfg, rc,
                      batch_slots=2, max_len=64, prefill_chunk=4)
    counters = launch_counters()
    for c in counters.values():
        c.launches = 0
    for i in range(3):
        eng.submit([1 + i, 5, 9, 2, 7, 3], max_new=4)
    eng.run()
    progs = eng.programs()
    assert eng.program_kind == "cuda_graph"
    assert set(captured) == {(2, 2)}
    graphs = [p for p in progs.values() if p["captured"]]
    assert graphs and all(p["kind"] == "cuda_graph" for p in graphs)
    assert captured[(2, 2)] == sum(p["launches_per_replay"]["queue_matmul"]
                                   for p in graphs)
    eager = sum(p["launches_per_replay"]["queue_matmul"]
                for p in graphs)   # each captured program ran once eagerly
    assert queue_matmul.launches == eager + sum(
        p["replays"] * p["launches_per_replay"]["queue_matmul"]
        for p in graphs)


def test_a_host_read_fails_the_capture(card):
    """A step that reads a tensor back to the host runs eagerly, then its
    capture raises; the card still works after."""
    from repro_torch.serve.graphs import CapturedStep
    prog = CapturedStep(lambda b: b["tokens"] * int(b["tokens"].sum()),
                        {"tokens": ((2, 1), torch.int64)},
                        torch.device("cuda"))
    with pytest.raises(RuntimeError):
        prog(tokens=np.ones((2, 1), np.int64))
    torch.cuda.synchronize()
    assert prog.graph is None
    assert float(torch.ones(3, device="cuda").sum()) == 3.0


# --- a chunk's columns as one batched body ------------------------------------

#: the families whose chunk runs its columns as one batched body
BATCHED_ARCHS = ["phi3-mini-3.8b", "glm4-9b", "nemotron-4-340b",
                 "pixtral-12b", "olmoe-1b-7b", "granite-moe-3b-a800m",
                 "falcon-mamba-7b", "recurrentgemma-2b", "minicpm3-4b"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_body_ops_keep_a_rows_bits_across_row_counts(card, dtype):
    """Each op of the batched body (``row_bits.BODY_OPS``) over a chunk's
    B x C rows gives every row the bits it gets over its column's B rows
    alone, at phi3-mini-3.8b's full widths (B 4, C 8), an MoE layer's
    expert products and combine at olmoe-1b-7b's, and the recurrent
    blocks' conv over columns, coefficients, recurrence steps and SSM
    readout at falcon-mamba-7b's and recurrentgemma-2b's, and an MLA
    layer's latent attention, absorb products and clamped write at
    minicpm3-4b's."""
    from repro_torch.benchmarks import row_bits
    rows = row_bits.candidates(torch.device("cuda"), dtypes=(dtype,))
    body = [r for r in rows if r["op"].startswith(row_bits.BODY_OPS)]
    assert len(body) == 22
    assert all(r["bit_equal"] for r in body), [
        (r["op"], r["max_abs"]) for r in body if not r["bit_equal"]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(1, 64), (4, 3072), (33, 3072),
                                    (7, 18432), (3, 100), (4, 18432),
                                    (32, 18432), (32, 5120), (24, 4096)])
@pytest.mark.parametrize("gamma_dtype", ["same", "float32"])
def test_rms_norm_kernel_against_plain(card, rows, d, dtype, gamma_dtype):
    """The kernel within 2e-4 (fp32) or 2e-2 (bf16) of its plain version,
    gamma in the compute dtype (the layers' norms) or fp32 (the final
    norm), at the served widths (nemotron's 18432 over a decode body's 4
    rows and a chunk's 32) and an odd one (100: one element a load); every
    row's bits equal to the row normed alone and to the rows normed in
    another grouping."""
    from repro_torch.kernels import rms_norm
    from repro_torch.kernels.rms_norm.ref import rms_norm_ref
    x = (3 * torch.randn((rows, d), generator=card, device="cuda")).to(dtype)
    g = 0.1 * torch.randn((d,), generator=card, device="cuda")
    g = g.to(dtype) if gamma_dtype == "same" else g
    before = rms_norm.launches
    out = rms_norm(x, g, 1e-5)
    torch.cuda.synchronize()
    assert rms_norm.launches == before + 1
    assert out.dtype == dtype and out.shape == x.shape
    _close(out, rms_norm_ref(x, g, 1e-5), TOL[dtype])
    for i in range(rows):
        assert torch.equal(rms_norm(x[i:i + 1], g, 1e-5), out[i:i + 1])
    half = rows // 2
    assert torch.equal(torch.cat([rms_norm(x[:half], g, 1e-5),
                                  rms_norm(x[half:], g, 1e-5)]), out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,hq,hkv,t,d", [
    (4, 1, 32, 32, 256, 96),    # phi3's decode body
    (2, 16, 32, 32, 80, 96),    # the prefill cell's chunk
    (4, 8, 32, 8, 256, 128),    # pixtral
    (3, 4, 32, 2, 64, 128),     # glm4-9b's GQA group of 16
    (2, 5, 96, 8, 40, 192),     # nemotron
    (2, 3, 4, 1, 33, 256),      # head dim 256, a ragged tile
    (3, 7, 8, 2, 24, 8),        # glm4-smoke
    (4, 8, 96, 8, 256, 192),    # nemotron's chunk
    (4, 1, 32, 32, 4096, 96),   # phi3's decode at a 4K context
    (4, 8, 32, 32, 4096, 96),   # phi3's chunk at a 4K context
    (3, 1, 32, 2, 4096, 128)])  # glm4-9b's decode at a 4K context
def test_decode_attention_kernel_against_plain(card, b, c, hq, hkv, t, d,
                                               dtype):
    """The kernel within 2e-4 (fp32) or 2e-2 (bf16) of its plain version,
    at lengths that end inside a span, on a span's edge, at T, past T
    (all T rows), at 0 (the mean of V, as the plain softmax gives) and
    across many 64-position spans (the 4K rows); every column's queries
    equal bit for bit to that column alone (a decode step's call), and
    every slot's and every K/V head's rows to that slot or head alone."""
    from repro_torch.kernels import decode_attention
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_rows_ref)
    # past one 256-position group, q x 4: each softmax then rests on a few
    # positions and the outputs are O(0.5), well above the tolerance, so a
    # lost span or group shows (unscaled, they are about 0.03 at 4K)
    q = torch.randn((c, b, hq, d), generator=card, device="cuda")
    q = (q * (4.0 if t > 256 else 1.0)).to(dtype)
    k = torch.randn((b, hkv, t, d), generator=card, device="cuda").to(dtype)
    v = torch.randn((b, hkv, t, d), generator=card, device="cuda").to(dtype)
    base = torch.tensor([t - 1, 0, 31, 5, 2 * t][:b], device="cuda")
    valid = base[None] + torch.arange(c, device="cuda")[:, None]
    valid[0, min(1, b - 1)] = 0
    valid = valid.to(torch.int32)
    before = decode_attention.launches
    out = decode_attention(q, k, v, valid)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    _close(out, decode_attention_rows_ref(q, k, v, valid), TOL[dtype])
    for j in range(c):
        assert torch.equal(decode_attention(q[j:j + 1], k, v,
                                            valid[j:j + 1]), out[j:j + 1])
    for s in range(b):
        assert torch.equal(decode_attention(
            q[:, s:s + 1], k[s:s + 1], v[s:s + 1], valid[:, s:s + 1]),
            out[:, s:s + 1])
    g = hq // hkv
    for h in (0, hkv - 1):
        assert torch.equal(decode_attention(
            q[:, :, h * g:(h + 1) * g].contiguous(),
            k[:, h:h + 1].contiguous(), v[:, h:h + 1].contiguous(), valid),
            out[:, :, h * g:(h + 1) * g])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c,h,t,r,dr", [
    (4, 1, 40, 256, 256, 32),     # minicpm3's decode body
    (4, 8, 40, 256, 256, 32),     # its chunk
    (3, 5, 40, 300, 256, 32),     # a cache of two groups (the merge)
    (4, 1, 40, 4096, 256, 32),    # decode at a 4K context
    (16, 8, 40, 256, 256, 32),    # 16 slots' chunks: two 16-row tiles a
                                  # block in bf16, one a column alone
    (2, 6, 4, 12, 16, 4)])        # reduced minicpm3 (bf16: 8-byte rope)
def test_latent_attention_kernel_against_plain(card, b, c, h, t, r, dr,
                                               dtype):
    """The kernel within 2e-4 (fp32) or 2e-2 (bf16) of its plain version,
    each column reading rows [0, min(len + c, T - 1)) and then its own row:
    rows 0 (the self row alone), inside a span, at T - 1 (the clamped
    columns past ``max_len``, whose self row stands for row T - 1) and
    across groups where T > 256; every column's queries equal bit for bit
    to that column alone (a decode step's call), every slot's to that
    slot alone, heads 0-15 and 16-39 launched alone to the whole launch's,
    and the same rows over a cache of T + 64 rows to the T launch's."""
    from repro_torch.kernels import latent_attention
    from repro_torch.kernels.latent_attention.ref import latent_attention_ref

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=card, device="cuda")
                ).to(dtype)
    # past one 256-position group, q x 4, so a lost span or group shows
    q = rnd(c, b, h, r, scale=4.0 if t > 256 else 1.0)
    qr, lat, rope = rnd(c, b, h, dr), rnd(b, t, r), rnd(b, t, dr)
    own, own_r = rnd(c, b, r), rnd(c, b, dr)
    base = torch.tensor(([0, t - 3, 31, t + 9] * 4)[:b], device="cuda")
    rows = (base[None] + torch.arange(c, device="cuda")[:, None]).clamp(
        max=t - 1).to(torch.int32)
    scale = 1.0 / math.sqrt(64 + dr)
    before = latent_attention.launches
    out = latent_attention(q, qr, lat, rope, rows, own, own_r, scale)
    torch.cuda.synchronize()
    assert latent_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    _close(out, latent_attention_ref(q, qr, lat, rope, rows, own, own_r,
                                     scale), TOL[dtype])
    for j in range(c):
        assert torch.equal(latent_attention(
            q[j:j + 1], qr[j:j + 1], lat, rope, rows[j:j + 1],
            own[j:j + 1], own_r[j:j + 1], scale), out[j:j + 1])
    for s in range(b):
        assert torch.equal(latent_attention(
            q[:, s:s + 1], qr[:, s:s + 1], lat[s:s + 1], rope[s:s + 1],
            rows[:, s:s + 1], own[:, s:s + 1], own_r[:, s:s + 1], scale),
            out[:, s:s + 1])
    for lo, hi in ((0, min(16, h)), (min(16, h), h)):
        if lo < hi:
            assert torch.equal(latent_attention(
                q[:, :, lo:hi].contiguous(), qr[:, :, lo:hi].contiguous(),
                lat, rope, rows, own, own_r, scale), out[:, :, lo:hi])
    longer = [torch.cat([x, rnd(b, 64, x.shape[-1])], dim=1)
              for x in (lat, rope)]
    assert torch.equal(latent_attention(q, qr, *longer, rows, own, own_r,
                                        scale), out)


def test_latent_attention_refuses_grad_and_mixed_dtypes(card):
    from repro_torch.kernels import latent_attention
    def rnd(*shape):
        return torch.randn(shape, generator=card, device="cuda")
    q = rnd(1, 2, 4, 16).requires_grad_()
    rows = torch.zeros((1, 2), dtype=torch.int32, device="cuda")
    args = (rnd(1, 2, 4, 4), rnd(2, 8, 16), rnd(2, 8, 4), rows,
            rnd(1, 2, 16), rnd(1, 2, 4), 0.5)
    with pytest.raises(RuntimeError, match="no backward"):
        latent_attention(q, *args)
    with torch.no_grad(), pytest.raises(TypeError, match="one dtype"):
        latent_attention(q.bfloat16(), *args)


def _token_prefill(params, cache, toks, counts, cfg, rc):
    """Each column through ``decode_step`` on a copy of the cache, its
    active slots' rows, lengths and logits kept: token-by-token prefill of
    exactly the chunk's tokens."""
    logits = torch.zeros((toks.shape[0], cfg.vocab), device="cuda")
    for j in range(toks.shape[1]):
        trial = {k: v.clone() for k, v in cache.items()}
        out, trial = decode_step(params, trial, {"tokens": toks[:, j:j + 1]},
                                 cfg, rc)
        act = torch.from_numpy(counts > j).cuda()
        for k, v in cache.items():
            if v.ndim == 1:
                v.copy_(torch.where(act, trial[k], v))
            else:
                v[:, act] = trial[k][:, act]
        logits[act] = out[act]
    return logits


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", BATCHED_ARCHS)
def test_a_replayed_chunk_equals_token_prefill(card, arch, dtype):
    """A chunk at widths 1-16 as a captured program (its first call eager,
    then two replays) against its columns' decode steps on a copy of the
    cache: logits and every cache leaf equal bit for bit (counts 0, 1, a
    partial and a whole chunk); and no product of the chunk took the wide
    kernel (each runs row by row, in slabs of the 4 slots; an MoE layer's
    expert products and an MLA layer's per-head absorb products too)."""
    cfg = get_reduced(arch)
    assert model_mod.batches_columns(cfg)
    rc = RunConfig(dtype=dtype, param_dtype=dtype, remat=False)
    params = prepare_params(init_model_params(0, cfg, device="cuda"), cfg,
                            rc)
    rng = np.random.default_rng(1)
    launch, slabs = qm_ops._launch, []
    expert_launch, expert_slabs = mg_ops._launch, []

    def recording(x, w, depth_x, depth_w, rowwise=False):
        slabs.append(rowwise)
        return launch(x, w, depth_x, depth_w, rowwise)

    def expert_recording(x, w, depth, active, rowwise=False):
        expert_slabs.append(rowwise)
        return expert_launch(x, w, depth, active, rowwise)

    for width in (1, 2, 3, 4, 8, 16):
        cache = init_cache(cfg, 4, 64, rc.dtype, device="cuda")
        cache["len"].copy_(torch.tensor([3, 0, 9, 1], dtype=torch.int32))
        ref = {k: v.clone() for k, v in cache.items()}
        prog = _program(prefill_step, params, cache, cfg, rc, width, 4)
        for call in range(3):
            toks = rng.integers(0, cfg.vocab, (4, width))
            n = np.array([0, 1, max(width // 2, 1), width], np.int32)
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(qm_ops, "_launch", recording)
                mp.setattr(mg_ops, "_launch", expert_recording)
                got = prog(tokens=toks, n_tokens=n)
            want = _token_prefill(params, ref, torch.from_numpy(toks).cuda(),
                                  n, cfg, rc)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (width, call)
            for k in ref:
                assert torch.equal(cache[k], ref[k]), (width, call, k)
        assert prog.graph is not None and prog.replays == 2
    assert slabs and all(slabs)
    assert all(expert_slabs) and bool(expert_slabs) == bool(cfg.moe
                                                            or cfg.mla)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_long_prompt_chunked_equals_token_prefill(card, dtype):
    """phi3-mini-3.8b at full width cut to 2 layers, caches of 512 rows:
    prompts of 200 and 300 tokens prefilled by a replayed chunk of 16 (its
    first call eager, then eighteen replays) against token prefill of the
    same tokens: logits after every chunk and every cache leaf equal bit
    for bit.  The later chunks' queries cross several of
    ``decode_attention``'s 64-position spans and, past 256 positions, its
    256-position groups, whose partials the merge launch folds; phase 4's
    prompts of at most 40 positions do neither."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention
    cfg = dataclasses.replace(get_config("phi3-mini-3.8b"), n_layers=2)
    rc = RunConfig(dtype=dtype, param_dtype=dtype, remat=False)
    params = prepare_params(init_model_params(0, cfg, device="cuda"), cfg,
                            rc)
    cache = init_cache(cfg, 2, 512, rc.dtype, device="cuda")
    ref = {k: v.clone() for k, v in cache.items()}
    prog = _program(prefill_step, params, cache, cfg, rc, 16, 2)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, 200), rng.integers(0, cfg.vocab,
                                                             300)]
    before = decode_attention.launches
    for start in range(0, 300, 16):
        toks = np.zeros((2, 16), np.int64)
        n = np.zeros(2, np.int32)
        for s, p in enumerate(prompts):
            part = p[start:start + 16]
            toks[s, :len(part)] = part
            n[s] = len(part)
        got = prog(tokens=toks, n_tokens=n)
        want = _token_prefill(params, ref, torch.from_numpy(toks).cuda(), n,
                              cfg, rc)
        torch.cuda.synchronize()
        assert torch.equal(got, want), start
    for k in ref:
        assert torch.equal(cache[k], ref[k]), k
    assert prog.replays == 18
    assert decode_attention.launches > before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_chunk_wider_than_the_cache_equals_token_prefill(card, dtype):
    """phi3-smoke, a replayed bucket of 16 columns over caches of 8 rows
    (the body runs in two runs of 8 columns, so no masked column wraps onto
    a row an active one writes): logits and every cache leaf equal token
    prefill's bit for bit."""
    cfg = get_reduced("phi3-mini-3.8b")
    rc = RunConfig(dtype=dtype, param_dtype=dtype, remat=False)
    params = prepare_params(init_model_params(0, cfg, device="cuda"), cfg,
                            rc)
    cache = init_cache(cfg, 4, 8, rc.dtype, device="cuda")
    cache["len"].copy_(torch.tensor([0, 2, 1, 0], dtype=torch.int32))
    ref = {k: v.clone() for k, v in cache.items()}
    prog = _program(prefill_step, params, cache, cfg, rc, 16, 4)
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (4, 16))
    n = np.array([0, 1, 5, 8], np.int32)
    got = prog(tokens=toks, n_tokens=n)
    want = _token_prefill(params, ref, torch.from_numpy(toks).cuda(), n, cfg,
                          rc)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    for k in ref:
        assert torch.equal(cache[k], ref[k]), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_hybrid_chunk_over_a_short_ring_equals_token_prefill(card, dtype):
    """recurrentgemma-smoke (window 16), a replayed bucket of 16 columns
    over caches of 8 rows: a ring shorter than the window is the whole
    cache, so the attention layers take the chunk's columns at once (in
    two runs of 8) as phase 4's ring of 256 rows against a window of 2048
    does; logits and every cache leaf equal token prefill's bit for
    bit."""
    cfg = get_reduced("recurrentgemma-2b")
    rc = RunConfig(dtype=dtype, param_dtype=dtype, remat=False)
    params = prepare_params(init_model_params(0, cfg, device="cuda"), cfg,
                            rc)
    cache = init_cache(cfg, 4, 8, rc.dtype, device="cuda")
    assert not model_mod._attends_by_column(cfg, cache)
    cache["len"].copy_(torch.tensor([0, 2, 1, 0], dtype=torch.int32))
    ref = {k: v.clone() for k, v in cache.items()}
    prog = _program(prefill_step, params, cache, cfg, rc, 16, 4)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (4, 16))
    n = np.array([0, 1, 5, 8], np.int32)
    got = prog(tokens=toks, n_tokens=n)
    want = _token_prefill(params, ref, torch.from_numpy(toks).cuda(), n, cfg,
                          rc)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    for k in ref:
        assert torch.equal(cache[k], ref[k]), k
