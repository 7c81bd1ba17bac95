"""The PyTorch port's CUDA kernels and model on the card, against their
plain versions.  These need a CUDA card and the CUDA toolkit; without a
card each test skips with a reason.  On a machine with one:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: fp32 2e-4 (no TF32: the kernels' fp32 path is plain FMA and
the references run with ``allow_tf32`` off), bf16 2e-2, logits 2e-3.
``moe_gemm`` must give the same bits at every ring depth and for a row
whatever rows come with it (what keeps chunked prefill bit-exact with token
prefill on the card)."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro_torch.config import RunConfig
from repro_torch.configs import get_reduced
from repro_torch.core.policy import ExecutionPolicy as EP
from repro_torch.kernels import (flash_attention, moe_gemm, queue_matmul,
                                 ssm_scan)
from repro_torch.kernels.flash_attention.ops import _plain
from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref
from repro_torch.kernels.queue_matmul.ref import matmul_ref
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
from repro_torch.models import forward, init_model_params
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,sq,sk,d,causal,window,q_offset", [
    (4, 2, 100, 100, 80, True, None, 0),
    (4, 4, 33, 97, 16, True, 24, 64),
    (2, 1, 65, 65, 128, False, 20, 0),
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
    """A broadcast x (expert stride 0) reads the one matrix; each row's
    result is the same bits whether it comes with 3 other rows or alone,
    and whether the block is 16 or 64 rows."""
    x = torch.randn((40, 512), generator=card, device="cuda").to(dtype)
    w = (torch.randn((6, 512, 128), generator=card, device="cuda")
         / 512 ** 0.5).to(dtype)
    full = moe_gemm(x.expand(6, 40, 512), w)
    assert torch.equal(full, moe_gemm(x.expand(6, 40, 512).contiguous(), w))
    four = moe_gemm(x[:4].expand(6, 4, 512), w)
    assert torch.equal(four, full[:, :4])
    one = moe_gemm(x[2:3].expand(6, 1, 512), w)
    assert torch.equal(one, full[:, 2:3])


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


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "glm4-9b", "olmoe-1b-7b",
                                  "granite-moe-3b-a800m", "falcon-mamba-7b"])
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
