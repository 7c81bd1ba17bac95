"""The PyTorch port's CUDA kernels and model on the card, against their
plain versions.  These need a CUDA card and the CUDA toolkit; without a
card each test skips with a reason.  On a machine with one:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: fp32 2e-4 (no TF32: the kernels' fp32 path is plain FMA and
the references run with ``allow_tf32`` off), bf16 2e-2, logits 2e-3."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro_torch.config import RunConfig
from repro_torch.configs import get_reduced
from repro_torch.core.policy import ExecutionPolicy as EP
from repro_torch.kernels import flash_attention, queue_matmul
from repro_torch.kernels.flash_attention.ops import _plain
from repro_torch.kernels.queue_matmul.ref import matmul_ref
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


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "glm4-9b"])
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
