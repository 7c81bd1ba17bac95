"""The gradients of the port's kernels on the CPU: the plain backward of
attention (``attention_bwd_ref``, the formulas of
``flash_attention_bwd.cu``) against ``torch.autograd`` of the plain
forward and against ``jax.vjp`` of the JAX package's
``flash_attention_ref``, over causal, windowed, GQA, a v head dim below
q's and rows that see no key; ``torch.autograd.gradcheck`` (fp64) of the
``queue_matmul`` and ``flash_attention`` autograd Functions, whose CPU
path is plain; and the refusal of the kernels that have no backward.

The kernels return 0 for a row that sees no key (the JAX reference gives
it the mean of V), so the function differentiated here is the plain
forward with such rows zeroed; its gradient there is 0.  Tolerances:
fp64 against autograd 1e-10; fp32 against JAX 2e-5 of the largest
entry (two fp32 sums in other orders)."""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.models.attention import flash_attention_ref as jax_flash_ref
from repro_torch.core.policy import ExecutionPolicy as EP
from repro_torch.kernels import moe_gemm, queue_matmul, rglru_scan, ssm_scan
from repro_torch.kernels._grad import refuse_grad
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd, ops)
from repro_torch.kernels.flash_attention.ref import (_mask,
                                                     attention_bwd_ref,
                                                     attention_lse_ref,
                                                     attention_ref)

#: (Hq, Hkv, Sq, Sk, D, Dv, causal, window)
CASES = [(2, 2, 12, 12, 8, 8, True, None),
         (2, 2, 12, 12, 8, 8, False, None),
         (4, 2, 15, 15, 8, 8, True, 5),
         (4, 1, 10, 10, 12, 6, True, None),
         (2, 1, 14, 5, 8, 8, False, 3)]          # rows 7.. see no key


def _inputs(hq, hkv, sq, sk, d, dv, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s)).to(dtype) for s in
                 ((2, hq, sq, d), (2, hkv, sk, d), (2, hkv, sk, dv),
                  (2, hq, sq, dv)))


def _zeroed_forward(q, k, v, causal, window):
    """The plain forward with GQA, rows that see no key set to 0 (what the
    kernel computes)."""
    out = ops._plain(q, k, v, causal, window, 0)
    keep = _mask(q.shape[2], k.shape[2], causal, window, 0, q.device)
    return out * keep.any(-1)[:, None].to(out.dtype)


@pytest.mark.parametrize("case", CASES)
def test_attention_bwd_ref_is_the_gradient_of_the_forward(case):
    hq, hkv, sq, sk, d, dv, causal, window = case
    q, k, v, do = _inputs(hq, hkv, sq, sk, d, dv, torch.float64)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = _zeroed_forward(*leaves, causal, window)
    want = torch.autograd.grad(out, leaves, do)
    lse = ops._plain_lse(q, k, causal, window, 0)
    got = flash_attention_bwd(q, k, v, out.detach(), lse, do, causal=causal,
                              window=window)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10)
    keep = _mask(sq, sk, causal, window, 0, "cpu")
    empty = ~keep.any(-1)
    assert torch.isinf(lse[:, :, empty]).all()
    assert (got[0][:, :, empty] == 0).all()


@pytest.mark.parametrize("case", CASES)
def test_attention_bwd_ref_matches_jax_vjp(case):
    """Against ``jax.vjp`` of the reference's blocked attention (ragged
    blocks), its rows that see no key zeroed as the kernel's are."""
    hq, hkv, sq, sk, d, dv, causal, window = case
    q, k, v, do = _inputs(hq, hkv, sq, sk, d, dv, torch.float32, seed=1)
    has_key = _mask(sq, sk, causal, window, 0, "cpu").any(-1).numpy()

    def f(a, b, c):
        out = jax_flash_ref(a, b, c, causal=causal, window=window,
                            block_q=8, block_k=4)
        return out * jnp.asarray(has_key, out.dtype)[:, None]
    out, vjp = jax.vjp(f, *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    want = vjp(jnp.asarray(do.numpy()))
    lse = ops._plain_lse(q, k, causal, window, 0)
    got = flash_attention_bwd(q, k, v, torch.from_numpy(np.array(out)),
                              lse, do, causal=causal, window=window)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-5,
                                   atol=2e-5 * float(np.abs(w).max()))


def test_attention_lse_ref_and_bwd_ref_per_head():
    """The per-head plain functions: lse is the log-sum-exp of the kept
    scaled scores, and the backward of one head at D 16."""
    rng = np.random.default_rng(2)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s)) for s in
                   ((3, 9, 16), (3, 9, 16), (3, 9, 16), (3, 9, 16)))
    lse = attention_lse_ref(q, k, causal=True)
    s = torch.einsum("bqd,bkd->bqk", q, k) / 4.0
    s = s.masked_fill(~_mask(9, 9, True, None, 0, "cpu"), -float("inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, -1))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = attention_ref(*leaves, causal=True)
    want = torch.autograd.grad(out, leaves, do)
    got = attention_bwd_ref(q, k, v, out.detach(), lse, do, causal=True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10)


#: gradcheck's (Hq, Hkv, S, D, Dv, causal, window): small, since it runs
#: the forward twice for every input element
GRADCHECK = [(2, 2, 5, 4, 4, True, None), (2, 2, 5, 4, 4, False, None),
             (2, 1, 6, 4, 4, True, 3), (2, 1, 5, 6, 3, True, None)]


@pytest.mark.parametrize("case", GRADCHECK)
def test_flash_attention_function_gradcheck(case):
    hq, hkv, s, d, dv, causal, window = case
    rng = np.random.default_rng(3)
    leaves = [torch.from_numpy(rng.standard_normal(shape)).requires_grad_()
              for shape in ((1, hq, s, d), (1, hkv, s, d), (1, hkv, s, dv))]
    assert torch.autograd.gradcheck(
        lambda a, b, c: flash_attention(a, b, c, causal=causal,
                                        window=window), leaves)


def test_flash_attention_function_forward_is_the_plain_output():
    """With grad on, the output has the same bits as without, and a
    backward through a q_offset raises (training never passes one)."""
    q, k, v, do = _inputs(4, 2, 10, 10, 8, 8, torch.float32)
    plain = flash_attention(q, k, v, causal=True)
    qg = q.clone().requires_grad_()
    out = flash_attention(qg, k, v, causal=True)
    assert out.grad_fn is not None and torch.equal(out.detach(), plain)
    out = flash_attention(qg, k, v, causal=True, q_offset=3)
    with pytest.raises(NotImplementedError, match="q_offset"):
        out.backward(do)


@pytest.mark.parametrize("policy", [None, EP.BASELINE, EP.COPIFT])
def test_queue_matmul_function_gradcheck(policy):
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((5, 7))).requires_grad_()
    w = torch.from_numpy(rng.standard_normal((7, 3))).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda a, b: queue_matmul(a, b, policy=policy), (x, w))
    # one operand only: the other's product is not computed
    y = queue_matmul(x.detach(), w, policy=policy)
    (gw,) = torch.autograd.grad(y.sum(), (w,))
    torch.testing.assert_close(
        gw, x.detach().t() @ torch.ones(5, 3, dtype=torch.float64))


def test_queue_matmul_function_keeps_the_forward_bits():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((6, 9)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((9, 4)).astype(np.float32))
    y = queue_matmul(x, w.clone().requires_grad_())
    assert y.grad_fn is not None and torch.equal(y.detach(),
                                                 queue_matmul(x, w))


def test_kernels_without_backward_refuse_grad():
    """The check the CUDA paths of ``moe_gemm``, ``ssm_scan`` and
    ``rglru_scan`` make before a launch (tests/test_torch_cuda.py runs
    them on the card): raise when an operand requires grad under grad
    mode, never hand back an output that carries no gradient."""
    a, b = torch.ones(3, requires_grad=True), torch.ones(3)
    with pytest.raises(NotImplementedError, match="MoE training"):
        refuse_grad("moe_gemm", "MoE training", b, a)
    refuse_grad("moe_gemm", "MoE training", b, b)
    with torch.no_grad():
        refuse_grad("moe_gemm", "MoE training", a, b)


def test_plain_versions_of_kernels_without_backward_differentiate():
    """On the CPU ``moe_gemm``, ``ssm_scan`` and ``rglru_scan`` take their
    plain versions, which autograd differentiates as they are."""
    rng = np.random.default_rng(6)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape)).requires_grad_()
    assert torch.autograd.gradcheck(moe_gemm, (t(2, 3, 4), t(2, 4, 5)))
    a = torch.from_numpy(rng.uniform(0.1, 0.9, (1, 6, 3))).requires_grad_()
    assert torch.autograd.gradcheck(rglru_scan, (a, t(1, 6, 3)))
    x, dt = t(1, 5, 3), torch.from_numpy(rng.uniform(0.1, 0.5, (1, 5, 3))
                                         ).requires_grad_()
    A = torch.from_numpy(-rng.uniform(0.5, 1.5, (3, 2))).requires_grad_()
    assert torch.autograd.gradcheck(ssm_scan, (x, dt, A, t(1, 5, 2),
                                               t(1, 5, 2)))
