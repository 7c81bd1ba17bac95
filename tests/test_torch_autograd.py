"""The gradients of the port's kernels on the CPU: the plain backward of
attention (``attention_bwd_ref``, the formulas of
``flash_attention_bwd.cu``) against ``torch.autograd`` of the plain
forward and against ``jax.vjp`` of the JAX package's
``flash_attention_ref``, over causal, windowed, GQA, a v head dim below
q's and rows that see no key; the plain backward passes of ``rglru_scan``,
``ssm_scan`` and ``moe_gemm`` (the formulas of their kernels) against
``torch.autograd`` of their plain forward and against ``jax.vjp`` of the
JAX package's plain functions, at lengths that are not a multiple of a
chunk, with per-expert, shared and masked expert operands;
``torch.autograd.gradcheck`` (fp64) of every autograd Function, whose CPU
path is plain.

The kernels return 0 for a row that sees no key (the JAX reference gives
it the mean of V), so the function differentiated here is the plain
forward with such rows zeroed; its gradient there is 0.  Tolerances:
fp64 against autograd 1e-10; fp32 against JAX 2e-5 of the largest
entry (two fp32 sums in other orders); the scans' and the expert
products' plain backward against JAX 2e-4 of the largest entry (fp32),
against autograd 1e-10 (fp64)."""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.kernels.moe_gemm.ref import moe_gemm_ref as jax_moe_ref
from repro.kernels.rglru_scan.ref import rglru_scan_ref as jax_rglru_ref
from repro.kernels.ssm_scan.ref import ssm_scan_ref as jax_ssm_ref
from repro.models.attention import flash_attention_ref as jax_flash_ref
from repro_torch.core.policy import ExecutionPolicy as EP
from repro_torch.kernels import moe_gemm, queue_matmul, rglru_scan, ssm_scan
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd, ops)
from repro_torch.kernels.flash_attention.ref import (_mask,
                                                     attention_bwd_ref,
                                                     attention_lse_ref,
                                                     attention_ref)
from repro_torch.kernels.moe_gemm import moe_gemm_bwd
from repro_torch.kernels.moe_gemm import ops as mg_ops
from repro_torch.kernels.moe_gemm.ref import moe_gemm_bwd_ref, moe_gemm_ref
from repro_torch.kernels.rglru_scan import ops as rg_ops
from repro_torch.kernels.rglru_scan import rglru_scan_bwd
from repro_torch.kernels.rglru_scan.ref import (rglru_scan_bwd_ref,
                                                rglru_scan_ref)
from repro_torch.kernels.ssm_scan import ops as ss_ops
from repro_torch.kernels.ssm_scan import ssm_scan_bwd
from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref, ssm_scan_ref

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


# --- the scans' and the expert products' backward -------------------------

#: (B, T, w): one step, the chunk length 16 and past it, a segment (256)
#: and past it
RGLRU_SHAPES = [(1, 1, 3), (2, 17, 5), (1, 40, 4), (2, 257, 3)]
#: (B, T, d, N): T below, at and past a chunk (32), ragged
SSM_SHAPES = [(1, 1, 3, 2), (2, 9, 4, 3), (1, 37, 5, 16), (2, 70, 3, 5)]
#: (E, C, d, f, x shared by every expert, mask)
MOE_CASES = [(3, 5, 4, 6, False, False), (3, 5, 4, 6, False, True),
             (4, 7, 6, 3, True, False), (4, 7, 6, 3, True, True),
             (2, 1, 9, 5, True, True)]


def _close_to(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * max(float(np.abs(want).max()), 1.0))


def _rglru_inputs(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.3, 0.99, shape)
    return [torch.from_numpy(v).to(dtype)
            for v in (a, rng.standard_normal(shape),
                      rng.standard_normal(shape))]


def _ssm_inputs(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    b, t, d, n = shape
    vals = (rng.standard_normal((b, t, d)) * 0.5,
            rng.uniform(0.05, 0.5, (b, t, d)),
            -rng.uniform(0.5, 1.5, (d, n)), rng.standard_normal((b, t, n)),
            rng.standard_normal((b, t, n)), rng.standard_normal((b, t, d)))
    return [torch.from_numpy(v).to(dtype) for v in vals]


def _moe_inputs(case, dtype, seed):
    e, c, d, f, shared, masked = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((c, d) if shared else (e, c, d))
    w = rng.standard_normal((e, d, f)) / np.sqrt(d)
    dy = rng.standard_normal((e, c, f))
    active = (torch.from_numpy((np.arange(e) % 2 == 0).astype(np.int8))
              if masked else None)
    return [torch.from_numpy(v).to(dtype) for v in (x, w, dy)] + [active]


@pytest.mark.parametrize("shape", RGLRU_SHAPES)
def test_rglru_scan_bwd_ref_is_the_gradient_of_the_forward(shape):
    a, bx, g = _rglru_inputs(shape, torch.float64, 7)
    leaves = [t.clone().requires_grad_() for t in (a, bx)]
    h = rglru_scan_ref(*leaves)
    want = torch.autograd.grad(h, leaves, g)
    got = rglru_scan_bwd_ref(a, h.detach(), g)
    for x, y in zip(got, want):
        assert x.dtype == torch.float64 and x.shape == y.shape
        torch.testing.assert_close(x, y, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("shape", RGLRU_SHAPES)
def test_rglru_scan_bwd_ref_matches_jax_vjp(shape):
    a, bx, g = _rglru_inputs(shape, torch.float32, 8)
    h, vjp = jax.vjp(jax_rglru_ref, jnp.asarray(a.numpy()),
                     jnp.asarray(bx.numpy()))
    want = vjp(jnp.asarray(g.numpy()))
    got = rglru_scan_bwd(a, torch.from_numpy(np.array(h)), g)
    for x, y in zip(got, want):
        _close_to(x.numpy(), y, 2e-4)


@pytest.mark.parametrize("shape", SSM_SHAPES)
def test_ssm_scan_bwd_ref_is_the_gradient_of_the_forward(shape):
    *args, dy = _ssm_inputs(shape, torch.float64, 9)
    leaves = [t.clone().requires_grad_() for t in args]
    want = torch.autograd.grad(ssm_scan_ref(*leaves), leaves, dy)
    got = ssm_scan_bwd_ref(*args, dy)
    for x, y in zip(got, want):
        assert x.dtype == torch.float64 and x.shape == y.shape
        torch.testing.assert_close(x, y, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("shape", SSM_SHAPES)
def test_ssm_scan_bwd_ref_matches_jax_vjp(shape):
    *args, dy = _ssm_inputs(shape, torch.float32, 10)
    _, vjp = jax.vjp(jax_ssm_ref, *(jnp.asarray(t.numpy()) for t in args))
    want = vjp(jnp.asarray(dy.numpy()))
    got = ssm_scan_bwd(*args, dy)
    for x, y in zip(got, want):
        _close_to(x.numpy(), y, 2e-4)


@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_gemm_bwd_ref_is_the_gradient_of_the_forward(case):
    x, w, dy, active = _moe_inputs(case, torch.float64, 11)
    leaves = [t.clone().requires_grad_() for t in (x, w)]
    want = torch.autograd.grad(moe_gemm_ref(*leaves, active), leaves, dy)
    got = moe_gemm_bwd_ref(x, w, dy, active)
    for g, y in zip(got, want):
        assert g.dtype == torch.float64 and g.shape == y.shape
        torch.testing.assert_close(g, y, rtol=1e-10, atol=1e-10)
    if active is not None:
        assert bool((got[1][active == 0] == 0).all())


@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_gemm_bwd_ref_matches_jax_vjp(case):
    """The JAX reference takes per-expert x and no mask: a shared x is
    broadcast and the mask multiplies its output, as the port defines
    them."""
    x, w, dy, active = _moe_inputs(case, torch.float32, 12)
    e, c = w.shape[0], dy.shape[1]
    keep = (np.ones(e, np.float32) if active is None
            else active.numpy().astype(np.float32))

    def f(xj, wj):
        if xj.ndim == 2:
            xj = jnp.broadcast_to(xj, (e, *xj.shape))
        return jax_moe_ref(xj, wj) * jnp.asarray(keep)[:, None, None]
    _, vjp = jax.vjp(f, jnp.asarray(x.numpy()), jnp.asarray(w.numpy()))
    want = vjp(jnp.asarray(dy.numpy()))
    got = moe_gemm_bwd(x, w, dy, active=active)
    for g, y in zip(got, want):
        assert g.shape == y.shape
        _close_to(g.numpy(), y, 2e-4)


@pytest.mark.parametrize("case", MOE_CASES[:3])
def test_moe_gemm_bwd_computes_only_what_is_needed(case):
    x, w, dy, _ = _moe_inputs(case, torch.float64, 13)
    dx, dw = moe_gemm_bwd(x, w, dy, need=(True, False))
    assert dw is None
    torch.testing.assert_close(dx, moe_gemm_bwd_ref(x, w, dy)[0])
    dx, dw = moe_gemm_bwd(x, w, dy, need=(False, True))
    assert dx is None
    torch.testing.assert_close(dw, moe_gemm_bwd_ref(x, w, dy)[1])


@pytest.mark.parametrize("shape", [(1, 6, 3), (2, 18, 2)])
def test_rglru_scan_function_gradcheck(shape):
    a, bx, _ = _rglru_inputs(shape, torch.float64, 14)
    assert torch.autograd.gradcheck(rg_ops._RglruScanFn.apply,
                                    (a.requires_grad_(),
                                     bx.requires_grad_()))


@pytest.mark.parametrize("shape", [(1, 5, 3, 2), (2, 7, 2, 4)])
def test_ssm_scan_function_gradcheck(shape):
    *args, _ = _ssm_inputs(shape, torch.float64, 15)
    assert torch.autograd.gradcheck(
        ss_ops._SsmScanFn.apply, [t.requires_grad_() for t in args])


@pytest.mark.parametrize("case", MOE_CASES[1:4])
def test_moe_gemm_function_gradcheck(case):
    x, w, _, active = _moe_inputs(case, torch.float64, 16)
    assert torch.autograd.gradcheck(
        lambda a, b: mg_ops._MoeGemmFn.apply(a, b, 2, active),
        (x.requires_grad_(), w.requires_grad_()))
