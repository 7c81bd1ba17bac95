"""The PyTorch port's kernel ops against the JAX package's Pallas kernels,
which run in interpret mode here (as tests/test_kernels.py runs them).  On
the CPU each port op takes its plain version, so these tests hold the
wrappers' semantics (policies, depths, padding, masks, GQA, q_offset) to
the reference; the CUDA kernels are held to the same plain versions on the
card by chip_smoke.py and tests/test_torch_cuda.py.

Tolerances: fp32 2e-4 and bf16 2e-2, those of tests/test_kernels.py
(fp32 accumulation in another order; bf16 output rounding)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.core.policy import ExecutionPolicy as JEP
from repro.kernels import flash_attention as jax_flash_attention
from repro.kernels import queue_matmul as jax_queue_matmul
from repro.models.attention import flash_attention_ref as jax_flash_ref
from repro_torch.core.policy import ExecutionPolicy as EP
from repro_torch.core.policy import OperatingPoint
from repro_torch.kernels import flash_attention, queue_matmul
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.queue_matmul import ops as qm_ops
from repro_torch.models.attention import flash_attention_ref

TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _pair(shape_x, shape_w, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape_x).astype(np.float32)
    w = rng.standard_normal(shape_w).astype(np.float32)
    jx, jw = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
    tdt = getattr(torch, dtype)
    return jx, jw, torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)


# --- queue_matmul -----------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(5, 33, 17), (130, 260, 70)])
def test_queue_matmul_matches_pallas_on_ragged_shapes(m, k, n, dtype):
    jx, jw, tx, tw = _pair((m, k), (k, n), dtype)
    ref = jax_queue_matmul(jx, jw, depth=2)
    out = queue_matmul(tx, tw, depth=2)
    assert out.dtype == tx.dtype and out.shape == (m, n)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), **TOL[dtype])


@pytest.mark.parametrize("policy", list(EP))
def test_queue_matmul_policies_match_pallas(policy):
    jx, jw, tx, tw = _pair((40, 200), (200, 24), "float32", seed=1)
    ref = jax_queue_matmul(jx, jw, policy=JEP(policy.value))
    out = queue_matmul(tx, tw, policy=policy)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL["float32"])


def test_queue_matmul_asymmetric_depths_match_pallas():
    jx, jw, tx, tw = _pair((20, 300), (300, 40), "float32", seed=2)
    ref = jax_queue_matmul(jx, jw, depth_x=2, depth_w=4)
    out = queue_matmul(tx, tw, depth_x=2, depth_w=4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL["float32"])


def _record(monkeypatch, point):
    calls = []
    monkeypatch.setattr(qm_ops, "_queue_matmul",
                        lambda x, w, **kw: calls.append(kw) or x @ w)
    monkeypatch.setattr(qm_ops, "operating_point", lambda: point)
    return calls


def test_queue_matmul_explicit_depth_survives_table_policy(monkeypatch):
    """An explicit depth stays a depth sweep even when the table resolves a
    policy that discards depth (analogue of test_calibration.py:257)."""
    calls = _record(monkeypatch, OperatingPoint(policy=EP.BASELINE,
                                                source="calibrated"))
    x = torch.ones((4, 4))
    qm_ops.queue_matmul(x, x, depth=3)
    assert calls[-1]["depth_x"] == calls[-1]["depth_w"] == 3
    assert calls[-1]["policy"] is EP.COPIFTV2
    qm_ops.queue_matmul(x, x, depth=3, depth_w=1)
    assert (calls[-1]["depth_x"], calls[-1]["depth_w"]) == (3, 1)
    assert calls[-1]["policy"] is EP.COPIFTV2
    qm_ops.queue_matmul(x, x)                    # no explicit depth: table
    assert calls[-1]["policy"] is EP.BASELINE


def test_queue_matmul_asymmetric_ring_depths_from_table(monkeypatch):
    """The x ring takes the I2F depth and the w ring the F2I depth
    (analogue of test_calibration.py:284)."""
    calls = _record(monkeypatch, OperatingPoint(
        policy=EP.COPIFTV2, queue_depth=4, queue_depth_i2f=2,
        queue_depth_f2i=8, unroll=4, source="calibrated"))
    x = torch.ones((4, 4))
    qm_ops.queue_matmul(x, x)
    assert (calls[-1]["depth_x"], calls[-1]["depth_w"]) == (2, 8)
    assert calls[-1]["unroll"] == 4
    qm_ops.queue_matmul(x, x, depth_x=16)
    assert (calls[-1]["depth_x"], calls[-1]["depth_w"]) == (16, 8)
    qm_ops.queue_matmul(x, x, policy=EP.COPIFT)
    assert calls[-1]["policy"] is EP.COPIFT


def test_queue_matmul_defaults_and_cpu_path_launch_nothing():
    assert qm_ops.operating_point() == OperatingPoint()
    before = queue_matmul.launches
    queue_matmul(torch.ones((3, 5)), torch.ones((5, 2)))
    assert queue_matmul.launches == before
    with pytest.raises(ValueError, match=r"x \(M, K\)"):
        queue_matmul(torch.ones((3, 5)), torch.ones((4, 2)))


# --- flash_attention ----------------------------------------------------------

def _qkv(B, Hq, Hkv, Sq, Sk, D, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in
                 ((B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D)))


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 48)])
def test_flash_attention_matches_pallas_gqa(causal, window):
    """Hq=4 over Hkv=2, ragged S (the Pallas wrapper pads it to 64s)."""
    q, k, v = _qkv(1, 4, 2, 100, 100, 32)
    ref = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, window=window, bq=64, bk=64)
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal, window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL["float32"])


@pytest.mark.parametrize("causal,window", [(True, None), (True, 24),
                                           (False, 24)])
def test_blocked_flash_attention_ref_matches_reference(causal, window):
    """The model-level blocked reference with q_offset > 0 (a query chunk
    at the end of a longer key sequence) and ragged blocks."""
    q, k, v = _qkv(2, 4, 2, 40, 96, 16, seed=1)
    kw = dict(causal=causal, window=window, block_q=32, block_k=16,
              q_offset=56)
    ref = jax_flash_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    out = flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)
    # the op's plain version takes the same q_offset
    op = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), causal=causal, window=window,
                         q_offset=56)
    np.testing.assert_allclose(op.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


def test_attention_ref_keeps_dtype_and_op_checks_shapes():
    q = torch.randn(3, 8, 16, dtype=torch.bfloat16)
    assert attention_ref(q, q, q).dtype == torch.bfloat16
    before = flash_attention.launches
    with pytest.raises(ValueError, match="flash_attention takes"):
        flash_attention(torch.ones(1, 3, 4, 8), torch.ones(1, 2, 4, 8),
                        torch.ones(1, 2, 4, 8))
    assert flash_attention.launches == before
