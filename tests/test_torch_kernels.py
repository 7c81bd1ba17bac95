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

from _calibration_isolation import isolated_calibration  # noqa: F401

import jax.numpy as jnp
import numpy as np
from _hypothesis_compat import given, settings, st

from repro.core.policy import ExecutionPolicy as JEP
from repro.kernels import flash_attention as jax_flash_attention
from repro.kernels import moe_gemm as jax_moe_gemm
from repro.kernels import queue_matmul as jax_queue_matmul
from repro.kernels import rglru_scan as jax_rglru_scan
from repro.kernels import ssm_scan as jax_ssm_scan
from repro.models.attention import flash_attention_ref as jax_flash_ref
from repro_torch.core.policy import ExecutionPolicy as EP
from repro_torch.core.policy import OperatingPoint
from repro_torch.kernels import (flash_attention, moe_gemm, queue_matmul,
                                 rglru_scan, ssm_scan)
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.moe_gemm import ops as mg_ops
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


# --- moe_gemm ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,c,d,f,depth", [(3, 5, 33, 17, 1),
                                           (2, 70, 130, 65, 2),
                                           (4, 4, 64, 96, 3)])
def test_moe_gemm_matches_pallas_on_ragged_shapes(e, c, d, f, depth, dtype):
    jx, jw, tx, tw = _pair((e, c, d), (e, d, f), dtype, seed=3)
    ref = jax_moe_gemm(jx, jw, bc=64, bf=64, bk=64, depth=depth)
    out = moe_gemm(tx, tw, bc=64, bf=64, bk=64, depth=depth)
    assert out.dtype == torch.float32 and out.shape == (e, c, f)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL[dtype])


def test_moe_gemm_takes_a_broadcast_x():
    """The dense dispatch's x: one (C, d) matrix seen by every expert
    (expert stride 0) gives what the copied (E, C, d) tensor gives."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((6, 40)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((5, 40, 24)).astype(np.float32))
    xe = x.expand(5, 6, 40)
    assert xe.stride(0) == 0
    ref = jax_moe_gemm(jnp.asarray(xe.numpy()), jnp.asarray(w.numpy()),
                       bc=64, bf=64, bk=64)
    out = moe_gemm(xe, w)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL["float32"])
    assert torch.equal(out, moe_gemm(xe.contiguous(), w))


@pytest.mark.parametrize("policy", list(EP))
def test_moe_gemm_policies_and_cpu_path_launch_nothing(policy):
    x = torch.ones((2, 3, 8))
    w = torch.ones((2, 8, 5))
    before = moe_gemm.launches
    out = moe_gemm(x, w, depth=4, policy=policy)
    assert moe_gemm.launches == before
    assert torch.equal(out, torch.full((2, 3, 5), 8.0))
    with pytest.raises(ValueError, match=r"x \(E, C, d\)"):
        moe_gemm(x, torch.ones((3, 8, 5)), policy=policy)


def test_moe_gemm_point_comes_from_the_table():
    assert mg_ops.operating_point() == OperatingPoint()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,c,d,f,bcast", [(6, 4, 40, 24, True),
                                           (5, 70, 130, 65, False),
                                           (8, 17, 64, 96, True)])
def test_moe_gemm_mask_against_pallas(e, c, d, f, bcast, dtype):
    """The expert mask: active experts match the Pallas kernel, inactive
    ones are exact zeros, and no mask or an all-ones one (bool or int8)
    gives the unmasked result."""
    jx, jw, tx, tw = _pair((e, c, d), (e, d, f), dtype, seed=5)
    if bcast:
        tx = tx[:1].expand(e, c, d)
        jx = jnp.asarray(tx.float().numpy(), dtype)
    ref = np.asarray(jax_moe_gemm(jx, jw, bc=64, bf=64, bk=64), np.float32)
    on = np.zeros(e, bool)
    on[[0, 2, e - 1]] = True
    for mask in (torch.from_numpy(on), torch.from_numpy(on).to(torch.int8)):
        out = moe_gemm(tx, tw, active=mask)
        assert out.dtype == torch.float32 and out.shape == (e, c, f)
        np.testing.assert_allclose(out.numpy()[on], ref[on], **TOL[dtype])
        assert (out.numpy()[~on] == 0).all()
    full = moe_gemm(tx, tw)
    np.testing.assert_allclose(full.numpy(), ref, **TOL[dtype])
    for ones in (torch.ones(e, dtype=torch.bool),
                 torch.ones(e, dtype=torch.int8)):
        assert torch.equal(moe_gemm(tx, tw, active=ones), full)


def test_moe_gemm_refuses_a_malformed_mask():
    x, w = torch.ones((3, 4, 8)), torch.ones((3, 8, 5))
    for bad in (torch.ones(4, dtype=torch.bool), torch.ones((3, 1)),
                torch.ones(3)):
        with pytest.raises(ValueError, match="active must be"):
            moe_gemm(x, w, active=bad)


@pytest.mark.parametrize("c,dtype,kind", [(1, torch.bfloat16, "thin"),
                                          (16, torch.bfloat16, "thin"),
                                          (17, torch.bfloat16, "wide"),
                                          (512, torch.bfloat16, "wide"),
                                          (4, torch.float32, "fp32"),
                                          (512, torch.float32, "fp32")])
def test_moe_gemm_regime_follows_c_and_dtype(c, dtype, kind):
    assert mg_ops.regime(c, dtype) == kind


@pytest.mark.parametrize("c,dtype,fits,first_refused", [
    (4, torch.bfloat16, 11, 12), (40, torch.bfloat16, 9, 10),
    (4, torch.float32, 16, None), (40, torch.float32, 14, 15)])
def test_moe_gemm_depths_that_fit(c, dtype, fits, first_refused):
    """The largest depth whose rings fit 227 KB in each kernel: the wide
    kernel's stages fall from 64 to 32 deep past depth 4, so it fits to
    9; the plan refuses the first depth past it, naming the bytes."""
    assert mg_ops.smem_bytes(c, fits, dtype) <= mg_ops.MAX_SMEM
    if first_refused is None:
        return
    assert mg_ops.smem_bytes(c, first_refused, dtype) > mg_ops.MAX_SMEM
    with pytest.raises(ValueError, match="bytes of shared memory"):
        mg_ops._plan(c <= mg_ops.THIN_MAX_C, 64, 2048, 1024, first_refused,
                     dtype)


def test_moe_gemm_split_is_a_function_of_the_shapes():
    """olmoe's 64 experts already give 1024 column tiles: no split.  Few
    experts over a deep K split it, up to a cluster of 8."""
    assert mg_ops.split_k(64, 2048, 1024) == 1
    assert mg_ops.split_k(64, 1024, 2048) == 1
    assert mg_ops.split_k(2, 2048, 128) == 4
    assert mg_ops.split_k(1, 16384, 64) == 8
    assert mg_ops._plan(True, 2, 2048, 128, 4, torch.bfloat16) == 4
    assert mg_ops._plan(False, 2, 2048, 128, 4, torch.bfloat16) == 1


# --- ssm_scan ---------------------------------------------------------------

def _scan_inputs(b, t, d, n, seed=0):
    """The distribution of tests/test_kernels.py's ssm_scan sweep."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, d)).astype(np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((b, t, d)))).astype(
        np.float32) * 0.1
    A = -np.abs(rng.standard_normal((d, n))).astype(np.float32)
    Bm = rng.standard_normal((b, t, n)).astype(np.float32)
    C = rng.standard_normal((b, t, n)).astype(np.float32)
    return x, dt, A, Bm, C


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,d,n", [(2, 37, 20, 4), (1, 150, 70, 16),
                                     (2, 9, 3, 8)])
def test_ssm_scan_matches_pallas_on_ragged_shapes(b, t, d, n, dtype):
    """Ragged T and d (the Pallas wrapper pads them to its 64 tiles); x,
    dt, B and C in ``dtype``, A in fp32, y in fp32."""
    x, dt, A, Bm, C = _scan_inputs(b, t, d, n)
    jd = getattr(jnp, dtype)
    ref = jax_ssm_scan(jnp.asarray(x, jd), jnp.asarray(dt, jd),
                       jnp.asarray(A), jnp.asarray(Bm, jd),
                       jnp.asarray(C, jd), bt=64, bd=64)
    td = getattr(torch, dtype)
    out = ssm_scan(*(torch.from_numpy(a).to(td) for a in (x, dt)),
                   torch.from_numpy(A),
                   *(torch.from_numpy(a).to(td) for a in (Bm, C)))
    assert out.dtype == torch.float32 and out.shape == (b, t, d)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL[dtype])


def test_ssm_scan_state_carries_across_time_blocks():
    """Analogue of tests/test_kernels.py:101: T over several Pallas time
    blocks."""
    t, d, n = 200, 8, 4
    args = (np.ones((1, t, d), np.float32) * 0.1,
            np.ones((1, t, d), np.float32) * 0.05, -np.ones((d, n), np.float32),
            np.ones((1, t, n), np.float32), np.ones((1, t, n), np.float32))
    ref = jax_ssm_scan(*(jnp.asarray(a) for a in args), bt=32, bd=8)
    out = ssm_scan(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_ssm_scan_checks_shapes_and_cpu_path_launches_nothing():
    x, dt, A, Bm, C = (torch.from_numpy(a) for a in _scan_inputs(1, 4, 6, 4))
    before = ssm_scan.launches
    ssm_scan(x, dt, A, Bm, C)
    assert ssm_scan.launches == before
    with pytest.raises(ValueError, match="ssm_scan takes"):
        ssm_scan(x, dt, A[:, :3], Bm, C)


# --- rglru_scan -------------------------------------------------------------

def _rglru_inputs(b, t, w, seed=0):
    """a in (0, 1) as the RG-LRU's gates make it, bx standard normal."""
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((b, t, w)) - 1.0))
    bx = rng.standard_normal((b, t, w))
    return a.astype(np.float32), bx.astype(np.float32)


@given(b=st.integers(1, 2), t=st.integers(1, 300), w=st.integers(1, 200),
       dtype=st.sampled_from(["float32", "bfloat16"]))
@settings(max_examples=12, deadline=None)
def test_rglru_scan_matches_pallas_over_shapes(b, t, w, dtype):
    """T and w not multiples of the Pallas wrapper's 128-wide tiles, which
    it pads; a and bx in ``dtype``, h in fp32 (tests/test_kernels.py:120's
    2e-4 for fp32)."""
    a, bx = _rglru_inputs(b, t, w, seed=t * 1000 + w)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jax_rglru_scan(jnp.asarray(a, jd), jnp.asarray(bx, jd))
    out = rglru_scan(torch.from_numpy(a).to(td), torch.from_numpy(bx).to(td))
    assert out.dtype == torch.float32 and out.shape == (b, t, w)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-4)


def test_rglru_scan_state_carries_across_time_blocks():
    """T over several of the Pallas kernel's time blocks (bt = 32)."""
    a, bx = _rglru_inputs(1, 200, 8, seed=3)
    ref = jax_rglru_scan(jnp.asarray(a), jnp.asarray(bx), bt=32, bw=8)
    out = rglru_scan(torch.from_numpy(a), torch.from_numpy(bx))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-4)


def test_rglru_scan_checks_shapes_and_cpu_path_launches_nothing():
    a, bx = (torch.from_numpy(x) for x in _rglru_inputs(1, 5, 6))
    before = rglru_scan.launches
    rglru_scan(a, bx)
    assert rglru_scan.launches == before
    with pytest.raises(ValueError, match="rglru_scan takes"):
        rglru_scan(a, bx[:, :4])
    with pytest.raises(ValueError, match="rglru_scan takes"):
        rglru_scan(a[0], bx[0])
