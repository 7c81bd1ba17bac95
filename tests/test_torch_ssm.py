"""The PyTorch port's Mamba-1 block against the JAX package's, on bridged
weights and the same seeded numpy inputs, in fp32: the full-sequence
forward (one ``ssm_scan`` over the sequence against the reference's
chunked associative scan), the causal conv with and without a carried
state, and the one-token decode step.  Tolerance rtol 1e-4 / atol 1e-5,
the reference's own for this block (tests/test_models.py:130); the state
is compared relative to its size (random weights make it large)."""
import pytest

torch = pytest.importorskip("torch")

from _calibration_isolation import isolated_calibration  # noqa: F401

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_reduced as jax_reduced
from repro.models.layers import init_params as jax_init_params
from repro.models.ssm import _conv1d as jax_conv1d
from repro.models.ssm import mamba_apply as jax_mamba_apply
from repro.models.ssm import mamba_decode as jax_mamba_decode
from repro.models.ssm import mamba_specs as jax_mamba_specs
from repro_torch import bridge
from repro_torch.configs import get_reduced
from repro_torch.models.layers import causal_conv1d
from repro_torch.models.ssm import mamba_apply, mamba_decode, ssm_dims

ARCH = "falcon-mamba-7b"
TOL = dict(rtol=1e-4, atol=1e-5)


def _setup(seed=0):
    cfg_j, cfg_t = jax_reduced(ARCH), get_reduced(ARCH)
    pj = jax_init_params(jax.random.PRNGKey(seed), jax_mamba_specs(cfg_j))
    # non-trivial A, dt bias and conv bias (the initializers give 1 and 0)
    rng = np.random.default_rng(seed)
    pj = {**pj,
          "A_log": pj["A_log"] * 0.5 + jnp.asarray(
              rng.standard_normal(pj["A_log"].shape), jnp.float32) * 0.3,
          "dt_bias": jnp.asarray(rng.standard_normal(pj["dt_bias"].shape),
                                 jnp.float32) * 0.5 - 1.0,
          "conv_b": jnp.asarray(rng.standard_normal(pj["conv_b"].shape),
                                jnp.float32) * 0.1}
    pt = bridge.from_numpy_tree(jax.tree_util.tree_map(np.asarray, pj),
                                "cpu")
    return cfg_j, cfg_t, pj, pt, rng


@pytest.mark.parametrize("b,s", [(2, 40), (1, 300)])
def test_mamba_apply_matches_reference(b, s):
    """S = 300 spans two of the reference's 256-step chunks."""
    cfg_j, cfg_t, pj, pt, rng = _setup()
    x = rng.standard_normal((b, s, cfg_j.d_model)).astype(np.float32) * 0.3
    ref = jax_mamba_apply(pj, jnp.asarray(x), cfg_j)
    out = mamba_apply(pt, torch.from_numpy(x), cfg_t)
    assert out.shape == (b, s, cfg_t.d_model)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_conv1d_matches_reference_with_and_without_state():
    cfg_j, cfg_t, pj, pt, rng = _setup(1)
    d_in = ssm_dims(cfg_t)[0]
    K = cfg_t.ssm.d_conv
    x = rng.standard_normal((3, 7, d_in)).astype(np.float32)
    st = rng.standard_normal((3, K - 1, d_in)).astype(np.float32)
    for state in (None, st):
        oj, sj = jax_conv1d(pj, jnp.asarray(x),
                            None if state is None else jnp.asarray(state))
        ot, s_t = causal_conv1d(
            pt, torch.from_numpy(x),
            None if state is None else torch.from_numpy(state))
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(s_t.numpy(), np.asarray(sj))


def test_mamba_decode_matches_reference_over_steps():
    """Four one-token steps from a non-zero state, carrying the SSM and
    conv states from step to step on each side."""
    cfg_j, cfg_t, pj, pt, rng = _setup(2)
    d_in, _, n = ssm_dims(cfg_t)
    K = cfg_t.ssm.d_conv
    h = rng.standard_normal((3, d_in, n)).astype(np.float32)
    c = rng.standard_normal((3, K - 1, d_in)).astype(np.float32) * 0.3
    hj, cj = jnp.asarray(h), jnp.asarray(c)
    ht, ct = torch.from_numpy(h), torch.from_numpy(c)
    for _ in range(4):
        x = rng.standard_normal((3, 1, cfg_j.d_model)).astype(np.float32)
        yj, hj, cj = jax_mamba_decode(pj, jnp.asarray(x), cfg_j, hj, cj)
        yt, ht, ct = mamba_decode(pt, torch.from_numpy(x), cfg_t, ht, ct)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
        scale = np.abs(np.asarray(hj)).max()
        np.testing.assert_allclose(ht.numpy() / scale,
                                   np.asarray(hj) / scale, **TOL)
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **TOL)


def test_decode_steps_continue_the_forward():
    """Within the port: a forward over S tokens equals S decode steps from
    a zero state (the scan kernel's path against the recurrent one)."""
    cfg_j, cfg_t, pj, pt, rng = _setup(3)
    d_in, _, n = ssm_dims(cfg_t)
    x = torch.from_numpy(
        rng.standard_normal((2, 12, cfg_t.d_model)).astype(np.float32))
    full = mamba_apply(pt, x, cfg_t)
    h = torch.zeros((2, d_in, n))
    c = torch.zeros((2, cfg_t.ssm.d_conv - 1, d_in))
    for t in range(12):
        y, h, c = mamba_decode(pt, x[:, t:t + 1], cfg_t, h, c)
        np.testing.assert_allclose(y[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=1e-4, atol=1e-4)
