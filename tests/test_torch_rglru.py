"""The PyTorch port's RG-LRU block against the JAX package's, on bridged
weights and the same seeded numpy inputs, in fp32: the gates (the
``1e-6`` clamp branch included), the full-sequence forward (one
``rglru_scan`` over the sequence against the reference's chunked
associative scan) and the one-token decode step.  Tolerance rtol 1e-4 /
atol 1e-5, the reference's own for its recurrent blocks
(tests/test_models.py:130); the state is compared relative to its size."""
import pytest

torch = pytest.importorskip("torch")

from _calibration_isolation import isolated_calibration  # noqa: F401

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_reduced as jax_reduced
from repro.models.layers import init_params as jax_init_params
from repro.models.rglru import _gates as jax_gates
from repro.models.rglru import rglru_apply as jax_rglru_apply
from repro.models.rglru import rglru_decode as jax_rglru_decode
from repro.models.rglru import rglru_specs as jax_rglru_specs
from repro_torch import bridge
from repro_torch.configs import get_reduced
from repro_torch.models.rglru import (_gates, rglru_apply, rglru_decode,
                                      rglru_specs)

ARCH = "recurrentgemma-2b"
TOL = dict(rtol=1e-4, atol=1e-5)


def _setup(seed=0, lam_shift=0.0):
    """Bridged block weights at the fan-in scale of the unstacked specs,
    with non-trivial biases and a spread of lam (``lam_shift`` moves it:
    very negative lam gives a -> 1, the clamp branch)."""
    cfg_j, cfg_t = jax_reduced(ARCH), get_reduced(ARCH)
    pj = jax_init_params(jax.random.PRNGKey(seed), jax_rglru_specs(cfg_j))
    rng = np.random.default_rng(seed)
    w = pj["lam"].shape[0]
    noise = lambda scale: jnp.asarray(rng.standard_normal(w) * scale,
                                      jnp.float32)
    pj = {**pj, "lam": noise(1.0) + lam_shift, "rg_b": noise(0.5),
          "ig_b": noise(0.5), "conv_b": noise(0.1)}
    pt = bridge.from_numpy_tree(jax.tree_util.tree_map(np.asarray, pj),
                                "cpu")
    return cfg_j, cfg_t, pj, pt, rng


def test_specs_match_reference():
    cfg_j, cfg_t = jax_reduced(ARCH), get_reduced(ARCH)
    specs_j, specs_t = jax_rglru_specs(cfg_j), rglru_specs(cfg_t)
    assert specs_j.keys() == specs_t.keys()
    for k in specs_j:
        a, b = specs_j[k], specs_t[k]
        assert (a.shape, a.axes, a.init, a.scale) == \
            (b.shape, b.axes, b.init, b.scale)


@pytest.mark.parametrize("lam_shift", [0.0, -40.0])
def test_gates_match_reference(lam_shift):
    """lam_shift -40: softplus(lam) ~ 1e-17, a rounds to 1 in fp32 and
    ``1 - exp(2 log_a)`` to 0, so beta is the clamp's sqrt(1e-6)."""
    cfg_j, cfg_t, pj, pt, rng = _setup(1, lam_shift)
    w = cfg_t.rglru.lru_width
    u = rng.standard_normal((2, 9, w)).astype(np.float32)
    aj, bj = jax_gates(pj, jnp.asarray(u))
    at, bt = _gates(pt, torch.from_numpy(u))
    assert at.dtype == bt.dtype == torch.float32
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), **TOL)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), **TOL)
    if lam_shift:
        assert bool((at == 1.0).all())
        beta = bt / (torch.sigmoid(torch.from_numpy(u) @ pt["ig_w"]
                                   + pt["ig_b"]) * torch.from_numpy(u))
        np.testing.assert_allclose(beta.numpy(), 1e-3, rtol=1e-4)


@pytest.mark.parametrize("b,s", [(2, 40), (1, 300)])
def test_rglru_apply_matches_reference(b, s):
    """S = 300 spans two of the reference's 256-step chunks."""
    cfg_j, cfg_t, pj, pt, rng = _setup()
    x = rng.standard_normal((b, s, cfg_j.d_model)).astype(np.float32) * 0.5
    ref = jax_rglru_apply(pj, jnp.asarray(x), cfg_j)
    out = rglru_apply(pt, torch.from_numpy(x), cfg_t)
    assert out.shape == (b, s, cfg_t.d_model)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_rglru_decode_matches_reference_over_steps():
    """Four one-token steps from a non-zero state, carrying h and the conv
    state from step to step on each side."""
    cfg_j, cfg_t, pj, pt, rng = _setup(2)
    w, K = cfg_t.rglru.lru_width, cfg_t.rglru.conv_width
    h = rng.standard_normal((3, w)).astype(np.float32)
    c = rng.standard_normal((3, K - 1, w)).astype(np.float32) * 0.3
    hj, cj = jnp.asarray(h), jnp.asarray(c)
    ht, ct = torch.from_numpy(h), torch.from_numpy(c)
    for _ in range(4):
        x = rng.standard_normal((3, 1, cfg_j.d_model)).astype(np.float32)
        yj, hj, cj = jax_rglru_decode(pj, jnp.asarray(x), cfg_j, hj, cj)
        yt, ht, ct = rglru_decode(pt, torch.from_numpy(x), cfg_t, ht, ct)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
        scale = np.abs(np.asarray(hj)).max()
        np.testing.assert_allclose(ht.numpy() / scale,
                                   np.asarray(hj) / scale, **TOL)
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **TOL)


def test_decode_steps_continue_the_forward():
    """Within the port: a forward over S tokens equals S decode steps from
    a zero state (the scan kernel's path against the recurrent one)."""
    cfg_j, cfg_t, pj, pt, rng = _setup(3)
    w, K = cfg_t.rglru.lru_width, cfg_t.rglru.conv_width
    x = torch.from_numpy(
        rng.standard_normal((2, 12, cfg_t.d_model)).astype(np.float32))
    full = rglru_apply(pt, x, cfg_t)
    h, c = torch.zeros((2, w)), torch.zeros((2, K - 1, w))
    for t in range(12):
        y, h, c = rglru_decode(pt, x[:, t:t + 1], cfg_t, h, c)
        np.testing.assert_allclose(y[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=1e-5, atol=1e-6)
