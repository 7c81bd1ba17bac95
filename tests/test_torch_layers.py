"""The PyTorch port's shared layers against the JAX package's: rms_norm,
RoPE with per-slot positions, and the three FFN activations.  Inputs come
from a seeded numpy generator; everything is fp32, and the tolerance is
1e-5 (the same fp32 arithmetic in another summation order)."""
import pytest

torch = pytest.importorskip("torch")

from _calibration_isolation import isolated_calibration  # noqa: F401

import jax.numpy as jnp
import numpy as np

from repro.models import layers as jl
from repro_torch.models import layers as tl

TOL = dict(rtol=1e-5, atol=1e-5)


def _rng():
    return np.random.default_rng(7)


def test_rms_norm_matches_reference():
    rng = _rng()
    x = rng.standard_normal((3, 5, 32)).astype(np.float32)
    g = (rng.standard_normal(32) * 0.1).astype(np.float32)
    ref = np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(g), 1e-5))
    out = tl.rms_norm(torch.from_numpy(x), torch.from_numpy(g), 1e-5)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_rope_per_slot_positions_match_reference():
    """Decode applies RoPE at each slot's own position: (B,) positions,
    angles broadcast over heads."""
    rng = _rng()
    pos = np.array([0, 7, 130], np.int32)
    x = rng.standard_normal((3, 4, 1, 16)).astype(np.float32)
    cj, sj = jl.rope_angles(jnp.asarray(pos), 16, 10_000.0)
    ct, st = tl.rope_angles(torch.from_numpy(pos), 16, 10_000.0)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), **TOL)
    ref = jl.apply_rope(jnp.asarray(x), cj[:, None, None], sj[:, None, None])
    out = tl.apply_rope(torch.from_numpy(x), ct[:, None, None],
                        st[:, None, None])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("act", ["swiglu", "relu2", "gelu"])
def test_ffn_apply_matches_reference(act):
    rng = _rng()
    d, f = 24, 40
    specs = jl.ffn_specs(d, f, act)
    p = {k: (rng.standard_normal(s.shape) / np.sqrt(s.shape[0])).astype(
        np.float32) for k, s in specs.items()}
    x = rng.standard_normal((2, 3, d)).astype(np.float32)
    ref = jl.ffn_apply({k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x), act)
    out = tl.ffn_apply({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x), act)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert tl.ffn_specs(d, f, act).keys() == specs.keys()
