"""MLA's absorbed attention over a chunk's columns (``latent_attention``):
its plain version against the JAX package's, and its row bits, on the CPU.

* ``latent_attention_ref`` against the absorbed attention of the JAX
  ``mla_decode`` (src/repro/models/attention.py:329-336, its einsums and
  softmax in jnp) on numpy inputs, within 2e-4 in fp32: each column's own
  row written into the cache at ``rows`` and attended with every row below
  it, at rows 0 (the self row alone), inside the cache and at T - 1 (the
  clamped write's row).
* A column's bits do not depend on the columns or slots run with it: a
  chunk of 8 columns equals each column alone (the decode step's call) and
  each slot alone, in fp32 and bf16, so a batched chunk keeps token
  decode's bits.
* The wrapper takes the plain version on a CPU tensor and launches
  nothing; it refuses operands whose shapes do not agree."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _calibration_isolation import isolated_calibration  # noqa: F401

import jax
import jax.numpy as jnp

from repro.models.attention import NEG_INF as JAX_NEG_INF
from repro_torch.kernels import latent_attention
from repro_torch.kernels.latent_attention.ref import latent_attention_ref

#: reduced minicpm3's widths (latent 16, rope 4, 4 heads, q/k 8 + 4) and
#: the full model's (latent 256, rope 32, 40 heads, q/k 64 + 32)
WIDTHS = {"reduced": (4, 16, 4, 8), "full": (40, 256, 32, 64)}


def _inputs(rng, C, B, H, T, r, dr):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(C, B, H, r) * 0.3, f(C, B, H, dr), f(B, T, r), f(B, T, dr),
            f(C, B, r), f(C, B, dr))


def _jax_absorbed(q_eff, q_rope, lat, rope, rows, self_lat, self_rope,
                  qk: int):
    """The JAX ``mla_decode``'s absorbed attention for each column c: its
    new row written at ``rows[c]`` (as the reference's cache write puts it
    at ``min(length, T - 1)``), every position up to it attended."""
    outs = []
    for c in range(q_eff.shape[0]):
        lat_c, rope_c = lat.copy(), rope.copy()
        for b in range(lat.shape[0]):
            lat_c[b, rows[c, b]] = self_lat[c, b]
            rope_c[b, rows[c, b]] = self_rope[c, b]
        length = jnp.asarray(rows[c])
        s = (jnp.einsum("bhr,btr->bht", jnp.asarray(q_eff[c]),
                        jnp.asarray(lat_c))
             + jnp.einsum("bhk,btk->bht", jnp.asarray(q_rope[c]),
                          jnp.asarray(rope_c)))
        s = s / math.sqrt(qk)
        mask = jnp.arange(lat.shape[1])[None] <= length[:, None]
        s = jnp.where(mask[:, None], s, JAX_NEG_INF)
        p = jax.nn.softmax(s, axis=-1)
        outs.append(np.asarray(jnp.einsum("bht,btr->bhr", p,
                                          jnp.asarray(lat_c))))
    return np.stack(outs)


@pytest.mark.parametrize("width", list(WIDTHS))
def test_the_plain_version_matches_the_jax_absorbed_attention(width):
    H, r, dr, nope = WIDTHS[width]
    C, B, T = 3, 4, 12
    rng = np.random.default_rng(0)
    ins = _inputs(rng, C, B, H, T, r, dr)
    # per column and slot: 0 (its own row alone), inside, T - 1 (clamped)
    rows = np.array([[0, 5, T - 1, 3], [1, 6, T - 1, 11], [2, 7, T - 1, 0]],
                    np.int32)
    got = latent_attention_ref(*map(torch.from_numpy, ins[:4]),
                               torch.from_numpy(rows),
                               *map(torch.from_numpy, ins[4:]),
                               1.0 / math.sqrt(nope + dr))
    want = _jax_absorbed(*ins[:4], rows, *ins[4:], nope + dr)
    assert got.shape == (C, B, H, r) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    # rows 0: the self row alone, its latent exactly
    assert torch.equal(got[0, 0], torch.from_numpy(ins[4][0, 0]).expand(H, r))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", list(WIDTHS))
def test_a_columns_bits_ignore_the_columns_and_slots_beside_it(width, dtype):
    """A chunk of 8 columns over 4 slots against each column alone (C = 1,
    the decode step's call) and each slot alone (B = 1), bit for bit."""
    H, r, dr, nope = WIDTHS[width]
    C, B, T = 8, 4, 40
    rng = np.random.default_rng(1)
    ins = [torch.from_numpy(a).to(dtype)
           for a in _inputs(rng, C, B, H, T, r, dr)]
    rows = torch.from_numpy(np.array([5, 0, 30, T - 8])[None]
                            + np.arange(C)[:, None]).clamp(max=T - 1)
    q, qr, lat, rope, own, own_r = ins
    scale = 1.0 / math.sqrt(nope + dr)
    full = latent_attention_ref(q, qr, lat, rope, rows, own, own_r, scale)
    assert full.dtype == dtype
    for c in range(C):
        one = latent_attention_ref(q[c:c + 1], qr[c:c + 1], lat, rope,
                                   rows[c:c + 1], own[c:c + 1],
                                   own_r[c:c + 1], scale)
        assert torch.equal(one, full[c:c + 1]), c
    for b in range(B):
        one = latent_attention_ref(q[:, b:b + 1], qr[:, b:b + 1],
                                   lat[b:b + 1], rope[b:b + 1],
                                   rows[:, b:b + 1], own[:, b:b + 1],
                                   own_r[:, b:b + 1], scale)
        assert torch.equal(one, full[:, b:b + 1]), b


def test_the_wrapper_is_the_plain_version_on_the_cpu():
    H, r, dr, nope = WIDTHS["reduced"]
    C, B, T = 2, 3, 10
    rng = np.random.default_rng(2)
    q, qr, lat, rope, own, own_r = map(torch.from_numpy,
                                       _inputs(rng, C, B, H, T, r, dr))
    rows = torch.tensor([[0, 4, 9], [1, 5, 9]], dtype=torch.int32)
    before = latent_attention.launches
    out = latent_attention(q, qr, lat, rope, rows, own, own_r, 0.25)
    assert latent_attention.launches == before
    assert torch.equal(out, latent_attention_ref(q, qr, lat, rope, rows, own,
                                                 own_r, 0.25))
    with pytest.raises(ValueError, match="do not agree"):
        latent_attention(q, qr, lat, rope, rows[:, :2], own, own_r, 0.25)
    with pytest.raises(ValueError, match="do not agree"):
        latent_attention(q, qr[..., :2], lat, rope, rows, own, own_r, 0.25)
    with pytest.raises(ValueError, match="latent_attention takes"):
        latent_attention(q[0], qr, lat, rope, rows, own, own_r, 0.25)
