"""The PyTorch port's MLA (minicpm3's Multi-head Latent Attention) against
the JAX package's, on reduced minicpm3 (4 heads, q/k head dim 8 + 4, v head
dim 8, latent 16) with bridged weights and numpy-seeded inputs, in fp32:
the expanded form (``mla_apply``, through ``flash_attention`` with a v head
dim below q's) and the absorbed decode (``mla_decode``) at per-slot lengths,
among them lengths at and past the cache's end, where the reference's
``dynamic_update_slice`` clamps the write to the last row.  Tolerance 2e-3,
the reference's own for logits (tests/test_models.py:90); the plain
attention with Dv < D is held to the same fp32 2e-5 as the other
attention references (tests/test_torch_kernels.py)."""
import pytest

torch = pytest.importorskip("torch")

from _calibration_isolation import isolated_calibration  # noqa: F401

import jax
import jax.numpy as jnp
import numpy as np

from repro.config import RunConfig as JRC
from repro.configs import get_reduced as jax_reduced
from repro.models import decode_step as jax_decode
from repro.models import init_cache as jax_init_cache
from repro.models import init_model_params as jax_init_params
from repro.models import attention as jattn
from repro_torch import bridge
from repro_torch.config import RunConfig
from repro_torch.configs import get_reduced
from repro_torch.kernels import flash_attention
from repro_torch.models import attention as tattn
from repro_torch.models import decode_step, init_cache

ARCH = "minicpm3-4b"
TOL = dict(rtol=2e-3, atol=2e-3)
JRC_ = JRC(dtype="float32", remat=False)
RC = RunConfig(dtype="float32", remat=False)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _layer0():
    """Layer 0's attention weights of reduced minicpm3, in JAX and
    bridged."""
    cfg = jax_reduced(ARCH)
    p = jax_init_params(jax.random.PRNGKey(5), cfg)["blocks"]["attn"]
    p = {k: v[0] for k, v in p.items()}
    return cfg, p, bridge.from_numpy_tree(_np(p), "cpu")


@pytest.mark.parametrize("q_offset", [0, 5])
def test_mla_apply_matches_reference(q_offset):
    cfg, pj, pt = _layer0()
    x = np.random.default_rng(0).standard_normal(
        (2, 13, cfg.d_model)).astype(np.float32)
    ref = jattn.mla_apply(pj, jnp.asarray(x), cfg, q_offset=q_offset)
    out = tattn.mla_apply(pt, torch.from_numpy(x), get_reduced(ARCH),
                          q_offset=q_offset)
    assert out.shape == (2, 13, cfg.d_model)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def _caches(cfg, B, T, rng):
    m = cfg.mla
    return (rng.standard_normal((B, T, m.kv_lora_rank)).astype(np.float32),
            rng.standard_normal((B, T, m.qk_rope_head_dim)).astype(
                np.float32))


@pytest.mark.parametrize("lengths", [[0, 3, 7, 5], [2, 8, 11, 7]])
def test_mla_decode_matches_reference_with_the_clamped_write(lengths):
    """Per-slot lengths into caches of 8 rows: 7 writes the last row, 8 and
    11 pass the end, where JAX clamps the write to row 7 and attends every
    row."""
    cfg, pj, pt = _layer0()
    rng = np.random.default_rng(1)
    lat, rope = _caches(cfg, 4, 8, rng)
    x = rng.standard_normal((4, 1, cfg.d_model)).astype(np.float32)
    n = np.asarray(lengths, np.int32)
    out_j, lat_j, rope_j = jattn.mla_decode(pj, jnp.asarray(x), cfg,
                                            jnp.asarray(lat),
                                            jnp.asarray(rope), jnp.asarray(n))
    lat_t, rope_t = torch.from_numpy(lat.copy()), torch.from_numpy(rope.copy())
    out_t, lat_o, rope_o = tattn.mla_decode(pt, torch.from_numpy(x),
                                            get_reduced(ARCH), lat_t, rope_t,
                                            torch.from_numpy(n))
    assert lat_o is lat_t and rope_o is rope_t        # written in place
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(lat_t.numpy(), np.asarray(lat_j), **TOL)
    np.testing.assert_allclose(rope_t.numpy(), np.asarray(rope_j), **TOL)
    # only the row at min(length, 7) of each slot changed
    changed = np.nonzero((lat_t.numpy() != lat).any(-1))
    assert list(changed[0]) == [0, 1, 2, 3]
    assert list(changed[1]) == [min(v, 7) for v in lengths]


def test_mla_decode_writes_the_given_rows_only():
    """``active`` (the chunked prefill's mask of slots): the other slots'
    cache rows keep their bits, the given slots' rows equal a write of
    every slot."""
    cfg, _, pt = _layer0()
    rng = np.random.default_rng(2)
    lat, rope = _caches(cfg, 3, 8, rng)
    x = torch.from_numpy(rng.standard_normal((3, 1, cfg.d_model)).astype(
        np.float32))
    n = torch.tensor([1, 4, 9], dtype=torch.int32)
    full = [torch.from_numpy(lat.copy()), torch.from_numpy(rope.copy())]
    some = [torch.from_numpy(lat.copy()), torch.from_numpy(rope.copy())]
    tattn.mla_decode(pt, x, get_reduced(ARCH), *full, n)
    tattn.mla_decode(pt, x, get_reduced(ARCH), *some, n,
                     active=torch.tensor([True, False, True]))
    for a, b, orig in zip(full, some, (lat, rope)):
        assert torch.equal(a[[0, 2]], b[[0, 2]])
        assert np.array_equal(b[1].numpy(), orig[1])


def test_decode_step_matches_reference_past_max_len():
    """The whole model decoding 6 tokens into caches of 8 rows from slot
    lengths 5 and 2: slot 0 passes the end after three steps, and every
    later write lands on the last row, as JAX's clamped write puts it."""
    cfg_j, cfg_t = jax_reduced(ARCH), get_reduced(ARCH)
    pj = jax_init_params(jax.random.PRNGKey(11), cfg_j)
    pt = bridge.from_numpy_tree(_np(pj), "cpu")
    rng = np.random.default_rng(3)
    cache_j = jax_init_cache(cfg_j, 2, 8, jnp.float32)
    lat, rope = (rng.standard_normal(v.shape).astype(np.float32)
                 for v in (cache_j["latent"], cache_j["rope"]))
    cache_j = {"latent": jnp.asarray(lat), "rope": jnp.asarray(rope),
               "len": jnp.asarray([5, 2], jnp.int32)}
    cache_t = bridge.from_numpy_tree(_np(cache_j), "cpu")
    assert cache_t["latent"].shape == tuple(
        init_cache(cfg_t, 2, 8, torch.float32, device="cpu")["latent"].shape)
    for _ in range(6):
        tok = rng.integers(0, cfg_j.vocab, (2, 1))
        lj, cache_j = jax_decode(pj, cache_j,
                                 {"tokens": jnp.asarray(tok, jnp.int32)},
                                 cfg_j, JRC_)
        lt, cache_t = decode_step(pt, cache_t,
                                  {"tokens": torch.from_numpy(tok)}, cfg_t,
                                  RC)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    assert cache_t["len"].tolist() == [11, 8]
    for k in ("latent", "rope"):
        np.testing.assert_allclose(cache_t[k].numpy(),
                                   np.asarray(cache_j[k]), **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_with_a_narrower_v_matches_reference(causal):
    """q/k head dim 12, v head dim 8 (reduced MLA's), GQA 4 over 2, a query
    chunk at an offset: the op's plain version and the model-level blocked
    reference against the JAX package's ``flash_attention_ref``, which
    takes Dv != D."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 4, 20, 12)).astype(np.float32)
    k = rng.standard_normal((2, 2, 36, 12)).astype(np.float32)
    v = rng.standard_normal((2, 2, 36, 8)).astype(np.float32)
    kw = dict(causal=causal, q_offset=16)
    ref = np.asarray(jattn.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=8,
        block_k=16, **kw))
    assert ref.shape == (2, 4, 20, 8)
    op = flash_attention(*(torch.from_numpy(t) for t in (q, k, v)), **kw)
    blocked = tattn.flash_attention_ref(
        *(torch.from_numpy(t) for t in (q, k, v)), block_q=8, block_k=16,
        **kw)
    for out in (op, blocked):
        assert out.shape == (2, 4, 20, 8)
        np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)


def test_flash_attention_refuses_a_wider_v():
    q = torch.ones(1, 2, 4, 8)
    before = flash_attention.launches
    with pytest.raises(ValueError, match="Dv <= D"):
        flash_attention(q, q, torch.ones(1, 2, 4, 16))
    with pytest.raises(ValueError, match="flash_attention takes"):
        flash_attention(q, q, torch.ones(1, 2, 5, 8))
    assert flash_attention.launches == before
