"""The PyTorch port's model against the JAX package's, on bridged weights
in fp32, for the dense family (phi3-mini-smoke, glm4-smoke with GQA 8 over
2), the MoE family (olmoe-smoke, granite-moe-smoke with GQA 4 over 2), the
SSM family (falcon-mamba-smoke), the hybrid family
(recurrentgemma-smoke: one (rec, rec, attn) macro block and a (rec, rec)
tail, local window 16), MLA (minicpm3-smoke: q/k head dim 12, v 8), the
squared-ReLU FFN (nemotron-smoke), the vision frontend (pixtral-smoke,
whose ``forward`` takes 8 patch rows and whose decode takes tokens) and
the audio encoder (hubert-smoke, ``forward`` on frames only):
``forward``, ``decode_step`` over several steps at
mixed per-slot lengths (and, for the hybrid, past its window, where the
K/V ring wraps), and ``prefill_step`` on a mixed-phase batch.  Tolerance 2e-3, the reference's own for logits
(tests/test_models.py:90); cache leaves (K/V, or the SSM and conv states)
are held to the same bound.  Within the port, chunked prefill is bit-exact
with token-by-token prefill."""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.config import RunConfig as JRC
from repro.configs import get_reduced as jax_reduced
from repro.models import decode_step as jax_decode
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_model_params as jax_init_params
from repro.models import prefill_step as jax_prefill
from repro_torch import bridge
from repro_torch.config import RunConfig
from repro_torch.configs import get_reduced
from repro_torch.models import (decode_step, forward, init_cache,
                                init_model_params, prefill_step,
                                prepare_params)

#: the decoders; pixtral's decode embeds tokens only, as the reference's
ARCHS = ["phi3-mini-3.8b", "glm4-9b", "olmoe-1b-7b", "granite-moe-3b-a800m",
         "falcon-mamba-7b", "recurrentgemma-2b", "minicpm3-4b",
         "nemotron-4-340b", "pixtral-12b"]
#: ``forward`` also runs the encoder over its frames
FORWARD_ARCHS = ARCHS + ["hubert-xlarge"]
#: the decoders without a frontend, whose decode reproduces ``forward``
TOKEN_ARCHS = [a for a in ARCHS if not jax_reduced(a).frontend]
HYBRID = "recurrentgemma-2b"
MOE_ARCHS = ["olmoe-1b-7b", "granite-moe-3b-a800m"]
JRC_ = JRC(dtype="float32", remat=False)
RC = RunConfig(dtype="float32", remat=False)
TOL = dict(rtol=2e-3, atol=2e-3)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _setup(arch):
    cfg_j, cfg_t = jax_reduced(arch), get_reduced(arch)
    params = jax_init_params(jax.random.PRNGKey(11), cfg_j)
    return cfg_j, cfg_t, params, bridge.from_numpy_tree(_np(params), "cpu")


def _assert_cache_close(cache_j, cache_t):
    for k, v in _np(cache_j).items():
        if v.dtype.kind == "i":
            np.testing.assert_array_equal(cache_t[k].numpy(), v)
        else:
            np.testing.assert_allclose(cache_t[k].numpy(), v, **TOL)


def _inputs(cfg, toks):
    """numpy inputs of ``forward``: the tokens, with the vision frontend's
    patches, or the audio frontend's frames in their place (0.1 of a
    seeded normal draw, as tests/test_models.py's ``_batch``)."""
    rng = np.random.default_rng(1)
    B, S = toks.shape
    if cfg.frontend == "audio":
        return {"frames": (rng.standard_normal((B, S, cfg.d_model))
                           * 0.1).astype(np.float32)}
    out = {"tokens": toks}
    if cfg.frontend == "vision":
        out["patches"] = (rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model)) * 0.1).astype(np.float32)
    return out


@pytest.mark.parametrize("arch", FORWARD_ARCHS)
def test_forward_matches_reference(arch):
    cfg_j, cfg_t, pj, pt = _setup(arch)
    toks = np.random.default_rng(0).integers(0, cfg_j.vocab, (2, 24))
    inputs = _inputs(cfg_t, toks)
    ref = jax_forward(pj, {k: jnp.asarray(v, jnp.int32 if k == "tokens"
                                          else None)
                           for k, v in inputs.items()}, cfg_j, JRC_)
    out = forward(pt, {k: torch.from_numpy(v) for k, v in inputs.items()},
                  cfg_t, RC)
    assert out.shape == (2, 24, cfg_t.vocab) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    # prepared weights (cast once, head held transposed) give the same
    again = forward(prepare_params(pt, cfg_t, RC),
                    {k: torch.from_numpy(v) for k, v in inputs.items()},
                    cfg_t, RC)
    assert torch.equal(again, out)


@pytest.mark.parametrize("arch", TOKEN_ARCHS)
def test_float64_run_stays_float64_and_matches_reference(arch):
    """``dtype="float64"`` (the CPU witness ``chip_smoke.py`` holds fp32
    against): forward logits, decode logits and every cache leaf stay
    fp64, and agree with the reference's fp32 numbers."""
    cfg_j, cfg_t, pj, pt = _setup(arch)
    rc64 = RunConfig(dtype="float64", remat=False)
    toks = np.random.default_rng(0).integers(0, cfg_j.vocab, (2, 24))
    ref = jax_forward(pj, {"tokens": jnp.asarray(toks, jnp.int32)}, cfg_j,
                      JRC_)
    out = forward(pt, {"tokens": torch.from_numpy(toks)}, cfg_t, rc64)
    assert out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    cache = init_cache(cfg_t, 2, 8, torch.float64, device="cpu")
    for j in range(3):
        lt, cache = decode_step(pt, cache, {
            "tokens": torch.from_numpy(toks[:, j:j + 1])}, cfg_t, rc64)
        assert lt.dtype == torch.float64
    assert all(v.dtype == torch.float64 for k, v in cache.items()
               if k != "len")
    # the same tokens through forward: decode's last logits agree
    np.testing.assert_allclose(lt.numpy(), out[:, 2].numpy(), rtol=1e-9,
                               atol=1e-9)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_with_grouped_dispatch_matches_reference(arch):
    """``rc.moe_dispatch = "grouped"``: the capacity-bounded dispatch of
    every MoE layer, tokens dropped as the reference drops them."""
    cfg_j, cfg_t, pj, pt = _setup(arch)
    toks = np.random.default_rng(6).integers(0, cfg_j.vocab, (2, 24))
    ref = jax_forward(pj, {"tokens": jnp.asarray(toks, jnp.int32)}, cfg_j,
                      JRC(dtype="float32", remat=False,
                          moe_dispatch="grouped"))
    out = forward(pt, {"tokens": torch.from_numpy(toks)}, cfg_t,
                  RunConfig(dtype="float32", remat=False,
                            moe_dispatch="grouped"))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def _mixed_cache(cfg_j, pj):
    """A cache whose slots sit at lengths 3, 1, 0 and 2."""
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg_j.vocab, (4, 4)).astype(np.int32)
    cache = jax_init_cache(cfg_j, 4, 16, jnp.float32)
    _, cache = jax_prefill(pj, cache, {
        "tokens": jnp.asarray(toks),
        "n_tokens": jnp.asarray([3, 1, 0, 2], jnp.int32)}, cfg_j, JRC_)
    return cache


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference_at_mixed_lengths(arch):
    cfg_j, cfg_t, pj, pt = _setup(arch)
    cache_j = _mixed_cache(cfg_j, pj)
    cache_t = bridge.from_numpy_tree(_np(cache_j), "cpu")
    rng = np.random.default_rng(2)
    for _ in range(4):
        tok = rng.integers(0, cfg_j.vocab, (4, 1))
        lj, cache_j = jax_decode(pj, cache_j,
                                 {"tokens": jnp.asarray(tok, jnp.int32)},
                                 cfg_j, JRC_)
        lt, cache_t = decode_step(pt, cache_t,
                                  {"tokens": torch.from_numpy(tok)}, cfg_t,
                                  RC)
        assert lt.dtype == torch.float32
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        _assert_cache_close(cache_j, cache_t)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_matches_reference_on_mixed_phases(arch):
    """Slot 0 prefills a full chunk, slot 1 decodes one token, slot 2 is
    free, slot 3 ingests a partial chunk."""
    cfg_j, cfg_t, pj, pt = _setup(arch)
    cache_j = _mixed_cache(cfg_j, pj)
    cache_t = bridge.from_numpy_tree(_np(cache_j), "cpu")
    toks = np.random.default_rng(3).integers(0, cfg_j.vocab, (4, 4))
    n = np.array([4, 1, 0, 3], np.int32)
    lj, cache_j = jax_prefill(pj, cache_j, {
        "tokens": jnp.asarray(toks, jnp.int32), "n_tokens": jnp.asarray(n)},
        cfg_j, JRC_)
    lt, cache_t = prefill_step(pt, cache_t, {
        "tokens": torch.from_numpy(toks), "n_tokens": torch.from_numpy(n)},
        cfg_t, RC)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    _assert_cache_close(cache_j, cache_t)


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_prefill_is_bit_exact_with_token_prefill(arch):
    cfg = get_reduced(arch)
    params = init_model_params(5, cfg, device="cpu")
    toks = torch.from_numpy(
        np.random.default_rng(4).integers(0, cfg.vocab, (3, 6)))
    chunk = init_cache(cfg, 3, 16, torch.float32, device="cpu")
    lc, chunk = prefill_step(params, chunk, {
        "tokens": toks, "n_tokens": torch.full((3,), 6, dtype=torch.int32)},
        cfg, RC)
    token = init_cache(cfg, 3, 16, torch.float32, device="cpu")
    for j in range(6):
        lt, token = decode_step(params, token, {"tokens": toks[:, j:j + 1]},
                                cfg, RC)
    assert torch.equal(lc, lt)
    for k in chunk:
        assert torch.equal(chunk[k], token[k]), k


def test_decode_steps_match_reference_past_the_window():
    """The hybrid model decoding 24 tokens into caches of 12: its K/V ring
    holds ``min(window, max_len)`` = 12 slots and wraps twice."""
    cfg_j, cfg_t, pj, pt = _setup(HYBRID)
    cache_j = jax_init_cache(cfg_j, 2, 12, jnp.float32)
    cache_t = init_cache(cfg_t, 2, 12, torch.float32, device="cpu")
    assert cache_t["k"].shape[3] == 12
    toks = np.random.default_rng(7).integers(0, cfg_j.vocab, (2, 24))
    for j in range(24):
        tok = toks[:, j:j + 1]
        lj, cache_j = jax_decode(pj, cache_j,
                                 {"tokens": jnp.asarray(tok, jnp.int32)},
                                 cfg_j, JRC_)
        lt, cache_t = decode_step(pt, cache_t,
                                  {"tokens": torch.from_numpy(tok)}, cfg_t,
                                  RC)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    _assert_cache_close(cache_j, cache_t)


def test_hybrid_chunked_prefill_is_bit_exact_past_the_window():
    """Ragged prompts of 26, 19 and 23 tokens (window 16) in chunks of 8
    against one column at a time: each slot's last logits and every cache
    leaf keep their bits."""
    cfg = get_reduced(HYBRID)
    params = init_model_params(6, cfg, device="cpu")
    toks = torch.from_numpy(
        np.random.default_rng(8).integers(0, cfg.vocab, (3, 26)))
    lens = np.array([26, 19, 23])
    out = {}
    for width in (8, 1):
        cache = init_cache(cfg, 3, 32, torch.float32, device="cpu")
        last = torch.zeros((3, cfg.vocab))
        for j in range(0, 26, width):
            n = np.clip(lens - j, 0, width).astype(np.int32)
            logits, cache = prefill_step(params, cache, {
                "tokens": toks[:, j:j + width],
                "n_tokens": torch.from_numpy(n)}, cfg, RC)
            last[n > 0] = logits[n > 0]
        out[width] = (last, cache)
    assert torch.equal(out[8][0], out[1][0])
    for k in out[8][1]:
        assert torch.equal(out[8][1][k], out[1][1][k]), k
