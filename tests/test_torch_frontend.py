"""The registry's last three architectures in the PyTorch port against the
JAX package, on the CPU at reduced sizes in fp32: the vision frontend
(pixtral-smoke: 8 patch rows in front of a GQA decoder) and the audio one
(hubert-smoke: a non-causal encoder over frames) through ``forward``,
pixtral's token decode, hubert's engine refusal, a training step whose
loss never reads hubert's embedding, and, for every architecture and
every shape it runs, ``supported_shapes``, ``input_specs`` and
``param_shapes`` against the reference's.  Logits are held to 2e-3, the
reference's own tolerance (tests/test_models.py:90)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro import configs as jax_configs
from repro.config import RunConfig as JRC
from repro.config import SHAPES as JAX_SHAPES
from repro.config import supported_shapes as jax_supported_shapes
from repro.models import forward as jax_forward
from repro.models import init_model_params as jax_init_params
from repro.models import input_specs as jax_input_specs
from repro.models import param_shapes as jax_param_shapes
from repro.optim import init_opt_state as jax_init_opt
from repro.serve import ServeEngine as JaxEngine
from repro.train.step import train_step as jax_train_step
from repro_torch import bridge, configs
from repro_torch.config import SHAPES, RunConfig, supported_shapes
from repro_torch.models import (decode_step, forward, init_cache,
                                init_model_params, input_specs,
                                param_shapes)
from repro_torch.optim import init_opt_state
from repro_torch.serve import ServeEngine
from repro_torch.train import train_step

JRC_ = JRC(dtype="float32", remat=False)
RC = RunConfig(dtype="float32", remat=False)
TOL = dict(rtol=2e-3, atol=2e-3)
FRONTENDS = ["pixtral-12b", "hubert-xlarge"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _setup(arch, seed=11):
    cfg_j, cfg_t = jax_configs.get_reduced(arch), configs.get_reduced(arch)
    pj = jax_init_params(jax.random.PRNGKey(seed), cfg_j)
    return cfg_j, cfg_t, pj, bridge.from_numpy_tree(_np(pj), "cpu")


def _inputs(cfg, B, S, seed=0):
    """The model inputs of tests/test_models.py's ``_batch`` (frames or
    patches at 0.1 of a normal draw) from a numpy generator: numpy arrays
    keyed as the reference keys them."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        return {"frames": (rng.standard_normal((B, S, cfg.d_model))
                           * 0.1).astype(np.float32)}
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.frontend == "vision":
        out["patches"] = (rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model)) * 0.1).astype(np.float32)
    return out


def _both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


@pytest.mark.parametrize("S", [24, 6])
@pytest.mark.parametrize("arch", FRONTENDS)
def test_frontend_forward_matches_reference(arch, S):
    """``forward`` on patches or frames.  At S = 6, below pixtral's 8
    patch rows, the reference's concatenation returns the patches' 8 rows
    and the port keeps that length."""
    cfg_j, cfg_t, pj, pt = _setup(arch)
    bj, bt = _both(_inputs(cfg_t, 2, S))
    ref = np.asarray(jax_forward(pj, bj, cfg_j, JRC_))
    out = forward(pt, bt, cfg_t, RC)
    rows = max(S, cfg_t.n_frontend_tokens)
    assert out.shape == ref.shape == (2, rows, cfg_t.vocab)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_hubert_attends_both_ways():
    """The encoder is non-causal: changing the last frame moves the first
    position's logits, as in the reference."""
    _, cfg, _, pt = _setup("hubert-xlarge")
    _, bt = _both(_inputs(cfg, 1, 12))
    later = {"frames": bt["frames"].clone()}
    later["frames"][:, -1] += 1.0
    a, b = forward(pt, bt, cfg, RC), forward(pt, later, cfg, RC)
    assert not torch.allclose(a[:, 0], b[:, 0])


def test_pixtral_token_decode_matches_forward_without_patches():
    """tests/test_models.py:62-87 for the vision model: decode embeds
    tokens only, so token-by-token decode reproduces ``forward`` of the
    same config with the frontend off."""
    _, cfg, _, pt = _setup("pixtral-12b")
    toks = torch.from_numpy(_inputs(cfg, 2, 8, seed=3)["tokens"])
    plain = dataclasses.replace(cfg, frontend=None, n_frontend_tokens=0)
    full = forward(pt, {"tokens": toks}, plain, RC)
    cache = init_cache(cfg, 2, 16, torch.float32, device="cpu")
    outs = []
    for t in range(8):
        logits, cache = decode_step(pt, cache, {"tokens": toks[:, t:t + 1]},
                                    cfg, RC)
        outs.append(logits)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               **TOL)


def test_engine_refuses_the_encoder_as_the_reference_does():
    cfg_j, cfg_t, pj, pt = _setup("hubert-xlarge")
    with pytest.raises(AssertionError, match="autoregressive"):
        JaxEngine(pj, cfg_j, JRC_, batch_slots=2, max_len=32)
    with pytest.raises(ValueError, match="autoregressive"):
        ServeEngine(pt, cfg_t, RC, batch_slots=2, max_len=32, device="cpu")


def test_adamw_decays_the_unread_embedding_as_the_reference():
    """hubert's loss never reads ``embed``: JAX's gradient of it is zeros,
    the port's fp32 zeros, and one AdamW step moves it by the weight decay
    alone, p (1 - lr wd), to the reference's bits."""
    cfg_j, cfg_t, pj, pt = _setup("hubert-xlarge", seed=4)
    batch = _inputs(cfg_t, 2, 16, seed=5)
    batch["labels"] = np.random.default_rng(6).integers(
        0, cfg_t.vocab, (2, 16)).astype(np.int32)
    bj, bt = _both(batch)
    jrc = JRC(dtype="float32", remat=False, lr=1e-2, warmup_steps=1,
              total_steps=10)
    trc = RunConfig(dtype="float32", remat=False, lr=1e-2, warmup_steps=1,
                    total_steps=10)
    before = pt["embed"].clone()
    pj, _, mj = jax_train_step(pj, jax_init_opt(pj), bj, cfg_j, jrc)
    pt, opt, mt = train_step(pt, init_opt_state(pt), bt, cfg_t, trc)
    assert abs(float(mt["loss"]) - float(mj["loss"])) <= 2e-5
    assert torch.count_nonzero(opt.mu["embed"]) == 0
    lr = float(mt["lr"])
    np.testing.assert_array_equal(pt["embed"].numpy(), np.asarray(pj["embed"]))
    np.testing.assert_allclose(
        pt["embed"].numpy(),
        (before * (1 - lr * trc.weight_decay)).numpy(), rtol=1e-6, atol=0)
    assert not torch.equal(pt["embed"], before)


def test_registry_equals_the_reference():
    assert configs.ARCHS == jax_configs.ARCHS
    for arch in configs.ARCHS:
        for get in ("get_config", "get_reduced"):
            assert dataclasses.asdict(getattr(configs, get)(arch)) == \
                dataclasses.asdict(getattr(jax_configs, get)(arch)), arch


def _spec(tree):
    """A spec tree as nested dicts of (shape, dtype name)."""
    if isinstance(tree, dict):
        return {k: _spec(v) for k, v in tree.items()}
    if isinstance(tree, tuple):            # the port's (shape, dtype)
        shape, dt = tree
        return tuple(shape), str(dt).split(".")[-1]
    return tuple(tree.shape), jnp.dtype(tree.dtype).name


@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("arch", jax_configs.ARCHS)
def test_shapes_and_input_specs_match_reference(arch, size):
    """For every shape the architecture runs: the same ``supported_shapes``,
    and ``input_specs`` (cache included) and ``param_shapes`` with the
    same keys, shapes and dtype names, in fp32 and bf16."""
    get = "get_config" if size == "full" else "get_reduced"
    cfg_j = getattr(jax_configs, get)(arch)
    cfg_t = getattr(configs, get)(arch)
    names = supported_shapes(cfg_t)
    assert names == jax_supported_shapes(cfg_j)
    for dtype in ("float32", "bfloat16"):
        assert _spec(param_shapes(cfg_t, dtype)) == \
            _spec(jax_param_shapes(cfg_j, jnp.dtype(dtype)))
        for name in names:
            got = input_specs(cfg_t, SHAPES[name], RunConfig(dtype=dtype))
            want = jax_input_specs(cfg_j, JAX_SHAPES[name], JRC(dtype=dtype))
            assert _spec(got) == _spec(want), (name, dtype)


@pytest.mark.parametrize("family,base,frontend", [
    ("vlm", "olmoe-1b-7b", "vision"), ("audio", "falcon-mamba-7b", "audio"),
    ("moe", "phi3-mini-3.8b", None), ("dense", "phi3-mini-3.8b", "video")])
def test_a_family_must_name_its_stack(family, base, frontend):
    """vlm and audio put their frontend in front of the dense stack; a
    family over another stack, or an unknown frontend, is no architecture
    of the registry."""
    cfg = dataclasses.replace(configs.get_reduced(base), family=family,
                              frontend=frontend, n_frontend_tokens=8)
    with pytest.raises(NotImplementedError, match="no architecture"):
        init_model_params(0, cfg, device="cpu")
