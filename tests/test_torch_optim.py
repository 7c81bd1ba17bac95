"""The port's optimizers and gradient compression against the JAX
package's, on the CPU: ``lr_schedule``, ``clip_by_global_norm``,
``adamw_update`` and ``lion_update`` on bridged parameters, states and
gradients (fp32; an update agrees to a few ulps: the port updates in
place, in chunks, and may fuse a multiply-add), and the int8 codec's
properties (unbiased, a round trip within one step, exact dequantization
of a fixed ``q``)."""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np
from _hypothesis_compat import given, settings, st

from repro.config import RunConfig as JRC
from repro.distributed.compression import dequantize_int8 as jax_dequantize
from repro.optim import OptState as JaxOptState
from repro.optim import adamw_update as jax_adamw
from repro.optim import clip_by_global_norm as jax_clip
from repro.optim import init_opt_state as jax_init_opt
from repro.optim import lion_update as jax_lion
from repro.optim import lr_schedule as jax_lr_schedule
from repro_torch import bridge
from repro_torch.config import RunConfig
from repro_torch.distributed import (compress_grads, dequantize_int8,
                                     quantize_int8)
from repro_torch.models.layers import tree_leaves
from repro_torch.optim import (OptState, adamw_update, clip_by_global_norm,
                               init_opt_state, lion_update, lr_schedule)
from repro_torch.optim import _CHUNK

#: fp32 agreement of one update: a few ulps of the largest value moved
TOL = dict(rtol=1e-6, atol=1e-7)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((5, 7)) * scale).astype(np.float32),
            "blocks": {"a": (rng.standard_normal((2, 3, 4)) * scale
                             ).astype(np.float32),
                       "ln": (rng.standard_normal((3,)) * scale
                              ).astype(np.float32)}}


def _close(got, want, **tol):
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(_np(want))):
        np.testing.assert_allclose(g.numpy(), w, **(tol or TOL))


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 50, 100, 150])
def test_lr_schedule_matches_reference(step):
    rc = RunConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    jrc = JRC(lr=1e-3, warmup_steps=10, total_steps=100)
    np.testing.assert_allclose(lr_schedule(step, rc),
                               float(jax_lr_schedule(jnp.asarray(step), jrc)),
                               rtol=1e-6)


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _tree(0, scale=3.0)
    want, norm_j = jax_clip(jax.tree_util.tree_map(jnp.asarray, g), max_norm)
    got, norm = clip_by_global_norm(bridge.from_numpy_tree(g, "cpu"),
                                    max_norm)
    np.testing.assert_allclose(float(norm), float(norm_j), rtol=1e-6)
    _close(got, want)


def _states(seed):
    """Bridged params, a mid-run AdamW state and gradients."""
    p, g = _tree(seed), _tree(seed + 1, scale=0.5)
    mu, nu = _tree(seed + 2, scale=0.1), _tree(seed + 3, scale=0.01)
    nu = jax.tree_util.tree_map(np.abs, nu)
    jstate = JaxOptState(jnp.asarray(7, jnp.int32),
                         jax.tree_util.tree_map(jnp.asarray, mu),
                         jax.tree_util.tree_map(jnp.asarray, nu))
    tstate = bridge.opt_state_from_numpy((np.asarray(7, np.int32), mu, nu),
                                         "cpu")
    return p, g, jstate, tstate


@pytest.mark.parametrize("seed", [0, 1])
def test_adamw_update_matches_reference(seed):
    """One AdamW step (clip, moments, bias correction, weight decay on
    every leaf) on bridged params, state and gradients."""
    p, g, jstate, tstate = _states(seed)
    rc = RunConfig(lr=1e-2, warmup_steps=3, total_steps=20, grad_clip=1.0)
    jrc = JRC(lr=1e-2, warmup_steps=3, total_steps=20, grad_clip=1.0)
    jp, js, jm = jax_adamw(jax.tree_util.tree_map(jnp.asarray, p), jstate,
                           jax.tree_util.tree_map(jnp.asarray, g), jrc)
    tp, ts, tm = adamw_update(bridge.from_numpy_tree(p, "cpu"), tstate,
                              bridge.from_numpy_tree(g, "cpu"), rc)
    assert int(ts.step) == int(js.step) == 8
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-6)
    _close(tp, jp)
    _close(ts.mu, js.mu)
    _close(ts.nu, js.nu)


def test_adamw_first_step_from_init_matches_reference():
    p, g, _, _ = _states(3)
    rc, jrc = RunConfig(lr=1e-2), JRC(lr=1e-2)
    jp_in = jax.tree_util.tree_map(jnp.asarray, p)
    jp, js, _ = jax_adamw(jp_in, jax_init_opt(jp_in),
                          jax.tree_util.tree_map(jnp.asarray, g), jrc)
    tp_in = bridge.from_numpy_tree(p, "cpu")
    tp, ts, _ = adamw_update(tp_in, init_opt_state(tp_in),
                             bridge.from_numpy_tree(g, "cpu"), rc)
    _close(tp, jp)
    _close(ts.nu, js.nu)
    back = JaxOptState(*bridge.opt_state_to_numpy(ts))
    assert int(back.step) == 1 and isinstance(back.mu, dict)


def test_lion_update_matches_reference():
    p, g, jstate, _ = _states(4)
    mu = _np(jstate.mu)
    jstate = jax_init_opt(jax.tree_util.tree_map(jnp.asarray, p), "lion")
    jstate = JaxOptState(jnp.asarray(2, jnp.int32),
                         jax.tree_util.tree_map(jnp.asarray, mu), jstate.nu)
    tstate = init_opt_state(bridge.from_numpy_tree(p, "cpu"), "lion")
    assert all(v.shape == () for v in tree_leaves(tstate.nu))
    tstate = OptState(torch.tensor(2, dtype=torch.int32),
                      bridge.from_numpy_tree(mu, "cpu"), tstate.nu)
    rc, jrc = RunConfig(lr=1e-2), JRC(lr=1e-2)
    jp, js, jm = jax_lion(jax.tree_util.tree_map(jnp.asarray, p), jstate,
                          jax.tree_util.tree_map(jnp.asarray, g), jrc)
    tp, ts, tm = lion_update(bridge.from_numpy_tree(p, "cpu"), tstate,
                             bridge.from_numpy_tree(g, "cpu"), rc)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    _close(tp, jp)
    _close(ts.mu, js.mu)


def test_updates_are_in_place_and_cross_chunks(monkeypatch):
    """The returned trees are the tensors passed in, and a leaf longer than
    a chunk is updated whole (the chunk shrunk to 7 elements here)."""
    import repro_torch.optim as optim
    monkeypatch.setattr(optim, "_CHUNK", 7)
    p, g, jstate, _ = _states(5)
    tp = bridge.from_numpy_tree(p, "cpu")
    ts = init_opt_state(tp)
    ptrs = [t.data_ptr() for t in tree_leaves(tp)]
    out, ts2, _ = adamw_update(tp, ts, bridge.from_numpy_tree(g, "cpu"),
                               RunConfig(lr=1e-2))
    assert out is tp and ts2.mu is ts.mu
    assert [t.data_ptr() for t in tree_leaves(out)] == ptrs
    jp_in = jax.tree_util.tree_map(jnp.asarray, p)
    jp, _, _ = jax_adamw(jp_in, jax_init_opt(jp_in),
                         jax.tree_util.tree_map(jnp.asarray, g),
                         JRC(lr=1e-2))
    _close(out, jp)
    assert _CHUNK == 1 << 26


# --- compression --------------------------------------------------------------

@given(st.integers(0, 2 ** 31 - 1))
@settings(max_examples=20, deadline=None)
def test_int8_quantization_unbiased_and_within_one_step(seed):
    """The reference's own properties (tests/test_substrate.py:125): the
    mean of 64 round trips is within 0.6 of a step of g, and one round
    trip is within one step."""
    g = torch.from_numpy(np.random.default_rng(seed).standard_normal(64)
                         .astype(np.float32) * 0.37)
    gen = torch.Generator().manual_seed(seed)
    qs = [dequantize_int8(*quantize_int8(gen, g)) for _ in range(64)]
    scale = float(g.abs().max()) / 127.0
    np.testing.assert_allclose(torch.stack(qs).mean(0).numpy(), g.numpy(),
                               atol=scale * 0.6)
    assert float((qs[0] - g).abs().max()) <= scale + 1e-6


def test_dequantize_a_fixed_q_exactly_as_reference():
    q = np.array([-127, -3, 0, 1, 64, 127], np.int8)
    scale = np.float32(0.0123)
    want = np.asarray(jax_dequantize(jnp.asarray(q), jnp.asarray(scale)))
    got = dequantize_int8(torch.from_numpy(q), torch.tensor(scale))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_quantize_int8_range_and_compress_grads_in_place():
    g = {"a": torch.linspace(-2.0, 3.0, 50), "b": torch.zeros(4)}
    q, scale = quantize_int8(torch.Generator().manual_seed(0), g["a"])
    assert q.dtype == torch.int8 and int(q.abs().max()) <= 127
    assert float(scale) == pytest.approx(3.0 / 127.0)
    ptr = g["a"].data_ptr()
    out = compress_grads(torch.Generator().manual_seed(1), g)
    assert out["a"].data_ptr() == ptr
    assert float((out["a"] - torch.linspace(-2.0, 3.0, 50)).abs().max()) \
        <= 3.0 / 127.0 + 1e-6
    assert torch.equal(out["b"], torch.zeros(4))
