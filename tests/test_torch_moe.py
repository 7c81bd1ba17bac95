"""The PyTorch port's MoE layer against the JAX package's, on bridged
weights and the same seeded numpy inputs, in fp32: the router's top-k
(indices equal, ties to the lower index), the dense dispatch and the
capacity-bounded grouped dispatch (with tokens dropped).  Tolerance rtol
1e-4 / atol 1e-5, that of tests/test_models.py:150 for the same layer."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from _calibration_isolation import isolated_calibration  # noqa: F401

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_reduced as jax_reduced
from repro.models.layers import init_params as jax_init_params
from repro.models.moe import moe_apply as jax_moe_apply
from repro.models.moe import moe_apply_grouped as jax_moe_apply_grouped
from repro.models.moe import moe_specs as jax_moe_specs
from repro.models.moe import router_probs as jax_router_probs
from repro_torch import bridge
from repro_torch.configs import get_reduced
from repro_torch.models import moe as moe_mod
from repro_torch.models.moe import moe_apply, moe_apply_grouped, router_probs

ARCHS = ["olmoe-1b-7b", "granite-moe-3b-a800m"]
TOL = dict(rtol=1e-4, atol=1e-5)


def _setup(arch, act="swiglu", seed=0):
    cfg_j = dataclasses.replace(jax_reduced(arch), ffn_act=act)
    cfg_t = dataclasses.replace(get_reduced(arch), ffn_act=act)
    pj = jax_init_params(jax.random.PRNGKey(seed), jax_moe_specs(cfg_j))
    pt = bridge.from_numpy_tree(jax.tree_util.tree_map(np.asarray, pj),
                                "cpu")
    x = np.random.default_rng(seed).standard_normal(
        (2, 16, cfg_j.d_model)).astype(np.float32) * 0.3
    return cfg_j, cfg_t, pj, pt, x


@pytest.mark.parametrize("arch", ARCHS)
def test_router_top_k_matches_reference(arch):
    cfg_j, cfg_t, pj, pt, x = _setup(arch)
    wj, ij = jax_router_probs(pj, jnp.asarray(x), cfg_j)
    wt, it = router_probs(pt, torch.from_numpy(x), cfg_t)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-5,
                               atol=1e-6)


def test_router_breaks_ties_toward_the_lower_expert():
    """Duplicated router columns give exactly equal logits: both packages
    must pick the lower expert index first."""
    cfg_j, cfg_t, pj, pt, x = _setup("olmoe-1b-7b")
    r = np.asarray(pj["router"]).copy()
    r[:, 5] = r[:, 2]
    r[:, 7] = r[:, 2]
    r[:, 6] = r[:, 1]
    pj = {**pj, "router": jnp.asarray(r)}
    pt = {**pt, "router": torch.from_numpy(r)}
    _, ij = jax_router_probs(pj, jnp.asarray(x), cfg_j)
    _, it = router_probs(pt, torch.from_numpy(x), cfg_t)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


@pytest.mark.parametrize("arch,act", [("olmoe-1b-7b", "swiglu"),
                                      ("granite-moe-3b-a800m", "swiglu"),
                                      ("olmoe-1b-7b", "relu2"),
                                      ("olmoe-1b-7b", "gelu")])
def test_dense_dispatch_matches_reference(arch, act):
    cfg_j, cfg_t, pj, pt, x = _setup(arch, act, seed=1)
    ref = jax_moe_apply(pj, jnp.asarray(x), cfg_j)
    out = moe_apply(pt, torch.from_numpy(x), cfg_t)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("tokens", [1, 3])
def test_routed_dispatch_matches_reference(arch, tokens, monkeypatch):
    """A few tokens route to few experts: moe_apply masks the others out
    of every expert product, matches the JAX dense dispatch and, on the
    CPU, equals the port's dense dispatch with every expert computed."""
    cfg_j, cfg_t, pj, pt, x = _setup(arch, seed=2)
    x = x[:1, :tokens]
    _, idx = router_probs(pt, torch.from_numpy(x), cfg_t)
    assert len(set(idx.flatten().tolist())) < cfg_t.moe.num_experts
    masks = []
    real = moe_mod.moe_gemm

    def spy(*args, active=None, **kwargs):
        masks.append(active)
        return real(*args, active=active, **kwargs)
    monkeypatch.setattr(moe_mod, "moe_gemm", spy)
    out = moe_apply(pt, torch.from_numpy(x), cfg_t)
    assert len(masks) == 3
    for m in masks:
        assert m.tolist() == [int(e in idx) for e in
                              range(cfg_t.moe.num_experts)]
    ref = jax_moe_apply(pj, jnp.asarray(x), cfg_j)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    monkeypatch.setattr(moe_mod, "moe_gemm",
                        lambda *a, active=None, **k: real(*a, **k))
    assert torch.equal(out, moe_apply(pt, torch.from_numpy(x), cfg_t))


def test_grouped_dispatch_masks_empty_buffers(monkeypatch):
    """The grouped dispatch hands moe_gemm the mask of non-empty buffers;
    the empty ones were zeros in and zeros out, so nothing changes."""
    cfg_j, cfg_t, pj, pt, x = _setup("olmoe-1b-7b", seed=3)
    x = x[:1, :2]
    masks = []
    real = moe_mod.moe_gemm

    def spy(*args, active=None, **kwargs):
        masks.append(active)
        return real(*args, active=active, **kwargs)
    monkeypatch.setattr(moe_mod, "moe_gemm", spy)
    out = moe_apply_grouped(pt, torch.from_numpy(x), cfg_t)
    _, idx = router_probs(pt, torch.from_numpy(x), cfg_t)
    used = [e in idx for e in range(cfg_t.moe.num_experts)]
    assert all(m.tolist() == used for m in masks) and not all(used)
    ref = jax_moe_apply_grouped(pj, jnp.asarray(x), cfg_j)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def _dropped(idx: np.ndarray, num_experts: int, capacity: int) -> np.ndarray:
    """Assignments past an expert's capacity, in the reference's order
    (stable by expert): a (T*k,) mask over the flattened top-k."""
    eid = idx.reshape(-1)
    order = np.argsort(eid, kind="stable")
    slot = np.empty_like(eid)
    for e in range(num_experts):
        mine = order[eid[order] == e]
        slot[mine] = np.arange(len(mine))
    return slot >= capacity


@pytest.mark.parametrize("arch", ARCHS)
def test_grouped_dispatch_matches_reference_with_drops(arch):
    """At capacity factor 0.75 (6 slots an expert for 8 assignments on
    average) tokens overflow their experts: the port drops the same
    assignments as the reference, so the outputs agree, and they differ
    from the dense dispatch exactly on the tokens that lost an expert."""
    cfg_j, cfg_t, pj, pt, x = _setup(arch, seed=2)
    _, idx = jax_router_probs(pj, jnp.asarray(x), cfg_j)
    T, k, E = 32, cfg_j.moe.top_k, cfg_j.moe.num_experts
    dropped = _dropped(np.asarray(idx), E, max(int(0.75 * k * T / E), 1))
    assert dropped.any() and not dropped.all()
    ref = jax_moe_apply_grouped(pj, jnp.asarray(x), cfg_j,
                                capacity_factor=0.75)
    out = moe_apply_grouped(pt, torch.from_numpy(x), cfg_t,
                            capacity_factor=0.75)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    dense = moe_apply(pt, torch.from_numpy(x), cfg_t).numpy()
    lost = dropped.reshape(T, k).any(axis=1)
    same = np.isclose(out.numpy(), dense, **TOL).reshape(T, -1).all(axis=1)
    np.testing.assert_array_equal(same, ~lost)


def test_grouped_dispatch_matches_dense_at_high_capacity():
    """Analogue of tests/test_models.py:150: nothing dropped."""
    cfg_j, cfg_t, pj, pt, x = _setup("olmoe-1b-7b", seed=3)
    out = moe_apply_grouped(pt, torch.from_numpy(x), cfg_t,
                            capacity_factor=8.0)
    ref = jax_moe_apply_grouped(pj, jnp.asarray(x), cfg_j,
                                capacity_factor=8.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(
        out.numpy(), moe_apply(pt, torch.from_numpy(x), cfg_t).numpy(),
        **TOL)
