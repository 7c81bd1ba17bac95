"""The PyTorch port's bridge and package boundary: parameter and cache trees
carried from the JAX package to the port and back are exact (values,
dtypes, shapes), the port's trees have the reference's layout, and the
port imports nothing of JAX or of the JAX package."""
import pathlib
import re

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_reduced as jax_reduced
from repro.models import init_cache as jax_init_cache
from repro.models import init_model_params as jax_init_params
from repro.models import param_specs as jax_param_specs
from repro_torch import bridge
from repro_torch.configs import get_reduced
from repro_torch.models import init_cache, init_model_params, param_specs
from repro_torch.models.layers import ParamSpec

ARCHS = ["phi3-mini-3.8b", "glm4-9b", "olmoe-1b-7b", "granite-moe-3b-a800m",
         "falcon-mamba-7b", "recurrentgemma-2b", "minicpm3-4b",
         "nemotron-4-340b", "pixtral-12b", "hubert-xlarge"]
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_same(a, b):
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
        return
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_param_tree_round_trip_is_exact(arch, dtype):
    cfg = jax_reduced(arch)
    tree = _np(jax_init_params(jax.random.PRNGKey(3), cfg, dtype))
    back = bridge.to_numpy_tree(bridge.from_numpy_tree(tree, "cpu"))
    _assert_same(tree, back)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_cache_tree_round_trip_is_exact(arch, dtype):
    cfg = jax_reduced(arch)
    cache = jax_init_cache(cfg, 3, 16, dtype)
    cache = {**{k: v + 0.5 for k, v in cache.items()},
             "len": jnp.asarray([0, 4, 9], jnp.int32)}
    tree = _np(cache)
    ported = bridge.from_numpy_tree(tree, "cpu")
    assert ported["len"].dtype == torch.int32
    _assert_same(tree, bridge.to_numpy_tree(ported))


def test_from_numpy_tree_recasts_floats_only():
    tree = {"w": np.ones((2, 3), np.float32), "len": np.arange(3, dtype=np.int32)}
    out = bridge.from_numpy_tree(tree, "cpu", dtype=torch.bfloat16)
    assert out["w"].dtype == torch.bfloat16 and out["len"].dtype == torch.int32


@pytest.mark.parametrize("arch", ARCHS)
def test_port_trees_have_the_reference_layout(arch):
    """Same keys, shapes, logical axes, initializers and scales as the JAX
    package's spec tree; and the materialized trees (params and cache) have
    the reference's shapes and dtypes."""
    cfg = jax_reduced(arch)
    specs_j = jax_param_specs(cfg)
    specs_t = param_specs(get_reduced(arch))

    def cmp(a, b):
        if isinstance(b, ParamSpec):
            assert (a.shape, a.axes, a.init, a.scale) == \
                (b.shape, b.axes, b.init, b.scale)
            return
        assert a.keys() == b.keys()
        for k in a:
            cmp(a[k], b[k])
    cmp(specs_j, specs_t)

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return (tuple(tree.shape), str(tree.dtype).split(".")[-1])
    p_j = _np(jax_init_params(jax.random.PRNGKey(0), cfg))
    p_t = init_model_params(0, get_reduced(arch), device="cpu")
    assert shapes(p_j) == shapes(p_t)
    c_j = _np(jax_init_cache(cfg, 2, 8, jnp.float32))
    c_t = init_cache(get_reduced(arch), 2, 8, torch.float32, device="cpu")
    assert shapes(c_j) == shapes(c_t)


def test_init_scales_follow_the_specs():
    cfg = get_reduced("phi3-mini-3.8b")
    gen = torch.Generator().manual_seed(0)
    p = init_model_params(gen, cfg, device="cpu")
    assert torch.count_nonzero(p["blocks"]["ln1"]) == 0
    # the reference takes fan-in from a leaf's first axis, which for the
    # stacked block leaves is the layer axis: std = 1/sqrt(n_layers)
    std = p["blocks"]["ffn"]["wi"].std().item()
    want = 1 / np.sqrt(cfg.n_layers)
    assert abs(std - want) < 0.05 * want
    assert abs(p["embed"].std().item() - 0.02) < 0.002
    again = init_model_params(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    assert torch.equal(p["embed"], again["embed"])


def test_hybrid_init_scales_follow_the_specs():
    """The hybrid tree: ``macros`` leaves stacked over the n_full macro
    blocks are drawn at std 1/sqrt(n_full), as the reference draws them;
    the unstacked ``tail_*`` leaves at 1/sqrt(their first axis), the input
    width."""
    import dataclasses
    cfg = dataclasses.replace(get_reduced("recurrentgemma-2b"), n_layers=26)
    p = init_model_params(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    assert set(p) == {"embed", "final_norm", "head", "macros", "tail_0_rec",
                      "tail_1_rec"}
    assert set(p["macros"]) == {"0_rec", "1_rec", "2_attn"}
    rg = p["macros"]["1_rec"]["rglru"]["rg_w"]
    assert rg.shape == (8, 64, 64)
    assert abs(rg.std().item() - 1 / np.sqrt(8)) < 0.05 / np.sqrt(8)
    wi = p["tail_1_rec"]["ffn"]["wi"]
    assert abs(wi.std().item() - 1 / np.sqrt(64)) < 0.05 / np.sqrt(64)
    assert torch.all(p["tail_0_rec"]["rglru"]["lam"] == 1)
    assert torch.count_nonzero(p["macros"]["2_attn"]["ln2"]) == 0


def test_port_imports_nothing_of_jax_or_the_jax_package():
    """No module of the port, and not ``chip_smoke.py``, imports jax, the
    JAX package or the reference's top-level ``benchmarks`` package (which
    imports ``repro``)."""
    pat = re.compile(r"^\s*(import\s+(jax|repro|benchmarks)\b"
                     r"|from\s+(jax|repro|benchmarks)(\.|\s))", re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert not offenders, offenders
