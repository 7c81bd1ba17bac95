"""The MoE layer row by row (``moe_apply(..., slab=B)``), as the serve
bodies run it over a chunk's C x B rows, on the CPU:

* over C x B rows it equals C calls over each column's B rows alone, bit
  for bit, in fp32 and bf16, with every activation (the router's product
  and the three expert products in slabs of B, the combine each row's own
  k expert rows summed in top-k order);
* it stays within rtol 1e-4 / atol 1e-5 of the JAX ``moe_apply`` (the
  tolerance of tests/test_models.py:150 for the same layer) in fp32, on
  bridged weights and the same seeded numpy inputs, as the dense dispatch
  does (tests/test_torch_moe.py);
* the plain ``moe_gemm`` with ``slab`` is one product a slab, and
  ``combine_rows`` is the reference's one-hot combine to fp32 rounding."""
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
from repro.models.moe import moe_specs as jax_moe_specs
from repro_torch import bridge
from repro_torch.configs import get_reduced
from repro_torch.kernels import moe_gemm
from repro_torch.kernels.moe_gemm import ops as mg_ops
from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref
from repro_torch.models import moe as moe_mod

ARCHS = ["olmoe-1b-7b", "granite-moe-3b-a800m"]
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread for both sides of every comparison."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setup(arch, act="swiglu", seed=0, rows=32):
    cfg_j = dataclasses.replace(jax_reduced(arch), ffn_act=act)
    cfg_t = dataclasses.replace(get_reduced(arch), ffn_act=act)
    pj = jax_init_params(jax.random.PRNGKey(seed), jax_moe_specs(cfg_j))
    pt = bridge.from_numpy_tree(jax.tree_util.tree_map(np.asarray, pj),
                                "cpu")
    x = np.random.default_rng(seed).standard_normal(
        (rows, cfg_j.d_model)).astype(np.float32) * 0.3
    return cfg_j, cfg_t, pj, pt, x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["swiglu", "relu2", "gelu"])
@pytest.mark.parametrize("cols,slots", [(8, 4), (5, 3), (1, 4), (16, 1)])
@pytest.mark.parametrize("arch", ARCHS)
def test_rows_equal_their_slabs_alone(arch, cols, slots, act, dtype):
    """(C, B, d) in slabs of B against each column's (1, B, d) alone: the
    same bits, though the chunk's mask is the union of every column's
    experts."""
    _, cfg, _, p, x = _setup(arch, act, seed=cols + slots,
                             rows=cols * slots)
    p = {k: v.to(dtype) for k, v in p.items()}
    xs = torch.from_numpy(x).to(dtype).reshape(cols, slots, -1)
    chunk = moe_mod.moe_apply(p, xs, cfg, slab=slots)
    assert chunk.dtype == dtype and chunk.shape == xs.shape
    for c in range(cols):
        alone = moe_mod.moe_apply(p, xs[c:c + 1], cfg, slab=slots)
        assert torch.equal(chunk[c:c + 1], alone), c


@pytest.mark.parametrize("act", ["swiglu", "relu2", "gelu"])
@pytest.mark.parametrize("arch", ARCHS)
def test_rows_match_jax(arch, act):
    """8 columns of 4 slots in slabs of 4 against the JAX dense dispatch
    over the same 32 tokens, and against the port's own one-hot combine
    (``slab`` None)."""
    cfg_j, cfg_t, pj, pt, x = _setup(arch, act, seed=3)
    ref = np.asarray(jax_moe_apply(pj, jnp.asarray(x[None]), cfg_j))[0]
    rows = moe_mod.moe_apply(pt, torch.from_numpy(x).reshape(8, 4, -1),
                             cfg_t, slab=4).reshape(32, -1)
    np.testing.assert_allclose(rows.numpy(), ref, **TOL)
    dense = moe_mod.moe_apply(pt, torch.from_numpy(x)[None], cfg_t)[0]
    np.testing.assert_allclose(rows.numpy(), dense.numpy(), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_slab_reaches_every_product(arch, monkeypatch):
    """The router's product and the three expert products are asked for
    in slabs of B, the experts with the union of every row's experts."""
    _, cfg, _, p, x = _setup(arch, seed=4)
    seen, masks = [], []
    real_mm, real_mg = moe_mod.matmul, moe_mod.moe_gemm

    def matmul(x, w, policy=None, slab=None):
        seen.append(("router", slab))
        return real_mm(x, w, policy, slab)

    def gemm(*args, active=None, slab=None, **kwargs):
        seen.append(("expert", slab))
        masks.append(active)
        return real_mg(*args, active=active, slab=slab, **kwargs)
    monkeypatch.setattr(moe_mod, "matmul", matmul)
    monkeypatch.setattr(moe_mod, "moe_gemm", gemm)
    xs = torch.from_numpy(x).reshape(8, 4, -1)
    moe_mod.moe_apply(p, xs, cfg, slab=4)
    assert seen == [("router", 4)] + [("expert", 4)] * 3
    _, idx = moe_mod.router_probs(p, xs, cfg)
    union = [int(e in idx) for e in range(cfg.moe.num_experts)]
    assert all(m.tolist() == union for m in masks)


@pytest.mark.parametrize("bcast", [True, False])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_plain_slab_product_is_one_product_a_slab(bcast, masked, dtype):
    """On the CPU ``moe_gemm`` with ``slab`` equals the slabs' products
    bit for bit (a shared or a per-expert x, with or without the mask),
    one row a slab and a ragged last slab included, and launches
    nothing."""
    g = torch.Generator().manual_seed(5)
    e, c, d, f = 6, 13, 48, 40
    x = torch.randn((c, d) if bcast else (e, c, d), generator=g).to(dtype)
    w = torch.randn((e, d, f), generator=g).to(dtype)
    active = (torch.tensor([1, 0, 1, 1, 0, 1], dtype=torch.int8)
              if masked else None)
    before = moe_gemm.launches
    for slab in (1, 3, 4, 13, 20):
        got = moe_gemm(x, w, active=active, slab=slab)
        assert got.shape == (e, c, f) and got.dtype == torch.float32
        want = torch.cat([moe_gemm_ref(x[..., i:i + slab, :], w, active)
                          for i in range(0, c, slab)], dim=1)
        assert torch.equal(got, want), slab
        torch.testing.assert_close(got, moe_gemm_ref(x, w, active))
    assert moe_gemm.launches == before
    with pytest.raises(ValueError, match="slab must be >= 1"):
        moe_gemm(x, w, slab=0)


def test_combine_rows_is_the_one_hot_combine():
    """Each token's k rows weighted and summed in top-k order: the
    reference's one-hot ``einsum`` to fp32 rounding, in the compute dtype,
    and a token's bits whatever tokens come with it."""
    g = torch.Generator().manual_seed(6)
    E, T, d, k = 8, 12, 16, 3
    for dtype in (torch.float32, torch.bfloat16, torch.float64):
        y = torch.randn((E, T, d), generator=g).to(dtype)
        idx = torch.stack([torch.randperm(E, generator=g)[:k]
                           for _ in range(T)])
        w = torch.softmax(torch.randn((T, k), generator=g), -1)
        out = moe_mod.combine_rows(y, w, idx)
        assert out.dtype == dtype and out.shape == (T, d)
        one_hot = torch.zeros((T, E), dtype=torch.float64)
        one_hot.scatter_(1, idx, w.to(dtype).double())
        want = torch.einsum("etd,te->td", y.double(), one_hot)
        tol = 1e-2 if dtype == torch.bfloat16 else 1e-6
        torch.testing.assert_close(out.double(), want, rtol=tol, atol=tol)
        for lo, hi in ((0, 5), (5, 6), (6, 12)):
            assert torch.equal(moe_mod.combine_rows(y[:, lo:hi], w[lo:hi],
                                                    idx[lo:hi]), out[lo:hi])


def test_rowwise_plan_on_the_host():
    """The thin kernel's tiles a block for the rows an expert of a chunk
    (the wrapper's mirror of ``moe_gemm_thin_tiles``): up to 4, halved
    where the rings would not fit, 0 where not one tile's do; bf16 runs
    thin at any C only row by row, and the shared memory counted at the
    tiles taken."""
    assert [mg_ops.thin_tiles(c, 4) for c in (1, 16, 17, 32, 33, 64, 80,
                                             1024)] == [1, 1, 2, 2, 4, 4,
                                                        4, 4]
    assert mg_ops.thin_tiles(64, 8) == 2 and mg_ops.thin_tiles(64, 11) == 1
    assert mg_ops.thin_tiles(64, 12) == 0
    assert mg_ops.regime(32, torch.bfloat16) == "wide"
    assert mg_ops.regime(32, torch.bfloat16, rowwise=True) == "thin"
    assert mg_ops.regime(32, torch.float32, rowwise=True) == "fp32"
    for depth in (1, 2, 4, 8):
        assert mg_ops.smem_bytes(4, depth, torch.bfloat16) == \
            mg_ops.smem_bytes(4, depth, torch.bfloat16, rowwise=True)
    assert mg_ops.smem_bytes(64, 4, torch.bfloat16, rowwise=True) > \
        mg_ops.smem_bytes(32, 4, torch.bfloat16, rowwise=True) > \
        mg_ops.smem_bytes(4, 4, torch.bfloat16)
    with pytest.raises(ValueError, match="16 rows a block"):
        mg_ops._plan(True, 64, 2048, 1024, 12, torch.bfloat16,
                     mg_ops.thin_tiles(64, 12))
    with pytest.raises(ValueError, match="64 rows a block"):
        mg_ops._plan(True, 64, 2048, 1024, 8, torch.bfloat16, 4)
    assert mg_ops._plan(True, 2, 2048, 128, 8, torch.bfloat16,
                        mg_ops.thin_tiles(64, 8)) == \
        mg_ops.split_k(2, 2048, 128) == 4
