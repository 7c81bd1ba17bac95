"""A chunk's columns as one batched body: ``prefill_step`` of every decoder
family (``models.model.batches_columns``: phi3-mini-3.8b, glm4-9b,
nemotron-4-340b, pixtral-12b, olmoe-1b-7b, granite-moe-3b-a800m,
falcon-mamba-7b, recurrentgemma-2b, minicpm3-4b) runs its C columns over
C x B rows at once, only the SSM and RG-LRU recurrences walking the columns
at B rows.

* The batched chunk equals token-by-token decode bit for bit — each
  column through ``decode_step`` on a copy of the cache, its active slots'
  rows kept — logits and every cache leaf, at widths 1-16 with counts 0, 1,
  a partial and a whole chunk, over two chunks, in fp32 and bf16.
* It is within the reference's 2e-3 of the JAX ``prefill_step``
  (tests/test_models.py:90) on bridged weights and the same numpy inputs.
* Every product of the chunk and of the decode step runs row by row, in
  slabs of the B slots (on the card the thin kernel, never the wide one);
  on the CPU each slab is its own product, since the CPU's one-row product
  rounds unlike its many-row one.  An MoE layer's router and expert
  products too (tests/test_torch_moe_rows.py).
* The step reads nothing back to the host and makes no shape from the data.
* recurrentgemma's attention layers run the columns at once where the K/V
  ring is shorter than the window (the whole cache) and one column at a
  time where it is the window (a later column may wrap onto a row an
  earlier one reads); an SSM chunk of any width is one body, its conv
  state gathered at each slot's count.
* minicpm3's MLA chunk is one body at any width: its latent and rope rows
  clamp at ``max_len - 1``, so a chunk straddling ``max_len`` writes each
  row below it once and the last row as the last active column past it
  leaves it (token decode's bits, and the JAX ``prefill_step``'s within
  2e-3).
* The row-by-row kernels' plain versions and wrappers on the CPU: the
  norm is the model's norm, decode attention the one-column attention's
  arithmetic row by row, neither launching anything.  MLA's latent
  attention and its plan are tested in tests/test_torch_latent_attention.py
  and tests/test_torch_latent_attention_plan.py."""
import pytest

torch = pytest.importorskip("torch")

from _calibration_isolation import isolated_calibration  # noqa: F401

import jax
import jax.numpy as jnp
import numpy as np

from repro.config import RunConfig as JRC
from repro.configs import get_reduced as jax_reduced
from repro.models import init_model_params as jax_init_params
from repro.models import prefill_step as jax_prefill
from repro_torch import bridge
from repro_torch.config import RunConfig
from repro_torch.configs import ARCHS, get_reduced
from repro_torch.kernels import decode_attention, queue_matmul, rms_norm
from repro_torch.kernels.decode_attention.ref import (decode_attention_ref,
                                                      decode_attention_rows_ref)
from repro_torch.kernels.queue_matmul import ops as qm_ops
from repro_torch.kernels.rms_norm.ref import rms_norm_ref
from repro_torch.models import (decode_step, init_cache, init_model_params,
                                prefill_step, prepare_params)
from repro_torch.models import layers
from repro_torch.models.model import _attends_by_column, batches_columns
from test_torch_serve_program import NoHostRoundTrip

BATCHED = ["phi3-mini-3.8b", "glm4-9b", "nemotron-4-340b", "pixtral-12b",
           "olmoe-1b-7b", "granite-moe-3b-a800m", "falcon-mamba-7b",
           "recurrentgemma-2b", "minicpm3-4b"]
TOL = dict(rtol=2e-3, atol=2e-3)


@pytest.fixture(autouse=True)
def one_thread():
    """The reduced models' ops are a few hundred elements: one CPU thread
    each, so that workers running side by side do not contend for cores
    (both paths of a comparison run under it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cache(cfg, dtype, seed, max_len=32):
    """4 slots of ``max_len`` rows at lengths 2, 0, 5, 1, every state leaf
    (K/V, SSM, RG-LRU, conv) a seeded draw in the cache's key order."""
    cache = init_cache(cfg, 4, max_len, dtype, device="cpu")
    rng = np.random.default_rng(seed)
    cache["len"].copy_(torch.tensor([2, 0, 5, 1], dtype=torch.int32))
    for k, v in cache.items():
        if k != "len":
            v.copy_(torch.from_numpy(
                rng.standard_normal(v.shape).astype(np.float32) * 0.1))
    return cache


def _token_prefill(params, cache, toks, counts, cfg, rc):
    """Each column through ``decode_step`` on a copy of the cache; the
    slots active in it keep its rows, length and logits."""
    logits = torch.zeros((toks.shape[0], cfg.vocab))
    for j in range(toks.shape[1]):
        trial = {k: v.clone() for k, v in cache.items()}
        out, trial = decode_step(params, trial, {"tokens": toks[:, j:j + 1]},
                                 cfg, rc)
        act = torch.from_numpy(counts > j)
        for k, v in cache.items():
            if v.ndim == 1:
                v.copy_(torch.where(act, trial[k], v))
            else:
                v[:, act] = trial[k][:, act]
        logits[act] = out[act]
    return logits


def test_the_batched_families():
    """The dense (GQA and MLA: minicpm3), vision, MoE (olmoe, granite), SSM
    (falcon-mamba) and hybrid (recurrentgemma) families batch their
    columns; the encoder (hubert) does not."""
    got = {name for name in ARCHS if batches_columns(get_reduced(name))}
    assert got == set(BATCHED)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", list(range(1, 17)))
@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "glm4-9b",
                                  "olmoe-1b-7b", "granite-moe-3b-a800m",
                                  "falcon-mamba-7b", "recurrentgemma-2b",
                                  "minicpm3-4b"])
def test_chunk_equals_token_decode(arch, width, dtype):
    cfg = get_reduced(arch)
    rc = RunConfig(dtype=dtype, param_dtype=dtype, remat=False)
    params = prepare_params(init_model_params(2, cfg, device="cpu"), cfg,
                            rc)
    chunk = _cache(cfg, rc.dtype, 3)
    token = {k: v.clone() for k, v in chunk.items()}
    rng = np.random.default_rng(width)
    for counts in ((0, 1, max(width // 2, 1), width),
                   (width, 0, 1, max(width - 1, 1))):
        n = np.array(counts, np.int32)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (4, width)))
        got, _ = prefill_step(params, chunk, {
            "tokens": toks, "n_tokens": torch.from_numpy(n)}, cfg, rc)
        want = _token_prefill(params, token, toks, n, cfg, rc)
        assert torch.equal(got, want), counts
        for k in chunk:
            assert torch.equal(chunk[k], token[k]), (counts, k)


@pytest.mark.parametrize("arch", ["nemotron-4-340b", "pixtral-12b"])
def test_chunk_equals_token_decode_other_families(arch):
    """relu2's FFN (nemotron) and the vision family's decode (pixtral) at
    width 8."""
    cfg = get_reduced(arch)
    rc = RunConfig(dtype="float32", remat=False)
    params = init_model_params(4, cfg, device="cpu")
    chunk = _cache(cfg, torch.float32, 5)
    token = {k: v.clone() for k, v in chunk.items()}
    n = np.array([8, 0, 3, 1], np.int32)
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, (4, 8)))
    got, _ = prefill_step(params, chunk, {
        "tokens": toks, "n_tokens": torch.from_numpy(n)}, cfg, rc)
    assert torch.equal(got, _token_prefill(params, token, toks, n, cfg, rc))
    for k in chunk:
        assert torch.equal(chunk[k], token[k]), k


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("arch", BATCHED)
def test_batched_chunk_matches_jax(arch):
    """Two chunks of width 8 over 4 slots (counts 0, 1, 5, 8, then 8, 0,
    3, 1) from lengths 2, 0, 5, 1: logits and every cache leaf within
    2e-3 of the JAX ``prefill_step``, lengths equal."""
    cfg_j, cfg_t = jax_reduced(arch), get_reduced(arch)
    jrc, trc = JRC(dtype="float32", remat=False), RunConfig(
        dtype="float32", remat=False)
    pj = jax_init_params(jax.random.PRNGKey(7), cfg_j)
    pt = bridge.from_numpy_tree(_np(pj), "cpu")
    cache_t = _cache(cfg_t, torch.float32, 8)
    cache_j = {k: jnp.asarray(v.numpy().copy()) for k, v in cache_t.items()}
    rng = np.random.default_rng(9)
    for counts in ((0, 1, 5, 8), (8, 0, 3, 1)):
        toks = rng.integers(0, cfg_j.vocab, (4, 8))
        n = np.array(counts, np.int32)
        lj, cache_j = jax_prefill(pj, cache_j, {
            "tokens": jnp.asarray(toks, jnp.int32),
            "n_tokens": jnp.asarray(n)}, cfg_j, jrc)
        lt, cache_t = prefill_step(pt, cache_t, {
            "tokens": torch.from_numpy(toks),
            "n_tokens": torch.from_numpy(n)}, cfg_t, trc)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        for k, v in _np(cache_j).items():
            if v.dtype.kind == "i":
                np.testing.assert_array_equal(cache_t[k].numpy(), v)
            else:
                np.testing.assert_allclose(cache_t[k].numpy(), v, **TOL)


@pytest.mark.parametrize("arch", ["glm4-9b", "nemotron-4-340b",
                                  "minicpm3-4b"])
def test_batched_steps_run_no_data_dependent_op(arch):
    cfg = get_reduced(arch)
    rc = RunConfig(dtype="float32", remat=False)
    params = init_model_params(3, cfg, device="cpu")
    cache = _cache(cfg, torch.float32, 0)
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab, (4, 4)))
    n = torch.tensor([0, 1, 3, 4], dtype=torch.int32)
    with NoHostRoundTrip():
        prefill_step(params, cache, {"tokens": toks, "n_tokens": n}, cfg, rc)
        decode_step(params, cache, {"tokens": toks[:, :1]}, cfg, rc)


@pytest.mark.parametrize("step", ["prefill", "decode"])
def test_every_product_runs_in_slabs_of_the_slots(monkeypatch, step):
    """Each product of a chunk (C x B rows) and of a decode step (B rows)
    is asked for row by row in slabs of B = 4, the head's too: on the card
    the thin kernel takes them all, whatever M."""
    seen = []
    real = qm_ops._product

    def recording(x, w, depth_x, depth_w, policy, slab=None):
        seen.append((x.shape[0], slab))
        return real(x, w, depth_x, depth_w, policy, slab)

    monkeypatch.setattr(qm_ops, "_product", recording)
    cfg = get_reduced("phi3-mini-3.8b")
    rc = RunConfig(dtype="bfloat16", param_dtype="bfloat16", remat=False)
    params = init_model_params(0, cfg, device="cpu")
    cache = _cache(cfg, torch.bfloat16, 1)
    toks = torch.ones((4, 8), dtype=torch.int64)
    if step == "prefill":
        prefill_step(params, cache, {"tokens": toks, "n_tokens": torch.tensor(
            [8, 8, 3, 0], dtype=torch.int32)}, cfg, rc)
        rows = {32, 4}
    else:
        decode_step(params, cache, {"tokens": toks[:, :1]}, cfg, rc)
        rows = {4}
    # 7 products a layer and the head
    assert len(seen) == 7 * cfg.n_layers + 1
    assert {m for m, _ in seen} == rows
    assert all(slab == 4 for _, slab in seen)


def test_the_plain_slab_product_is_one_product_a_slab():
    """On the CPU a row-by-row product equals the slabs' products bit for
    bit, one row a slab included (where the CPU's one-row product rounds
    unlike a many-row one)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((12, 96), generator=g)
    w = torch.randn((96, 80), generator=g)
    for slab in (1, 3, 4, 12):
        got = queue_matmul(x, w, slab=slab)
        want = torch.cat([queue_matmul(x[i:i + slab], w)
                          for i in range(0, 12, slab)])
        assert torch.equal(got, want), slab
    with pytest.raises(ValueError, match="slab must be >= 1"):
        queue_matmul(x, w, slab=0)


def test_rms_norm_wrapper_is_the_models_norm_on_the_cpu():
    g = torch.Generator().manual_seed(1)
    before = rms_norm.launches
    for dtype in (torch.float32, torch.bfloat16, torch.float64):
        x = torch.randn((3, 5, 64), generator=g).to(dtype)
        gamma = (0.1 * torch.randn((64,), generator=g)).to(dtype)
        out = rms_norm(x, gamma, 1e-5)
        assert out.dtype == dtype
        assert torch.equal(out, rms_norm_ref(x, gamma, 1e-5))
        assert torch.equal(out, layers.rms_norm(x, gamma, 1e-5))
    assert rms_norm.launches == before
    with pytest.raises(ValueError, match="gamma"):
        rms_norm(torch.ones((2, 8)), torch.ones((4,)))


def test_decode_attention_wrapper_on_the_cpu():
    """The rows version on the CPU: each column's queries keep their bits
    whatever columns run with them, and agree with the one-column
    attention to fp32 rounding at valid lengths (C, B), a length of 0 (the
    mean of V, as the plain softmax gives) and one past T included."""
    g = torch.Generator().manual_seed(2)
    C, B, Hq, Hkv, T, D = 5, 2, 4, 2, 10, 8
    q = torch.randn((C, B, Hq, D), generator=g)
    k = torch.randn((B, Hkv, T, D), generator=g)
    v = torch.randn((B, Hkv, T, D), generator=g)
    valid = torch.tensor([[0, 4], [11, 5], [3, 6], [1, 7], [10, 8]],
                         dtype=torch.int32)
    before = decode_attention.launches
    out = decode_attention(q, k, v, valid)
    assert decode_attention.launches == before
    assert torch.equal(out, decode_attention_rows_ref(q, k, v, valid))
    for c in range(C):
        assert torch.equal(decode_attention(q[c:c + 1], k, v,
                                            valid[c:c + 1]), out[c:c + 1])
        one = decode_attention_ref(q[c][:, :, None], k, v, valid[c])
        torch.testing.assert_close(out[c], one[:, :, 0], rtol=1e-5,
                                   atol=1e-5)
    torch.testing.assert_close(out[0, 0], v[0].mean(dim=1).repeat_interleave(
        Hq // Hkv, dim=0))
    with pytest.raises(ValueError, match="do not agree"):
        decode_attention(q, k, v, valid[:, :1])


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "glm4-9b",
                                  "recurrentgemma-2b"])
def test_a_chunk_wider_than_the_cache_equals_token_decode(arch):
    """A bucket of 16 columns over caches of 8 rows (a chunk wider than
    ``max_len``: its masked columns' positions wrap onto the rows its
    active ones write; recurrentgemma's ring of 8 rows, shorter than its
    window of 16, attends the columns at once): still token decode's
    bits, logits and every cache leaf."""
    cfg = get_reduced(arch)
    rc = RunConfig(dtype="float32", remat=False)
    params = init_model_params(6, cfg, device="cpu")
    chunk = init_cache(cfg, 4, 8, torch.float32, device="cpu")
    chunk["len"].copy_(torch.tensor([0, 2, 1, 0], dtype=torch.int32))
    token = {k: v.clone() for k, v in chunk.items()}
    n = np.array([0, 1, 5, 8], np.int32)
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab, (4, 16)))
    got, _ = prefill_step(params, chunk, {
        "tokens": toks, "n_tokens": torch.from_numpy(n)}, cfg, rc)
    assert torch.equal(got, _token_prefill(params, token, toks, n, cfg, rc))
    for k in chunk:
        assert torch.equal(chunk[k], token[k]), k


#: each ring branch of recurrentgemma-smoke (window 16): the cache's rows,
#: whether the attention runs one column at a time, the starting lengths
#: and two chunks (width, counts)
RINGS = {"window": (32, True, (2, 0, 13, 1),
                    ((8, (8, 0, 8, 3)), (6, (1, 6, 5, 0)))),
         "whole cache": (8, False, (2, 0, 1, 0),
                         ((8, (3, 0, 4, 2)), (6, (1, 6, 2, 0))))}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ring", list(RINGS))
def test_the_hybrid_rings_equal_token_decode(ring, dtype):
    """recurrentgemma-smoke in both ring branches, every state leaf drawn,
    logits and every cache leaf token decode's bits over two chunks: caches
    of 32 rows, a ring of the window, whose attention runs one column at a
    time (positions up to 25, so a chunk's later rows wrap onto rows its
    earlier ones read); and caches of 8 rows, a ring shorter than the
    window (the whole cache, positions below 8 as a served prompt's are),
    whose attention runs the columns at once."""
    max_len, by_column, lens, chunks = RINGS[ring]
    cfg = get_reduced("recurrentgemma-2b")
    rc = RunConfig(dtype=dtype, param_dtype=dtype, remat=False)
    params = prepare_params(init_model_params(5, cfg, device="cpu"), cfg,
                            rc)
    chunk = _cache(cfg, rc.dtype, 4, max_len)
    chunk["len"].copy_(torch.tensor(lens, dtype=torch.int32))
    assert _attends_by_column(cfg, chunk) == by_column
    token = {k: v.clone() for k, v in chunk.items()}
    rng = np.random.default_rng(8)
    for width, counts in chunks:
        n = np.array(counts, np.int32)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (4, width)))
        got, _ = prefill_step(params, chunk, {
            "tokens": toks, "n_tokens": torch.from_numpy(n)}, cfg, rc)
        assert torch.equal(got, _token_prefill(params, token, toks, n, cfg,
                                               rc)), counts
        for k in chunk:
            assert torch.equal(chunk[k], token[k]), (counts, k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", [24, 40])
def test_a_wide_ssm_chunk_is_one_body(monkeypatch, width, dtype):
    """falcon-mamba-smoke, whose cache holds no K/V rows: a chunk of 24 or
    40 columns runs as one body (each layer's ``in_proj`` one product over
    all the chunk's rows) and equals token decode bit for bit, logits and
    every cache leaf, at counts 0, 1, a partial and a whole chunk, then a
    second chunk."""
    cfg = get_reduced("falcon-mamba-7b")
    rc = RunConfig(dtype=dtype, param_dtype=dtype, remat=False)
    params = prepare_params(init_model_params(6, cfg, device="cpu"), cfg,
                            rc)
    chunk = _cache(cfg, rc.dtype, 7)
    token = {k: v.clone() for k, v in chunk.items()}
    rng = np.random.default_rng(width)
    rows, real = [], qm_ops._product

    def recording(x, w, depth_x, depth_w, policy, slab=None):
        rows.append(x.shape[0])
        return real(x, w, depth_x, depth_w, policy, slab)

    for counts in ((0, 1, width // 2, width), (width, 3, 0, width - 1)):
        n = np.array(counts, np.int32)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (4, width)))
        rows.clear()
        with monkeypatch.context() as mp:
            mp.setattr(qm_ops, "_product", recording)
            got, _ = prefill_step(params, chunk, {
                "tokens": toks, "n_tokens": torch.from_numpy(n)}, cfg, rc)
        # 4 products a layer and the head, all but the head over C x B rows
        assert rows == [4 * width] * (4 * cfg.n_layers) + [4]
        assert torch.equal(got, _token_prefill(params, token, toks, n, cfg,
                                               rc)), counts
        for k in chunk:
            assert torch.equal(chunk[k], token[k]), (counts, k)


@pytest.mark.parametrize("step", ["prefill", "decode"])
@pytest.mark.parametrize("arch,max_len,chunk_rows,body", [
    ("falcon-mamba-7b", 32, {32: 8, 4: 1}, 9),
    # 4 RG-LRU layers of 5 products, 5 FFNs of 3 and 1 attention layer of
    # 4, and the head: the attention with a ring shorter than the window
    # over the chunk's rows, else over one column's 4 at a time
    ("recurrentgemma-2b", 8, {32: 39, 4: 1}, 40),
    ("recurrentgemma-2b", 32, {32: 35, 4: 33}, 40)])
def test_the_recurrent_products_run_in_slabs_of_the_slots(
        monkeypatch, arch, max_len, chunk_rows, body, step):
    """Each product of a falcon-mamba or recurrentgemma chunk (C x B rows,
    or B rows for an attention layer run by column) and of a decode step
    (B rows) is asked for row by row in slabs of B = 4, the head's too."""
    seen = []
    real = qm_ops._product

    def recording(x, w, depth_x, depth_w, policy, slab=None):
        seen.append((x.shape[0], slab))
        return real(x, w, depth_x, depth_w, policy, slab)

    monkeypatch.setattr(qm_ops, "_product", recording)
    cfg = get_reduced(arch)
    rc = RunConfig(dtype="bfloat16", param_dtype="bfloat16", remat=False)
    params = init_model_params(0, cfg, device="cpu")
    cache = _cache(cfg, torch.bfloat16, 1, max_len)
    toks = torch.ones((4, 8), dtype=torch.int64)
    if step == "prefill":
        prefill_step(params, cache, {"tokens": toks, "n_tokens": torch.tensor(
            [8, 8, 3, 0], dtype=torch.int32)}, cfg, rc)
        want = chunk_rows
    else:
        decode_step(params, cache, {"tokens": toks[:, :1]}, cfg, rc)
        want = {4: body}
    got = {}
    for m, _ in seen:
        got[m] = got.get(m, 0) + 1
    assert got == want
    assert all(slab == 4 for _, slab in seen)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_an_mla_chunk_across_max_len_equals_token_decode_and_jax(dtype):
    """minicpm3-smoke over caches of 8 rows from lengths 5, 0, 7, 3, every
    leaf drawn: a chunk of counts 0, 1, a partial (4) and a whole chunk
    (8), then one of 8, 6, 1 and 0, so that several active columns of one
    slot clamp onto row 7 (slot 2 from its first column, slot 3 after four
    unique rows), a slot stops short of it and one reaches it only in the
    second chunk.  Logits and every cache leaf token decode's bits; in
    fp32 also within 2e-3 of the JAX ``prefill_step`` on bridged weights,
    lengths equal."""
    arch = "minicpm3-4b"
    cfg_j, cfg_t = jax_reduced(arch), get_reduced(arch)
    rc = RunConfig(dtype=dtype, param_dtype=dtype, remat=False)
    pj = jax_init_params(jax.random.PRNGKey(3), cfg_j)
    pt = prepare_params(bridge.from_numpy_tree(_np(pj), "cpu"), cfg_t, rc)
    chunk = _cache(cfg_t, rc.dtype, 4, max_len=8)
    chunk["len"].copy_(torch.tensor([5, 0, 7, 3], dtype=torch.int32))
    token = {k: v.clone() for k, v in chunk.items()}
    cache_j = {k: jnp.asarray(v.float().numpy() if v.is_floating_point()
                              else v.numpy().copy())
               for k, v in chunk.items()}
    rng = np.random.default_rng(5)
    for counts in ((0, 1, 4, 8), (8, 6, 1, 0)):
        n = np.array(counts, np.int32)
        toks = rng.integers(0, cfg_t.vocab, (4, 8))
        got, _ = prefill_step(pt, chunk, {
            "tokens": torch.from_numpy(toks),
            "n_tokens": torch.from_numpy(n)}, cfg_t, rc)
        want = _token_prefill(pt, token, torch.from_numpy(toks), n, cfg_t,
                              rc)
        assert torch.equal(got, want), counts
        for k in chunk:
            assert torch.equal(chunk[k], token[k]), (counts, k)
        if dtype != "float32":
            continue
        lj, cache_j = jax_prefill(pj, cache_j, {
            "tokens": jnp.asarray(toks, jnp.int32),
            "n_tokens": jnp.asarray(n)}, cfg_j, JRC(dtype="float32",
                                                     remat=False))
        np.testing.assert_allclose(got.numpy(), np.asarray(lj), **TOL)
        for k, v in _np(cache_j).items():
            if v.dtype.kind == "i":
                np.testing.assert_array_equal(chunk[k].numpy(), v)
            else:
                np.testing.assert_allclose(chunk[k].numpy(), v, **TOL)
    assert chunk["len"].tolist() == [13, 7, 12, 11]
