"""The serve step as one program per chunk width: ``prefill_step`` and
``decode_step`` of the PyTorch port run nothing that a CUDA graph's capture
refuses, for the five families the engine serves — dense GQA
(phi3-mini-smoke), MoE (olmoe-smoke), SSM (falcon-mamba-smoke), hybrid with
its window ring (recurrentgemma-smoke) and MLA (minicpm3-smoke).

* Under a ``TorchDispatchMode``, neither step reads a tensor back to the
  host (``aten._local_scalar_dense``), makes a shape from the data
  (``nonzero``, ``masked_select``, ``unique``, a boolean index) or makes a
  tensor from host data (``lift_fresh``).
* A chunk whose counts are all zero leaves every cache leaf bit for bit.
* Mixed counts (0, 1, a partial chunk, a whole one) over two chunks give
  logits and cache rows within 2e-3 of the JAX ``prefill_step`` on the
  same numpy inputs and bridged weights (the reference's tolerance for
  logits, tests/test_models.py:90).
* A bucket wider than the chunk (masked columns that run, as the
  reference's scan runs them) equals one column at a time bit for bit.
* The engine, whose steps are :class:`~repro_torch.serve.graphs.CapturedStep`
  programs (eager here, on the CPU), equals the JAX engine's tokens, steps
  and ``prefill_compiles``, one program per width.

Every family here, MLA included, runs a chunk as one batched body, the
decode step that body at C = 1 (tests/test_torch_chunk_body.py holds it to
token decode bit for bit, MLA's across ``max_len`` too)."""
import pytest

torch = pytest.importorskip("torch")

from _calibration_isolation import isolated_calibration  # noqa: F401

import jax
import jax.numpy as jnp
import numpy as np
from torch.utils._python_dispatch import TorchDispatchMode

from repro.config import RunConfig as JRC
from repro.configs import get_reduced as jax_reduced
from repro.core.policy import PolicyTable as JPolicyTable
from repro.models import init_cache as jax_init_cache
from repro.models import init_model_params as jax_init_params
from repro.models import prefill_step as jax_prefill
from repro.serve import ServeEngine as JaxEngine
from repro_torch import bridge
from repro_torch.config import RunConfig
from repro_torch.configs import get_reduced
from repro_torch.models import (decode_step, init_cache, init_model_params,
                                prefill_step)
from repro_torch.serve import ServeEngine
from repro_torch.serve.graphs import CapturedStep

ARCHS = ["phi3-mini-3.8b", "olmoe-1b-7b", "falcon-mamba-7b",
         "recurrentgemma-2b", "minicpm3-4b"]
RC = RunConfig(dtype="float32", remat=False)
JRC_ = JRC(dtype="float32", remat=False)
TOL = dict(rtol=2e-3, atol=2e-3)

#: ops whose result a capture cannot hold: a read back to the host, or a
#: shape that depends on the data
REFUSED = ("_local_scalar_dense", "nonzero", "masked_select", "lift_fresh")


class NoHostRoundTrip(TorchDispatchMode):
    """Fails on an op of :data:`REFUSED`, any ``unique``, and an index or
    index write through a boolean mask."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name.lstrip("_").startswith("unique") or name in REFUSED:
            raise AssertionError(f"data-dependent op {func}")
        if name.startswith("index"):
            idx = args[1] if len(args) > 1 else ()
            if any(isinstance(t, torch.Tensor) and t.dtype in (torch.bool,
                                                               torch.uint8)
                   for t in (idx if isinstance(idx, (list, tuple)) else ())):
                raise AssertionError(f"boolean index in {func}")
        return func(*args, **(kwargs or {}))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _filled_cache(cfg, batch, max_len, seed):
    """A cache of ``batch`` slots whose state leaves hold a seeded normal
    draw (0.1 of it) and whose slots sit at lengths 2, 0, 3, 1, ..."""
    cache = init_cache(cfg, batch, max_len, torch.float32, device="cpu")
    rng = np.random.default_rng(seed)
    for k, v in cache.items():
        if k == "len":
            v.copy_(torch.tensor([(2, 0, 3, 1)[i % 4] for i in range(batch)],
                                 dtype=torch.int32))
        else:
            v.copy_(torch.from_numpy(
                (rng.standard_normal(v.shape) * 0.1).astype(np.float32)))
    return cache


@pytest.mark.parametrize("arch", ARCHS)
def test_steps_run_no_data_dependent_op(arch):
    cfg = get_reduced(arch)
    params = init_model_params(3, cfg, device="cpu")
    cache = _filled_cache(cfg, 4, 16, 0)
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab, (4, 4)))
    n = torch.tensor([0, 1, 3, 4], dtype=torch.int32)
    with NoHostRoundTrip():
        prefill_step(params, cache, {"tokens": toks, "n_tokens": n}, cfg, RC)
        decode_step(params, cache, {"tokens": toks[:, :1]}, cfg, RC)


def test_the_mode_catches_host_reads():
    """The mode is no vacuous pass: each kind of op it refuses fails."""
    x = torch.arange(4.0)
    for fn in (lambda: bool((x > 1).any()), lambda: x[x > 1],
               lambda: torch.nonzero(x), lambda: torch.unique(x),
               lambda: torch.tensor(1.0) + x):
        with pytest.raises(AssertionError):
            with NoHostRoundTrip():
                fn()


@pytest.mark.parametrize("arch", ARCHS)
def test_zero_counts_are_a_no_op(arch):
    cfg = get_reduced(arch)
    params = init_model_params(4, cfg, device="cpu")
    cache = _filled_cache(cfg, 3, 16, 2)
    before = {k: v.clone() for k, v in cache.items()}
    toks = torch.from_numpy(
        np.random.default_rng(3).integers(0, cfg.vocab, (3, 4)))
    logits, out = prefill_step(params, cache, {
        "tokens": toks, "n_tokens": torch.zeros(3, dtype=torch.int32)},
        cfg, RC)
    assert out is cache
    assert torch.equal(logits, torch.zeros_like(logits))
    for k, v in before.items():
        assert torch.equal(cache[k], v), k


@pytest.mark.parametrize("arch", ARCHS)
def test_mixed_counts_match_jax(arch):
    """Two chunks of width 8 over 4 slots: counts (0, 1, 5, 8), then
    (8, 0, 3, 1), from a cache at lengths 2, 0, 3, 1; logits and every
    cache leaf after each chunk."""
    cfg_j, cfg_t = jax_reduced(arch), get_reduced(arch)
    pj = jax_init_params(jax.random.PRNGKey(5), cfg_j)
    pt = bridge.from_numpy_tree(_np(pj), "cpu")
    cache_t = _filled_cache(cfg_t, 4, 24, 6)
    # copies: the port writes its cache in place, and a JAX array may
    # share a numpy buffer's memory while it is still being computed
    cache_j = {k: jnp.asarray(v.numpy().copy()) for k, v in cache_t.items()}
    assert set(cache_j) == set(_np(jax_init_cache(cfg_j, 4, 24,
                                                  jnp.float32)))
    rng = np.random.default_rng(7)
    for counts in ((0, 1, 5, 8), (8, 0, 3, 1)):
        toks = rng.integers(0, cfg_j.vocab, (4, 8))
        n = np.array(counts, np.int32)
        lj, cache_j = jax_prefill(pj, cache_j, {
            "tokens": jnp.asarray(toks, jnp.int32),
            "n_tokens": jnp.asarray(n)}, cfg_j, JRC_)
        lt, cache_t = prefill_step(pt, cache_t, {
            "tokens": torch.from_numpy(toks),
            "n_tokens": torch.from_numpy(n)}, cfg_t, RC)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        for k, v in _np(cache_j).items():
            if v.dtype.kind == "i":
                np.testing.assert_array_equal(cache_t[k].numpy(), v)
            else:
                np.testing.assert_allclose(cache_t[k].numpy(), v, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_wide_bucket_equals_token_prefill(arch):
    """Prompts of 5, 3, 0 and 7 tokens in one bucket of 8 (its last
    column masked for every slot) against one column at a time: each
    slot's last logits and every cache leaf keep their bits."""
    cfg = get_reduced(arch)
    params = init_model_params(8, cfg, device="cpu")
    toks = torch.from_numpy(
        np.random.default_rng(9).integers(0, cfg.vocab, (4, 8)))
    lens = np.array([5, 3, 0, 7])
    out = {}
    for width in (8, 1):
        cache = _filled_cache(cfg, 4, 24, 10)
        last = torch.zeros((4, cfg.vocab))
        for j in range(0, 8, width):
            n = np.clip(lens - j, 0, width).astype(np.int32)
            logits, cache = prefill_step(params, cache, {
                "tokens": toks[:, j:j + width],
                "n_tokens": torch.from_numpy(n)}, cfg, RC)
            last[n > 0] = logits[n > 0]
        out[width] = (last, cache)
    assert torch.equal(out[8][0], out[1][0])
    for k in out[8][1]:
        assert torch.equal(out[8][1][k], out[1][1][k]), k


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_programs_match_the_jax_engine(arch):
    """Chunk 4, two slots, five prompts of 1–9 tokens: the same tokens,
    engine steps and chunk programs as the JAX engine's; on the CPU each
    program is the eager call, run once per engine step."""
    cfg = jax_reduced(arch)
    pj = jax_init_params(jax.random.PRNGKey(0), cfg)
    pt = bridge.from_numpy_tree(_np(pj), "cpu")
    rng = np.random.default_rng(11)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab, n)]
               for n in (3, 9, 1, 6, 2)]
    jeng = JaxEngine(pj, cfg, JRC_, batch_slots=2, max_len=32,
                     prefill_chunk=4, policy_table=JPolicyTable())
    teng = ServeEngine(pt, get_reduced(arch), RC, batch_slots=2, max_len=32,
                       prefill_chunk=4, device="cpu")
    for p in prompts:
        jeng.submit(p, max_new=3)
        teng.submit(p, max_new=3)
    dj, dt = jeng.run(), teng.run()
    assert sorted(dj) == sorted(dt) == list(range(len(prompts)))
    for rid in dj:
        assert dj[rid].generated == dt[rid].generated, rid
    assert teng._n_steps == jeng._n_steps
    assert teng.prefill_compiles == jeng.prefill_compiles
    progs = teng.programs()
    assert teng.program_kind == "eager"
    assert sorted(progs) == sorted(
        ["decode"] * ("decode" in progs)
        + [f"prefill/{w}" for w in teng._prefill_fns])
    assert sum(p["calls"] for p in progs.values()) == teng._n_steps
    assert all(p["kind"] == "eager" and not p["captured"]
               and p["replays"] == 0 for p in progs.values())


def test_captured_step_reuses_its_static_buffers():
    """On the CPU a program copies each call's arrays into the same
    buffers and runs the step on them."""
    seen = []

    def fn(batch):
        seen.append({k: v for k, v in batch.items()})
        return batch["tokens"].sum(dim=1) + batch["n_tokens"]

    step = CapturedStep(fn, {"tokens": ((2, 3), torch.int64),
                             "n_tokens": ((2,), torch.int32)}, "cpu")
    a = step(tokens=np.array([[1, 2, 3], [4, 5, 6]]),
             n_tokens=np.array([1, 0], np.int32))
    assert a.tolist() == [7, 15]
    b = step(tokens=np.zeros((2, 3), np.int64),
             n_tokens=np.array([2, 2], np.int32))
    assert b.tolist() == [2, 2]
    assert seen[0]["tokens"] is seen[1]["tokens"] is step.inputs["tokens"]
    assert step.stats() == {"kind": "eager", "calls": 2, "captured": False,
                            "capture_s": 0.0, "pool_bytes": 0,
                            "replays": 0, "launches_per_replay": {}}
