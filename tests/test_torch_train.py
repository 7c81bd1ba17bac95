"""The PyTorch port's training path against the JAX package's, on the CPU
at reduced sizes, fp32: the loss and every gradient leaf of
``train.step.loss_fn`` for every reduced architecture (remat on and off;
the frontends with their patches or frames), three
``train_step``s, microbatch accumulation, the data stream, the
fault-tolerant driver and the launcher.

Tolerances: the loss within 2e-5 of the reference's (both fp32, summed in
other orders); a gradient leaf within rtol 2e-3 and an atol of 2e-3 of
its largest entry (the logits' own 2e-3, tests/test_models.py:90, scaled
to the leaf; measured up to 3e-4 of it).  Over three AdamW steps the two
packages drift apart where a gradient entry is near zero: Adam's first
updates are nearly sign(g), so fp32 rounding of such an entry can flip
it, and the flip moves that weight by up to 2 lr (on the same gradients
one step agrees to an ulp, tests/test_torch_optim.py).  So after three
steps every weight is held within 3 lr, at least 98% of each leaf within
1e-5, each later step's loss within 1e-4 and its gradient norm within 1%
(the first step's within 2e-5 and 2e-4)."""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.config import RunConfig as JRC
from repro.configs import get_reduced as jax_reduced
from repro.data import PrefetchLoader as JaxPrefetchLoader
from repro.data import SyntheticLMStream as JaxStream
from repro.models import init_model_params as jax_init_params
from repro.optim import init_opt_state as jax_init_opt
from repro.train.step import _grads as jax_grads
from repro.train.step import loss_fn as jax_loss_fn
from repro.train.step import train_step as jax_train_step
from repro_torch import bridge
from repro_torch.config import RunConfig, ShapeConfig, resolve_run_config
from repro_torch.configs import get_reduced
from repro_torch.data import PrefetchLoader, SyntheticLMStream
from repro_torch.models import init_model_params
from repro_torch.optim import init_opt_state
from repro_torch.runtime import FaultTolerantTrainer, InjectedFault
from repro_torch.train import loss_fn, make_train_step, train_step
from repro_torch.train.step import _grads

ARCHS = ["phi3-mini-3.8b", "glm4-9b", "minicpm3-4b", "olmoe-1b-7b",
         "granite-moe-3b-a800m", "falcon-mamba-7b", "recurrentgemma-2b",
         "nemotron-4-340b", "pixtral-12b", "hubert-xlarge"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _setup(arch, seed=3):
    cfg_j, cfg_t = jax_reduced(arch), get_reduced(arch)
    pj = jax_init_params(jax.random.PRNGKey(seed), cfg_j)
    return cfg_j, cfg_t, pj, bridge.from_numpy_tree(_np(pj), "cpu")


def _batch(vocab, B=2, S=16, seed=5, step=0):
    b = JaxStream(vocab, S, B, seed=seed).batch_at(step)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _with_frontend(cfg, bj, bt, seed=8):
    """The stream's batch with the frontend's inputs, as the reference's
    tests/test_models.py ``_batch`` makes them (0.1 of a normal draw,
    here from numpy): pixtral's patches beside the tokens, hubert's
    frames in their place."""
    if not cfg.frontend:
        return bj, bt
    rng = np.random.default_rng(seed)
    B, S = bt["labels"].shape
    if cfg.frontend == "audio":
        key, shape = "frames", (B, S, cfg.d_model)
        bj = {"labels": bj["labels"]}
        bt = {"labels": bt["labels"]}
    else:
        key, shape = "patches", (B, cfg.n_frontend_tokens, cfg.d_model)
    x = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    return {**bj, key: jnp.asarray(x)}, {**bt, key: torch.from_numpy(x)}


def _assert_tree_close(got, ref, rtol=2e-3, scale=2e-3, path=""):
    """Every leaf of the port's tree ``got`` within rtol and an atol of
    ``scale`` times the leaf's largest reference entry."""
    assert sorted(got) == sorted(ref), path
    for k, r in ref.items():
        if isinstance(r, dict):
            _assert_tree_close(got[k], r, rtol, scale, f"{path}/{k}")
        else:
            g = got[k].detach().numpy()
            assert g.shape == r.shape, f"{path}/{k}"
            np.testing.assert_allclose(
                g, r, rtol=rtol, atol=scale * float(np.abs(r).max()),
                err_msg=f"{path}/{k}")


_REF_GRADS = {}


def _reference_grads(arch):
    """JAX's loss and gradients for ``arch`` (remat off; its remat only
    recomputes), once per test process."""
    if arch not in _REF_GRADS:
        cfg_j, _, pj, _ = _setup(arch)
        bj, _ = _with_frontend(cfg_j, *_batch(cfg_j.vocab))
        (loss, _), g = jax.value_and_grad(jax_loss_fn, has_aux=True)(
            pj, bj, cfg_j, JRC(dtype="float32", remat=False))
        _REF_GRADS[arch] = (float(loss), _np(g))
    return _REF_GRADS[arch]


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch, remat):
    """``loss_fn``'s value and the gradient of every parameter leaf, with
    the port's forward under ``torch.utils.checkpoint`` (remat) or not,
    against ``jax.value_and_grad`` of the reference's ``loss_fn``; with
    the frontends' patches or frames, and hubert's ``embed``, which its
    loss never reads, all zeros as JAX's."""
    ref_loss, ref_g = _reference_grads(arch)
    _, cfg_t, _, pt = _setup(arch)
    _, bt = _with_frontend(cfg_t, *_batch(cfg_t.vocab))
    g, metrics = _grads(pt, bt, cfg_t, RunConfig(dtype="float32",
                                                 remat=remat))
    assert abs(float(metrics["loss"]) - ref_loss) <= 2e-5
    _assert_tree_close(g, ref_g)
    # the parameters are left as they were given: no grad attached
    assert not any(p.requires_grad for p in jax.tree_util.tree_leaves(pt))


def test_remat_runs_each_layer_twice_and_keeps_the_loss():
    """Under remat every layer's forward runs again in the backward (the
    attention op is called 2 L times), and the loss is the same bits."""
    from repro_torch.kernels.flash_attention import ops
    _, cfg, _, pt = _setup("phi3-mini-3.8b")
    _, bt = _batch(cfg.vocab)
    calls = []
    real = ops._FlashAttentionFn.forward

    def spy(ctx, *args):
        calls.append(1)
        return real(ctx, *args)
    ops._FlashAttentionFn.forward = staticmethod(spy)
    try:
        losses = []
        for remat in (False, True):
            calls.clear()
            g, m = _grads(pt, bt, cfg, RunConfig(dtype="float32",
                                                 remat=remat))
            losses.append(m["loss"])
            assert len(calls) == cfg.n_layers * (2 if remat else 1)
    finally:
        ops._FlashAttentionFn.forward = staticmethod(real)
    assert torch.equal(losses[0], losses[1])


def test_three_train_steps_match_reference():
    """Three AdamW ``train_step``s from the same weights on the stream's
    first three batches: the losses, the learning rates, the gradient
    norms and every parameter after the last step."""
    cfg_j, cfg_t, pj, pt = _setup("phi3-mini-3.8b", seed=0)
    lr = 1e-4
    jrc = JRC(dtype="float32", remat=False, lr=lr, warmup_steps=2,
              total_steps=10)
    trc = RunConfig(dtype="float32", remat=False, lr=lr, warmup_steps=2,
                    total_steps=10)
    oj, ot = jax_init_opt(pj), init_opt_state(pt)
    for step in range(3):
        bj, bt = _batch(cfg_j.vocab, B=4, step=step)
        pj, oj, mj = jax_train_step(pj, oj, bj, cfg_j, jrc)
        pt, ot, mt = train_step(pt, ot, bt, cfg_t, trc)
        assert abs(float(mt["loss"]) - float(mj["loss"])) <= (
            2e-5 if step == 0 else 1e-4)
        np.testing.assert_allclose(float(mt["lr"]), float(mj["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(mt["grad_norm"]),
                                   float(mj["grad_norm"]),
                                   rtol=2e-4 if step == 0 else 1e-2)
    assert int(ot.step) == int(oj.step) == 3
    ref = jax.tree_util.tree_leaves(_np(pj))
    for got, want in zip(jax.tree_util.tree_leaves(
            bridge.to_numpy_tree(pt)), ref):
        err = np.abs(got - want)
        assert err.max() <= 3 * lr
        assert (err > 1e-5 + 1e-5 * np.abs(want)).mean() <= 0.02


def test_microbatch_two_matches_reference_microbatch_two():
    """``rc.microbatch = 2``: the two halves' gradients summed and halved
    and the mean loss, against the reference's scan; and against the
    full batch's, as the reference's own test holds it (1e-3)."""
    cfg_j, cfg_t, pj, pt = _setup("phi3-mini-3.8b", seed=0)
    bj, bt = _batch(cfg_j.vocab, B=4)
    gj, mj = jax_grads(pj, bj, cfg_j, JRC(dtype="float32", remat=False,
                                          microbatch=2))
    g2, m2 = _grads(pt, bt, cfg_t, RunConfig(dtype="float32", remat=False,
                                             microbatch=2))
    assert abs(float(m2["loss"]) - float(mj["loss"])) <= 2e-5
    _assert_tree_close(g2, _np(gj))
    g1, _ = _grads(pt, bt, cfg_t, RunConfig(dtype="float32", remat=False))
    _assert_tree_close(g2, bridge.to_numpy_tree(g1), rtol=1e-3, scale=1e-3)
    with pytest.raises(ValueError, match="microbatches"):
        _grads(pt, {k: v[:3] for k, v in bt.items()}, cfg_t,
               RunConfig(dtype="float32", microbatch=2))


def test_train_step_with_grad_compression_moves_the_weights():
    """int8-compressed gradients (the generator seeded with the step, as
    the reference keys it) still give a finite step that moves every
    weight matrix, and the same seed gives the same step."""
    _, cfg, _, pt = _setup("phi3-mini-3.8b", seed=0)
    rc = RunConfig(dtype="float32", remat=False, lr=1e-2,
                   grad_compression=True)
    _, bt = _batch(cfg.vocab)
    outs = []
    for _ in range(2):
        p = bridge.from_numpy_tree(bridge.to_numpy_tree(pt), "cpu")
        p, o, m = train_step(p, init_opt_state(p), bt, cfg, rc)
        assert np.isfinite(float(m["loss"])) and int(o.step) == 1
        outs.append(p)
    assert not torch.equal(outs[0]["blocks"]["ffn"]["wi"],
                           pt["blocks"]["ffn"]["wi"])
    assert torch.equal(outs[0]["blocks"]["ffn"]["wi"],
                       outs[1]["blocks"]["ffn"]["wi"])


def test_loss_decreases_over_steps():
    """The reference's own check (tests/test_substrate.py:56): 30 steps on
    one batch take the loss below 0.8 of its first value."""
    _, cfg, _, pt = _setup("phi3-mini-3.8b", seed=0)
    rc = RunConfig(remat=False, dtype="float32", lr=1e-2, warmup_steps=5,
                   total_steps=100)
    _, bt = _batch(cfg.vocab, B=4)
    opt = init_opt_state(pt)
    first = None
    for _ in range(30):
        pt, opt, m = train_step(pt, opt, bt, cfg, rc)
        first = float(m["loss"]) if first is None else first
    assert float(m["loss"]) < 0.8 * first


def test_make_train_step_resolves_the_train_workload():
    """The step factory resolves the ``"train"`` operating point once, as
    the port's ``resolve_run_config`` does, and checks the batch shape."""
    cfg = get_reduced("phi3-mini-3.8b")
    shape = ShapeConfig("t", 16, 2, "train")
    step = make_train_step(cfg, shape, RunConfig(dtype="float32"),
                           device="cpu")
    rc, op = resolve_run_config(RunConfig(dtype="float32"), "train")
    assert step.rc == rc and step.operating_point == op
    params = bridge.from_numpy_tree(
        _np(jax_init_params(jax.random.PRNGKey(0), jax_reduced(
            "phi3-mini-3.8b"))), "cpu")
    batch = SyntheticLMStream(cfg.vocab, 16, 2).batch_at(0)
    _, opt, m = step(params, init_opt_state(params), batch)
    assert int(opt.step) == 1 and np.isfinite(float(m["loss"]))
    with pytest.raises(ValueError, match="tokens for a step"):
        step(params, opt, SyntheticLMStream(cfg.vocab, 8, 2).batch_at(0))


def test_make_train_step_names_a_missing_frontend_input():
    """pixtral's step trains on patches too: a batch without them raises
    a KeyError naming them (the reference's step fails on the same key);
    with them it takes a finite step."""
    cfg = get_reduced("pixtral-12b")
    shape = ShapeConfig("t", 16, 2, "train")
    step = make_train_step(cfg, shape, RunConfig(dtype="float32"),
                           device="cpu")
    params = init_model_params(0, cfg, device="cpu")
    batch = SyntheticLMStream(cfg.vocab, 16, 2).batch_at(0)
    with pytest.raises(KeyError, match="patches"):
        step(params, init_opt_state(params), batch)
    batch["patches"] = (np.random.default_rng(0).standard_normal(
        (2, cfg.n_frontend_tokens, cfg.d_model)) * 0.1).astype(np.float32)
    _, opt, m = step(params, init_opt_state(params), batch)
    assert int(opt.step) == 1 and np.isfinite(float(m["loss"]))


# --- data -------------------------------------------------------------------

@pytest.mark.parametrize("seed,dp_rank,dp_size", [(0, 0, 1), (7, 0, 2),
                                                  (7, 1, 2), (123, 3, 4)])
def test_stream_equals_reference(seed, dp_rank, dp_size):
    """The copied stream gives the JAX package's batches bit for bit."""
    for vocab, S, B in ((100, 16, 4), (32064, 33, 8)):
        a = SyntheticLMStream(vocab, S, B, seed=seed, dp_rank=dp_rank,
                              dp_size=dp_size)
        b = JaxStream(vocab, S, B, seed=seed, dp_rank=dp_rank,
                      dp_size=dp_size)
        for step in (0, 1, 12, 999):
            x, y = a.batch_at(step), b.batch_at(step)
            assert sorted(x) == sorted(y) == ["labels", "tokens"]
            for k in x:
                assert x[k].dtype == y[k].dtype
                np.testing.assert_array_equal(x[k], y[k])


def test_prefetch_loader_orders_batches_as_reference():
    s = SyntheticLMStream(100, 8, 2, seed=1)
    loader = PrefetchLoader(s, start_step=3, depth=2)
    ref = JaxPrefetchLoader(JaxStream(100, 8, 2, seed=1), start_step=3,
                            depth=2)
    try:
        for step in range(3, 7):
            got, want = loader.get(), ref.get()
            np.testing.assert_array_equal(got["tokens"],
                                          s.batch_at(step)["tokens"])
            np.testing.assert_array_equal(got["tokens"], want["tokens"])
    finally:
        loader.close()
        ref.close()
    assert not loader._thread.is_alive()


# --- driver and launcher ------------------------------------------------------

def test_trainer_recovers_from_injected_fault_with_equal_losses(tmp_path):
    """A fault at step 17 restores the step-10 checkpoint and replays steps
    10..16; their losses equal the first pass's bit for bit."""
    cfg = get_reduced("phi3-mini-3.8b")
    shape = ShapeConfig("tiny", 16, 4, "train")
    rc = RunConfig(remat=False, dtype="float32", lr=1e-2, warmup_steps=5,
                   total_steps=100)
    params = bridge.from_numpy_tree(_np(jax_init_params(
        jax.random.PRNGKey(0), jax_reduced("phi3-mini-3.8b"))), "cpu")
    faults = {17}

    def fault_hook(step):
        if step in faults:
            faults.discard(step)
            raise InjectedFault(f"device loss @ {step}")

    tr = FaultTolerantTrainer(cfg, shape, rc, "cpu", str(tmp_path),
                              ckpt_every=10, fault_hook=fault_hook)
    out = tr.run(params, num_steps=25)
    assert out["restarts"] == 1 and out["step"] == 25
    seen = {}
    for step, loss in out["metrics"]:
        seen.setdefault(step, []).append(loss)
    assert [s for s, v in seen.items() if len(v) == 2] == list(range(10, 17))
    for s in range(10, 17):
        assert seen[s][0] == seen[s][1]
    assert sorted(os.listdir(tmp_path)) == ["step_00000010",
                                            "step_00000020",
                                            "step_00000025"]
    tr.ckpt.close()


@pytest.mark.parametrize("arch,name,flags", [
    ("phi3-mini-3.8b", "phi3-mini-smoke", ()),
    ("granite-moe-3b-a800m", "granite-moe-smoke", ("--remat",)),
    ("falcon-mamba-7b", "falcon-mamba-7b-smoke", ("--remat",)),
    ("recurrentgemma-2b", "recurrentgemma-smoke", ("--dtype", "bfloat16"))])
def test_launch_train_reduced_on_the_cpu(tmp_path, arch, name, flags):
    """``python -m repro_torch.launch.train --reduced --device cpu`` trains
    one model of each family and prints the reference launcher's lines."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         arch, "--reduced", "--device", "cpu", "--steps", "4",
         "--batch", "2", "--seq", "16", "--ckpt-every", "2", "--ckpt-dir",
         str(tmp_path), *flags], capture_output=True, text=True, env=env,
        timeout=300, check=True).stdout.splitlines()
    assert out[0].startswith(f"arch={name} params=")
    assert out[1].startswith("policy=copiftv2 (source=default")
    assert out[2].startswith("finished 4 steps in")
    assert out[3].startswith("loss: first~")
    assert "step_00000004" in os.listdir(tmp_path)


@pytest.mark.parametrize("arch,missing", [("pixtral-12b", "patches"),
                                          ("hubert-xlarge", "frames")])
def test_launch_train_names_the_input_the_stream_lacks(arch, missing):
    """The synthetic stream gives tokens and labels only, as the
    reference's: the launcher exits before it draws a weight, naming the
    frontend's input."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         "--reduced", "--device", "cpu", "--steps", "2"],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0 and missing in out.stderr
    assert "params=" not in out.stdout


def test_loss_fn_metrics():
    """Loss and accuracy of known logits (a one-hot sum, as the
    reference's)."""
    cfg_j, cfg_t, pj, pt = _setup("phi3-mini-3.8b")
    bj, bt = _batch(cfg_j.vocab)
    lj, mj = jax_loss_fn(pj, bj, cfg_j, JRC(dtype="float32", remat=False))
    lt, mt = loss_fn(pt, bt, cfg_t, RunConfig(dtype="float32", remat=False))
    assert abs(float(lt) - float(lj)) <= 2e-5
    assert float(mt["accuracy"]) == pytest.approx(float(mj["accuracy"]))


def test_forward_checkpoints_only_when_a_gradient_is_taken(monkeypatch):
    """``rc.remat`` (the ``RunConfig`` default) runs the layers under
    ``torch.utils.checkpoint`` only when a parameter requires grad: a
    serving ``forward`` in grad mode is not checkpointed."""
    import repro_torch.models.model as model_mod
    calls = []
    real = model_mod.checkpoint

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)
    monkeypatch.setattr(model_mod, "checkpoint", spy)
    _, cfg, _, pt = _setup("phi3-mini-3.8b")
    _, bt = _batch(cfg.vocab)
    model_mod.forward(pt, bt, cfg, RunConfig(dtype="float32"))
    assert calls == []
    _grads(pt, bt, cfg, RunConfig(dtype="float32"))
    assert len(calls) == cfg.n_layers
