"""The port's example scripts (``repro_torch.examples.quickstart``,
``serve_batch``, ``train_lm``) against the JAX package's
``examples/*.py`` on the CPU, and every entry script of this slice
refusing to run on the CPU unless asked.

Tolerances: quickstart's loss at each step within 2e-5 of the reference
step's from the same state (tests/test_torch_train.py's one-step
tolerance; both fp32, summed in other orders), its decoded tokens
equal; serve_batch's tokens, engine steps, chunk programs and traffic
history equal with ``==``."""
import contextlib
import importlib.util
import io
import os
import runpy
import sys

import pytest

torch = pytest.importorskip("torch")

from _calibration_isolation import isolated_calibration  # noqa: F401

import jax
import jax.numpy as jnp
import numpy as np

from repro.config import RunConfig as JRC
from repro.configs import get_reduced as jax_reduced
from repro.models import init_model_params as jax_init_params
from repro.optim import OptState as JOptState
from repro.serve import ServeEngine as JaxEngine
from repro.train import train_step as jax_train_step
from repro_torch import bridge
from repro_torch.config import RunConfig
from repro_torch.configs import get_reduced
from repro_torch.examples import quickstart, serve_batch, train_lm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bridged(arch):
    cfg = jax_reduced(arch)
    pj = jax_init_params(jax.random.PRNGKey(0), cfg)
    return cfg, pj, bridge.from_numpy_tree(
        jax.tree_util.tree_map(np.asarray, pj), "cpu")


def _reference_module(name):
    """The JAX package's ``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"_reference_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_matches_reference(monkeypatch):
    """Five steps of the port's ``run`` on JAX's ``PRNGKey(0)`` weights,
    bridged.  Before each of its steps the reference's jitted
    ``train_step`` (the script's run config: lr 1e-2, warmup 2) takes the
    same step from the same weights, optimizer state and batch: every
    loss within 2e-5, the one-step tolerance of tests/test_torch_train.py.
    Then the reference's engine (two slots, ``max_len`` 64) decodes from
    the port's trained weights: the same 8 tokens.

    Each step is taken from the port's state, not run free: at lr 1e-2
    (100 x tests/test_torch_train.py's) two fp32 runs drift apart within a
    few steps, since an AdamW update of a near-zero gradient entry is
    nearly its sign and a flip moves the weight by up to 2 lr."""
    steps = 5
    cfg_j, _, pt = _bridged("phi3-mini-3.8b")
    rc = JRC(dtype="float32", param_dtype="float32", remat=False, lr=1e-2,
             warmup_steps=2, total_steps=steps)
    jstep = jax.jit(lambda p, o, b: jax_train_step(p, o, b, cfg_j, rc))
    ref_losses = []
    real = quickstart.train_step

    def shadowed(params, opt, batch, cfg, rc_t):
        pj = jax.tree_util.tree_map(jnp.asarray,
                                    bridge.to_numpy_tree(params))
        oj = JOptState(*jax.tree_util.tree_map(
            jnp.asarray, bridge.opt_state_to_numpy(opt)))
        _, _, mj = jstep(pj, oj, {k: jnp.asarray(v.numpy())
                                  for k, v in batch.items()})
        ref_losses.append(float(mj["loss"]))
        return real(params, opt, batch, cfg, rc_t)
    monkeypatch.setattr(quickstart, "train_step", shadowed)

    out = quickstart.run(pt, get_reduced("phi3-mini-3.8b"), steps, "cpu")
    assert len(out["losses"]) == len(ref_losses) == steps
    for i, (got, want) in enumerate(zip(out["losses"], ref_losses)):
        assert abs(got - want) <= 2e-5, (i, got, want)
    assert out["losses"][-1] < out["losses"][0]
    pj = jax.tree_util.tree_map(jnp.asarray, bridge.to_numpy_tree(pt))
    eng = JaxEngine(pj, cfg_j, rc, batch_slots=2, max_len=64)
    rid = eng.submit([1, 2, 3, 4], max_new=8)
    assert out["generated"] == eng.run()[rid].generated
    assert len(out["generated"]) == 8


def _port_lines(text):
    """The printed lines with the throughput (a wall time) taken out."""
    out = []
    for line in text.splitlines():
        if " tok/s, " in line:
            head, tail = line.split(" tokens, ", 1)
            line = head + " tokens, " + tail.split(" tok/s, ", 1)[1]
        out.append(line)
    return out


@pytest.mark.parametrize("prefill", ["chunked", "token"])
def test_serve_batch_matches_reference(prefill, monkeypatch):
    """glm4-smoke in fp32 on bridged weights: the reference script's
    printed lines (the throughput aside) and an engine built as the script
    builds it, against the port's ``run``: tokens, engine steps, chunk
    programs and traffic history equal with ``==``."""
    cfg_j, pj, pt = _bridged("glm4-9b")
    rc_j = JRC(dtype="float32", param_dtype="float32", remat=False)
    jeng = JaxEngine(pj, cfg_j, rc_j, batch_slots=3, max_len=128,
                     prefill=prefill)
    rids = [jeng.submit(p, max_new=10) for p in serve_batch.prompts(6)]
    done = jeng.run()

    monkeypatch.setattr(sys, "argv", ["serve_batch.py", "--prefill",
                                      prefill])
    ref_out = io.StringIO()
    with contextlib.redirect_stdout(ref_out):
        runpy.run_path(os.path.join(ROOT, "examples", "serve_batch.py"),
                       run_name="__main__")
    port_out = io.StringIO()
    with contextlib.redirect_stdout(port_out):
        got = serve_batch.run(pt, get_reduced("glm4-9b"),
                              RunConfig(dtype="float32",
                                        param_dtype="float32", remat=False),
                              6, 10, prefill, "cpu")
    assert _port_lines(port_out.getvalue()) == \
        _port_lines(ref_out.getvalue())
    assert got["tokens"] == [done[r].generated for r in rids]
    assert got["steps"] == jeng._n_steps
    assert got["prefill_compiles"] == jeng.prefill_compiles
    assert got["traffic_history"] == jeng.traffic_history
    assert got["traffic_level"] == jeng.traffic_level == "high"


def test_serve_batch_main_serves_the_reduced_config():
    """The CLI on the CPU serves glm4-9b's reduced config by default."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = serve_batch.main(["--device", "cpu", "--requests", "3",
                                "--max-new", "4"])
    assert "glm4-smoke: 3 requests, 12 tokens" in out.getvalue()
    assert [len(t) for t in got["tokens"]] == [4, 4, 4]


def test_train_lm_small_improves_and_checkpoints(tmp_path):
    """``--preset small --steps 20 --device cpu``: the loss improves (the
    script raises otherwise) and a checkpoint is written at the last
    step."""
    out = train_lm.main(["--preset", "small", "--steps", "20", "--device",
                         "cpu", "--ckpt-dir", str(tmp_path)])
    assert out["step"] == 20 and out["last"] < out["first"]
    assert len(out["metrics"]) == 20
    assert all(np.isfinite(loss) for _, loss in out["metrics"])
    assert "step_00000020" in os.listdir(tmp_path)


def test_train_lm_presets_equal_reference():
    """The presets verbatim, and each config's parameter count equal to
    the reference's.  ``n_params()`` gives the 100m preset 65,011,712
    (embedding and head 33.6 M, 8 layers of 3.9 M); the reference's
    docstring calls it ~115M."""
    from repro.config import ModelConfig as JModelConfig
    ref = _reference_module("train_lm")
    assert train_lm.PRESETS == ref.PRESETS
    for preset, p in ref.PRESETS.items():
        want = JModelConfig(name=f"lm-{preset}", family="dense",
                            n_layers=p["n_layers"], d_model=p["d_model"],
                            n_heads=p["n_heads"], n_kv_heads=p["n_kv_heads"],
                            d_ff=p["d_ff"], vocab=p["vocab"]).n_params()
        assert train_lm.model_config(preset).n_params() == want, preset
    assert train_lm.model_config("100m").n_params() == 65_011_712


# --- no script runs on the CPU without being asked -------------------------

def _entry_points():
    from repro_torch.benchmarks import (collective_policy, kernel_bench,
                                        run, serve_slo)
    return {"quickstart": quickstart.main, "serve_batch": serve_batch.main,
            "train_lm": train_lm.main, "kernel_bench": kernel_bench.main,
            "collective_policy": collective_policy.main,
            "serve_slo": lambda argv: serve_slo.cli(["--prefill", *argv]),
            "run": run.main}


@pytest.mark.parametrize("name", ["quickstart", "serve_batch", "train_lm",
                                  "kernel_bench", "collective_policy",
                                  "serve_slo", "run"])
def test_scripts_need_the_card_unless_asked(name, monkeypatch):
    """Without ``--device cpu`` every entry script that touches a device
    (``serve_slo`` under ``--prefill``: its simulated section runs on the
    host) raises the port's "no CUDA device" error here, before it draws a
    weight or starts a process."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        _entry_points()[name]([])
