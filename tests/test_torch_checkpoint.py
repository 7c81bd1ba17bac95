"""The port's checkpoints: round trip, keep-k, atomic publish, the async
writer's snapshot, and the same files as the JAX package's, so that a
checkpoint written by either package restores in the other (values
exact, dtypes kept, bf16 bit for bit, leaves in ``jax.tree_util``'s
order: dicts by sorted key, ``OptState`` by field).  The JAX package's
``restore`` cannot read a bf16 leaf back, its own or the port's (numpy
has no cast from the stored 2-byte void to bfloat16), so the port-to-JAX
direction carries fp32 and int32 leaves only."""
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.checkpoint import restore as jax_restore
from repro.checkpoint import save as jax_save
from repro.configs import get_reduced as jax_reduced
from repro.models import init_model_params as jax_init_params
from repro.optim import OptState as JaxOptState
from repro.optim import init_opt_state as jax_init_opt
from repro_torch import bridge
from repro_torch.checkpoint import (CheckpointManager, latest_step, restore,
                                    save)
from repro_torch.models.layers import tree_leaves
from repro_torch.optim import OptState, init_opt_state


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_state(bf16=True):
    params = jax_init_params(jax.random.PRNGKey(0),
                             jax_reduced("phi3-mini-3.8b"))
    opt = jax_init_opt(params)
    opt = JaxOptState(jnp.asarray(5, jnp.int32),
                      jax.tree_util.tree_map(lambda p: p * 0.5, opt.mu),
                      jax.tree_util.tree_map(lambda p: p + 0.25, opt.nu))
    out = {"params": params, "opt": opt}
    if bf16:
        out["half"] = jnp.linspace(-3, 3, 7).astype(jnp.bfloat16)
    return out


def _port_like(state_np):
    out = {"params": bridge.from_numpy_tree(state_np["params"], "cpu"),
           "opt": bridge.opt_state_from_numpy(state_np["opt"], "cpu")}
    if "half" in state_np:
        out["half"] = torch.zeros(7, dtype=torch.bfloat16)
    return out


def test_checkpoint_roundtrip(tmp_path):
    state = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
             "b": {"c": torch.tensor(3)},
             "h": torch.tensor([1.5, -2.25], dtype=torch.bfloat16)}
    save(str(tmp_path), 7, state, extra={"data_step": 7})
    like = {"a": torch.zeros(2, 3), "b": {"c": torch.tensor(0)},
            "h": torch.zeros(2, dtype=torch.bfloat16)}
    step, back, extra = restore(str(tmp_path), like)
    assert step == 7 and extra["data_step"] == 7
    for k in ("a", "h"):
        assert back[k].dtype == state[k].dtype
        assert torch.equal(back[k], state[k])
    assert back["b"]["c"].shape == () and int(back["b"]["c"]) == 3
    with pytest.raises(ValueError, match="mismatch"):
        restore(str(tmp_path), {"a": like["a"]})


def test_checkpoint_manager_async_keep_k(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2)
    for s in (10, 20, 30, 40):
        m.save_async(s, {"x": torch.tensor([s])})
    m.wait()
    m.close()
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)
                   if d.startswith("step_"))
    assert steps == [30, 40]
    assert latest_step(str(tmp_path)) == 40
    assert not m._thread.is_alive()


def test_checkpoint_atomicity_no_tmp_left(tmp_path):
    save(str(tmp_path), 1, {"x": torch.ones(3)})
    save(str(tmp_path), 1, {"x": torch.zeros(3)})      # republished
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp")]
    assert torch.equal(restore(str(tmp_path), {"x": torch.ones(3)})[1]["x"],
                       torch.zeros(3))


def test_save_async_snapshots_before_queueing(tmp_path):
    """The caller updates its tensors in place right after ``save_async``;
    the checkpoint holds the values at the call."""
    x = torch.ones(1000)
    m = CheckpointManager(str(tmp_path), keep=3)
    m.save_async(1, {"x": x})
    x.mul_(7.0)
    m.wait()
    m.close()
    assert torch.equal(restore(str(tmp_path), {"x": x})[1]["x"],
                       torch.ones(1000))


def test_flattening_order_is_jax_tree_util_order():
    state_np = _np(_jax_state(bf16=False))
    got = [bridge.to_numpy_tree(t) for t in tree_leaves(_port_like(state_np))]
    want = jax.tree_util.tree_leaves(state_np)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == np.asarray(w).tobytes()


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    """JAX saves {params, OptState, a bf16 leaf}; the port restores it
    into its own structure, every value exact."""
    state = _jax_state()
    jax_save(str(tmp_path), 5, state, extra={"data_step": 5})
    state_np = _np(state)
    step, back, extra = restore(str(tmp_path), _port_like(state_np))
    assert step == 5 and extra == {"data_step": 5}
    assert isinstance(back["opt"], OptState)
    assert back["opt"].step.dtype == torch.int32 and int(back["opt"].step) == 5
    for got, want in zip(tree_leaves(back),
                         jax.tree_util.tree_leaves(state_np)):
        if got.dtype == torch.bfloat16:
            assert np.array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))
        else:
            np.testing.assert_array_equal(got.numpy(), want)


def test_port_checkpoint_restores_in_jax(tmp_path):
    """The port saves its trained-from-JAX state; JAX restores it into the
    reference's structure, every value exact, and the manifest describes
    the same tree."""
    state_np = _np(_jax_state(bf16=False))
    save(str(tmp_path / "port"), 9, _port_like(state_np),
         extra={"data_step": 9})
    step, back, extra = jax_restore(str(tmp_path / "port"),
                                    _jax_state(bf16=False))
    assert step == 9 and extra == {"data_step": 9}
    assert isinstance(back["opt"], JaxOptState)
    for got, want in zip(jax.tree_util.tree_leaves(_np(back)),
                         jax.tree_util.tree_leaves(state_np)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    jax_save(str(tmp_path / "jax"), 9, _jax_state(bf16=False))
    manifests = [json.load(open(tmp_path / d / "step_00000009" /
                                "manifest.json")) for d in ("port", "jax")]
    assert manifests[0]["treedef"] == manifests[1]["treedef"]
    assert manifests[0]["n_leaves"] == manifests[1]["n_leaves"]


def test_restore_onto_a_device_and_dtype_of_like(tmp_path):
    save(str(tmp_path), 2, {"w": torch.arange(4, dtype=torch.float32)})
    _, back, _ = restore(str(tmp_path),
                         {"w": torch.zeros(4, dtype=torch.float64)},
                         device="cpu")
    assert back["w"].dtype == torch.float64
    assert back["w"].tolist() == [0.0, 1.0, 2.0, 3.0]
    opt = init_opt_state({"w": torch.zeros(4)})
    save(str(tmp_path), 3, {"opt": opt})
    _, back, _ = restore(str(tmp_path), {"opt": opt})
    assert isinstance(back["opt"], OptState) and back["opt"].step.shape == ()
