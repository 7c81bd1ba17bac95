"""The port's roofline (``repro_torch.roofline``) and dry run
(``repro_torch.launch.dryrun``): H100 roofline terms, ``model_flops_for``,
``analytic_device_bytes`` and ``cell_tag`` equal to the JAX package's with
``==``; the one-card column against the depth cuts the card runs; the
meta device's FLOP count against ``FlopCounterMode``'s count of the same
call run for real on the CPU, against a count written out by hand, and
linear in depth; and the CLI over every cell."""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh as JaxAbstractMesh
from torch.utils.flop_counter import FlopCounterMode

from _calibration_isolation import isolated_calibration  # noqa: F401
import repro.config as jconfig
from repro.configs import ARCHS, get_config as jax_config
from repro.launch import dryrun as jdry
from repro.roofline import model_flops_for as jax_model_flops
from repro_torch.config import SHAPES, ShapeConfig, supported_shapes
from repro_torch.configs import get_config, get_reduced
from repro_torch.device import torch_dtype
from repro_torch.launch import dryrun as tdry
from repro_torch.launch.mesh import production_mesh
from repro_torch.models import (decode_step, forward, init_cache,
                                init_model_params, input_specs, param_specs)
from repro_torch.optim import init_opt_state
from repro_torch.roofline import (KINDS, Roofline, collective_bytes,
                                  model_flops_for)
from repro_torch.train.step import train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_mesh(multi_pod: bool) -> JaxAbstractMesh:
    shape, names = (((2, 16, 16), ("pod", "data", "model")) if multi_pod
                    else ((16, 16), ("data", "model")))
    try:
        return JaxAbstractMesh(shape, names)
    except TypeError:                   # jax 0.4.x: ((name, size), ...)
        return JaxAbstractMesh(tuple(zip(names, shape)))


# --- roofline -----------------------------------------------------------------

def test_roofline_terms():
    """The reference's test over one H100's rates: 989e12 FLOP/s, 3.35e12
    B/s of HBM, 18 NVLink links of 25e9 B/s."""
    r = Roofline(arch="a", shape="s", mesh="m", chips=256,
                 per_device_flops=989e12, per_device_bytes=3.35e12,
                 per_device_coll_bytes=450e9,
                 model_flops=989e12 * 256 * 0.5)
    assert abs(r.t_compute - 1.0) < 1e-9
    assert abs(r.t_memory - 1.0) < 1e-9
    assert abs(r.t_collective - 1.0) < 1e-9
    assert abs(r.mfu - 0.5) < 1e-9
    assert r.useful_flops_ratio == 0.5
    r.per_device_bytes = 2 * 3.35e12
    assert r.bottleneck == "memory" and r.to_dict()["step_time"] == 2.0


def test_collective_bytes_from_records():
    out = collective_bytes([("all-gather", 8192), ("all-reduce", 4096),
                            ("collective-permute", 4096),
                            ("all-gather", 10)])
    assert out == {"all-gather": 8202, "all-reduce": 4096,
                   "reduce-scatter": 0, "all-to-all": 0,
                   "collective-permute": 4096, "total": 16394}
    assert set(out) == set(KINDS) | {"total"}
    with pytest.raises(ValueError):
        collective_bytes([("broadcast", 1)])


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_the_reference(arch):
    for name in SHAPES:
        assert model_flops_for(get_config(arch), SHAPES[name]) == \
            jax_model_flops(jax_config(arch), jconfig.SHAPES[name])


# --- persistent state and tags --------------------------------------------------

@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_device_bytes_equal_the_reference(arch, multi_pod):
    jm, tm = _jax_mesh(multi_pod), production_mesh(multi_pod=multi_pod)
    for name in supported_shapes(get_config(arch)):
        js, ts = jconfig.SHAPES[name], SHAPES[name]
        assert tdry.analytic_device_bytes(
            get_config(arch), ts, tm, tdry.default_runconfig(ts)) == \
            jdry.analytic_device_bytes(jax_config(arch), js, jm,
                                       jdry.default_runconfig(js))


@pytest.mark.parametrize("arch,layers,state_gib,with_grad_gib", [
    # parameters + mu + nu at the depths the card trains
    ("phi3-mini-3.8b", None, 42.70, None),
    ("falcon-mamba-7b", 32, 43.62, None),
    ("pixtral-12b", 10, 45.47, None),
    # + the fp32 gradient: the depths the card could not take
    ("falcon-mamba-7b", None, None, 108.37),
    ("pixtral-12b", None, None, 182.51),
    ("olmoe-1b-7b", None, None, 103.10)])
def test_one_card_column(arch, layers, state_gib, with_grad_gib):
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    shape = SHAPES["train_4k"]
    rc = tdry.default_runconfig(shape)
    st = tdry.device_state_bytes(cfg, shape, tdry.ONE_CARD, rc)
    card = tdry.one_card(cfg, shape, rc)
    if state_gib is not None:
        assert round((st["params"] + st["opt"]) / 2**30, 2) == state_gib
        assert card["fits_one_card"]
    if with_grad_gib is not None:
        assert round(card["state_bytes"] / 2**30, 2) == with_grad_gib
        assert not card["fits_one_card"]
    n = sum(torch.Size(shape).numel()
            for shape in tdry._leaf_shapes(param_specs(cfg)))
    assert card["state_bytes"] == 16 * n


def test_serving_column_counts_the_caches():
    cfg = get_config("phi3-mini-3.8b")
    shape = SHAPES["decode_32k"]
    rc = tdry.default_runconfig(shape)
    st = tdry.device_state_bytes(cfg, shape, tdry.ONE_CARD, rc)
    kv = 2 * cfg.n_layers * 128 * cfg.n_kv_heads * 32768 * 96 * 2
    assert st["cache"] == kv + 128 * 4          # + the int32 lengths
    card = tdry.one_card(cfg, shape, rc)
    assert card["state_bytes"] == st["params"] + st["cache"]
    assert not card["fits_one_card"]


def test_cell_tags_equal_the_reference():
    for arch in ARCHS:
        for name in supported_shapes(get_config(arch)):
            for mp in (False, True):
                for policy in (None, "copift"):
                    for analysis in (False, True):
                        assert tdry.cell_tag(arch, name, mp, policy,
                                             analysis) == \
                            jdry.cell_tag(arch, name, mp, policy, analysis)


# --- FLOP counts ----------------------------------------------------------------

def _cpu_count(cfg, shape, rc) -> int:
    """``FlopCounterMode``'s count of the step run for real on the CPU, on
    seeded weights and inputs."""
    params = init_model_params(0, cfg, torch_dtype(rc.param_dtype), "cpu")
    gen = torch.Generator().manual_seed(1)

    def draw(sd):
        shp, dt = sd
        if dt in (torch.int32, torch.int64):
            return torch.randint(0, cfg.vocab, shp, generator=gen, dtype=dt)
        return torch.randn(shp, generator=gen).to(dt)
    specs = input_specs(cfg, shape, rc)
    with FlopCounterMode(display=False) as fc:
        if shape.mode == "decode":
            cache = init_cache(cfg, shape.global_batch, shape.seq_len,
                               rc.dtype, "cpu")
            decode_step(params, cache, {"tokens": draw(specs["tokens"])},
                        cfg, rc)
        else:
            batch = {k: draw(v) for k, v in specs.items()}
            if shape.mode == "train":
                train_step(params, init_opt_state(params), batch, cfg, rc)
            else:
                forward(params, batch, cfg, rc)
    return fc.get_total_flops()


FAMILIES = ("phi3-mini-3.8b", "olmoe-1b-7b", "falcon-mamba-7b",
            "recurrentgemma-2b", "minicpm3-4b", "pixtral-12b",
            "hubert-xlarge")


@pytest.mark.parametrize("arch,mode", [
    (arch, mode) for arch in FAMILIES for mode in ("prefill", "decode",
                                                   "train")
    if mode != "decode" or arch != "hubert-xlarge"])   # an encoder
def test_meta_count_equals_the_cpu_count(arch, mode):
    """The dry run's rc (bf16 compute; fp32 parameters, remat and AdamW in
    training; grouped MoE dispatch) on a reduced config: the meta device's
    count equals the CPU's, kernels' plain versions and all."""
    cfg = get_reduced(arch)
    shape = ShapeConfig(f"small_{mode}", 32, 2, mode)
    rc = tdry.default_runconfig(shape, "copiftv2")
    meta = tdry.count_flops(cfg, shape, rc)
    assert meta > 0 and meta == _cpu_count(cfg, shape, rc)


def test_phi3_prefill_count_by_hand():
    """phi3-mini-3.8b at full size, prefill_32k: every product 2 M N K —
    q, k, v, o, the SwiGLU FFN's three, the head — and attention's two
    products over every (query, key) pair, as its plain version computes
    them (masked scores too), per layer."""
    cfg = get_config("phi3-mini-3.8b")
    shape = SHAPES["prefill_32k"]
    B, S, d, H, hd = 32, 32768, 3072, 32, 96
    Hkv, ff, V, L = 32, 8192, 32064, 32
    assert (cfg.d_model, cfg.n_heads, cfg.resolved_head_dim, cfg.n_kv_heads,
            cfg.d_ff, cfg.vocab, cfg.n_layers) == (d, H, hd, Hkv, ff, V, L)
    T = B * S
    layer = (2 * T * d * H * hd              # q
             + 2 * 2 * T * d * Hkv * hd      # k, v
             + 2 * T * H * hd * d            # o
             + 3 * 2 * T * d * ff            # wi, wg, wo
             + 2 * 2 * B * H * S * S * hd)   # q k^T, p v
    want = L * layer + 2 * T * d * V         # + the head
    assert tdry.count_flops(cfg, shape, tdry.default_runconfig(shape)) == want


@pytest.mark.parametrize("shape_name", ["prefill_32k", "train_4k"])
@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "olmoe-1b-7b",
                                  "falcon-mamba-7b", "recurrentgemma-2b",
                                  "pixtral-12b", "hubert-xlarge"])
def test_count_is_linear_in_depth(arch, shape_name):
    """A(L) = A(1) + (L - 1)(A(2) - A(1)) at full width: the reference's
    two-point extrapolation, which the port's direct count checks."""
    cfg, shape = get_config(arch), SHAPES[shape_name]
    rc = tdry.default_runconfig(shape)
    a1, a2 = (tdry.count_flops(tdry._with_layers(cfg, u), shape, rc)
              for u in (1, 2))
    L = tdry._n_units(cfg)
    assert tdry.count_flops(cfg, shape, rc) == a1 + (L - 1) * (a2 - a1)


# --- the CLI ----------------------------------------------------------------

def test_cli_writes_every_cell(tmp_path):
    out_dir = tmp_path / "cells"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--mesh", "both", "--out-dir", str(out_dir)],
        capture_output=True, text=True, env=env, timeout=900)
    assert run.returncode == 0, run.stderr[-4000:]
    cells = list(tdry.all_cells())
    assert "FAIL" not in run.stdout
    assert run.stdout.count("OK  ") == len(cells)
    files = sorted(os.listdir(out_dir))
    assert len(files) == len(cells)
    for name in files:
        with open(out_dir / name) as f:
            art = json.load(f)
        assert art["ok"] and art["flops"]["step"] > 0
        assert art["roofline"]["per_device_flops"] * art["chips"] == \
            pytest.approx(art["flops"]["step"])
        assert isinstance(art["fits_one_card"], bool)
        assert art["collectives"]["total"] >= 0
