"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the JAX package's, with ``tuple(...) ==``: every arch of the registry at
full size, every shape it supports, the 16 x 16 and 2 x 16 x 16
production meshes (JAX's ``AbstractMesh`` on one side, the port's on the
other), FSDP on and off; and the reference's rule tests
(``tests/test_distributed.py``) on the port."""
import pytest

torch = pytest.importorskip("torch")

import jax
from jax.sharding import AbstractMesh as JaxAbstractMesh
from jax.sharding import PartitionSpec as JP

from _calibration_isolation import isolated_calibration  # noqa: F401
from repro.config import RunConfig as JRC
from repro.configs import ARCHS, get_config as jax_config
from repro.distributed import sharding as jsh
from repro_torch.config import SHAPES, RunConfig, supported_shapes
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as tsh
from repro_torch.launch.mesh import AbstractMesh, production_mesh

MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


def _jax_mesh(multi_pod: bool) -> JaxAbstractMesh:
    shape, names = MESHES[multi_pod]
    try:
        return JaxAbstractMesh(shape, names)
    except TypeError:                   # jax 0.4.x: ((name, size), ...)
        return JaxAbstractMesh(tuple(zip(names, shape)))


def _jax_flat(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {"/".join(str(k.key) for k in path): tuple(p)
            for path, p in leaves}


def _flat(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    assert isinstance(tree, tsh.PartitionSpec), tree
    return {prefix: tuple(tree)}


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_placements_equal_the_reference(arch, multi_pod, fsdp):
    """Parameters, and for each supported shape the inputs (caches
    included), the caches and the logits."""
    jm, tm = _jax_mesh(multi_pod), production_mesh(multi_pod=multi_pod)
    assert tm.shape == dict(zip(jm.axis_names, MESHES[multi_pod][0]))
    jcfg, tcfg = jax_config(arch), get_config(arch)
    want = _jax_flat(jsh.param_pspecs(jcfg, jm, JRC(fsdp=fsdp)))
    got = _flat(tsh.param_pspecs(tcfg, tm, RunConfig(fsdp=fsdp)))
    assert got == want
    import repro.config as jconfig
    for name in supported_shapes(tcfg):
        js, ts = jconfig.SHAPES[name], SHAPES[name]
        assert _flat(tsh.input_pspecs(tcfg, ts, tm)) == \
            _jax_flat(jsh.input_pspecs(jcfg, js, jm))
        assert _flat(tsh.cache_pspecs(tcfg, ts, tm)) == \
            _jax_flat(jsh.cache_pspecs(jcfg, js, jm))
        assert tuple(tsh.logits_pspec(tcfg, ts, tm)) == \
            tuple(jsh.logits_pspec(jcfg, js, jm))


MESH = AbstractMesh(("data", "model"), (16, 16))
P = tsh.PartitionSpec


def _find(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


@pytest.mark.parametrize("arch,fsdp,path,want", [
    # attention heads over model; FSDP adds data on the embed dim
    ("phi3-mini-3.8b", False, "blocks/attn/wq", (P(None, None, "model"),)),
    ("phi3-mini-3.8b", True, "blocks/attn/wq", (P(None, "data", "model"),)),
    # kv_heads = 2 < model = 16: replicated
    ("glm4-9b", False, "blocks/attn/wk", (P(None, None, None), P())),
    # olmoe's 64 experts over model; granite's 40 fall back to the expert
    # hidden dim
    ("olmoe-1b-7b", False, "blocks/ffn/wi", (P(None, "model"),)),
    ("granite-moe-3b-a800m", False, "blocks/ffn/wi",
     (P(None, None, None, "model"),)),
    # the vocabulary over model
    ("phi3-mini-3.8b", False, "embed", (P("model"),)),
    ("phi3-mini-3.8b", False, "head", (P("model"),))])
def test_rule(arch, fsdp, path, want):
    """The reference's rule tests (``tests/test_distributed.py:35-66``)."""
    specs = tsh.param_pspecs(get_config(arch), MESH, RunConfig(fsdp=fsdp))
    assert _find(specs, path) in want


@pytest.mark.parametrize("shape,axes", [((64, 64), ("heads", "ff")),
                                        ((64, 64, 64),
                                         ("embed", "experts", "lora"))])
def test_leaf_pspec_never_reuses_axis(shape, axes):
    spec = tsh._leaf_pspec(shape, axes, MESH, fsdp=True)
    used = [a for a in spec if a is not None]
    assert len(used) == len(set(used))


def test_partition_spec_is_the_reference_tuple():
    """A spec compares with the reference's ``P`` by ``tuple(...)``, keeps
    what it is given (no trailing ``None`` dropped but by
    ``_leaf_pspec``) and prints as a spec."""
    for dims in ((("pod", "data"), None), (("data",), None), ((), "model")):
        assert tuple(P(*dims)) == tuple(JP(*dims))
    assert tuple(tsh._leaf_pspec((64, 8), ("ff", None), MESH, False)) == \
        ("model",)
    assert repr(P("model", None)) == "P('model', None)"


def test_mesh_module_touches_no_process_group():
    import torch.distributed as dist
    import repro_torch.launch.mesh as mesh
    assert not dist.is_initialized()
    assert mesh.production_mesh(multi_pod=True).size == 512
    assert mesh.axis_sizes(mesh.production_mesh()) == {"data": 16,
                                                       "model": 16}


def test_rules_on_a_production_device_mesh():
    """``make_production_mesh`` under PyTorch's fake process group (256
    ranks, in a child process, so no test inherits the group): the rules
    resolve on the ``DeviceMesh`` as on its ``AbstractMesh``, and
    ``to_placements`` names the mesh dims a spec shards."""
    import os
    import subprocess
    import sys
    child = (
        "import torch.distributed as dist\n"
        "from torch.testing._internal.distributed.fake_pg import FakeStore\n"
        "from repro_torch.config import RunConfig\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.distributed import sharding as s\n"
        "from repro_torch.launch import mesh as m\n"
        "dist.init_process_group('fake', store=FakeStore(), rank=0,\n"
        "                        world_size=256)\n"
        "dm = m.make_production_mesh(device_type='cpu')\n"
        "cfg, rc = get_config('phi3-mini-3.8b'), RunConfig(fsdp=True)\n"
        "assert m.axis_sizes(dm) == {'data': 16, 'model': 16}\n"
        "assert s.param_pspecs(cfg, dm, rc) == s.param_pspecs(\n"
        "    cfg, m.production_mesh(), rc)\n"
        "wq = s.param_pspecs(cfg, dm, rc)['blocks']['attn']['wq']\n"
        "print(wq, s.to_placements(wq, dm))\n"
        "dist.destroy_process_group()\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", child], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ,
                                  PYTHONPATH=os.path.join(root, "src")))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == \
        "P(None, 'data', 'model') (Shard(dim=1), Shard(dim=2))"
