"""Logical-axis -> mesh-axis resolution (DP / TP / FSDP / EP / SP).

The JAX package's rules, rule for rule: every parameter leaf carries
logical axis names (:class:`~repro_torch.models.layers.ParamSpec`), and
mesh axes are assigned greedily by priority with divisibility checks, so
e.g. granite-moe's 40 experts (not divisible by model=16) fall back to
sharding the expert hidden dim instead, with no per-arch special case.

The rules read a mesh's axis names and sizes only, so they resolve on an
:class:`~repro_torch.launch.mesh.AbstractMesh` (no devices, no process
group) or a ``DeviceMesh`` alike.  A result is a :class:`PartitionSpec`:
one entry per tensor dim, each a mesh-axis name, a tuple of names or
``None``, trailing ``None`` s dropped where the reference drops them
(:func:`_leaf_pspec`).  :func:`to_placements` turns one into DTensor
placements on a ``DeviceMesh``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from ..config import ModelConfig, RunConfig, ShapeConfig
from ..launch.mesh import axis_sizes
from ..models.layers import ParamSpec, logical_axes_tree
from ..models.model import param_specs
from ..models.ssm import ssm_dims

Pytree = Any


class PartitionSpec(tuple):
    """Mesh axes per tensor dim: a name, a tuple of names, or ``None``.  As
    JAX's, a tuple of one name is kept as the name and an empty tuple as
    ``None``."""

    def __new__(cls, *dims):
        def canon(d):
            if isinstance(d, tuple):
                return None if not d else d[0] if len(d) == 1 else d
            return d
        return super().__new__(cls, tuple(canon(d) for d in dims))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec

#: logical axis -> (priority, mesh-axis candidates).  Lower priority wins the
#: mesh axis when several dims of one leaf could take it.
RULES: Dict[str, Tuple[int, Tuple[str, ...]]] = {
    "vocab": (0, ("model",)),
    "heads": (0, ("model",)),
    "kv_heads": (0, ("model",)),
    "experts": (0, ("model",)),
    "inner": (0, ("model",)),
    "inner2": (0, ("model",)),
    "ff": (1, ("model",)),
    "expert_ff": (1, ("model",)),
    "lora": (2, ("model",)),
    "embed": (5, ("data",)),        # ZeRO-3/FSDP, only when rc.fsdp
}


def _leaf_pspec(shape: Tuple[int, ...], axes: Tuple[Optional[str], ...],
                mesh, fsdp: bool) -> P:
    sizes = axis_sizes(mesh)
    taken: set = set()
    assign: list = [None] * len(shape)
    order = sorted(range(len(shape)),
                   key=lambda i: RULES.get(axes[i], (99, ()))[0])
    for i in order:
        name = axes[i]
        if name is None or name not in RULES:
            continue
        if name == "embed" and not fsdp:
            continue
        for cand in RULES[name][1]:
            if cand in taken or cand not in sizes:
                continue
            if shape[i] % sizes[cand] == 0 and shape[i] >= sizes[cand]:
                assign[i] = cand
                taken.add(cand)
                break
    while assign and assign[-1] is None:
        assign.pop()
    return P(*assign)


def param_pspecs(cfg: ModelConfig, mesh, rc: RunConfig) -> Pytree:
    """A :class:`PartitionSpec` per leaf of :func:`param_specs`' tree."""
    def walk(specs, axes):
        if isinstance(specs, ParamSpec):
            return _leaf_pspec(specs.shape, axes, mesh, rc.fsdp)
        return {k: walk(specs[k], axes[k]) for k in specs}
    specs = param_specs(cfg)
    return walk(specs, logical_axes_tree(specs))


def _batch_axes(mesh, batch: int) -> Optional[Tuple[str, ...]]:
    """Shard the batch over ('pod','data') when divisible, else 'data',
    else replicate (e.g. long_500k's batch of 1)."""
    sizes = axis_sizes(mesh)
    axes = [a for a in ("pod", "data") if a in sizes]
    size = 1
    for a in axes:
        size *= sizes[a]
    if axes and batch % size == 0 and batch >= size:
        return tuple(axes)
    if "data" in sizes and batch % sizes["data"] == 0 \
            and batch >= sizes["data"]:
        return ("data",)
    return None


def _model_axis(mesh, dim: int) -> Optional[str]:
    sizes = axis_sizes(mesh)
    if "model" in sizes and dim % sizes["model"] == 0 \
            and dim >= sizes["model"]:
        return "model"
    return None


def input_pspecs(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Pytree:
    """PartitionSpecs in the structure of
    :func:`~repro_torch.models.input_specs`."""
    b = _batch_axes(mesh, shape.global_batch)
    base: Dict[str, Any] = {}
    if shape.mode == "decode":
        base["tokens"] = P(b)
        base["cache"] = cache_pspecs(cfg, shape, mesh)
        return base
    if cfg.frontend == "audio":
        base["frames"] = P(b, None, None)
    else:
        base["tokens"] = P(b, None)
        if cfg.frontend == "vision":
            base["patches"] = P(b, None, None)
    if shape.mode == "train":
        base["labels"] = P(b, None)
    return base


def cache_pspecs(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Pytree:
    """PartitionSpecs in the structure of
    :func:`~repro_torch.models.cache_spec`."""
    b = _batch_axes(mesh, shape.global_batch)
    out: Dict[str, Any] = {"len": P(b)}   # per-sequence positions: (B,)
    if cfg.family == "ssm":
        d_in, _, _ = ssm_dims(cfg)
        out["ssm"] = P(None, b, _model_axis(mesh, d_in), None)
        out["conv"] = P(None, b, None, _model_axis(mesh, d_in))
        return out
    if cfg.family == "hybrid":
        w = cfg.rglru.lru_width or cfg.d_model
        out["h"] = P(None, b, _model_axis(mesh, w))
        out["conv"] = P(None, b, None, _model_axis(mesh, w))
        out["k"] = _kv_cache_spec(cfg, mesh, b, cfg.rglru.window)
        out["v"] = _kv_cache_spec(cfg, mesh, b, cfg.rglru.window)
        return out
    if cfg.mla:
        # the latent cache's sequence dim over 'model' (flash-decode: the
        # softmax and contraction over the sharded axis become small sums,
        # storage divides TP-ways without a gather)
        t_ax = _model_axis(mesh, shape.seq_len)
        out["latent"] = P(None, b, t_ax, None)
        out["rope"] = P(None, b, t_ax, None)
        return out
    out["k"] = _kv_cache_spec(cfg, mesh, b, shape.seq_len)
    out["v"] = _kv_cache_spec(cfg, mesh, b, shape.seq_len)
    return out


def _kv_cache_spec(cfg: ModelConfig, mesh, b, seq_len: int) -> P:
    """(L, B, Hkv, T, hd) cache: heads over 'model' when divisible, else
    the sequence dim (flash-decode semantics) — the capacity fix for
    kv_heads < TP (pixtral 8, nemotron 8, glm4 2)."""
    h_ax = _model_axis(mesh, cfg.n_kv_heads)
    if h_ax is not None:
        return P(None, b, h_ax, None, None)
    return P(None, b, None, _model_axis(mesh, seq_len), None)


def logits_pspec(cfg: ModelConfig, shape: ShapeConfig, mesh) -> P:
    b = _batch_axes(mesh, shape.global_batch)
    v = _model_axis(mesh, cfg.vocab)
    if shape.mode == "decode":
        return P(b, v)
    return P(b, None, v)


def to_placements(spec: P, mesh) -> tuple:
    """DTensor placements of ``spec`` on a ``DeviceMesh``: ``Shard(d)`` on
    each mesh dim that tensor dim ``d`` names, ``Replicate()`` on the
    others."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, ax in enumerate(spec)
                if ax == name or (isinstance(ax, tuple) and name in ax)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)
