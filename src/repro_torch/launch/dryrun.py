"""Multi-pod dry run of the port: every (arch x shape x mesh) cell counted on
the meta device, nothing allocated.

For each cell, one call of the cell's step (``train_step``, ``forward`` or
``decode_step``) runs on the meta device with the production run config:
parameters from ``param_shapes``, optimizer state from
``opt_state_shapes`` (``step`` a real CPU scalar: the optimizer and the
step read it on the host), inputs from ``input_specs`` and caches from
``cache_spec``.  ``torch.utils.flop_counter.FlopCounterMode`` counts the
call's FLOPs: every product of every layer, the kernels' through their
plain versions (each wrapper's meta path), remat's recomputed forward
included.  The port counts every layer, so it needs no two-point
extrapolation; the ``analysis`` variant records the same direct count
under its own tag.  A product the placements shard is split evenly over
the chips (the rules shard divisible dims only), so a device's FLOPs are
the count over the chips.

From the placements (:mod:`repro_torch.distributed.sharding`) on the
production mesh's axes (:func:`~repro_torch.launch.mesh.production_mesh`,
no process group) come:

- ``analytic_device_gb``: the bytes a device holds of the persistent state
  (parameters, AdamW moments, decode caches), the reference's formula;
- ``one_card``: parameters + ``mu`` + ``nu`` + the fp32 gradient
  (training), or parameters + caches (serving), on a 1 x 1 mesh, and
  ``fits_one_card`` against one card's 80 GB;
- the memory term: the least traffic a device's step needs, each
  persistent buffer and each input and output moved once: parameters read
  (prefill, decode) or read and written with the fp32 gradient written and
  read and ``mu``, ``nu`` read and written (training); caches read and
  written (decode); inputs read; logits written (not in training, where
  the loss consumes them);
- the collective term, the bytes the placements imply for one step on one
  device, as records for :func:`~repro_torch.roofline.collective_bytes`.
  With ``n_a`` the size of the mesh axes ``a``, ``s`` a leaf's bytes on
  one device and ``t`` the tokens a device holds (batch over its batch
  axes, times the sequence; one a sequence in decode):

  * FSDP gathers: each leaf sharded over a batch axis is gathered before
    use, ``s (n_data - 1)`` bytes (``all-gather``), once a forward: once
    in prefill and decode, twice in training (the forward, and remat's
    recomputed forward for the backward);
  * gradient reduction (training): each leaf's fp32 gradient is
    reduce-scattered over the batch axes that shard it, ``g (n - 1)``
    bytes with ``g`` its shard (``reduce-scatter``), and the shard
    all-reduced over the batch axes that do not, ``2 g (n - 1) / n``
    (``all-reduce``);
  * TP activation reductions: a weight that writes the residual stream
    (last logical axis ``embed``) with a contracting axis over ``model``
    (attention ``wo``, the FFN's ``wo``, the SSM and RG-LRU
    ``out_proj``, an expert ``wo`` sharded on its hidden dim) and the
    embedding lookup of a vocabulary over ``model`` end in an all-reduce
    of ``t x d_model`` activations, ``2 t d b (n_model - 1) / n_model``
    bytes (``all-reduce``, ``b`` the compute dtype's bytes); experts over
    ``model`` instead send each token's ``top_k`` rows out and back,
    ``2 t top_k d b (n_model - 1) / n_model`` (``all-to-all``); once a
    forward in prefill and decode, three times in training (the forward,
    remat's recomputed forward and the backward's input gradients).  The
    smaller reductions (the loss's log-sum-exp over a sharded vocabulary,
    the SSM's ``x_proj`` over its inner dim, MLA's low-rank projections)
    are left out.

  The port has no compiled module, so no HLO exists to hold this formula
  to; it is the placements' arithmetic, not a measurement.

Artifacts go to ``artifacts/dryrun_port/`` (``--out-dir``), one JSON file a
cell; ``artifacts/dryrun/`` is the JAX package's.
"""
import argparse
import dataclasses
import functools
import json
import os
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..config import SHAPES, ModelConfig, RunConfig, ShapeConfig, supported_shapes
from ..configs import ARCHS, get_config
from ..device import torch_dtype
from ..distributed.sharding import (_batch_axes, cache_pspecs, logits_pspec,
                                    param_pspecs)
from ..launch.mesh import AbstractMesh, axis_sizes, production_mesh
from ..models.layers import ParamSpec, tree_map
from ..models.model import (cache_spec, decode_step, forward, input_specs,
                            param_shapes, param_specs)
from ..optim import OptState, opt_state_shapes
from ..roofline import (HBM_BYTES, Roofline, collective_bytes,
                        model_flops_for)
from ..train.step import train_step

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "artifacts", "dryrun_port")

#: a 1 x 1 mesh: the one-card column
ONE_CARD = AbstractMesh(("data", "model"), (1, 1))


def resolved_operating_point(shape: ShapeConfig):
    """The cell's machine-model operating point, cluster geometry included,
    from the calibration-backed :class:`~repro_torch.core.policy.PolicyTable`
    (``REPRO_CALIBRATION_DIR`` honoured): training shapes resolve the
    ``train`` workload, prefill/decode the ``serve`` one."""
    from ..core.policy import default_table
    workload = "train" if shape.mode == "train" else "serve"
    return default_table().resolve(workload)


def default_runconfig(shape: ShapeConfig, policy: Optional[str] = None,
                      analysis: bool = False) -> RunConfig:
    from ..core.policy import ExecutionPolicy
    if policy is None:        # calibrated table point; explicit string wins
        policy = resolved_operating_point(shape).policy.value
    return RunConfig(policy=ExecutionPolicy.parse(policy),
                     dtype="bfloat16",
                     param_dtype="float32" if shape.mode == "train" else "bfloat16",
                     remat=(shape.mode == "train"),
                     fsdp=True,    # ZeRO-style weight sharding over 'data'
                     #   in inference too: a 341B model's bf16 weights are
                     #   43 GB/device under TP=16 alone
                     moe_dispatch="grouped",       # deployable dispatch path
                     attn_batch_shard=True,
                     analysis_mode=analysis)


def _with_layers(cfg: ModelConfig, units: int) -> ModelConfig:
    """A config with ``units`` repeating units (layers, or hybrid macros) —
    the tail of a hybrid config is kept verbatim."""
    if cfg.family == "hybrid":
        pat = len(cfg.rglru.pattern)
        tail = cfg.n_layers % pat
        return dataclasses.replace(cfg, n_layers=pat * units + tail)
    return dataclasses.replace(cfg, n_layers=units)


def _n_units(cfg: ModelConfig) -> int:
    if cfg.family == "hybrid":
        return cfg.n_layers // len(cfg.rglru.pattern)
    return cfg.n_layers


# ---------------------------------------------------------------------------
# the persistent state's bytes
# ---------------------------------------------------------------------------

def _per_dev(shape_, spec, sizes: Dict[str, int]) -> float:
    n = 1
    for d in shape_:
        n *= d
    div = 1
    for ax in spec:
        if ax is None:
            continue
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            div *= sizes[a]
    return n / div


def device_state_bytes(cfg: ModelConfig, shape: ShapeConfig, mesh,
                       rc: RunConfig) -> Dict[str, float]:
    """Bytes one device holds of the persistent state, from the leaf
    placements: ``params``, ``opt`` (AdamW's fp32 ``mu`` and ``nu``;
    training) and ``cache`` (decode).  Each is a sum of whole numbers (the
    rules shard divisible dims only), so it is exact."""
    sizes = axis_sizes(mesh)
    pdt = torch_dtype(rc.param_dtype).itemsize
    shapes = _leaf_shapes(param_specs(cfg))
    specs = [p for _, p, _ in _named_leaves(param_specs(cfg),
                                             param_pspecs(cfg, mesh, rc))]
    out = {"params": sum(_per_dev(s, p, sizes) * pdt
                         for s, p in zip(shapes, specs))}
    if shape.mode == "train":
        out["opt"] = 2 * sum(_per_dev(s, p, sizes) * 4
                             for s, p in zip(shapes, specs))
    if shape.mode == "decode":
        cspec = cache_pspecs(cfg, shape, mesh)
        cshape = cache_spec(cfg, shape.global_batch, shape.seq_len,
                            torch_dtype(rc.dtype))
        out["cache"] = sum(_per_dev(cshape[k][0], cspec[k], sizes)
                           * cshape[k][1].itemsize for k in sorted(cshape))
    return out


def _leaf_shapes(specs) -> List[Tuple[int, ...]]:
    """Every leaf's shape, in :func:`tree_leaves`' order."""
    if isinstance(specs, ParamSpec):
        return [specs.shape]
    return [s for k in sorted(specs) for s in _leaf_shapes(specs[k])]


def analytic_device_bytes(cfg: ModelConfig, shape: ShapeConfig,
                          mesh, rc: RunConfig) -> Dict[str, float]:
    """Exact per-device GB of the *persistent* state (params, optimizer,
    decode caches) from the leaf placements."""
    out = {f"{k}_gb": v / 1e9
           for k, v in device_state_bytes(cfg, shape, mesh, rc).items()}
    out["total_gb"] = sum(v for k, v in out.items() if k.endswith("_gb"))
    return out


def one_card(cfg: ModelConfig, shape: ShapeConfig,
             rc: RunConfig) -> Dict[str, Any]:
    """The state one card would hold alone: parameters + ``mu`` + ``nu`` +
    the fp32 gradient (training), or parameters + caches (serving), in
    bytes, and whether it fits one card's ``HBM_BYTES``."""
    b = device_state_bytes(cfg, shape, ONE_CARD, rc)
    total = b["params"] + b.get("cache", 0.0)
    if shape.mode == "train":
        grad = b["params"] / torch_dtype(rc.param_dtype).itemsize * 4
        total += b["opt"] + grad
    return {"state_bytes": total, "fits_one_card": total <= HBM_BYTES}


# ---------------------------------------------------------------------------
# the step's count, traffic and collectives
# ---------------------------------------------------------------------------

def _meta(tree):
    return tree_map(lambda sd: torch.empty(sd[0], dtype=sd[1], device="meta"),
                    tree)


@functools.lru_cache(maxsize=None)
def count_flops(cfg: ModelConfig, shape: ShapeConfig, rc: RunConfig) -> int:
    """The FLOPs of one call of the cell's step on the meta device (the
    whole step, every device's share), counted by ``FlopCounterMode``."""
    from torch.utils.flop_counter import FlopCounterMode
    params = _meta(param_shapes(cfg, rc.param_dtype))
    specs = input_specs(cfg, shape, rc)
    if shape.mode == "train":
        o = opt_state_shapes(param_shapes(cfg, rc.param_dtype))
        opt = OptState(torch.zeros((), dtype=torch.int32), _meta(o.mu),
                       _meta(o.nu))
        call = functools.partial(train_step, params, opt, _meta(specs), cfg,
                                 rc)
    elif shape.mode == "prefill":
        call = functools.partial(forward, params, _meta(specs), cfg, rc)
    else:
        call = functools.partial(decode_step, params, _meta(specs["cache"]),
                                 {"tokens": _meta(specs["tokens"])}, cfg, rc)
    with FlopCounterMode(display=False) as fc:
        call()
    return fc.get_total_flops()


def _batch_split(shape: ShapeConfig, mesh) -> Tuple[Tuple[str, ...], int]:
    """The mesh axes that split the step's batch, and into how many
    parts."""
    axes = _batch_axes(mesh, shape.global_batch) or ()
    sizes, n = axis_sizes(mesh), 1
    for a in axes:
        n *= sizes[a]
    return axes, n


def memory_bytes(cfg: ModelConfig, shape: ShapeConfig, mesh,
                 rc: RunConfig) -> float:
    """The least bytes a device's step moves (see the module docstring)."""
    sizes = axis_sizes(mesh)
    st = device_state_bytes(cfg, shape, mesh, rc)
    inputs = sum(torch.Size(v[0]).numel() * v[1].itemsize
                 for k, v in input_specs(cfg, shape, rc).items()
                 if k != "cache") / _batch_split(shape, mesh)[1]
    if shape.mode == "train":
        grad = st["params"] / torch_dtype(rc.param_dtype).itemsize * 4
        return 2 * st["params"] + 2 * grad + 2 * st["opt"] + inputs
    # decode's logits are fp32, forward's in the compute dtype
    dims = ((shape.global_batch, cfg.vocab) if shape.mode == "decode" else
            (shape.global_batch, shape.seq_len, cfg.vocab))
    out_b = 4 if shape.mode == "decode" else torch_dtype(rc.dtype).itemsize
    logits = _per_dev(dims, logits_pspec(cfg, shape, mesh), sizes) * out_b
    return st["params"] + 2 * st.get("cache", 0.0) + inputs + logits


def collective_records(cfg: ModelConfig, shape: ShapeConfig, mesh,
                       rc: RunConfig) -> List[Tuple[str, float]]:
    """``(kind, bytes)`` records of the collectives the placements imply for
    one step on one device (see the module docstring)."""
    sizes = axis_sizes(mesh)
    b_axes, n_b = _batch_split(shape, mesh)
    train = shape.mode == "train"
    pdt = torch_dtype(rc.param_dtype).itemsize
    act = torch_dtype(rc.dtype).itemsize
    # the tokens one device holds: one a sequence in decode
    t = shape.global_batch / n_b * (1 if shape.mode == "decode"
                                    else shape.seq_len)
    n_m = sizes.get("model", 1)
    recs: List[Tuple[str, float]] = []
    for path, spec, leaf in _named_leaves(param_specs(cfg),
                                          param_pspecs(cfg, mesh, rc)):
        named = [a for ax in spec if ax is not None
                 for a in (ax if isinstance(ax, tuple) else (ax,))]
        s = _per_dev(leaf.shape, spec, sizes)
        n_fsdp = 1
        for a in named:
            if a in b_axes:
                n_fsdp *= sizes[a]
        if n_fsdp > 1:
            recs += [("all-gather", s * pdt * (n_fsdp - 1))] * (2 if train
                                                                 else 1)
        if train:
            g = s * 4
            if n_fsdp > 1:
                recs.append(("reduce-scatter", g * (n_fsdp - 1)))
            n_rep = 1
            for a in b_axes:
                if a not in named:
                    n_rep *= sizes[a]
            if n_rep > 1:
                recs.append(("all-reduce", 2 * g * (n_rep - 1) / n_rep))
        if n_m == 1 or "model" not in named:
            continue
        layers = leaf.shape[0] if leaf.axes[0] == "layers" else 1
        axes = [a for a in leaf.axes if a != "layers"]
        full = list(spec) + [None] * (len(leaf.axes) - len(spec))
        model_axis = [a for a, ax in zip(leaf.axes, full)
                      if ax == "model" or (isinstance(ax, tuple)
                                           and "model" in ax)]
        reps = layers * (3 if train else 1)
        frac = (n_m - 1) / n_m
        if path == "embed" and cfg.frontend != "audio":   # hubert reads frames
            recs.append(("all-reduce", 2 * t * cfg.d_model * act * frac
                         * (3 if train else 1)))
        elif model_axis == ["experts"] and axes[-1] == "embed":
            recs.append(("all-to-all", 2 * t * cfg.moe.top_k * cfg.d_model
                         * act * frac * reps))
        elif len(axes) >= 2 and axes[-1] == "embed" and \
                model_axis[0] != "experts" and path != "head":
            recs.append(("all-reduce", 2 * t * cfg.d_model * act * frac
                         * reps))
    return recs


def _named_leaves(specs, pspecs, path: str = ""):
    """(top-level key, placement, ParamSpec) of every leaf."""
    if isinstance(specs, ParamSpec):
        yield path, pspecs, specs
        return
    for k in sorted(specs):
        yield from _named_leaves(specs[k], pspecs[k], path or k)


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def cell_tag(arch: str, shape_name: str, multi_pod: bool,
             policy: Optional[str], analysis: bool) -> str:
    """The one source of truth for a cell's artifact tag (and hence its
    cache filename): ``policy=None`` resolves the workload's calibrated
    operating point exactly like :func:`run_cell` does."""
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    variant = "analysis" if analysis else "deploy"
    if policy is None:
        policy = resolved_operating_point(SHAPES[shape_name]).policy.value
    return f"{arch}_{shape_name}_{mesh_name}_{policy}_{variant}"


def cell_path(arch: str, shape_name: str, multi_pod: bool,
              policy: Optional[str], analysis: bool,
              out_dir: str = ART_DIR) -> str:
    return os.path.join(
        out_dir, f"{cell_tag(arch, shape_name, multi_pod, policy, analysis)}"
        ".json")


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             policy: Optional[str] = None, rc: Optional[RunConfig] = None,
             save: bool = True, analysis: bool = False,
             out_dir: str = ART_DIR) -> Dict[str, Any]:
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    variant = "analysis" if analysis else "deploy"
    op = resolved_operating_point(SHAPES[shape_name])
    if policy is None:
        policy = op.policy.value
    tag = cell_tag(arch, shape_name, multi_pod, policy, analysis)
    path = os.path.join(out_dir, f"{tag}.json")
    if save and os.path.exists(path):
        with open(path) as f:
            return json.load(f)

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh = production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    rc = rc or default_runconfig(shape, policy, analysis=analysis)

    t0 = time.time()
    # neither the policy nor the analysis flag changes a product: one count
    # serves every variant of a cell
    flops = count_flops(cfg, shape, dataclasses.replace(
        rc, policy=RunConfig().policy, analysis_mode=False))
    count_s = time.time() - t0
    coll = collective_bytes(collective_records(cfg, shape, mesh, rc))
    rl = Roofline(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
        per_device_flops=flops / chips,
        per_device_bytes=memory_bytes(cfg, shape, mesh, rc),
        per_device_coll_bytes=float(coll["total"]),
        model_flops=model_flops_for(cfg, shape))
    card = one_card(cfg, shape, rc)
    art = {
        "tag": tag, "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "policy": policy, "chips": chips, "variant": variant,
        "analytic_device_gb": analytic_device_bytes(cfg, shape, mesh, rc),
        "one_card": {"state_gb": card["state_bytes"] / 1e9,
                     "state_gib": card["state_bytes"] / 2**30},
        "fits_one_card": card["fits_one_card"],
        "flops": {"step": flops, "per_device": flops / chips,
                  "counted_layers": cfg.n_layers},
        "count_s": round(count_s, 2),
        "collectives": coll,
        "roofline": rl.to_dict(),
        # the machine-model operating point the cost model assumes; an
        # explicit --policy / caller rc pin overrides the table's policy
        "machine_model": {
            "workload": "train" if shape.mode == "train" else "serve",
            "source": (op.source if rc.policy is op.policy else "override"),
            "policy": rc.policy.value,
            "queue_depth": op.queue_depth,
            "queue_depth_i2f": op.queue_depth_i2f,
            "queue_depth_f2i": op.queue_depth_f2i,
            "unroll": op.unroll,
            "n_cores": op.n_cores,
            "tcdm_banks": op.tcdm_banks,
        },
        "ok": True,
    }
    if save:
        os.makedirs(out_dir, exist_ok=True)
        with open(path, "w") as f:
            json.dump(art, f, indent=1)
    return art


def all_cells(multi_pod_also: bool = True, analysis_also: bool = True):
    """(arch, shape, multi_pod, analysis) triples: the deploy cell on both
    meshes and the analysis cell on the single pod."""
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape_name in supported_shapes(cfg):
            yield arch, shape_name, False, False
            if analysis_also:
                yield arch, shape_name, False, True
            if multi_pod_also:
                yield arch, shape_name, True, False


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="Multi-pod dry run on the meta "
                                             "device")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod", "both"])
    ap.add_argument("--policy", default=None,
                    help="pin the execution policy (default: resolve the "
                         "workload's calibrated operating point)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--fresh", action="store_true", help="ignore cache")
    ap.add_argument("--analysis", action="store_true",
                    help="the analysis variant (the same direct count)")
    ap.add_argument("--no-analysis", action="store_true",
                    help="with --all: skip analysis variants")
    ap.add_argument("--out-dir", default=ART_DIR,
                    help="where the cells' JSON files go")
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        cells = list(all_cells(
            multi_pod_also=(args.mesh in ("multipod", "both")),
            analysis_also=not args.no_analysis))
        if args.mesh == "multipod":
            cells = [c for c in cells if c[2]]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        meshes = {"pod": [False], "multipod": [True], "both": [False, True]}
        cells = [(args.arch, args.shape, mp, args.analysis)
                 for mp in meshes[args.mesh]]

    failures = []
    for arch, shape_name, mp, analysis in cells:
        var = "analysis" if analysis else "deploy"
        tag = f"{arch}/{shape_name}/{'2x16x16' if mp else '16x16'}/{var}"
        path = cell_path(arch, shape_name, mp, args.policy, analysis,
                         args.out_dir)
        if args.fresh and os.path.exists(path):
            os.remove(path)
        try:
            art = run_cell(arch, shape_name, mp, policy=args.policy,
                           analysis=analysis, out_dir=args.out_dir)
            rl = art["roofline"]
            print(f"OK  {tag:<58} count={art['count_s']:>6.2f}s "
                  f"bottleneck={rl['bottleneck']:<10} "
                  f"t=({rl['t_compute']:.2e},{rl['t_memory']:.2e},"
                  f"{rl['t_collective']:.2e})s mfu={rl['mfu']:.3f} "
                  f"one_card={art['one_card']['state_gib']:.2f}GiB "
                  f"fits={art['fits_one_card']}", flush=True)
        except Exception as e:
            failures.append((tag, repr(e)))
            print(f"FAIL {tag}: {e}", flush=True)
            traceback.print_exc()
    if failures:
        raise SystemExit(f"{len(failures)} dry-run cells failed")


if __name__ == "__main__":
    main()
