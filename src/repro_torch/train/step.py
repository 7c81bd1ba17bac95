"""Training step: loss, gradient accumulation over microbatches, optional
int8 gradient compression, AdamW update, and the step factory the
launcher and the fault-tolerant driver use.

The JAX package's ``train/step.py`` without a mesh: the port trains on one
device, so :func:`make_train_step` returns a closure where the reference
returns a pjit-compiled step and its shardings (sharding is a later
slice).  The gradient is ``torch.autograd.grad`` of :func:`loss_fn`
through the port's ``forward``, whose products and attention run the
hand-written kernels on the card with their backward kernels
(``queue_matmul``, ``flash_attention``).  Parameters and optimizer state
are updated in place (:mod:`repro_torch.optim`)."""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ModelConfig, RunConfig, ShapeConfig, resolve_run_config
from ..core.policy import OperatingPoint, PolicyTable
from ..device import DeviceLike, resolve_device, upcast, wide_dtype
from ..distributed.compression import compress_grads
from ..models.layers import tree_leaves, tree_map, tree_unflatten
from ..models.model import forward, input_specs
from ..optim import OptState, adamw_update

Pytree = Any

__all__ = ["loss_fn", "make_train_step", "resolve_run_config", "train_step"]


def loss_fn(params: Pytree, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            rc: RunConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross entropy: logits in the compute dtype, then an
    fp32 log-sum-exp minus the label's logit (a one-hot sum, as the
    reference takes it); accuracy of the argmax."""
    logits = forward(params, batch, cfg, rc)
    labels = batch["labels"].long()
    lg = upcast(logits)
    lse = torch.logsumexp(lg, dim=-1)
    onehot = F.one_hot(labels, cfg.vocab).to(lg.dtype)
    nll = lse - (lg * onehot).sum(-1)
    loss = nll.mean()
    acc = (lg.argmax(-1) == labels).to(lg.dtype).mean()
    return loss, {"loss": loss, "accuracy": acc}


def _value_and_grad(params, batch, cfg, rc):
    ps = tree_leaves(params)
    with torch.enable_grad():
        for p in ps:
            p.requires_grad_(True)
        try:
            loss, metrics = loss_fn(params, batch, cfg, rc)
            grads = torch.autograd.grad(loss, ps, allow_unused=True)
        finally:
            for p in ps:
                p.requires_grad_(False)
    # contiguous, as the optimizer walks every leaf in flat chunks; a leaf
    # the loss never reads (hubert's embed) gets the zeros JAX gives it, in
    # the wide dtype, so AdamW still decays it
    grads = [torch.zeros(p.shape, dtype=wide_dtype(p.dtype), device=p.device)
             if g is None else g.contiguous() for p, g in zip(ps, grads)]
    return ({k: v.detach() for k, v in metrics.items()},
            tree_unflatten(params, grads))


def _grads(params: Pytree, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
           rc: RunConfig) -> Tuple[Pytree, Dict[str, torch.Tensor]]:
    """The loss's gradient with respect to every parameter leaf.  With
    ``rc.microbatch`` > 1 the batch is split into that many microbatches,
    their gradients summed into fp32 zeros in order and divided by their
    count, and the metrics are the mean loss, as the reference's scan."""
    mb = rc.microbatch
    if not mb or mb <= 1:
        metrics, g = _value_and_grad(params, batch, cfg, rc)
        return g, metrics
    B = batch["labels"].shape[0]
    if B % mb:
        raise ValueError(f"global batch {B} does not divide into {mb} "
                         f"microbatches")
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params)
    loss_sum = torch.zeros((), dtype=torch.float32,
                           device=tree_leaves(params)[0].device)
    for i in range(mb):
        part = {k: v[i * (B // mb):(i + 1) * (B // mb)]
                for k, v in batch.items()}
        metrics, g = _value_and_grad(params, part, cfg, rc)
        for a, gi in zip(tree_leaves(acc), tree_leaves(g)):
            a.add_(gi)
        loss_sum = loss_sum + metrics["loss"]
    for a in tree_leaves(acc):
        a.div_(mb)
    return acc, {"loss": loss_sum / mb}


def train_step(params: Pytree, opt: OptState, batch: Dict[str, torch.Tensor],
               cfg: ModelConfig, rc: RunConfig,
               rng: Optional[torch.Generator] = None
               ) -> Tuple[Pytree, OptState, Dict[str, torch.Tensor]]:
    """Gradients, optional int8 compression (``rng``, else a generator on
    the parameters' device seeded with the step, as the reference keys it),
    then AdamW in place.  Returns (params, new OptState, metrics)."""
    grads, metrics = _grads(params, batch, cfg, rc)
    if rc.grad_compression:
        if rng is None:
            rng = torch.Generator(device=tree_leaves(params)[0].device)
            rng.manual_seed(int(opt.step))
        grads = compress_grads(rng, grads)
    params, opt, om = adamw_update(params, opt, grads, rc)
    return params, opt, {**metrics, **om}


def make_train_step(cfg: ModelConfig, shape: ShapeConfig, rc: RunConfig,
                    device: DeviceLike = None,
                    operating_point: Optional[OperatingPoint] = None,
                    policy_table: Optional[PolicyTable] = None
                    ) -> Callable[..., Tuple[Pytree, OptState,
                                             Dict[str, torch.Tensor]]]:
    """A step ``step(params, opt, batch) -> (params, opt, metrics)`` on
    ``device`` (``None`` = the card) for batches of ``shape``: the
    ``"train"`` workload's execution policy resolves once, here, through
    :func:`resolve_run_config` (pinned by ``operating_point`` when given);
    numpy batches are moved to the device.  A batch must hold every input
    :func:`input_specs` names for the shape (tokens, or the audio
    frontend's frames; the vision frontend's patches; labels), its labels
    of the shape's (global_batch, seq_len).  The step's ``cfg``, ``rc``
    (resolved) and ``operating_point`` attributes say what it runs."""
    rc, op = resolve_run_config(rc, "train", operating_point, policy_table)
    dev = resolve_device(device)
    needs = sorted(input_specs(cfg, shape, rc))

    def step(params, opt, batch):
        missing = [k for k in needs if k not in batch]
        if missing:
            raise KeyError(f"{cfg.name} trains on {needs}; the batch has "
                           f"no {missing}")
        batch = {k: (torch.from_numpy(np.asarray(v)) if not
                     isinstance(v, torch.Tensor) else v).to(dev)
                 for k, v in batch.items()}
        if batch["labels"].shape != (shape.global_batch, shape.seq_len):
            raise ValueError(f"batch of {tuple(batch['labels'].shape)} "
                             f"label tokens for a step of shape "
                             f"({shape.global_batch}, {shape.seq_len})")
        return train_step(params, opt, batch, cfg, rc)

    step.cfg, step.rc, step.operating_point = cfg, rc, op
    return step
