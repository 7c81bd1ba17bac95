"""Fault-tolerant training driver.

The JAX package's ``runtime/driver.py`` on one device: the loop owns
periodic async checkpoints, straggler monitoring and restart-on-failure.
A failure (an :class:`InjectedFault` simulating device loss) triggers:
wait for the checkpoint writer -> re-make the step -> restore the latest
checkpoint onto the device -> seek the data stream -> continue.  Where the
reference rebuilds a mesh from a ``mesh_factory``, the port names a
``device``; the restore copies the checkpoint into the tensors already on
it (the step updates them in place), so the card never holds two copies
of the state."""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import torch

from ..checkpoint.manager import CheckpointManager, latest_step, restore
from ..config import ModelConfig, RunConfig, ShapeConfig, resolve_run_config
from ..core.policy import OperatingPoint, PolicyTable
from ..data.pipeline import SyntheticLMStream
from ..device import DeviceLike, resolve_device
from ..models.layers import tree_leaves
from ..optim import init_opt_state
from ..train.step import make_train_step
from .straggler import StragglerMonitor

Pytree = Any


class InjectedFault(RuntimeError):
    """Simulated device/host failure for resilience testing."""


class FaultTolerantTrainer:
    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, rc: RunConfig,
                 device: DeviceLike, ckpt_dir: str, ckpt_every: int = 50,
                 fault_hook: Optional[Callable[[int], None]] = None,
                 operating_point: Optional[OperatingPoint] = None,
                 policy_table: Optional[PolicyTable] = None):
        # policy resolution happens once here; restarts re-make the step
        # with the SAME pinned operating point, never a fresh lookup
        rc, self.operating_point = resolve_run_config(
            rc, "train", operating_point, policy_table)
        self.cfg, self.shape, self.rc = cfg, shape, rc
        self.device = resolve_device(device)
        self.ckpt = CheckpointManager(ckpt_dir, keep=3)
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.fault_hook = fault_hook
        self.monitor = StragglerMonitor()
        self.restarts = 0
        self.metrics_log: list = []

    def _build(self):
        return make_train_step(self.cfg, self.shape, self.rc, self.device,
                               operating_point=self.operating_point)

    def run(self, params: Pytree, opt=None, start_step: int = 0,
            num_steps: int = 100) -> Dict[str, Any]:
        rc = self.rc
        opt = opt if opt is not None else init_opt_state(params)
        step_fn = self._build()
        stream = SyntheticLMStream(self.cfg.vocab, self.shape.seq_len,
                                   self.shape.global_batch, seed=rc.seed)
        step = start_step
        while step < start_step + num_steps:
            try:
                batch = stream.batch_at(step)
                t0 = time.monotonic()
                if self.fault_hook:
                    self.fault_hook(step)
                params, opt, metrics = step_fn(params, opt, batch)
                loss = float(metrics["loss"])
                self.monitor.record(step, time.monotonic() - t0)
                self.metrics_log.append((step, loss))
                step += 1
                if step % self.ckpt_every == 0:
                    self.ckpt.save_async(step, {"params": params, "opt": opt},
                                         extra={"data_step": step})
            except InjectedFault:
                # device loss: re-make the step and resume from durable state
                self.restarts += 1
                self.ckpt.wait()
                last = latest_step(self.ckpt_dir)
                step_fn = self._build()
                if last is not None:
                    state = {"params": params, "opt": opt}
                    last, saved, extra = restore(self.ckpt_dir, state,
                                                 device="cpu")
                    with torch.no_grad():
                        for dst, src in zip(tree_leaves(state),
                                            tree_leaves(saved)):
                            dst.copy_(src)
                    step = extra.get("data_step", last)
                else:
                    step = start_step
        self.ckpt.save_async(step, {"params": params, "opt": opt},
                             extra={"data_step": step})
        self.ckpt.wait()
        return {"params": params, "opt": opt, "step": step,
                "restarts": self.restarts, "metrics": self.metrics_log}
