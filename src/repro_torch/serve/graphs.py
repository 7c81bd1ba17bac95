"""One device program per engine step: the port's counterpart of the
reference's ``jax.jit`` of its decode step and of its chunked-prefill step
at each bucketed chunk width (``repro.serve.engine``).

On the card that program is a CUDA graph.  :class:`CapturedStep` holds a
step function of the engine (weights, cache and config bound) and static
device buffers for its inputs (``tokens``, and ``n_tokens`` for a chunk);
each call copies the host's arrays into those buffers, then

* on a CUDA device, the first call runs the step eagerly.  That call is
  the warm-up and its logits are the call's result.  The graph is captured
  after it: a capture records the kernels and runs none, so the live cache
  is stepped once.  Every later call replays the graph.  A capture that
  fails raises: there is no eager fallback and no switch;
* on the CPU, every call runs the step eagerly on the same buffers, so the
  CPU tests exercise the same bookkeeping.

**What a capture freezes.**  Whatever the step resolves on the host while
it is captured is fixed in its graph: every shape, each ``queue_matmul``'s
ring depths (from the run's policy and the policy table), its thin or wide
kernel and its split over K, every Python branch.  That is sound because
an engine's ``RunConfig`` and shapes are fixed for its life.  The graph
reads the weights and reads and writes the cache at the addresses it
captured, so the engine updates its cache in place and never rebinds a
leaf.  The step must read nothing back to the host and make no shape from
the data (``models.model.prefill_step``'s device-side mask).

**Launch counts.**  A wrapper counts its kernel's launches where it
launches it (``queue_matmul.launches`` and the others of
:func:`~repro_torch.kernels.launch_counters`); a replay calls no wrapper.
So the capture records each counter's growth, takes it back (the capture
launched nothing), and every replay adds it.

**Memory.**  The graphs of one engine share one memory pool (its widths
never run at once).  A replay's logits live in that pool and hold until
the next replay of any graph of the pool; the engine reads them at once.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..kernels import launch_counters

#: a step's result from its static inputs (name -> device buffer)
StepFn = Callable[[Dict[str, torch.Tensor]], torch.Tensor]


def graph_pool(device: torch.device):
    """A memory pool for an engine's graphs, or None off the card."""
    if device.type != "cuda":
        return None
    with torch.cuda.device(device):
        return torch.cuda.graph_pool_handle()


class CapturedStep:
    """``fn`` over static input buffers of ``inputs`` (name -> (shape,
    dtype)): a CUDA graph on the card after its first call, the eager call
    elsewhere (see the module's docstring)."""

    def __init__(self, fn: StepFn,
                 inputs: Dict[str, Tuple[Tuple[int, ...], torch.dtype]],
                 device: torch.device, pool=None):
        self._fn = fn
        self.device = torch.device(device)
        self.inputs = {k: torch.zeros(shape, dtype=dt, device=self.device)
                       for k, (shape, dt) in inputs.items()}
        self._pool = pool
        self.graph: Optional["torch.cuda.CUDAGraph"] = None
        self._out: Optional[torch.Tensor] = None
        #: kernel launches one replay makes, by kernel (the capture's)
        self.per_replay: Dict[str, int] = {}
        self.calls = self.replays = 0
        #: wall seconds of the capture, and the bytes the pool reserved
        #: for it (0 where an earlier graph's blocks sufficed)
        self.capture_s = 0.0
        self.pool_bytes = 0

    @property
    def kind(self) -> str:
        """``"cuda_graph"`` on the card, else ``"eager"``."""
        return "cuda_graph" if self.device.type == "cuda" else "eager"

    def __call__(self, **arrays: np.ndarray) -> torch.Tensor:
        """Copy ``arrays`` into the static buffers and run the step."""
        for k, a in arrays.items():
            self.inputs[k].copy_(torch.from_numpy(np.asarray(a)))
        self.calls += 1
        if self.device.type != "cuda":
            return self._run()
        if self.graph is None:
            out = self._run()                   # the warm-up
            self._capture()
            return out
        self.graph.replay()
        self.replays += 1
        counters = launch_counters()
        for name, n in self.per_replay.items():
            counters[name].launches += n
        return self._out

    def _run(self) -> torch.Tensor:
        with torch.no_grad():
            return self._fn(self.inputs)

    def _capture(self) -> None:
        counters = launch_counters()
        before = {k: c.launches for k, c in counters.items()}
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.cuda.device(self.device):
            try:
                # entering frees the allocator's cached blocks: read after
                with torch.cuda.graph(graph, pool=self._pool):
                    reserved = torch.cuda.memory_reserved()
                    out = self._run()
            finally:
                grown = {k: c.launches - before[k]
                         for k, c in counters.items()}
                for k, c in counters.items():
                    c.launches = before[k]
            self.pool_bytes = torch.cuda.memory_reserved() - reserved
        self.capture_s = time.perf_counter() - t0
        self.per_replay = {k: n for k, n in grown.items() if n}
        self.graph, self._out = graph, out

    def stats(self) -> Dict[str, object]:
        """What the program is and has done: its kind, calls, capture
        seconds, pool bytes, replays and launches per replay."""
        return {"kind": self.kind, "calls": self.calls,
                "captured": self.graph is not None,
                "capture_s": self.capture_s, "pool_bytes": self.pool_bytes,
                "replays": self.replays,
                "launches_per_replay": dict(self.per_replay)}
