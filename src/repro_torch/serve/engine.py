"""Batched serving engine: continuous batching over fixed decode slots,
with chunked prefill on the live path.

The port of ``repro.serve.engine``, with the same behaviour: requests are
admitted through the scheduler's bounded arrival queue; every engine step
advances all active slots with one call; slots refill mid-run the step
after they drain, over zeroed cache rows (``cache["len"]`` is a (B,)
position vector, so a readmission never disturbs its neighbours).

Prompt ingestion is chunked: any step with a prefilling slot runs
:func:`~repro_torch.models.model.prefill_step`, up to ``prefill_chunk``
prompt tokens per prefilling slot while decoding neighbours ride along with
a one-token chunk — bit-exact with the token-by-token path: every decoder
family runs a chunk's columns as one body whose every row keeps its decode
bits, under a device-side mask.
Chunk widths are bucketed to powers of two.  ``prefill="token"`` keeps
one-token steps as the TTFT baseline.

As the reference jits its decode step and one prefill program per chunk
width, the engine runs each as one program
(:class:`~repro_torch.serve.graphs.CapturedStep`): on the card a CUDA
graph, captured after the step's first (eager) call and replayed from then
on, all of an engine's graphs in one memory pool; on the CPU the eager call
on the same static input buffers.  There is no switch: on the card the
engine always captures, and a capture that fails raises.
``prefill_compiles`` counts the prefill programs, one per width on either
device, as the reference counts its compilations.  A capture freezes what
the step resolves on the host — ring depths from ``rc.policy`` and the
policy table, the thin or wide kernel, the split over K — which is sound
because the engine's ``rc`` is fixed for its life: retargeting to a new
traffic level swaps only the accounting.  Every step is charged through the
:class:`~repro_torch.serve.scheduler.StepCostModel` (full batch width plus
the ingested prompt tokens at ``PREFILL_FRACTION``), so the engine clock is
in cycles-equivalent, as in the virtual-time ``simulate_serve``.

With neither an ``operating_point`` nor a ``traffic`` level the engine runs
in measured-traffic mode: a
:class:`~repro_torch.serve.scheduler.TrafficEstimator` watches arrivals and
the engine re-resolves the per-traffic ``serve`` point at refill boundaries
(``traffic_history`` records every retarget).  Retargeting swaps only the
accounting, never the tokens.

Everything runs on ``device`` (``None`` = the card; a machine without one
raises unless ``device="cpu"`` is asked for).  The weights are prepared
once at load (:func:`~repro_torch.models.model.prepare_params`): cast to
``rc.dtype``, the head held transposed and an MLA layer's W_uk and W_uv
head-major.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import (ModelConfig, RunConfig, _DEFAULT_RC_POLICY,
                      resolve_run_config)
from ..core.policy import OperatingPoint, PolicyTable, default_table
from ..device import DeviceLike, resolve_device
from ..models.model import (decode_step, init_cache, prefill_step,
                            prepare_params)
from .graphs import CapturedStep, graph_pool
from .scheduler import (AdmissionControl, ContinuousScheduler, HostDispatch,
                        ServeReport, ServeSLO, StepCostModel,
                        TrafficEstimator, build_report)

Pytree = Any


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int
    generated: List[int] = field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Continuous-batching engine.

    The execution policy is resolved for the ``"serve"`` workload at startup
    through :func:`repro_torch.config.resolve_run_config`: an explicit
    ``operating_point`` wins, a caller-pinned (non-default) ``rc.policy``
    stays authoritative, and otherwise the policy table supplies the point.
    A ``traffic`` level pins the table's per-traffic point; with no pin the
    engine measures the level from arrivals.  The resolved policy is
    threaded into the engine's :class:`RunConfig`, so every ``queue_matmul``
    of the decode and prefill steps runs under it.

    With ``batch_slots=None`` the batch is ``SLOTS_PER_CORE * n_cores`` of
    the resolved point.  :meth:`metrics` turns the scheduler's timestamps
    (cycles-equivalent) into p50/p99 latency and energy per token.
    """

    SLOTS_PER_CORE = 4

    PREFILL_MODES = ("chunked", "token")

    def __init__(self, params: Pytree, cfg: ModelConfig, rc: RunConfig,
                 batch_slots: Optional[int] = None, max_len: int = 256,
                 operating_point: Optional[OperatingPoint] = None,
                 policy_table: Optional[PolicyTable] = None,
                 mode: str = "continuous", max_pending: int = 64,
                 traffic: Optional[str] = None,
                 cost_model: Optional[StepCostModel] = None,
                 dispatch: Optional[HostDispatch] = None,
                 prefill: str = "chunked", prefill_chunk: int = 8,
                 device: DeviceLike = None):
        if not cfg.causal:
            raise ValueError("serving requires an autoregressive model")
        if prefill not in self.PREFILL_MODES:
            raise ValueError(f"prefill must be one of {self.PREFILL_MODES}, "
                             f"got {prefill!r}")
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got "
                             f"{prefill_chunk}")
        self.device = resolve_device(device)
        pinned = rc.policy if rc.policy is not _DEFAULT_RC_POLICY else None
        rc, self.operating_point = resolve_run_config(
            rc, "serve", operating_point, policy_table, traffic=traffic)
        if batch_slots is None:
            batch_slots = self.SLOTS_PER_CORE * max(
                1, self.operating_point.n_cores)
        self.cfg, self.rc = cfg, rc
        self.params = (prepare_params(params, cfg, rc) if params else params)
        self.traffic = traffic
        self.max_len = max_len
        self.prefill = prefill
        self.prefill_chunk = prefill_chunk
        self._cost = cost_model or StepCostModel.from_operating_point(
            self.operating_point)
        self._explicit_cost = cost_model is not None
        # measured-traffic mode: no pinned point, no pinned level — estimate
        # offered load from arrivals and re-resolve at refill boundaries
        self._measured = operating_point is None and traffic is None
        self._pinned_policy = pinned
        self._table = (policy_table if policy_table is not None
                       else default_table())
        self.traffic_level: Optional[str] = traffic
        self.traffic_history: List[Dict[str, Any]] = []
        estimator = None
        if self._measured:
            step_cyc, _ = self._cost.step_cost(batch_slots, 0)
            estimator = TrafficEstimator(
                capacity_tokens_per_cycle=batch_slots / max(step_cyc, 1e-9))
        self.sched = ContinuousScheduler(
            batch_slots, mode=mode,
            admission=AdmissionControl(max_pending=max_pending,
                                       max_total_len=max_len),
            estimator=estimator)
        self.requests: Dict[int, Request] = {}
        self.cache = init_cache(cfg, batch_slots, max_len, rc.dtype,
                                device=self.device)
        self._pool = graph_pool(self.device)
        self._step = self._program(decode_step, 1)
        #: chunk width -> prefill program.  Widths are powers of two, so at
        #: most log2(prefill_chunk)+1 entries; ``prefill_compiles`` counts
        #: them (a CUDA graph each on the card, as the reference's jit
        #: compiles one program each).
        self._prefill_fns: Dict[int, CapturedStep] = {}
        self.prefill_compiles = 0
        self._next_rid = 0
        self.finished: Dict[int, Request] = {}
        self._dispatch = dispatch
        self._n_steps = 0
        self._clock = 0.0       # cycles-equivalent (StepCostModel-driven)
        self._energy = 0.0

    @property
    def slots(self) -> List[Optional[Request]]:
        """The live :class:`Request` per slot (``None`` for free slots)."""
        return [self.requests[s.rid] if s is not None else None
                for s in self.sched.slots]

    def submit(self, prompt: List[int], max_new: int = 16) -> int:
        """Queue a request; raises
        :class:`~repro_torch.serve.scheduler.AdmissionError` when admission
        control sheds it.  Empty prompts are refused before any state is
        created."""
        rid = self._next_rid
        self.sched.submit(rid, len(prompt), max_new, now=self._clock)
        self._next_rid += 1
        self.requests[rid] = Request(rid, list(prompt), max_new)
        return rid

    def _reset_slot_cache(self, i: int) -> None:
        """Zero slot ``i``'s rows in every cache leaf, in place, before
        reuse: batch is axis 1 of every stacked leaf, axis 0 of ``len``."""
        for v in self.cache.values():
            if v.ndim == 1:
                v[i] = 0
            elif v.ndim > 1:
                v[:, i] = 0

    # -- chunked prefill machinery ----------------------------------------
    @staticmethod
    def _bucket(n: int) -> int:
        """Smallest power of two >= n."""
        return 1 << max(n - 1, 0).bit_length()

    def _program(self, step: Callable, width: int) -> CapturedStep:
        """``step`` (``decode_step`` or ``prefill_step``) over the engine's
        weights and cache as one program over static inputs: ``tokens``
        (slots, width), and ``n_tokens`` (slots,) for a chunk."""
        params, cache, cfg, rc = self.params, self.cache, self.cfg, self.rc
        n = self.sched.n_slots
        inputs = {"tokens": ((n, width), torch.int64)}
        if step is prefill_step:
            inputs["n_tokens"] = ((n,), torch.int32)
        return CapturedStep(lambda batch: step(params, cache, batch, cfg,
                                               rc)[0],
                            inputs, self.device, self._pool)

    def _prefill_fn(self, width: int) -> CapturedStep:
        fn = self._prefill_fns.get(width)
        if fn is None:
            fn = self._prefill_fns[width] = self._program(prefill_step,
                                                          width)
            self.prefill_compiles += 1
        return fn

    @property
    def program_kind(self) -> str:
        """What a step program is here: ``"cuda_graph"`` or ``"eager"``."""
        return self._step.kind

    def programs(self) -> Dict[str, Dict[str, Any]]:
        """Each step program that has run (``"decode"``, ``"prefill/<width>"``)
        with its :meth:`~repro_torch.serve.graphs.CapturedStep.stats`."""
        progs = {"decode": self._step, **{
            f"prefill/{w}": fn for w, fn in sorted(self._prefill_fns.items())}}
        return {k: fn.stats() for k, fn in progs.items() if fn.calls}

    def _next_tokens(self, logits: torch.Tensor) -> np.ndarray:
        return torch.argmax(logits, dim=-1).cpu().numpy()

    def _chunk_forward(self, active) -> Tuple[np.ndarray, np.ndarray, int]:
        """One mixed-phase chunk call: prefilling slots ingest up to
        ``prefill_chunk`` prompt tokens, decoding slots ride along with a
        one-token chunk, free slots stay masked out.  Returns the per-slot
        argmax tokens, the per-slot chunk counts, and the prompt tokens
        ingested."""
        n = self.sched.n_slots
        need = 1
        for _, sreq in active:
            if sreq.phase == "prefill":
                need = max(need, min(self.prefill_chunk,
                                     sreq.prompt_len - sreq.prefill_cursor))
        width = self._bucket(need)
        tokens = np.zeros((n, width), np.int64)
        counts = np.zeros((n,), np.int32)
        prefill_tokens = 0
        for i, sreq in active:
            req = self.requests[sreq.rid]
            cur = sreq.prefill_cursor
            if cur < len(req.prompt):
                k = min(self.prefill_chunk, len(req.prompt) - cur)
                tokens[i, :k] = req.prompt[cur:cur + k]
                counts[i] = k
                prefill_tokens += k
            else:
                tokens[i, 0] = (req.generated[-1] if req.generated
                                else req.prompt[-1])
                counts[i] = 1
        logits = self._prefill_fn(width)(tokens=tokens, n_tokens=counts)
        return self._next_tokens(logits), counts, prefill_tokens

    def _token_forward(self, active) -> Tuple[np.ndarray, np.ndarray, int]:
        """One token-by-token step: every active slot advances one token
        through the plain decode step."""
        tokens = np.zeros((self.sched.n_slots, 1), np.int64)
        counts = np.zeros((self.sched.n_slots,), np.int32)
        for i, sreq in active:
            req = self.requests[sreq.rid]
            cur = sreq.prefill_cursor
            if cur < len(req.prompt):
                tokens[i, 0] = req.prompt[cur]
            elif req.generated:
                tokens[i, 0] = req.generated[-1]
            else:
                tokens[i, 0] = req.prompt[-1]
            counts[i] = 1
        logits = self._step(tokens=tokens)
        return self._next_tokens(logits), counts, 0

    # -- measured-traffic retargeting --------------------------------------
    def _maybe_retarget_traffic(self) -> None:
        """In measured-traffic mode, re-resolve the per-traffic operating
        point when the estimator's level moved.  Called at refill
        boundaries only, and only swaps the accounting (operating point,
        cost model, estimator capacity)."""
        est = self.sched.estimator
        if not self._measured or est is None:
            return
        level = est.level()
        if level is None or level == self.traffic_level:
            return
        kw = ({"policy": self._pinned_policy}
              if self._pinned_policy is not None else {})
        op = self._table.resolve("serve", traffic=level, **kw)
        self.traffic_level = level
        self.operating_point = op
        if not self._explicit_cost:
            self._cost = StepCostModel.from_operating_point(op)
        step_cyc, _ = self._cost.step_cost(self.sched.n_slots, 0)
        est.capacity = self.sched.n_slots / max(step_cyc, 1e-9)
        self.traffic_history.append({
            "clock": self._clock, "level": level,
            "offered_load": est.offered_load(),
            "policy": op.policy.value, "source": op.source})

    def step(self) -> None:
        """Advance every active slot — one chunk of prompt tokens for
        prefilling slots, one decoded token for the rest — refilling freed
        slots from the arrival queue first (continuous batching)."""
        placed = self.sched.refill(self._clock)
        for i, _ in placed:
            self._reset_slot_cache(i)
        if placed:
            self._maybe_retarget_traffic()
        active = self.sched.active()
        if not active:
            return
        if self.prefill == "chunked" and any(
                sreq.phase == "prefill" for _, sreq in active):
            nxt, counts, prefill_tokens = self._chunk_forward(active)
        else:
            nxt, counts, prefill_tokens = self._token_forward(active)
        cycles, joules = self._cost.step_cost(self.sched.n_slots,
                                              prefill_tokens)
        if self._dispatch is not None:
            cycles = self._dispatch.step(cycles, self._clock)
        end = self._clock + cycles
        self._energy += joules
        for i, sreq in active:
            req = self.requests[sreq.rid]
            cur = sreq.prefill_cursor
            if cur < len(req.prompt):
                k = int(counts[i])
                self.sched.advance_prefill(sreq.rid, k, end)
                if cur + k < len(req.prompt):
                    continue               # still ingesting the prompt
                # the call that ingested the last prompt token emitted the
                # first generated token — fall through to record it
            req.generated.append(int(nxt[i]))
            if self.sched.record_token(sreq.rid, end):
                req.done = True
                self.finished[req.rid] = req
        self._clock = end
        self._n_steps += 1

    def run(self, max_steps: int = 1000) -> Dict[int, Request]:
        steps = 0
        while self.sched.busy and steps < max_steps:
            self.step()
            steps += 1
        return self.finished

    def metrics(self, slo: Optional[ServeSLO] = None) -> ServeReport:
        """Per-request serving report (p50/p99 latency, TTFT, J/token, SLO
        attainment), in cycles-equivalent as the steps were charged."""
        return build_report(self.sched, self._clock, self._energy,
                            slo=slo, dispatch=self._dispatch,
                            cost_source=self._cost.source)
