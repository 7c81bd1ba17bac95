"""Serve-path scheduling: request lifecycle, continuous batching, and
SLO accounting on top of the calibrated machine model.

This module is the bookkeeping half of the serving stack: `engine.ServeEngine`
owns the decode step and the KV cache, while the scheduler owns the
arrival queue, admission control, slot assignment, per-request timestamps and
the cost model that converts engine steps into cycles-equivalent latency and
joules-per-token.  `simulate_serve` drives the same scheduler in virtual time
(no model, just the calibrated step costs) — that is what the trace-driven
`benchmarks/serve_slo.py` load generator runs, so the benchmark's batching
comparison and the real engine share one lifecycle implementation.

SLO objective semantics
-----------------------
A serve SLO is stated per request, in cycles-equivalent of the machine model
(the simulated RISC-V cluster has no wall clock):

* every request's *work* is ``max_new + prefill_weight * prompt_len`` tokens
  (prompt tokens are cheaper than decode tokens — chunked prefill amortizes
  the per-step overhead — so they count at a discount);
* a request *meets its SLO* iff its end-to-end latency (finish − arrival,
  queueing included) is at most ``p99_cycles_per_token × work + base_cycles``;
* the fleet *meets the SLO* iff the p99 over per-request normalized latencies
  (latency / work) is ≤ ``p99_cycles_per_token``, and, when a joules bound is
  set, measured energy-per-token is ≤ ``energy_per_token``.

**Throughput-at-SLO** — the headline serving metric, and what the
``serve-slo`` calibration objective maximizes — counts only the output tokens
of requests that met their SLO, divided by total cycles: tokens delivered
late are real work but worthless to the operator, so a configuration that
drains faster while blowing tail latency does not win.  The calibration-side
selection (``core.calibrate``, objective ``"serve-slo"``) applies the same
semantics analytically: for each Pareto-front point it estimates the p99
sojourn under the traffic level's offered load with an M/D/1-flavoured
queueing bound and picks the highest-throughput point whose estimate fits the
latency and energy budgets (see ``_select`` there).

Why continuous batching wins here: one engine step costs the *full* decode
batch width in both cycles and energy regardless of how many slots hold live
requests — the batch is a fixed-shape jitted program, padded rows burn PE
cycles like real ones.  Static (wave) batching drains every slot before
admitting the next wave, so short requests finish early and their slots idle
until the longest request in the wave completes; continuous batching refills
each slot the step after it frees.  Same cost per step, more live tokens per
step — higher throughput-at-SLO and lower J/token.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass
from typing import Any, Deque, Dict, List, Optional, Tuple

from ..core.policy import TRAFFIC_LEVELS, OperatingPoint
from ..runtime.straggler import Heartbeat, StragglerMonitor


class AdmissionError(RuntimeError):
    """Raised by :meth:`ContinuousScheduler.submit` when admission control
    rejects a request (backpressure or an unservable shape)."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


@dataclass(frozen=True)
class AdmissionControl:
    """Admission policy: bound the arrival queue and refuse unservable shapes.

    ``max_pending`` bounds the number of queued (admitted-but-unscheduled)
    requests — beyond it the engine sheds load instead of growing an
    unbounded backlog whose tail latency is unbounded too.  ``max_total_len``
    (the engine's KV capacity) rejects requests whose ``prompt + max_new``
    could never fit a slot: admitting one would either overflow the cache or
    silently truncate, both worse than an upfront refusal.
    """
    max_pending: int = 64
    max_total_len: Optional[int] = None

    def reject_reason(self, prompt_len: int, max_new: int,
                      n_pending: int) -> Optional[str]:
        if prompt_len < 1 or max_new < 1:
            return f"empty request (prompt_len={prompt_len}, max_new={max_new})"
        if self.max_total_len is not None and \
                prompt_len + max_new > self.max_total_len:
            return (f"request needs {prompt_len + max_new} cache rows, "
                    f"slot capacity is {self.max_total_len}")
        if n_pending >= self.max_pending:
            return f"queue full ({n_pending}/{self.max_pending} pending)"
        return None


@dataclass
class ServeRequest:
    """Scheduler-side view of one request: shape plus lifecycle timestamps.

    Times are in whatever unit the caller's clock uses — cycles-equivalent in
    the virtual-time simulation, engine steps in the live engine (converted
    to cycles by the :class:`StepCostModel` when reporting).
    """
    rid: int
    prompt_len: int
    max_new: int
    arrival: float
    admit_time: Optional[float] = None    # entered a slot
    prefill_end: Optional[float] = None
    first_token: Optional[float] = None
    finish: Optional[float] = None
    tokens_out: int = 0
    prefill_cursor: int = 0
    slot: Optional[int] = None

    @property
    def phase(self) -> str:
        if self.finish is not None:
            return "done"
        if self.slot is None:
            return "queued"
        return "decode" if self.prefill_cursor >= self.prompt_len else "prefill"


class TrafficEstimator:
    """EWMA arrival-rate estimator mapping the *measured* request stream
    onto the calibration's :data:`~repro_torch.core.policy.TRAFFIC_LEVELS`.

    The schema-v5 ``serve-slo`` calibration selects one operating point per
    offered-load level; this estimator closes that loop against live
    traffic so the serve engine can re-resolve its per-traffic point from
    what actually arrives instead of a static launch flag.

    Offered load is estimated as ``rate x work / capacity``:

    * ``rate`` — reciprocal of an EWMA over inter-arrival gaps (same-clock
      bursts drive the gap toward zero, saturating the estimate — the
      right answer for a thundering herd);
    * ``work`` — EWMA of per-request work tokens
      (``max_new + PREFILL_FRACTION * prompt_len``, the same discount the
      step cost model charges chunked prompt tokens);
    * ``capacity`` — the engine's full-width decode token rate
      (tokens/cycle), supplied by the owner and updated when the operating
      point (and so the cost model) changes.

    :meth:`level` maps the clamped load fraction to the *nearest*
    :data:`TRAFFIC_LEVELS` entry, or ``None`` until ``min_arrivals``
    arrivals have been observed — a cold estimator must not trigger a
    re-selection on no evidence.  Every arrival is observed, shed ones
    included: admission rejections are offered load too.
    """

    def __init__(self, capacity_tokens_per_cycle: float,
                 alpha: float = 0.25, min_arrivals: int = 4):
        assert 0.0 < alpha <= 1.0, alpha
        self.capacity = capacity_tokens_per_cycle
        self.alpha = alpha
        self.min_arrivals = min_arrivals
        self.n_arrivals = 0
        self._gap: Optional[float] = None      # EWMA inter-arrival gap
        self._work: Optional[float] = None     # EWMA work tokens / request
        self._last: Optional[float] = None     # previous arrival timestamp

    def observe(self, now: float, prompt_len: int, max_new: int) -> None:
        work = max_new + PREFILL_FRACTION * prompt_len
        self._work = work if self._work is None else \
            (1.0 - self.alpha) * self._work + self.alpha * work
        if self._last is not None:
            gap = max(now - self._last, 0.0)
            self._gap = gap if self._gap is None else \
                (1.0 - self.alpha) * self._gap + self.alpha * gap
        self._last = now
        self.n_arrivals += 1

    def offered_load(self) -> Optional[float]:
        """Estimated offered load as a fraction of service capacity in
        [0, 1], or None while cold (fewer than ``min_arrivals`` seen)."""
        if self.n_arrivals < self.min_arrivals or self._gap is None \
                or self._work is None:
            return None
        rate = 1.0 / max(self._gap, 1e-12)
        rho = rate * self._work / max(self.capacity, 1e-12)
        return min(max(rho, 0.0), 1.0)

    def level(self) -> Optional[str]:
        """The nearest :data:`TRAFFIC_LEVELS` name, or None while cold."""
        rho = self.offered_load()
        if rho is None:
            return None
        return min(TRAFFIC_LEVELS,
                   key=lambda name: abs(TRAFFIC_LEVELS[name] - rho))


class ContinuousScheduler:
    """Arrival queue + slot assignment for a fixed-width decode batch.

    ``mode="continuous"`` refills any free slot the moment the queue is
    non-empty; ``mode="static"`` reproduces wave batching (refill only once
    *every* slot has drained) and exists as the baseline the serve-SLO
    benchmark measures continuous batching against.  An attached
    :class:`TrafficEstimator` observes every arrival timestamp (admitted or
    shed) so the owner can map measured load onto the calibrated traffic
    levels.
    """

    MODES = ("continuous", "static")

    def __init__(self, n_slots: int, mode: str = "continuous",
                 admission: Optional[AdmissionControl] = None,
                 estimator: Optional[TrafficEstimator] = None):
        if mode not in self.MODES:
            raise ValueError(f"mode must be one of {self.MODES}, got {mode!r}")
        self.n_slots = n_slots
        self.mode = mode
        self.admission = admission or AdmissionControl()
        self.estimator = estimator
        self.queue: Deque[ServeRequest] = deque()
        self.slots: List[Optional[ServeRequest]] = [None] * n_slots
        self.requests: Dict[int, ServeRequest] = {}
        self.n_rejected = 0
        self.n_completed = 0

    # -- lifecycle ---------------------------------------------------------
    def submit(self, rid: int, prompt_len: int, max_new: int,
               now: float) -> ServeRequest:
        if self.estimator is not None:
            self.estimator.observe(now, prompt_len, max_new)
        reason = self.admission.reject_reason(prompt_len, max_new,
                                              len(self.queue))
        if reason is not None:
            self.n_rejected += 1
            raise AdmissionError(reason)
        req = ServeRequest(rid, prompt_len, max_new, arrival=now)
        self.requests[rid] = req
        self.queue.append(req)
        return req

    def refill(self, now: float) -> List[Tuple[int, ServeRequest]]:
        """Move queued requests into free slots; returns the new
        ``(slot, request)`` assignments so the engine can reset cache rows."""
        if self.mode == "static" and any(s is not None for s in self.slots):
            return []
        placed: List[Tuple[int, ServeRequest]] = []
        for i in range(self.n_slots):
            if self.slots[i] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            req.slot, req.admit_time = i, now
            self.slots[i] = req
            placed.append((i, req))
        return placed

    def advance_prefill(self, rid: int, tokens: int, now: float) -> None:
        req = self.requests[rid]
        req.prefill_cursor += tokens
        if req.prefill_cursor >= req.prompt_len and req.prefill_end is None:
            req.prefill_end = now

    def record_token(self, rid: int, now: float) -> bool:
        """One decoded token for ``rid``; returns True when it finished
        (the slot is freed — the engine must not reuse it before resetting
        the slot's cache rows via the next :meth:`refill`)."""
        req = self.requests[rid]
        if req.first_token is None:
            req.first_token = now
        req.tokens_out += 1
        if req.tokens_out >= req.max_new:
            req.finish = now
            if req.slot is not None:
                self.slots[req.slot] = None
            req.slot = None
            self.n_completed += 1
            return True
        return False

    # -- queries -----------------------------------------------------------
    def active(self) -> List[Tuple[int, ServeRequest]]:
        return [(i, r) for i, r in enumerate(self.slots) if r is not None]

    @property
    def busy(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)


# ---------------------------------------------------------------------------
# step-cost model: engine steps -> cycles & joules at the calibrated point
# ---------------------------------------------------------------------------

#: one machine-model proxy sample ~ one decode token's activation math
#: (the ``expf`` kernel is the ``serve`` workload's instruction-mix analogue,
#: see core.policy.WORKLOAD_PROXIES)
_SAMPLES_PER_TOKEN = 1.0
#: chunked-prefill marginal cost per prompt token, as a fraction of a decode
#: token: prefill batches prompt tokens through one jitted chunk call
#: (``models.model.prefill_step``), amortizing the per-step dispatch/sync
#: overhead the decode path pays every token.  Both the live engine and the
#: virtual-time simulation charge prompt tokens at this fraction.
PREFILL_FRACTION = 0.25
#: fixed per-step dispatch overhead (cycles): queue maintenance + batch
#: launch, independent of width
_STEP_OVERHEAD_CYCLES = 16.0


@dataclass(frozen=True)
class StepCostModel:
    """Cycles & joules per engine step, derived from a calibrated
    :class:`~repro_torch.core.policy.OperatingPoint` by simulating the serve
    workload's proxy kernel at that point's full geometry.

    One decode step over a batch of width ``W`` costs
    ``overhead + W * cycles_decode_token`` cycles and
    ``W * energy_decode_token`` joules *regardless of how many slots are
    live* — the jitted batch is fixed-shape, padded rows execute.  Chunked
    prefill adds a discounted marginal cost per prompt token ingested.
    """
    cycles_decode_token: float
    energy_decode_token: float
    cycles_prefill_token: float
    energy_prefill_token: float
    overhead_cycles: float = _STEP_OVERHEAD_CYCLES
    source: str = "default"

    @classmethod
    def from_operating_point(cls, op: Optional[OperatingPoint] = None,
                             workload: str = "serve",
                             n_samples: int = 32) -> "StepCostModel":
        """Simulate the workload's proxy kernel at ``op``'s geometry and
        derive per-token costs.  Falls back to the paper-default operating
        point if ``op``'s geometry is rejected by the machine model, and to
        flat constants if even that fails (never raises)."""
        from ..core.policy import WORKLOAD_PROXIES
        from ..core.sweep import SweepPoint, run_point
        kernel = WORKLOAD_PROXIES.get(workload, "expf")
        candidates = [] if op is None else [(op, op.source)]
        candidates.append((OperatingPoint(), "default"))
        for candidate, src in candidates:
            rec = run_point(SweepPoint(
                kernel=kernel, policy=candidate.policy.value,
                queue_depth=candidate.queue_depth,
                queue_latency=candidate.queue_latency,
                unroll=candidate.unroll, unroll_int=candidate.unroll_int,
                queue_depth_i2f=candidate.queue_depth_i2f,
                queue_depth_f2i=candidate.queue_depth_f2i,
                n_cores=candidate.n_cores, tcdm_banks=candidate.tcdm_banks,
                pipeline=candidate.pipeline, cq_depth=candidate.cq_depth,
                dma_buffers=candidate.dma_buffers, n_samples=n_samples))
            if rec.status == "ok" and rec.cycles > 0 and rec.n_samples > 0:
                cpt = rec.cycles / rec.n_samples * _SAMPLES_PER_TOKEN
                ept = rec.energy / rec.n_samples * _SAMPLES_PER_TOKEN
                return cls(cycles_decode_token=cpt, energy_decode_token=ept,
                           cycles_prefill_token=cpt * PREFILL_FRACTION,
                           energy_prefill_token=ept * PREFILL_FRACTION,
                           source=src)
        return cls(cycles_decode_token=64.0, energy_decode_token=64.0,
                   cycles_prefill_token=16.0, energy_prefill_token=16.0,
                   source="flat-fallback")

    def step_cost(self, width: int, prefill_tokens: int = 0
                  ) -> Tuple[float, float]:
        """(cycles, joules) for one engine step: a full-width decode pass
        plus ``prefill_tokens`` chunked prompt tokens."""
        cycles = (self.overhead_cycles + width * self.cycles_decode_token
                  + prefill_tokens * self.cycles_prefill_token)
        energy = (width * self.energy_decode_token
                  + prefill_tokens * self.energy_prefill_token)
        return cycles, energy


# ---------------------------------------------------------------------------
# straggler-aware dispatch
# ---------------------------------------------------------------------------

class HostDispatch:
    """Straggler-aware work dispatch over ``n_hosts`` data-parallel hosts.

    Each step's batch is split by per-host weights; a host's step time is its
    share of the work stretched by its (unknown to the dispatcher) slowdown
    factor, and the step completes at the barrier — the slowest host.  Every
    per-host time feeds one shared :class:`StragglerMonitor`; a flagged host
    has its dispatch weight halved, shifting work to healthy hosts until its
    step times re-enter the robust band (self-stabilizing — no oscillation,
    because flagged samples never pollute the baseline window).  A
    :class:`Heartbeat` seeded at the dispatcher's start time tracks liveness
    without declaring slow-but-beating hosts dead.

    The monitor is fed each host's time *relative to the step's median host
    time*, not the raw time: reweighting deliberately shifts every host's
    absolute step time, and raw times against a zero-noise baseline window
    (MAD degenerates to the epsilon floor) would flag healthy hosts for the
    shift the mitigation itself caused.  Relative to the median, a healthy
    host is exactly 1.0 every step no matter how the weights move.
    """

    def __init__(self, n_hosts: int, window: int = 32, threshold: float = 4.0,
                 min_samples: int = 8, heartbeat_timeout: float = 1e9,
                 start: float = 0.0):
        self.n_hosts = n_hosts
        self.hosts = [f"host{i}" for i in range(n_hosts)]
        self.weights = [1.0] * n_hosts
        self.speeds = [1.0] * n_hosts     # slowdown factors (tests inject)
        self.monitor = StragglerMonitor(window=window, threshold=threshold,
                                        min_samples=min_samples)
        self.heartbeat = Heartbeat(self.hosts, timeout=heartbeat_timeout,
                                   start=start)
        self.flag_counts: Dict[int, int] = {}
        self._step_no = 0

    def set_speed(self, host: int, slowdown: float) -> None:
        self.speeds[host] = slowdown

    def step(self, cycles: float, now: float) -> float:
        """Dispatch one step of ``cycles`` total work at virtual time
        ``now``; returns the barrier (slowest-host) completion time."""
        if self.n_hosts <= 1:
            self.heartbeat.beat(self.hosts[0], now + cycles)
            return cycles
        total_w = sum(self.weights)
        times = [cycles * self.n_hosts * (w / total_w) * s
                 for w, s in zip(self.weights, self.speeds)]
        med = StragglerMonitor._median(times)
        ratios = [t / max(med, 1e-9) for t in times]
        flagged = [self.monitor.record(self._step_no, r) for r in ratios]
        self._step_no += 1
        for i, (t, f) in enumerate(zip(times, flagged)):
            self.heartbeat.beat(self.hosts[i], now + t)
            if f:
                self.flag_counts[i] = self.flag_counts.get(i, 0) + 1
                # halve the flagged host's share (floored — a mis-flagged
                # host must never be starved to zero)
                self.weights[i] = max(self.weights[i] * 0.5, 2.0 ** -6)
        return max(times)

    @property
    def flagged_hosts(self) -> List[int]:
        return sorted(self.flag_counts)

    def dead(self, now: float) -> List[str]:
        return self.heartbeat.dead(now)


# ---------------------------------------------------------------------------
# SLO definition + report
# ---------------------------------------------------------------------------

def percentile(xs: List[float], q: float) -> float:
    """Linear-interpolation percentile (deterministic, no numpy dependency
    in the hot reporting path).  ``q`` in [0, 100]."""
    if not xs:
        return 0.0
    s = sorted(xs)
    if len(s) == 1:
        return s[0]
    pos = (len(s) - 1) * q / 100.0
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(s) - 1)
    frac = pos - lo
    return s[lo] * (1.0 - frac) + s[hi] * frac


@dataclass(frozen=True)
class ServeSLO:
    """Service-level objective in cycles-equivalent (module docstring has
    the full semantics)."""
    p99_cycles_per_token: float
    energy_per_token: Optional[float] = None
    prefill_weight: float = 0.25
    base_cycles: float = 0.0

    def work_tokens(self, prompt_len: int, max_new: int) -> float:
        return max_new + self.prefill_weight * prompt_len

    def budget(self, prompt_len: int, max_new: int) -> float:
        return (self.p99_cycles_per_token
                * self.work_tokens(prompt_len, max_new) + self.base_cycles)


@dataclass
class ServeReport:
    """Per-run serving metrics: request outcomes, latency percentiles,
    energy accounting and SLO attainment."""
    mode: str
    n_completed: int
    n_rejected: int
    n_unfinished: int
    total_cycles: float
    total_energy: float
    tokens_out: int
    throughput: float                 # tokens / cycle, all completions
    energy_per_token: float           # joules / token, all tokens
    p50_latency: float                # normalized: cycles per work-token
    p99_latency: float
    p50_ttft: float                   # time to first token, cycles
    p99_ttft: float
    slo: Optional[Dict[str, Any]] = None
    straggler: Optional[Dict[str, Any]] = None
    cost_source: str = "default"

    def to_dict(self) -> Dict[str, Any]:
        d = dict(self.__dict__)
        return d


def build_report(sched: ContinuousScheduler, total_cycles: float,
                 total_energy: float, slo: Optional[ServeSLO] = None,
                 dispatch: Optional[HostDispatch] = None,
                 cost_source: str = "default") -> ServeReport:
    done = [r for r in sched.requests.values() if r.finish is not None]
    norm_lat = [(r.finish - r.arrival)
                / max(slo.work_tokens(r.prompt_len, r.max_new) if slo
                      else float(r.max_new), 1e-9) for r in done]
    ttft = [r.first_token - r.arrival for r in done
            if r.first_token is not None]
    tokens = sum(r.tokens_out for r in sched.requests.values())
    cyc = max(total_cycles, 1e-9)
    report = ServeReport(
        mode=sched.mode, n_completed=len(done), n_rejected=sched.n_rejected,
        n_unfinished=len(sched.requests) - len(done),
        total_cycles=total_cycles, total_energy=total_energy,
        tokens_out=tokens, throughput=tokens / cyc,
        energy_per_token=total_energy / max(tokens, 1),
        p50_latency=percentile(norm_lat, 50), p99_latency=percentile(norm_lat, 99),
        p50_ttft=percentile(ttft, 50), p99_ttft=percentile(ttft, 99),
        cost_source=cost_source)
    if slo is not None:
        met = [r for r in done
               if r.finish - r.arrival <= slo.budget(r.prompt_len, r.max_new)]
        met_tokens = sum(r.tokens_out for r in met)
        energy_ok = (slo.energy_per_token is None
                     or report.energy_per_token <= slo.energy_per_token)
        report.slo = {
            "p99_cycles_per_token": slo.p99_cycles_per_token,
            "energy_budget_per_token": slo.energy_per_token,
            "attainment": len(met) / max(len(done), 1),
            "throughput_at_slo": met_tokens / cyc,
            "p99_met": report.p99_latency <= slo.p99_cycles_per_token,
            "energy_met": energy_ok,
        }
    if dispatch is not None:
        report.straggler = {
            "n_hosts": dispatch.n_hosts,
            "flagged_hosts": dispatch.flagged_hosts,
            "flag_events": len(dispatch.monitor.events),
            "weights": list(dispatch.weights),
            "dead_hosts": dispatch.dead(total_cycles),
        }
    return report


# ---------------------------------------------------------------------------
# virtual-time serve simulation (trace-driven, deterministic)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TraceRequest:
    """One request in an arrival trace (times in cycles-equivalent)."""
    rid: int
    arrival: float
    prompt_len: int
    max_new: int


def simulate_serve(trace: List[TraceRequest], n_slots: int,
                   cost: StepCostModel, mode: str = "continuous",
                   slo: Optional[ServeSLO] = None,
                   admission: Optional[AdmissionControl] = None,
                   prefill_chunk: int = 8,
                   dispatch: Optional[HostDispatch] = None,
                   max_steps: int = 200_000) -> ServeReport:
    """Run an arrival trace through the scheduler in virtual time.

    Pure bookkeeping over the calibrated :class:`StepCostModel` — no model,
    no jax — so it is exactly deterministic for a fixed trace, which is what
    lets ``benchmarks/serve_slo.py`` gate on exact numbers in CI.  Each step
    ingests up to ``prefill_chunk`` prompt tokens per prefilling slot and
    decodes one token per decoding slot; a slot whose prefill completes this
    step emits its first token the next step (matching the live engine).
    Step time is stretched by the :class:`HostDispatch` barrier when hosts
    are attached; energy is not stretched (a slow host takes longer at the
    same power draw modelled per useful token).
    """
    sched = ContinuousScheduler(n_slots, mode=mode, admission=admission)
    trace = sorted(trace, key=lambda t: (t.arrival, t.rid))
    clock = 0.0
    ai = 0
    steps = 0
    total_energy = 0.0
    while steps < max_steps:
        while ai < len(trace) and trace[ai].arrival <= clock:
            t = trace[ai]
            ai += 1
            try:
                sched.submit(t.rid, t.prompt_len, t.max_new, now=t.arrival)
            except AdmissionError:
                pass                       # shed load; counted by scheduler
        sched.refill(clock)
        active = sched.active()
        if not active:
            if ai < len(trace):
                clock = max(clock, trace[ai].arrival)
                continue
            if sched.queue:                # static mode drains between waves
                sched.refill(clock)
                if not sched.active():
                    break                  # unservable leftovers
                continue
            break
        prefill_tokens = 0
        decoding = [r for _, r in active if r.phase == "decode"]
        for _, r in active:
            if r.phase == "prefill":
                chunk = min(prefill_chunk, r.prompt_len - r.prefill_cursor)
                prefill_tokens += chunk
                sched.advance_prefill(r.rid, chunk, clock)
        cycles, energy = cost.step_cost(n_slots, prefill_tokens)
        if dispatch is not None:
            cycles = dispatch.step(cycles, clock)
        clock += cycles
        total_energy += energy
        for r in decoding:
            sched.record_token(r.rid, clock)
        steps += 1
    return build_report(sched, clock, total_energy, slo=slo,
                        dispatch=dispatch,
                        cost_source=cost.source)
