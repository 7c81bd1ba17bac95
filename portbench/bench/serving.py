"""The system under test: ``repro_torch.serve.ServeEngine`` built from a
configuration file, warmed, and driven through one measured window.

The window's only entry into the program is the engine's ``submit`` and
``step``.  Around each call the harness keeps its own records: when each
request was due, submitted, placed in a slot (seen at the start of the
step that placed it), and when each of its tokens reached the host (a
step returns once its argmax is copied there).  From the scheduler's
public per-request counters it also notes, for each step, which slots
took how many columns at which cache length: the work the step's
programs did for requests.  Spans named ``portbench.*`` wrap each call
for the profiler (``torch.profiler.record_function``).
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

from .traffic import Request

clock = time.perf_counter

def widths(prefill_chunk: int) -> List[int]:
    """The chunk widths the engine buckets a step to (powers of two)."""
    return [1 << i for i in range(prefill_chunk.bit_length())
            if 1 << i <= prefill_chunk]


@dataclass
class Rec:
    """One request of the traffic as the harness saw it (host seconds)."""
    req: Request
    due_t: float = 0.0
    submit_t: Optional[float] = None
    refused: bool = False
    rid: Optional[int] = None
    placed_t: Optional[float] = None
    first_t: Optional[float] = None
    last_t: Optional[float] = None
    finish_t: Optional[float] = None
    generated: List[int] = field(default_factory=list)


@dataclass
class Step:
    t0: float
    t1: float
    width: int                      # columns of the chunk program; 0: decode
    cols: List[Tuple[int, int]]     # (cache length before, columns) a slot
    new_tokens: int
    in_window: bool
    profiled: bool = False


@dataclass
class Run:
    """Everything a run recorded, for the metric readers."""
    model: Dict[str, Any]
    slots: int
    recs: List[Rec]
    steps: List[Step]
    t_open: float
    t_close: float
    t_drained: float
    setup_s: float
    trace: Optional[Dict[str, Any]] = None

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open

    def window_steps(self) -> List[Step]:
        return [s for s in self.steps if s.in_window]


def port_config(cfg: Dict[str, Any]):
    """The program's registry config for ``cfg``'s ``arch`` (the reduced
    one where ``registry`` is ``reduced``, for tests), held to every key of
    the file that names a field of the program's config: a number or a
    string compared as it is, a group (``moe``) field by field, and
    ``head_dim`` as the program resolves it.  The family's layout
    (:func:`.weights.check_layout`) holds the rest."""
    import dataclasses
    from repro_torch.configs import get_config, get_reduced
    mcfg = (get_reduced if cfg.get("registry") == "reduced"
            else get_config)(cfg["arch"])
    fields = {f.name for f in dataclasses.fields(mcfg)} - {"name"}
    bad = {}
    for key in fields.intersection(cfg):
        have = (mcfg.resolved_head_dim if key == "head_dim"
                else getattr(mcfg, key))
        want = cfg[key]
        if isinstance(want, dict):
            have = None if have is None else {
                k: getattr(have, k, None) for k in want}
        if have != want:
            bad[key] = (have, want)
    if bad:
        raise SystemExit(f"{cfg['arch']}: the program's config departs from "
                         f"the file's (program, file): {bad}")
    return mcfg


def build_engine(cfg: Dict[str, Any], weights: Dict[str, Any], device):
    """The engine as the configuration file states it: its dtype, slots,
    cache length, chunk and pending bound, on the paper's default
    operating point (no calibration is read)."""
    from repro_torch.config import RunConfig
    from repro_torch.core.policy import OperatingPoint
    from repro_torch.models.model import param_shapes
    from repro_torch.serve import ServeEngine
    from .weights import check_layout
    mcfg = port_config(cfg)
    check_layout(cfg, param_shapes(mcfg, cfg["dtype"]))
    srv = cfg["serving"]
    rc = RunConfig(dtype=cfg["dtype"], param_dtype=cfg["dtype"], remat=False)
    return ServeEngine(weights, mcfg, rc, batch_slots=srv["slots"],
                       max_len=srv["max_len"],
                       operating_point=OperatingPoint(),
                       max_pending=srv["max_pending"], prefill="chunked",
                       prefill_chunk=srv["prefill_chunk"], device=device)


def warm(eng, prefill_chunk: int) -> None:
    """Run each program this cell's traffic uses once, so each is captured
    before the window: a request of ``w`` prompt tokens for each chunk
    width ``w`` (its first step runs the chunk program of width ``w``) and
    two new tokens (its second step runs the decode program)."""
    for w in widths(prefill_chunk):
        rid = eng.submit(list(range(1, w + 1)), max_new=2)
        while rid not in eng.finished:
            eng.step()


class Driver:
    """Drives the engine through the window and keeps the records."""

    def __init__(self, eng, recs: List[Rec]):
        self.eng = eng
        self.recs = recs
        self.by_rid: Dict[int, Rec] = {}
        self.steps: List[Step] = []
        self.before: Dict[int, Tuple[int, int]] = {}
        self.n_finished = len(eng.finished)
        self.profiled = False

    def submit(self, rec: Rec, now: float) -> None:
        from repro_torch.serve.scheduler import AdmissionError
        rec.submit_t = now
        with torch.profiler.record_function("portbench.submit"):
            try:
                rec.rid = self.eng.submit(rec.req.prompt, rec.req.max_new)
            except AdmissionError:
                rec.refused = True
                return
        self.by_rid[rec.rid] = rec

    def step(self, in_window: bool) -> None:
        eng = self.eng
        t0 = clock()
        with torch.profiler.record_function("portbench.step"):
            eng.step()
        t1 = clock()
        with torch.profiler.record_function("portbench.observe"):
            self._observe(t0, t1, in_window)

    def _observe(self, t0: float, t1: float, in_window: bool) -> None:
        sched = self.eng.sched
        rids = [s.rid for s in sched.slots if s is not None]
        if len(self.eng.finished) > self.n_finished:
            rids += list(itertools.islice(self.eng.finished,
                                          self.n_finished, None))
            self.n_finished = len(self.eng.finished)
        cols, new, width = [], 0, 0
        for rid in rids:
            sr = sched.requests[rid]
            c0, n0 = self.before.get(rid, (0, 0))
            c1, n1 = sr.prefill_cursor, sr.tokens_out
            if c0 < sr.prompt_len:
                cols.append((c0, c1 - c0))
                width = max(width, c1 - c0)
            else:
                cols.append((sr.prompt_len + n0 - 1, 1))
            rec = self.by_rid.get(rid)
            if rec is None:
                continue
            if rec.placed_t is None:
                rec.placed_t = t0
            if n1 > n0:
                new += n1 - n0
                if rec.first_t is None:
                    rec.first_t = t1
                rec.last_t = t1
            if sr.finish is not None and rec.finish_t is None:
                rec.finish_t = t1
        self.before = {s.rid: (s.prefill_cursor, s.tokens_out)
                       for s in sched.slots if s is not None}
        width = 1 << (width - 1).bit_length() if width else 0
        self.steps.append(Step(t0, t1, width, cols, new, in_window,
                               self.profiled))

    def pending(self) -> int:
        return len(self.eng.sched.queue)

    def busy(self) -> bool:
        return self.eng.sched.busy
