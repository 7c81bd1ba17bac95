"""One run of one cell: set-up, the measured window, the check of what the
window produced, and the result's line.

Set-up runs from the process's start to the window's opening: the cell's
kernels built or loaded (``build/kernels/`` inside the checkout), the
weights drawn on the device from the seed, the engine built with its cache,
and each program this cell's traffic uses warmed and captured.  The window
then drives only ``ServeEngine.submit`` and ``ServeEngine.step``.  Once it
has closed (and an open loop's due requests have drained), the device's
peak memory is read, the served tokens are copied out and the engine is
freed; only then does the plain reference run.
"""
from __future__ import annotations

import gc
import json
import sys
import time
from typing import Any, Dict, Optional

import torch

from . import check, kinds, readers, serving, timeline, weights
from .env import process_start
from .manifest import Cell
from .trace import Tracer
from .traffic import make_requests

#: seconds the traced part of a ``--trace 1`` window lasts (its end)
TRACE_SECONDS = 3.0


def build_kernels(cfg: Dict[str, Any]) -> None:
    """Build (first run in a checkout) or find the configuration's kernels,
    all ``nvcc`` processes at once."""
    from repro_torch.kernels import _build
    _build.build_all(cfg["kernels"])


def device_info(device: torch.device, peak: int) -> Dict[str, Any]:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": peak}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, started: Optional[float] = None,
        control: bool = False) -> Dict[str, Any]:
    """The result of one run (the result line's keys, ``check`` last).
    ``control`` also reads the control's numbers (:func:`check.gaps`) and
    scores them against the cell's limits (``control_correct``), which
    the benchmark's own runs never do."""
    started = process_start() if started is None else started
    cfg, mix = cell.config, cell.traffic
    srv = cfg["serving"]
    if device.type == "cuda":
        build_kernels(cfg)
    w = weights.draw(cfg, seed, device)
    eng = serving.build_engine(cfg, w, device)
    serving.warm(eng, srv["prefill_chunk"])
    tracer = None
    if trace:
        if device.type == "cuda":
            Tracer.warm()
        tracer = Tracer(seconds, TRACE_SECONDS, device)
    reqs = make_requests(mix, seed, seconds, cfg["vocab"], srv["max_len"])
    recs = [serving.Rec(r) for r in reqs]
    drv = serving.Driver(eng, recs)
    _sync(device)
    setup_s = time.time() - started
    kind = kinds.load(mix["kind"])
    t_open, t_close, t_drained = kind.drive(drv, recs, seconds, mix, tracer)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    run_ = serving.Run(cfg, srv["slots"], drv.recs, drv.steps, t_open,
                       t_close, t_drained, setup_s,
                       tracer.finish() if tracer is not None else None)
    check.collect(eng, drv.recs)
    programs = eng.programs()
    del eng, drv
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = readers.read(m["name"], run_)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    t_check = time.perf_counter()
    sample = check.sample(run_, seed, check.n_sample(cell.check))
    readings = check.gaps(cfg, w, sample, device, control)
    readings["check_s"] = time.perf_counter() - t_check
    limits = check.limits_of(cell.check)
    ok, table = check.verdict(readings, limits)
    due = timeline.due(run_)
    out: Dict[str, Any] = {
        "correct": bool(ok and readings["requests"] > 0),
        "attempted": len(due), "failed": kind.failed(due),
        "metrics": metrics, "device": device_info(device, peak)}
    if trace and run_.trace is not None:
        out["device"]["busy_s"] = run_.trace["busy_s"]
        out["device"]["window_s"] = run_.trace["window_s"]
        out["breakdown"] = {"device_ops": run_.trace["device_ops"],
                            "idle_gaps": run_.trace["idle_gaps"]}
    out["programs"] = {k: {"replays": v["replays"],
                           "capture_s": v["capture_s"]}
                       for k, v in programs.items()}
    out["load"] = load(run_)
    out["checked"] = readings
    if control:
        out["control_correct"] = check.control_verdict(readings, limits)[0]
    out["check"] = table
    return out


def backlog(run_: serving.Run, t: float) -> int:
    """Requests due by ``t`` and not yet placed in a slot at ``t``."""
    return sum(r.due_t <= t and (r.placed_t is None or r.placed_t > t)
               for r in run_.recs)


def load(run_: serving.Run) -> Dict[str, Any]:
    """What the knee sweep reads: the offered requests, the backlog half
    way through the window and at its close, and the unfinished ones at
    the drain's end."""
    due = timeline.due(run_)
    ttft = timeline.ttft_s(run_)
    return {"offered": len(due),
            **{f"ttft_p{q}_s": timeline.percentile(ttft, q)
               for q in (50, 90, 95)},
            "drain_s": run_.t_drained - run_.t_close,
            "backlog_half": backlog(run_, run_.t_open + run_.window_s / 2),
            "backlog_close": backlog(run_, run_.t_close),
            "unfinished": sum(r.finish_t is None for r in due),
            "steps": len(run_.window_steps())}


def report(out: Dict[str, Any]) -> None:
    """Each number compared beside its limit as the last lines on standard
    error, then the result as the last line on standard output."""
    for name, v in out["check"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)

