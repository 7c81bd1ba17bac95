"""The traced part of a ``--trace 1`` run: ``torch.profiler`` (CPU and
CUDA activity) over the last few seconds of the window, opened at a step
boundary and closed as the window closes, and its reduction to
device-busy time, kernel time by name, the top device operations and the
idle gaps labelled by the innermost host span or operation open across
them.

Kineto stamps host and device events on one clock (nanoseconds since the
epoch), so a gap between device operations is labelled by what the host
was doing then."""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

import torch

TOP = 10


def _ns(e, what: str) -> int:
    f = getattr(e, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, f"{what}_us")() * 1000)


class Tracer:
    """Profiles the last ``seconds`` of the window: it starts at the first
    step boundary that many seconds before the close and stops when the
    window closes, so that stopping the profiler and reducing its events
    delay no step of the window."""

    def __init__(self, window_s: float, seconds: float,
                 device: torch.device):
        self.device = device
        self.window_s = window_s
        self.seconds = min(seconds, window_s)
        self.t_open: Optional[float] = None
        self.prof = None
        self.result: Optional[Dict[str, Any]] = None

    @staticmethod
    def warm() -> None:
        """Start and stop the profiler once, so its first-use cost falls in
        set-up, not in the window."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def poll(self, drv, now: float) -> None:
        if self.t_open is None:
            self.t_open = now
        if (self.prof is None
                and now >= self.t_open + self.window_s - self.seconds):
            self._start(drv)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _start(self, drv) -> None:
        from torch.profiler import ProfilerActivity, profile
        self._sync()
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        self.ns0 = time.time_ns()
        drv.profiled = True

    def stop(self, drv) -> None:
        """At the window's close: stop profiling (the reduction waits for
        :meth:`finish`)."""
        if self.prof is None:
            return
        self._sync()
        self.t1 = time.perf_counter()
        self.ns1 = time.time_ns()
        drv.profiled = False
        self.prof.__exit__(None, None, None)

    def finish(self) -> Optional[Dict[str, Any]]:
        """The reduction of the traced events, once the window is over."""
        if self.prof is not None and self.result is None:
            self.result = reduce(self.prof.profiler.kineto_results.events(),
                                 self.ns0, self.ns1, self.t1 - self.t0)
            self.prof = None
        return self.result


def kernel_seconds(result: Optional[Dict[str, Any]], kernel: str
                   ) -> Optional[float]:
    """Device seconds of a kernel of the program by its name: every device
    operation whose name holds ``<kernel>_`` (its ``__global__`` functions
    are named so: ``queue_matmul_thin``, ``decode_attention_split``, ...);
    None where the trace has none."""
    if not result:
        return None
    s = sum(v for k, v in result["kernel_by_name"].items()
            if f"{kernel}_" in k)
    return s if s > 0 else None


def _merge(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _label(cpu: List[Tuple[int, int, str]], starts: List[int], t: int) -> str:
    """The innermost host event open at ``t`` (the latest-starting one that
    covers it), or ``host, no event``."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - 400), -1):
        s, e, name = cpu[j]
        if e >= t:
            return name
    return "host, no event"


def reduce(events, ns0: int, ns1: int, window_s: float) -> Dict[str, Any]:
    """Device busy seconds (the union of device operations), kernel seconds
    by family and by name, and idle seconds by host label, over the traced
    window [ns0, ns1]."""
    dev: List[Tuple[int, int, str]] = []
    cpu: List[Tuple[int, int, str]] = []
    for e in events:
        s = _ns(e, "start")
        d = _ns(e, "duration")
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.is_user_annotation():
                continue
            dev.append((s, s + d, e.name()))
        else:
            cpu.append((s, s + d, e.name()))
    stamps = [s for s, _, _ in dev + cpu]
    if stamps and abs(min(stamps) - ns0) > 10**9:
        # the profiler's clock is not the epoch's: take its own span
        ns0, ns1 = min(stamps), max(e for _, e, _ in dev + cpu)
        window_s = (ns1 - ns0) * 1e-9
    by_name: Dict[str, float] = defaultdict(float)
    for s, e, name in dev:
        by_name[name] += (e - s) * 1e-9
    busy = _merge([(max(s, ns0), min(e, ns1)) for s, e, _ in dev
                   if e > ns0 and s < ns1])
    busy_s = sum(e - s for s, e in busy) * 1e-9
    cpu.sort()
    starts = [c[0] for c in cpu]
    idle: Dict[str, float] = defaultdict(float)
    edge = ns0
    for s, e in busy + [(ns1, ns1)]:
        if s > edge:
            idle[_label(cpu, starts, (s + edge) // 2)] += (s - edge) * 1e-9
        edge = max(edge, e)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy_s, "window_s": window_s,
            "n_device_ops": len(dev), "kernel_by_name": dict(by_name),
            "device_ops": [[k[:160], v] for k, v in top],
            "idle_gaps": [[k[:160], v] for k, v in gaps]}
