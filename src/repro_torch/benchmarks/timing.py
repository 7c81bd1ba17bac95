"""The timers the benchmarks and ``examples.copiftv2_demo`` share: device
time from CUDA events on the card, the host clock elsewhere."""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch

#: the timing sleep: cycles per second at the H100's highest SM clock (a
#: lower clock sleeps longer), and the longest sleep
SLEEP_CYCLES_PER_S, MAX_SLEEP_S = 1.98e9, 0.2


def event_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` in ms between two CUDA events around
    ``iters`` calls, after ``warmup`` calls.  The calls queue behind a
    sleep on the card long enough for the host to enqueue them all, so the
    host's time to launch them does not show."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    sleep_s = min(MAX_SLEEP_S, 1.5 * iters * host_s + 1e-3)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(sleep_s * SLEEP_CYCLES_PER_S))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, reps: int, barrier: Optional[Callable[[], object]] = None
            ) -> float:
    """Mean host-clock microseconds of ``fn()`` over ``reps`` calls after a
    warm one; ``barrier`` (a process group's, say) runs before and after
    the timed calls."""
    fn()
    if barrier is not None:
        barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    if barrier is not None:
        barrier()
    return (time.perf_counter() - t0) / reps * 1e6
