"""Straggler detection: robust z-score over per-step wall times (median/MAD),
with a mitigation hook.  On real clusters the hook re-shards or evicts the
slow host; in this container tests inject synthetic timings."""
from __future__ import annotations

from collections import deque
from typing import Callable, Deque, List, Optional, Tuple


class StragglerMonitor:
    def __init__(self, window: int = 50, threshold: float = 4.0,
                 min_samples: int = 10,
                 on_straggler: Optional[Callable[[int, float, float], None]] = None):
        self.window: Deque[float] = deque(maxlen=window)
        self.threshold = threshold
        self.min_samples = min_samples
        self.on_straggler = on_straggler
        self.events: List[Tuple[int, float, float]] = []

    @staticmethod
    def _median(xs: List[float]) -> float:
        s = sorted(xs)
        n = len(s)
        return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])

    def record(self, step: int, seconds: float) -> bool:
        """Record a step time; returns True if it is flagged as a straggler.
        Flagged samples are excluded from the baseline window."""
        flagged = False
        if len(self.window) >= self.min_samples:
            med = self._median(list(self.window))
            mad = self._median([abs(x - med) for x in self.window]) or 1e-9
            z = 0.6745 * (seconds - med) / mad
            if z > self.threshold:
                flagged = True
                self.events.append((step, seconds, z))
                if self.on_straggler:
                    self.on_straggler(step, seconds, z)
        if not flagged:
            self.window.append(seconds)
        return flagged


class Heartbeat:
    """Host liveness tracking (simulated clock injectable for tests).

    Hosts start their timeout clock at ``start`` (the monitor's creation
    time), not at an implicit 0.0: a monitor created at a large wall-clock
    ``now`` must not declare every host dead before any has had a chance
    to beat."""

    def __init__(self, hosts: List[str], timeout: float = 60.0,
                 start: float = 0.0):
        self.timeout = timeout
        self.last: dict = {h: start for h in hosts}

    def beat(self, host: str, now: float) -> None:
        self.last[host] = now

    def dead(self, now: float) -> List[str]:
        return [h for h, t in self.last.items() if now - t > self.timeout]
