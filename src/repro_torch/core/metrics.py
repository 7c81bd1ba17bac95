"""Result aggregation for the reproduction experiments (paper Fig. 3)."""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import (Callable, Dict, Hashable, Iterable, List, Optional,
                    TypeVar)

from .bench_kernels import KERNELS
from .machine import MachineConfig, SimResult, simulate
from .policy import ExecutionPolicy
from .transform import TransformConfig, lower

T = TypeVar("T")


def geomean(xs: Iterable[float]) -> float:
    xs = list(xs)
    return math.exp(sum(math.log(x) for x in xs) / len(xs))


def group_by(items: Iterable[T],
             key: Callable[[T], Hashable]) -> Dict[Hashable, List[T]]:
    """Bucket ``items`` by ``key(item)``, preserving input order per bucket."""
    out: Dict[Hashable, List[T]] = {}
    for it in items:
        out.setdefault(key(it), []).append(it)
    return out


def best(items: Iterable[T], attr: str, maximize: bool = True) -> T:
    """The item with the extreme value of ``attr`` (works on records too)."""
    pick = max if maximize else min
    return pick(items, key=lambda it: getattr(it, attr))


@dataclass
class KernelComparison:
    kernel: str
    results: Dict[ExecutionPolicy, SimResult]

    def ipc(self, p: ExecutionPolicy) -> float:
        return self.results[p].ipc

    def speedup(self, a: ExecutionPolicy, b: ExecutionPolicy) -> float:
        """Throughput (samples/cycle) of ``a`` relative to ``b``."""
        return self.results[a].throughput / self.results[b].throughput

    def energy_gain(self, a: ExecutionPolicy, b: ExecutionPolicy) -> float:
        """Energy-efficiency (samples/J) of ``a`` relative to ``b``."""
        return self.results[a].efficiency / self.results[b].efficiency

    def power_ratio(self, a: ExecutionPolicy, b: ExecutionPolicy) -> float:
        return self.results[a].power / self.results[b].power


def run_suite(n_samples: int = 128,
              tcfg: Optional[TransformConfig] = None,
              mcfg: Optional[MachineConfig] = None,
              kernels: Optional[List[str]] = None) -> Dict[str, KernelComparison]:
    tcfg = tcfg or TransformConfig(n_samples=n_samples)
    mcfg = mcfg or MachineConfig()
    out: Dict[str, KernelComparison] = {}
    for name in (kernels or list(KERNELS)):
        dfg = KERNELS[name]
        res = {p: simulate(lower(dfg, p, tcfg), mcfg) for p in ExecutionPolicy}
        out[name] = KernelComparison(name, res)
    return out


def summarize(suite: Dict[str, KernelComparison]) -> Dict[str, float]:
    V2, CP, BL = (ExecutionPolicy.COPIFTV2, ExecutionPolicy.COPIFT,
                  ExecutionPolicy.BASELINE)
    sp = {k: c.speedup(V2, CP) for k, c in suite.items()}
    eg = {k: c.energy_gain(V2, CP) for k, c in suite.items()}
    sb = {k: c.speedup(V2, BL) for k, c in suite.items()}
    eb = {k: c.energy_gain(V2, BL) for k, c in suite.items()}
    return {
        "peak_ipc_v2": max(c.ipc(V2) for c in suite.values()),
        "max_speedup_vs_copift": max(sp.values()),
        "geomean_speedup_vs_copift": geomean(sp.values()),
        "max_energy_vs_copift": max(eg.values()),
        "geomean_energy_vs_copift": geomean(eg.values()),
        "max_speedup_vs_baseline": max(sb.values()),
        "max_energy_vs_baseline": max(eb.values()),
        "geomean_ipc_copift_vs_baseline": geomean(
            c.ipc(CP) / c.ipc(BL) for c in suite.values()),
        "geomean_energy_copift_vs_baseline": geomean(
            c.energy_gain(CP, BL) for c in suite.values()),
    }


#: Published claims (paper §III / abstract, plus [1] for COPIFT-vs-baseline).
PAPER_CLAIMS = {
    "peak_ipc_v2": 1.81,
    "max_speedup_vs_copift": 1.49,
    "geomean_speedup_vs_copift": 1.19,
    "max_energy_vs_copift": 1.47,
    "geomean_energy_vs_copift": 1.21,
    "max_speedup_vs_baseline": 1.96,
    "max_energy_vs_baseline": 1.75,
    "geomean_ipc_copift_vs_baseline": 1.6,
    "geomean_energy_copift_vs_baseline": 1.3,
}
