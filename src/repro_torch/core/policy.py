"""Execution policies — the paper's methodology ladder, framework-wide.

BASELINE  — original sequential code on the single-issue core (Snitch [6]).
COPIFT    — DAC'25 methodology [1]: DFG partition + batch + software pipeline
            + double buffering; inter-thread communication spilled to memory;
            batch-granular semaphore synchronization.
COPIFTV2  — this paper: DFG partition + schedule; communication and
            synchronization through blocking hardware FIFO queues (I2F/F2I);
            no loop transformations.

The port's own copy of ``repro.core.policy``.  On the card the enum steers
``kernels/queue_matmul``: BASELINE is the plain matmul, COPIFT stages one
tile per operand and waits for it before computing (ring depth 1), and
COPIFTV2 keeps ``depth`` tiles of each operand in flight in shared memory.

An :class:`OperatingPoint` bundles the policy with the queue geometry /
unroll it should run at, and a :class:`PolicyTable` resolves one per
workload: an explicit override wins, then a calibrated entry, then the
paper's hard-coded headline point.  Reading calibration artifacts needs the
machine model (``repro.core.calibrate``), which the port does not have yet,
so the port's :func:`default_table` holds no entry and every workload
resolves to the defaults, as the JAX package does when no artifact exists.
Resolution happens once at startup — the selection machinery stays off the
hot path.
"""
from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass
from typing import Dict, Optional


class ExecutionPolicy(enum.Enum):
    BASELINE = "baseline"
    COPIFT = "copift"
    COPIFTV2 = "copiftv2"

    @classmethod
    def parse(cls, s: "str | ExecutionPolicy") -> "ExecutionPolicy":
        if isinstance(s, ExecutionPolicy):
            return s
        return cls(s.lower())


@dataclass(frozen=True)
class OperatingPoint:
    """One (policy, queue geometry, unroll) choice for a workload.

    The defaults are the paper's headline hardware point (queue depth 4,
    latency 1, unroll 8 under COPIFTv2) — the fallback when no calibration
    is available.  ``source`` records how the point was chosen:
    ``"default"`` (fallback), ``"calibrated"`` (from a calibration record)
    or ``"override"`` (caller-pinned).
    """
    policy: ExecutionPolicy = ExecutionPolicy.COPIFTV2
    queue_depth: int = 4
    queue_latency: int = 1
    unroll: int = 8
    unroll_int: Optional[int] = None
    queue_depth_i2f: Optional[int] = None
    queue_depth_f2i: Optional[int] = None
    #: cluster geometry: PEs sharing the TCDM and the bank count (None =
    #: conflict-free).  The paper's headline point is a single PE.
    n_cores: int = 1
    tcdm_banks: Optional[int] = None
    #: pipelined-cluster geometry: producer/consumer core pairing over
    #: inter-core channels, the channel FIFO depth, and the producer's DMA
    #: double-buffering degree.  The defaults leave the fabric unused.
    pipeline: bool = False
    cq_depth: int = 4
    dma_buffers: int = 2
    source: str = "default"

    def effective_depths(self) -> "tuple[int, int]":
        return (self.queue_depth_i2f or self.queue_depth,
                self.queue_depth_f2i or self.queue_depth)


#: Consumer workloads mapped to the machine-model kernel whose instruction
#: mix is the closest analogue: the per-kernel calibration for the proxy
#: supplies the workload's operating point.
#:  * ``queue_matmul`` / ``moe_gemm`` stream quantized operand tiles through
#:    a blocking FIFO ring — the int8 dequantization dot product;
#:  * ``serve`` decode is dominated by activation math (exp in softmax /
#:    gating) — the range-reduction ``expf`` kernel;
#:  * ``train`` is GEMM-bound — ``dequant_dot`` again.
WORKLOAD_PROXIES: Dict[str, str] = {
    "queue_matmul": "dequant_dot",
    "moe_gemm": "dequant_dot",
    "serve": "expf",
    "train": "dequant_dot",
}

#: Consumer workloads' pinned queue-visibility latency class: operand tiles
#: cross the shared interconnect (class 2), serve decode's softmax/gating
#: FIFOs are core-local (class 1).
WORKLOAD_QUEUE_LATENCIES: Dict[str, int] = {
    "queue_matmul": 2,
    "moe_gemm": 2,
    "serve": 1,
    "train": 2,
}

#: Serve-path traffic levels: offered load as a fraction of the best
#: sustainable service rate.  A calibration record may carry one
#: ``serve-slo`` selection per level; :meth:`PolicyTable.resolve` takes a
#: ``traffic=`` level and falls back to the latency-class/global selection.
TRAFFIC_LEVELS: Dict[str, float] = {
    "low": 0.3,
    "medium": 0.6,
    "high": 0.85,
}


class PolicyTable:
    """Workload → :class:`OperatingPoint` resolution.

    Resolution order for :meth:`resolve`:

    1. an explicit ``override`` point (or keyword field overrides) — wins
       unconditionally, tagged ``source="override"``;
    2. an entry for the workload itself, then for its
       :data:`WORKLOAD_PROXIES` proxy kernel.  When the entry has a record
       (``records``), a pinned ``traffic=`` level's selection wins, else
       the workload's queue-latency class selection; the entry itself is
       the fallback;
    3. the :class:`OperatingPoint` defaults — tagged ``"default"``.

    ``records`` hold objects with ``operating_point_for(latency)`` and,
    optionally, ``operating_point_for_traffic(level)``, as the JAX
    package's calibration records do.
    """

    def __init__(self, entries: Optional[Dict[str, OperatingPoint]] = None,
                 records: Optional[Dict[str, "object"]] = None):
        self.entries: Dict[str, OperatingPoint] = dict(entries or {})
        self.records: Dict[str, "object"] = dict(records or {})

    def resolve(self, workload: str,
                override: Optional[OperatingPoint] = None,
                queue_latency: Optional[int] = None,
                traffic: Optional[str] = None,
                **field_overrides) -> OperatingPoint:
        if override is not None:
            return dataclasses.replace(override, source="override")
        key = workload if workload in self.entries else \
            WORKLOAD_PROXIES.get(workload)
        point = self.entries.get(key) if key is not None else None
        if point is not None:
            rec = self.records.get(key)
            traffic_point = None
            if rec is not None and traffic is not None:
                for_traffic = getattr(rec, "operating_point_for_traffic",
                                      None)
                if for_traffic is not None:
                    traffic_point = for_traffic(traffic)
            if traffic_point is not None:
                point = traffic_point
            else:
                if queue_latency is None:
                    queue_latency = WORKLOAD_QUEUE_LATENCIES.get(workload)
                if rec is not None and queue_latency is not None:
                    point = rec.operating_point_for(queue_latency)  # type: ignore[attr-defined]
        if point is None:
            point = OperatingPoint()
        if field_overrides:
            point = dataclasses.replace(point, **field_overrides,
                                        source="override")
        return point

    def __repr__(self) -> str:
        return f"PolicyTable({sorted(self.entries)})"


#: the process-wide table: no calibrated entry until the port reads
#: calibration artifacts, so every workload resolves to the defaults
_DEFAULT_TABLE = PolicyTable()


def default_table() -> PolicyTable:
    """The process-wide table (empty in this slice of the port)."""
    return _DEFAULT_TABLE
