"""Execution policies — the paper's methodology ladder, framework-wide.

BASELINE  — original sequential code on the single-issue core (Snitch [6]).
COPIFT    — DAC'25 methodology [1]: DFG partition + batch + software pipeline
            + double buffering; inter-thread communication spilled to memory;
            batch-granular semaphore synchronization.
COPIFTV2  — this paper: DFG partition + schedule; communication and
            synchronization through blocking hardware FIFO queues (I2F/F2I);
            no loop transformations.

The port's own copy of ``repro.core.policy``.  On the card the enum steers
``kernels/queue_matmul`` (and ``moe_gemm``): BASELINE is the plain matmul,
COPIFT stages one tile per operand and waits for it before computing (ring
depth 1), and COPIFTV2 keeps ``depth`` tiles of each operand in flight in
shared memory.

Policy *selection* lives here too: an :class:`OperatingPoint` bundles the
policy with the queue geometry / unroll it should run at, and a
:class:`PolicyTable` resolves one per workload.  The table is populated from
DSE calibration artifacts (``core.calibrate``, written by
``python -m repro_torch.examples.explore calibrate`` into
``artifacts/calibration/`` or the ``REPRO_CALIBRATION_DIR`` override; the
JAX package's artifacts are the same files); consumers fall back to the
paper's hard-coded headline point when no artifact exists, and an explicit
override always wins.  Workloads whose fabric pins a queue-visibility
latency class (:data:`WORKLOAD_QUEUE_LATENCIES`) resolve through the
schema-v4 per-class selections when the artifact carries them, with the
global selection as the fallback.  Resolution happens once at startup — the
selection machinery stays off the hot path (cf. Snitch, arXiv:2002.10143).
"""
from __future__ import annotations

import dataclasses
import enum
import os
import warnings
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
    latency 1, unroll 8 under COPIFTv2) — the sane fallback when no
    calibration artifact is available.  ``source`` records how the point was
    chosen: ``"default"`` (fallback), ``"calibrated"`` (loaded from a DSE
    artifact) or ``"override"`` (caller-pinned).
    """
    policy: ExecutionPolicy = ExecutionPolicy.COPIFTV2
    queue_depth: int = 4
    queue_latency: int = 1
    unroll: int = 8
    unroll_int: Optional[int] = None
    queue_depth_i2f: Optional[int] = None
    queue_depth_f2i: Optional[int] = None
    #: cluster geometry (``core.cluster``): PEs sharing the TCDM and the
    #: bank count (None = conflict-free).  The paper's headline point is a
    #: single PE; cluster-level calibration artifacts populate these.
    n_cores: int = 1
    tcdm_banks: Optional[int] = None
    #: pipelined-cluster geometry (``transform.partition_pipeline`` +
    #: ``core.cluster``): producer/consumer core pairing over inter-core
    #: channels, the channel FIFO depth, and the producer's DMA
    #: double-buffering degree.  The paper's headline point is a single
    #: work-partitioned PE, so the defaults leave the fabric unused.
    pipeline: bool = False
    cq_depth: int = 4
    dma_buffers: int = 2
    source: str = "default"

    def effective_depths(self) -> "tuple[int, int]":
        return (self.queue_depth_i2f or self.queue_depth,
                self.queue_depth_f2i or self.queue_depth)


#: Consumer workloads mapped to the machine-model kernel whose instruction
#: mix is the closest analogue: the per-kernel calibration
#: artifact for the proxy supplies the workload's operating point.
#:  * ``queue_matmul`` / ``moe_gemm`` stream quantized operand tiles through
#:    a blocking FIFO ring — the int8 dequantization dot product is the
#:    matching mixed int/FP kernel;
#:  * ``serve`` decode is dominated by activation math (exp in softmax /
#:    gating) — the range-reduction ``expf`` kernel;
#:  * ``train`` is GEMM-bound (forward + backward matmuls over quantized
#:    comms) — ``dequant_dot`` again.
WORKLOAD_PROXIES: Dict[str, str] = {
    "queue_matmul": "dequant_dot",
    "moe_gemm": "dequant_dot",
    "serve": "expf",
    "train": "dequant_dot",
}

#: Consumer workloads' pinned queue-visibility latency class.  The fabric a
#: workload's machine analogue communicates over fixes how many cycles a
#: pushed value takes to become pop-visible, and the schema-v4 calibration
#: artifacts carry per-latency-class selections (``selected_by_latency``)
#: precisely so these consumers can take the best point *at their latency*
#: instead of the global winner: ``queue_matmul`` / ``moe_gemm`` / ``train``
#: stream operand tiles through the shared-TCDM interconnect (one traversal
#: each way: class 2), while ``serve`` decode's softmax/gating FIFOs are
#: core-local (class 1).  :meth:`PolicyTable.resolve` falls back to the
#: global selection when the class was never swept.
WORKLOAD_QUEUE_LATENCIES: Dict[str, int] = {
    "queue_matmul": 2,
    "moe_gemm": 2,
    "serve": 1,
    "train": 2,
}

#: Serve-path traffic levels: offered load as a fraction of the best
#: sustainable service rate on the calibrated Pareto front.  The schema-v5
#: calibration artifacts carry one ``serve-slo`` selection per level
#: (``selected_by_traffic``): max throughput subject to the estimated-p99
#: and joules-per-token bounds *at that offered load* — queueing delay
#: grows with load, so the feasible set shrinks as traffic rises and the
#: levels select different points on fronts where cheap-but-slow
#: configurations only hold the SLO when the queue stays short.
#: :meth:`PolicyTable.resolve` takes a ``traffic=`` level and falls back to
#: the latency-class/global selection when the artifact predates v5 or
#: never analysed that level.
TRAFFIC_LEVELS: Dict[str, float] = {
    "low": 0.3,
    "medium": 0.6,
    "high": 0.85,
}


class PolicyTable:
    """Workload → :class:`OperatingPoint` resolution, calibration-backed.

    Resolution order for :meth:`resolve`:

    1. an explicit ``override`` point (or keyword field overrides) — wins
       unconditionally, tagged ``source="override"``;
    2. a calibrated entry for the workload itself, then for its
       :data:`WORKLOAD_PROXIES` proxy kernel — tagged ``"calibrated"``.
       When a ``traffic=`` level is pinned and the artifact carries a
       schema-v5 per-traffic ``serve-slo`` selection for it, that level's
       point wins; otherwise, when the workload pins a queue-latency class
       (an explicit ``queue_latency=`` argument, or its
       :data:`WORKLOAD_QUEUE_LATENCIES` entry) and the artifact carries a
       schema-v4 per-class selection for it, that class's point is
       returned; the global selection is the fallback for classes/levels
       the calibration never analysed;
    3. the :class:`OperatingPoint` defaults — tagged ``"default"``.
    """

    def __init__(self, entries: Optional[Dict[str, OperatingPoint]] = None,
                 directory: Optional[str] = None,
                 records: Optional[Dict[str, "object"]] = None):
        self.entries: Dict[str, OperatingPoint] = dict(entries or {})
        #: kernel -> full CalibrationRecord, kept alongside the resolved
        #: global points so latency-class resolution can reach
        #: ``operating_point_for`` (in-memory tables have none)
        self.records: Dict[str, "object"] = dict(records or {})
        self.directory = directory

    @classmethod
    def load(cls, directory: Optional[str] = None) -> "PolicyTable":
        """Build a table from every valid artifact in the calibration
        directory (``REPRO_CALIBRATION_DIR`` or ``artifacts/calibration``).
        Invalid or stale artifacts are skipped with a warning — consumers
        then fall back to defaults rather than failing at startup."""
        # local import: calibrate imports sweep -> policy (cycle otherwise)
        from .calibrate import (CalibrationError, calibration_dir,
                                load_artifact)
        directory = directory or calibration_dir()
        entries: Dict[str, OperatingPoint] = {}
        records: Dict[str, "object"] = {}
        if os.path.isdir(directory):
            for fname in sorted(os.listdir(directory)):
                if not fname.endswith(".json"):
                    continue
                path = os.path.join(directory, fname)
                try:
                    rec = load_artifact(path)
                except CalibrationError as e:
                    warnings.warn(
                        f"ignoring calibration artifact {path}: {e}; "
                        f"affected workloads fall back to defaults",
                        stacklevel=2)
                    continue
                entries[rec.kernel] = rec.operating_point()
                records[rec.kernel] = rec
        return cls(entries, directory=directory, records=records)

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
                # schema-v5 per-traffic serve-slo selection; getattr keeps
                # pre-v5 CalibrationRecord objects (and stale-fallback
                # loads) working — they simply lack the accessor
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
        return (f"PolicyTable({sorted(self.entries)} "
                f"from {self.directory or '<memory>'})")


# One table per calibration directory: loading scans the filesystem, and the
# resolved points must stay stable for a process's lifetime (selection is a
# startup decision, never a hot-path one).  Keyed by directory so tests can
# repoint ``REPRO_CALIBRATION_DIR`` at temp dirs without cross-talk.
_TABLE_CACHE: Dict[str, PolicyTable] = {}


def default_table() -> PolicyTable:
    """The process-wide calibration-backed table (cached per directory)."""
    from .calibrate import calibration_dir
    directory = calibration_dir()
    table = _TABLE_CACHE.get(directory)
    if table is None:
        table = _TABLE_CACHE[directory] = PolicyTable.load(directory)
    return table


def clear_policy_table_cache() -> None:
    """Drop cached tables (tests repointing ``REPRO_CALIBRATION_DIR``)."""
    _TABLE_CACHE.clear()
