"""Design-space exploration over the machine model (the DSE engine).

The paper's headline numbers come from one hardware point (queue depth 4,
latency 1, unroll 8).  This module sweeps the whole configuration grid —
(kernel x policy x queue_depth x queue_latency x unroll x unroll_int) — through
the simulator and reduces each run to a flat :class:`SweepRecord` with IPC,
energy, throughput and the stall breakdown, ready for Pareto extraction
(``core.pareto``) and CSV emission.

Every sweep point doubles as a correctness test: the simulated program's
outputs are compared bit-for-bit against the sequential baseline interpreter
(``LoopDFG.eval_reference``), so a large sweep is also the repo's largest
semantics fuzzer for the COPIFT/COPIFTv2 lowerings.

Sweep points are plain primitives (no lambdas, no Programs), so they pickle
across process boundaries; :func:`run_sweep` fans the grid out over a process
pool (the stepper is pure Python — processes, not threads, buy parallelism)
and falls back to in-process execution when a pool is unavailable.

Per-worker caching: a sweep redoes a lot of shared work if every point is
treated as independent — ``lower()`` does not depend on ``queue_latency``
(nor on ``queue_depth`` for queue-free policies), and the interpreter oracle
``dfg.eval_reference`` depends only on ``(kernel, n_samples)``.  Both are
memoized per process (:func:`_lower_cached` / :func:`_reference_cached`),
and :func:`partition_points` hands each pool worker a contiguous, presized
run of points sorted by lowering key so those memos actually hit.  Workers
are sized by ``min(cpu, len(points))`` and can be pinned with the
``REPRO_SWEEP_WORKERS`` environment variable (CI sets it to 1).

Engines: every point carries an ``engine`` field.  ``"cycle"`` and
``"event"`` are the per-point steppers from ``core.machine``;
``engine="batch"`` routes non-clustered points through
``core.batch_machine.BatchStepper``, which advances *all points sharing a
lowered program* in one vectorized pass — each worker groups its partition
by program identity (:func:`_batch_records`), so the whole
``queue_depth x queue_latency x i2f x f2i`` machine axis of a
depth-insensitive policy collapses into a single numpy evaluation.
Clustered and pipelined points batch the same way: grouped by
*partitioned-program-set* identity and advanced through
``core.batch_cluster.BatchClusterStepper`` (:func:`_batch_cluster_records`),
collapsing the ``banks x cq_depth x machine`` axes of one partitioning
into a single pass.  Both batch engines are bit-identical to the event
engine (enforced by ``tests/test_batch_machine.py`` /
``tests/test_batch_cluster.py``); program sets they cannot express fall
back to the per-point event stepper.

Strategies: :func:`run_sweep` evaluates every point exhaustively by
default; ``strategy="adaptive"`` dispatches to
``core.search.adaptive_sweep`` (front-guided successive halving), which
returns records only for points that survive to full fidelity.
"""
from __future__ import annotations

import functools
import itertools
import os
from dataclasses import asdict, dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .batch_cluster import (BatchClusterDeadlock, BatchClusterStepper,
                            BatchClusterUnsupported)
from .batch_machine import BatchDeadlock, BatchStepper, BatchUnsupported
from .bench_kernels import KERNELS
from .cluster import ClusterConfig, ClusterStepper
from .isa import Queue
from .machine import DeadlockError, ENGINES, MachineConfig, stepper_for
from .metrics import best, geomean, group_by
from .policy import ExecutionPolicy
from .transform import (TransformConfig, lower, partition_kernel,
                        partition_pipeline)

#: engines accepted by sweep points: the per-point steppers from
#: ``core.machine`` plus the vectorized batch engine (``core.batch_machine``)
SWEEP_ENGINES: Tuple[str, ...] = tuple(ENGINES) + ("batch",)

#: search strategies accepted by :func:`run_sweep`
STRATEGIES: Tuple[str, ...] = ("exhaustive", "adaptive")


@dataclass(frozen=True)
class SweepPoint:
    """One configuration in the design space.  All fields are primitives so
    points (and lists of them) pickle cleanly into pool workers."""
    kernel: str
    policy: str                      # ExecutionPolicy value
    queue_depth: int = 4
    queue_latency: int = 1
    unroll: int = 8
    unroll_int: Optional[int] = None
    n_samples: int = 64
    engine: str = "event"            # SWEEP_ENGINES: "event"|"cycle"|"batch"
    #: asymmetric FIFO geometry: per-queue depth overrides (None => the
    #: symmetric ``queue_depth``).  The lowering targets the tighter queue
    #: (min effective depth), which keeps the no-deadlock schedule guarantee
    #: on the looser one.
    queue_depth_i2f: Optional[int] = None
    queue_depth_f2i: Optional[int] = None
    #: cluster geometry (``core.cluster``): cores sharing the TCDM, and the
    #: bank count (None = conflict-free).  ``n_cores=1, tcdm_banks=None`` is
    #: the single-PE machine, bit-identical to the plain stepper.
    n_cores: int = 1
    tcdm_banks: Optional[int] = None
    #: pipelined-cluster axes (``transform.partition_pipeline``):
    #: ``pipeline=True`` splits each core pair into an INT producer streaming
    #: operands over inter-core channels to an FP-heavy consumer.
    #: ``cq_depth`` bounds the channel FIFOs (runtime property, like
    #: ``tcdm_banks``); ``dma_buffers`` is the producer's double-buffering
    #: degree (a schedule property — it shapes the lowered program).
    pipeline: bool = False
    cq_depth: int = 4
    dma_buffers: int = 2

    def effective_depths(self) -> Tuple[int, int]:
        return (self.queue_depth_i2f or self.queue_depth,
                self.queue_depth_f2i or self.queue_depth)

    @property
    def clustered(self) -> bool:
        return self.n_cores > 1 or self.tcdm_banks is not None or self.pipeline


@dataclass
class SweepRecord:
    """Flat, serializable result for one sweep point."""
    kernel: str
    policy: str
    queue_depth: int
    queue_latency: int
    unroll: int
    unroll_int: Optional[int]
    n_samples: int
    status: str                      # "ok" | "rejected" | "deadlock"
    detail: str = ""
    cycles: int = 0
    ipc: float = 0.0
    energy: float = 0.0
    power: float = 0.0
    throughput: float = 0.0
    efficiency: float = 0.0
    instrs_int: int = 0
    instrs_fp: int = 0
    max_occ_i2f: int = 0
    max_occ_f2i: int = 0
    fifo_violations: int = 0
    equivalent: bool = False         # outputs bit-identical to the interpreter
    engine: str = "event"
    queue_depth_i2f: Optional[int] = None
    queue_depth_f2i: Optional[int] = None
    #: cluster columns: core count, TCDM banks (None = conflict-free),
    #: mean per-core IPC (== ipc on one core; ``ipc`` itself is the cluster
    #: aggregate over the makespan, up to 2*n_cores), and the total cycles
    #: lost to bank conflicts
    n_cores: int = 1
    tcdm_banks: Optional[int] = None
    ipc_per_core: float = 0.0
    bank_stalls: int = 0
    #: pipelined-cluster columns: the pipeline/channel/DMA geometry
    #: plus the cycles lost to channel back-pressure (``*_cq_empty`` +
    #: ``*_cq_full``) and to DMA waits (``*_dma``)
    pipeline: bool = False
    cq_depth: int = 4
    dma_buffers: int = 2
    cq_stalls: int = 0
    dma_stalls: int = 0
    stalls: Dict[str, int] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return self.status == "ok"


#: column order for CSV emission (see ``core.pareto.write_csv``)
CSV_FIELDS: Tuple[str, ...] = (
    "kernel", "policy", "queue_depth", "queue_latency", "unroll", "unroll_int",
    "n_samples", "status", "cycles", "ipc", "energy", "power", "throughput",
    "efficiency", "instrs_int", "instrs_fp", "max_occ_i2f", "max_occ_f2i",
    "fifo_violations", "equivalent", "engine", "queue_depth_i2f",
    "queue_depth_f2i", "n_cores", "tcdm_banks", "ipc_per_core", "bank_stalls",
    "pipeline", "cq_depth", "dma_buffers", "cq_stalls", "dma_stalls",
    "stalls", "detail",
)

#: the earlier column set (cluster axes but no pipeline/channel/DMA ones);
#: ``core.pareto.read_csv`` still accepts it, defaulting the pipeline columns
PRE_PIPELINE_CSV_FIELDS: Tuple[str, ...] = tuple(
    f for f in CSV_FIELDS
    if f not in ("pipeline", "cq_depth", "dma_buffers", "cq_stalls",
                 "dma_stalls"))

#: the oldest column set (no cluster axes); ``core.pareto.read_csv``
#: still accepts it, defaulting the cluster columns (n_cores=1)
LEGACY_CSV_FIELDS: Tuple[str, ...] = tuple(
    f for f in PRE_PIPELINE_CSV_FIELDS
    if f not in ("n_cores", "tcdm_banks", "ipc_per_core", "bank_stalls"))


def grid(kernels: Optional[Sequence[str]] = None,
         policies: Optional[Sequence[ExecutionPolicy]] = None,
         queue_depths: Sequence[int] = (1, 2, 4, 8),
         queue_latencies: Sequence[int] = (1,),
         unrolls: Sequence[int] = (8,),
         unroll_ints: Sequence[Optional[int]] = (None,),
         n_samples: int = 64,
         engine: str = "event",
         i2f_depths: Sequence[Optional[int]] = (None,),
         f2i_depths: Sequence[Optional[int]] = (None,),
         n_cores: Sequence[int] = (1,),
         tcdm_banks: Sequence[Optional[int]] = (None,),
         pipelines: Sequence[bool] = (False,),
         cq_depths: Sequence[int] = (4,),
         dma_buffers: Sequence[int] = (2,)) -> List[SweepPoint]:
    """Enumerate the cartesian configuration grid as sweep points.

    ``i2f_depths``/``f2i_depths`` add asymmetric FIFO geometries: each non-
    None value overrides that queue's depth while ``queue_depths`` keeps
    supplying the symmetric base (and the other queue's depth).

    ``n_cores``/``tcdm_banks`` are the cluster axes (``core.cluster``):
    core counts sharing the TCDM and bank counts (None = conflict-free).
    The defaults keep every existing grid a single-PE grid.

    ``pipelines``/``cq_depths``/``dma_buffers`` are the pipelined-cluster
    axes: producer/consumer core pairing over inter-core channels,
    channel FIFO depth, and the producer's DMA double-buffering degree.
    Pipelined points require an even ``n_cores >= 2`` and the COPIFTv2
    policy — other combinations come back as ``status="rejected"``."""
    ks = list(kernels) if kernels else sorted(KERNELS)
    ps = list(policies) if policies else list(ExecutionPolicy)
    unknown = [k for k in ks if k not in KERNELS]
    if unknown:
        raise KeyError(f"unknown kernels: {unknown} (have {sorted(KERNELS)})")
    if engine not in SWEEP_ENGINES:
        raise ValueError(
            f"unknown engine {engine!r} (have {SWEEP_ENGINES})")
    if any(nc < 1 for nc in n_cores):
        raise ValueError(f"n_cores axis must be positive: {tuple(n_cores)}")
    if any(nb is not None and nb < 1 for nb in tcdm_banks):
        raise ValueError(
            f"tcdm_banks axis must be positive or None: {tuple(tcdm_banks)}")
    if any(cd < 1 for cd in cq_depths):
        raise ValueError(f"cq_depths axis must be positive: {tuple(cq_depths)}")
    if any(db < 1 for db in dma_buffers):
        raise ValueError(
            f"dma_buffers axis must be positive: {tuple(dma_buffers)}")
    return [
        SweepPoint(kernel=k, policy=ExecutionPolicy.parse(p).value,
                   queue_depth=d, queue_latency=lat, unroll=u, unroll_int=ui,
                   n_samples=n_samples, engine=engine,
                   queue_depth_i2f=di, queue_depth_f2i=df,
                   n_cores=nc, tcdm_banks=nb,
                   pipeline=pl, cq_depth=cd, dma_buffers=db)
        for k, p, d, lat, u, ui, di, df, nc, nb, pl, cd, db in
        itertools.product(
            ks, ps, queue_depths, queue_latencies, unrolls, unroll_ints,
            i2f_depths, f2i_depths, n_cores, tcdm_banks, pipelines,
            cq_depths, dma_buffers)
    ]


# -- per-worker memos --------------------------------------------------------
# Both caches are process-local (each pool worker owns one) and keyed purely
# on primitives, so cache state never crosses a pickle boundary.  Cached
# values are treated as immutable by every consumer: steppers copy
# ``init_env`` and never touch a Program's streams, and the interpreter
# reference is only compared against, never written.

def _tcfg_for(pt: SweepPoint) -> TransformConfig:
    # the schedule targets the tighter FIFO of an asymmetric pair: the
    # replay gate's no-deadlock guarantee then holds a fortiori on the
    # looser queue
    return TransformConfig(unroll=pt.unroll, unroll_int=pt.unroll_int,
                           batch=min(32, pt.n_samples),
                           queue_depth=min(pt.effective_depths()),
                           n_samples=pt.n_samples)


def _lower_key(pt: SweepPoint) -> Tuple:
    """The transform-relevant fields of a point (see
    ``TransformConfig.lowering_key``): ``queue_latency`` never matters, and
    ``queue_depth`` only matters for depth-sensitive policies.  ``n_cores``
    shapes the partitioned per-core programs; ``tcdm_banks`` is purely a
    runtime (machine) property.  ``pipeline``/``dma_buffers`` shape the
    producer/consumer programs; ``cq_depth`` is runtime-only (like
    ``tcdm_banks``)."""
    policy = ExecutionPolicy.parse(pt.policy)
    pipe = (pt.pipeline, pt.dma_buffers if pt.pipeline else 0)
    return (pt.kernel, pt.n_cores) + pipe + _tcfg_for(pt).lowering_key(policy)


@functools.lru_cache(maxsize=64)
def _lower_cached(kernel: str, policy_value: str, tcfg: TransformConfig):
    """Memoized ``lower()``; raises ValueError exactly like the uncached
    call (lru_cache does not cache exceptions, but rejection is cheap)."""
    return lower(KERNELS[kernel], ExecutionPolicy.parse(policy_value), tcfg)


@functools.lru_cache(maxsize=64)
def _reference_cached(kernel: str, n_samples: int):
    """Memoized sequential-interpreter oracle for equivalence checks."""
    return KERNELS[kernel].eval_reference(n_samples)


@functools.lru_cache(maxsize=64)
def _partition_cached(kernel: str, policy_value: str, tcfg: TransformConfig,
                      n_cores: int) -> Tuple:
    """Memoized ``partition_kernel()`` (the cluster analogue of
    ``_lower_cached``); raises ValueError exactly like the uncached call."""
    return tuple(partition_kernel(KERNELS[kernel],
                                  ExecutionPolicy.parse(policy_value),
                                  tcfg, n_cores))


@functools.lru_cache(maxsize=64)
def _pipeline_cached(kernel: str, tcfg: TransformConfig, n_cores: int,
                     dma_buffers: int) -> Tuple:
    """Memoized ``partition_pipeline()`` (producer/consumer pairing is
    COPIFTv2-only, so no policy key); raises ValueError like the uncached
    call."""
    return tuple(partition_pipeline(KERNELS[kernel], tcfg, n_cores,
                                    dma_buffers=dma_buffers))


def clear_worker_caches() -> None:
    """Drop this process's lowering/reference memos (benchmark hygiene)."""
    from . import transform
    _lower_cached.cache_clear()
    _reference_cached.cache_clear()
    _partition_cached.cache_clear()
    _pipeline_cached.cache_clear()
    transform._V2_PREFIX_CACHE.clear()
    transform._PARTITION_CACHE.clear()


def _geometry_detail(pt: SweepPoint) -> Optional[str]:
    """A rejection message for malformed cluster geometry, else None."""
    if (pt.n_cores < 1 or (pt.tcdm_banks is not None and pt.tcdm_banks < 1)
            or pt.cq_depth < 1 or pt.dma_buffers < 1):
        return (f"invalid cluster geometry: n_cores={pt.n_cores}, "
                f"tcdm_banks={pt.tcdm_banks}, cq_depth={pt.cq_depth}, "
                f"dma_buffers={pt.dma_buffers}")
    return None


def _point_base(pt: SweepPoint, policy: ExecutionPolicy) -> Dict:
    """The identity columns every record for ``pt`` shares."""
    return dict(kernel=pt.kernel, policy=policy.value,
                queue_depth=pt.queue_depth, queue_latency=pt.queue_latency,
                unroll=pt.unroll, unroll_int=pt.unroll_int,
                n_samples=pt.n_samples, engine=pt.engine,
                queue_depth_i2f=pt.queue_depth_i2f,
                queue_depth_f2i=pt.queue_depth_f2i,
                n_cores=pt.n_cores, tcdm_banks=pt.tcdm_banks,
                pipeline=pt.pipeline, cq_depth=pt.cq_depth,
                dma_buffers=pt.dma_buffers)


def _lower_tcfg(pt: SweepPoint, policy: ExecutionPolicy) -> TransformConfig:
    """The lowering config for ``pt``, normalized so the per-worker memo key
    collapses axes the transform ignores (depth for queue-free policies)."""
    tcfg = _tcfg_for(pt)
    if policy not in TransformConfig.DEPTH_SENSITIVE_POLICIES:
        # depth is not transform-relevant here: normalize it out of the memo
        # key so one lowering serves the whole depth axis
        tcfg = TransformConfig(unroll=tcfg.unroll, unroll_int=tcfg.unroll_int,
                               batch=tcfg.batch, n_samples=tcfg.n_samples)
    return tcfg


def _mcfg_for(pt: SweepPoint) -> MachineConfig:
    d_i2f, d_f2i = pt.effective_depths()
    return MachineConfig(queue_depth=pt.queue_depth,
                         queue_latency=pt.queue_latency,
                         queue_depths=({Queue.I2F: d_i2f, Queue.F2I: d_f2i}
                                       if (pt.queue_depth_i2f is not None or
                                           pt.queue_depth_f2i is not None)
                                       else None))


def _check_equivalent(dfg, env: Dict, n_samples: int, ref: Dict) -> bool:
    """Outputs in ``env`` bit-identical to the interpreter oracle ``ref``?"""
    return all(
        [env.get(f"{node.name}@{i}") for i in range(n_samples)]
        == ref[node.name]
        for node in dfg.outputs())


def _ok_record(base: Dict, res, equivalent: bool) -> SweepRecord:
    """Flatten a single-PE :class:`SimResult` into an ok record."""
    s = res.summary()
    return SweepRecord(
        **base, status="ok", cycles=s["cycles"], ipc=s["ipc"],
        energy=s["energy"], power=s["power"], throughput=s["throughput"],
        efficiency=s["efficiency"], instrs_int=s["instrs_int"],
        instrs_fp=s["instrs_fp"], max_occ_i2f=s["max_occ_i2f"],
        max_occ_f2i=s["max_occ_f2i"], fifo_violations=s["fifo_violations"],
        equivalent=equivalent, ipc_per_core=s["ipc"], stalls=s["stalls"])


def run_point(pt: SweepPoint, *, use_caches: bool = True) -> SweepRecord:
    """Lower + simulate one configuration and check baseline equivalence.

    Never raises for model-level outcomes: infeasible schedules come back as
    ``status="rejected"`` and runtime deadlocks as ``status="deadlock"`` so a
    sweep always yields one record per point.  ``use_caches=False`` bypasses
    the per-worker memos (the pre-caching pipeline, kept for benchmarking).

    ``engine="batch"`` on a single point runs a width-1 batch — single-PE
    points through :class:`~.batch_machine.BatchStepper`, clustered and
    pipelined points through
    :class:`~.batch_cluster.BatchClusterStepper` (the grouped fast paths
    live in :func:`_batch_records` / :func:`_batch_cluster_records`,
    reached via :func:`run_sweep`); batch-inexpressible programs fall back
    to the per-point event stepper.
    """
    dfg = KERNELS[pt.kernel]
    policy = ExecutionPolicy.parse(pt.policy)
    detail = _geometry_detail(pt)
    if detail is not None:
        # a malformed cluster geometry must yield one rejected record, not a
        # raw traceback killing a pool worker (and an n_cores=0 point must
        # never masquerade as a cheap single-PE run in a calibration sweep)
        return SweepRecord(**_point_base(pt, policy), status="rejected",
                           detail=detail)
    base = _point_base(pt, policy)
    tcfg = _lower_tcfg(pt, policy)
    mcfg = _mcfg_for(pt)
    if pt.clustered:
        return _run_cluster_point(pt, dfg, policy, base, tcfg, mcfg,
                                  use_caches)
    try:
        if use_caches:
            prog = _lower_cached(pt.kernel, policy.value, tcfg)
        else:
            prog = lower(dfg, policy, tcfg, use_prefix_cache=False)
    except ValueError as e:
        return SweepRecord(**base, status="rejected", detail=str(e))
    if pt.engine == "batch":
        try:
            out = BatchStepper(prog, [mcfg]).run()[0]
        except BatchUnsupported:
            out = None               # inexpressible: event-stepper fallback
        if isinstance(out, BatchDeadlock):
            return SweepRecord(**base, status="deadlock", detail=out.message)
        res = out
    else:
        res = None
    if res is None:
        try:
            sim_engine = "event" if pt.engine == "batch" else pt.engine
            res = stepper_for(prog, mcfg, sim_engine).run()
        except DeadlockError as e:
            return SweepRecord(**base, status="deadlock", detail=str(e))
    ref = (_reference_cached(pt.kernel, pt.n_samples) if use_caches
           else dfg.eval_reference(pt.n_samples))
    equivalent = _check_equivalent(dfg, res.env, pt.n_samples, ref)
    return _ok_record(base, res, equivalent)


def _pipeline_policy_detail(pt: SweepPoint,
                            policy: ExecutionPolicy) -> Optional[str]:
    """A rejection message for pipelined points on the wrong policy."""
    if pt.pipeline and policy is not ExecutionPolicy.COPIFTV2:
        return (f"pipeline partitioning is COPIFTv2-only "
                f"(got policy {policy.value!r})")
    return None


def _cluster_progs(pt: SweepPoint, dfg, policy: ExecutionPolicy,
                   tcfg: TransformConfig, use_caches: bool) -> Tuple:
    """The per-core program set for a clustered point.  Raises ValueError
    for infeasible partitionings, exactly like the uncached transforms.
    The memoized variants return one tuple object per distinct
    partitioning, so ``id(progs)`` doubles as the batch grouping key."""
    if pt.pipeline:
        if use_caches:
            return _pipeline_cached(pt.kernel, tcfg, pt.n_cores,
                                    pt.dma_buffers)
        return tuple(partition_pipeline(dfg, tcfg, pt.n_cores,
                                        dma_buffers=pt.dma_buffers,
                                        use_prefix_cache=False))
    if use_caches:
        return _partition_cached(pt.kernel, policy.value, tcfg, pt.n_cores)
    return tuple(partition_kernel(dfg, policy, tcfg, pt.n_cores,
                                  use_prefix_cache=False))


def _ccfg_for(pt: SweepPoint, mcfg: MachineConfig) -> ClusterConfig:
    return ClusterConfig(n_cores=pt.n_cores, tcdm_banks=pt.tcdm_banks,
                         machine=mcfg, cq_depth=pt.cq_depth,
                         dma_buffers=pt.dma_buffers)


def _cluster_ok_record(pt: SweepPoint, base: Dict, dfg, res, ref,
                       equiv_memo: Optional[Dict] = None) -> SweepRecord:
    """Flatten a :class:`~.cluster.ClusterResult` into an ok record, checking
    the *concatenated* per-core outputs against the sequential interpreter.
    Work-partitioned points assign disjoint sample ranges per core (core
    ``c`` owns ``[c*chunk, (c+1)*chunk)``); pipelined points assign them per
    producer/consumer *pair* — only the odd-indexed (consumer) cores hold
    outputs.  ``equiv_memo`` (grouped batch path) caches the check per
    distinct env tuple: lockstep points of one group share env objects."""
    if pt.pipeline:
        # outputs live on the consumer cores (odd indices), one per pair
        owners = res.core_results[1::2]
    else:
        owners = res.core_results
    chunk = pt.n_samples // len(owners)
    key = tuple(id(core.env) for core in owners)
    equivalent = equiv_memo.get(key) if equiv_memo is not None else None
    if equivalent is None:
        equivalent = all(
            [core.env.get(f"{node.name}@{i}") for i in range(chunk)]
            == ref[node.name][c * chunk:(c + 1) * chunk]
            for node in dfg.outputs()
            for c, core in enumerate(owners))
        if equiv_memo is not None:
            equiv_memo[key] = equivalent
    s = res.summary()
    return SweepRecord(
        **base, status="ok", cycles=s["cycles"], ipc=s["ipc"],
        energy=s["energy"], power=s["power"], throughput=s["throughput"],
        efficiency=s["efficiency"], instrs_int=s["instrs_int"],
        instrs_fp=s["instrs_fp"], max_occ_i2f=s["max_occ_i2f"],
        max_occ_f2i=s["max_occ_f2i"], fifo_violations=s["fifo_violations"],
        equivalent=equivalent, ipc_per_core=s["ipc_per_core"],
        bank_stalls=s["bank_stalls"], cq_stalls=s["cq_stalls"],
        dma_stalls=s["dma_stalls"], stalls=s["stalls"])


def _run_cluster_point(pt: SweepPoint, dfg, policy: ExecutionPolicy,
                       base: Dict, tcfg: TransformConfig,
                       mcfg: MachineConfig,
                       use_caches: bool) -> SweepRecord:
    """The cluster leg of :func:`run_point`: partition the kernel across
    ``pt.n_cores`` and run the per-core programs under the shared bank
    arbiter.  ``engine="batch"`` runs a width-1
    :class:`~.batch_cluster.BatchClusterStepper` (the grouped fast path
    lives in :func:`_batch_cluster_records`); inexpressible program sets
    fall back to the per-point event engine."""
    detail = _pipeline_policy_detail(pt, policy)
    if detail is not None:
        return SweepRecord(**base, status="rejected", detail=detail)
    try:
        progs = _cluster_progs(pt, dfg, policy, tcfg, use_caches)
    except ValueError as e:
        return SweepRecord(**base, status="rejected", detail=str(e))
    ccfg = _ccfg_for(pt, mcfg)
    res = None
    if pt.engine == "batch":
        try:
            out = BatchClusterStepper(progs, [ccfg]).run()[0]
        except BatchClusterUnsupported:
            out = None               # inexpressible: event-stepper fallback
        if isinstance(out, BatchClusterDeadlock):
            return SweepRecord(**base, status="deadlock", detail=out.message)
        res = out
    if res is None:
        try:
            sim_engine = "event" if pt.engine == "batch" else pt.engine
            res = ClusterStepper(progs, ccfg, engine=sim_engine).run()
        except DeadlockError as e:
            return SweepRecord(**base, status="deadlock", detail=str(e))
    ref = (_reference_cached(pt.kernel, pt.n_samples) if use_caches
           else dfg.eval_reference(pt.n_samples))
    return _cluster_ok_record(pt, base, dfg, res, ref)


def partition_points(points: Sequence[SweepPoint],
                     workers: int) -> List[List[int]]:
    """Presized, cache-friendly partition of ``points`` for a worker pool.

    Returns at most ``workers`` lists of *input indices*.  Points sharing a
    lowering key stay on one worker and adjacent keys stay adjacent (the
    partition walks key groups in sorted order, cutting only at group
    boundaries once a worker reaches its presized target), so each worker's
    lowering/reference memos see runs of hits instead of a random shuffle.
    """
    if workers <= 0:
        raise ValueError("workers must be positive")
    groups: Dict[Tuple, List[int]] = {}
    for i, pt in enumerate(points):
        groups.setdefault(_lower_key(pt), []).append(i)
    target = -(-len(points) // workers)          # ceil division
    parts: List[List[int]] = [[]]

    def sortable(kv):                # lowering keys mix None with ints
        return tuple((v is None, 0 if v is None else v) for v in kv[0])

    for _key, idxs in sorted(groups.items(), key=sortable):
        if len(parts[-1]) >= target and len(parts) < workers:
            parts.append([])
        parts[-1].extend(idxs)
    return parts


def _batch_eligible(pt: SweepPoint) -> bool:
    """Points the grouped batch paths handle: batch-engine with well-formed
    geometry — single-PE points go through :func:`_batch_records`, clustered
    and pipelined ones through :func:`_batch_cluster_records` (everything
    else goes through :func:`run_point`)."""
    return pt.engine == "batch" and _geometry_detail(pt) is None


def _batch_records(pairs: List[Tuple[int, SweepPoint]]
                   ) -> List[Tuple[int, SweepRecord]]:
    """The grouped fast path for batch-eligible points.

    Lowers every point through the per-worker memo, groups by *lowered
    program identity* — ``id(prog)`` merges the whole machine axis of a
    depth-insensitive policy (and depth-saturated COPIFTv2 classes that
    reuse a Program) into one group — and advances each group through a
    single :class:`~.batch_machine.BatchStepper` pass.  Per group, the
    equivalence oracle is checked once per distinct result env (lockstep
    points share one env object; only scalar-delegated outliers re-check).
    Groups the batch engine cannot express fall back to per-point event
    simulation via :func:`run_point`; deadlocked points become
    ``status="deadlock"`` records exactly like the scalar path."""
    out: List[Tuple[int, SweepRecord]] = []
    groups: Dict[int, List[Tuple[int, SweepPoint, MachineConfig]]] = {}
    progs: Dict[int, object] = {}
    for i, pt in pairs:
        policy = ExecutionPolicy.parse(pt.policy)
        try:
            prog = _lower_cached(pt.kernel, policy.value,
                                 _lower_tcfg(pt, policy))
        except ValueError as e:
            out.append((i, SweepRecord(**_point_base(pt, policy),
                                       status="rejected", detail=str(e))))
            continue
        gid = id(prog)
        progs[gid] = prog
        groups.setdefault(gid, []).append((i, pt, _mcfg_for(pt)))
    for gid, items in groups.items():
        prog = progs[gid]
        try:
            results = BatchStepper(prog, [m for _, _, m in items]).run()
        except BatchUnsupported:
            out.extend((i, run_point(pt)) for i, pt, _ in items)
            continue
        equiv_by_env: Dict[int, bool] = {}
        for (i, pt, _mcfg), res in zip(items, results):
            policy = ExecutionPolicy.parse(pt.policy)
            base = _point_base(pt, policy)
            if isinstance(res, BatchDeadlock):
                out.append((i, SweepRecord(**base, status="deadlock",
                                           detail=res.message)))
                continue
            eq = equiv_by_env.get(id(res.env))
            if eq is None:
                eq = _check_equivalent(
                    KERNELS[pt.kernel], res.env, pt.n_samples,
                    _reference_cached(pt.kernel, pt.n_samples))
                equiv_by_env[id(res.env)] = eq
            out.append((i, _ok_record(base, res, eq)))
    return out


def _batch_cluster_records(pairs: List[Tuple[int, SweepPoint]]
                           ) -> List[Tuple[int, SweepRecord]]:
    """The grouped fast path for batch-eligible *clustered* points.

    Partitions every point through the per-worker memos, groups by
    *partitioned-program-set identity* — the memoized transforms return one
    tuple per distinct partitioning, so ``id(progs)`` merges the whole
    ``tcdm_banks x cq_depth x machine`` axis of one partitioning (bank
    count, channel depth and per-core MachineConfig are runtime properties)
    into one group — and advances each group through a single
    :class:`~.batch_cluster.BatchClusterStepper` pass.  The equivalence
    oracle runs once per distinct env tuple (lockstep points share the
    per-core env objects; only scalar-delegated outliers re-check).
    Program sets the batch engine cannot express fall back to per-point
    event simulation via :func:`run_point`; deadlocked points become
    ``status="deadlock"`` records carrying the scalar engine's message."""
    out: List[Tuple[int, SweepRecord]] = []
    groups: Dict[int, List[Tuple[int, SweepPoint, ClusterConfig]]] = {}
    progsets: Dict[int, Tuple] = {}
    for i, pt in pairs:
        policy = ExecutionPolicy.parse(pt.policy)
        base = _point_base(pt, policy)
        detail = _pipeline_policy_detail(pt, policy)
        if detail is not None:
            out.append((i, SweepRecord(**base, status="rejected",
                                       detail=detail)))
            continue
        try:
            progs = _cluster_progs(pt, KERNELS[pt.kernel], policy,
                                   _lower_tcfg(pt, policy), use_caches=True)
        except ValueError as e:
            out.append((i, SweepRecord(**base, status="rejected",
                                       detail=str(e))))
            continue
        gid = id(progs)
        progsets[gid] = progs
        groups.setdefault(gid, []).append((i, pt, _ccfg_for(pt,
                                                            _mcfg_for(pt))))
    for gid, items in groups.items():
        progs = progsets[gid]
        try:
            results = BatchClusterStepper(
                progs, [c for _, _, c in items]).run()
        except BatchClusterUnsupported:
            out.extend((i, run_point(pt)) for i, pt, _ in items)
            continue
        equiv_memo: Dict[Tuple[int, ...], bool] = {}
        for (i, pt, _ccfg), res in zip(items, results):
            policy = ExecutionPolicy.parse(pt.policy)
            base = _point_base(pt, policy)
            if isinstance(res, BatchClusterDeadlock):
                out.append((i, SweepRecord(**base, status="deadlock",
                                           detail=res.message)))
                continue
            dfg = KERNELS[pt.kernel]
            ref = _reference_cached(pt.kernel, pt.n_samples)
            out.append((i, _cluster_ok_record(pt, base, dfg, res, ref,
                                              equiv_memo)))
    return out


def _run_indexed(pairs: List[Tuple[int, SweepPoint]]
                 ) -> List[Tuple[int, SweepRecord]]:
    """Pool-worker entry: run a batch in partition order, tagging each record
    with its input index so the caller can restore input order.  Batch-
    eligible points peel off into the grouped fast paths (single-PE and
    cluster); the rest run one at a time."""
    batched = [(i, pt) for i, pt in pairs
               if _batch_eligible(pt) and not pt.clustered]
    clustered = [(i, pt) for i, pt in pairs
                 if _batch_eligible(pt) and pt.clustered]
    rest = [(i, pt) for i, pt in pairs if not _batch_eligible(pt)]
    out = [(i, run_point(pt)) for i, pt in rest]
    if batched:
        out.extend(_batch_records(batched))
    if clustered:
        out.extend(_batch_cluster_records(clustered))
    return out


def resolve_workers(n_points: int, workers: Optional[int] = None) -> int:
    """Pool width: explicit ``workers`` wins, then the ``REPRO_SWEEP_WORKERS``
    environment override (CI pins it to 1), then ``min(cpu, n_points)`` —
    small sweeps no longer degrade to serial on many-core hosts."""
    if workers is None:
        env = os.environ.get("REPRO_SWEEP_WORKERS", "").strip()
        if env:
            workers = int(env)
    if workers is None:
        workers = min(os.cpu_count() or 1, n_points)
    return max(1, workers)


def run_sweep(points: Sequence[SweepPoint],
              workers: Optional[int] = None,
              strategy: str = "exhaustive",
              **search_kw) -> List[SweepRecord]:
    """Run a sweep, returning records in input order.  ``workers=None``
    auto-sizes a process pool (see :func:`resolve_workers`); ``workers<=1``
    forces in-process execution.  Pool startup failures (restricted
    sandboxes) degrade to serial.  Points are fanned out with
    :func:`partition_points` — one partition per worker, so batch grouping
    happens inside each worker and never double-partitions.

    ``strategy`` selects the search discipline (:data:`STRATEGIES`):
    ``"exhaustive"`` evaluates every point; ``"adaptive"`` dispatches to
    ``core.search.adaptive_sweep`` (front-guided successive halving) and
    returns *only* the full-fidelity survivor records — extra keyword
    arguments (``tolerance``, ``fidelity_ladder``, ...) pass through."""
    if strategy not in STRATEGIES:
        raise ValueError(
            f"unknown strategy {strategy!r} (have {STRATEGIES})")
    if strategy == "adaptive":
        from .search import adaptive_sweep   # local: search imports sweep
        records, _meta = adaptive_sweep(points, workers=workers, **search_kw)
        return records
    if search_kw:
        raise TypeError(
            f"unexpected arguments for exhaustive sweep: {sorted(search_kw)}")
    points = list(points)
    workers = resolve_workers(len(points), workers)
    if workers > 1 and len(points) > 1:
        try:
            from concurrent.futures import ProcessPoolExecutor
            from concurrent.futures.process import BrokenProcessPool
            parts = [p for p in partition_points(points, workers) if p]
            out: List[Optional[SweepRecord]] = [None] * len(points)
            with ProcessPoolExecutor(max_workers=len(parts)) as pool:
                futs = [pool.submit(_run_indexed,
                                    [(i, points[i]) for i in part])
                        for part in parts]
                for fut in futs:
                    for i, rec in fut.result():
                        out[i] = rec
                return list(out)     # type: ignore[arg-type]
        except (ImportError, OSError, PermissionError, BrokenProcessPool):
            pass                     # no usable pool: run in-process below
    serial: List[Optional[SweepRecord]] = [None] * len(points)
    for i, rec in _run_indexed(list(enumerate(points))):
        serial[i] = rec
    return list(serial)              # type: ignore[arg-type]


def sweep_summary(records: Iterable[SweepRecord]) -> Dict[str, float]:
    """Aggregate a sweep into headline scalars (geomeans over ok points)."""
    recs = [r for r in records]
    ok = [r for r in recs if r.ok]
    out: Dict[str, float] = {
        "n_points": float(len(recs)),
        "n_ok": float(len(ok)),
        "n_rejected": float(sum(r.status == "rejected" for r in recs)),
        "n_equivalent": float(sum(r.equivalent for r in ok)),
        "n_fifo_violations": float(sum(r.fifo_violations for r in ok)),
    }
    if ok:
        out["peak_ipc"] = best(ok, "ipc").ipc
        out["best_efficiency"] = best(ok, "efficiency").efficiency
        for pol, rs in sorted(group_by(ok, lambda r: r.policy).items()):
            out[f"geomean_ipc_{pol}"] = geomean(r.ipc for r in rs)
            out[f"geomean_efficiency_{pol}"] = geomean(r.efficiency for r in rs)
    return out


def record_to_row(rec: SweepRecord) -> Dict[str, object]:
    """A CSV-ready dict in :data:`CSV_FIELDS` order (stalls packed)."""
    d = asdict(rec)
    d["stalls"] = ";".join(f"{k}={v}" for k, v in sorted(rec.stalls.items()))
    d["equivalent"] = int(rec.equivalent)
    d["pipeline"] = int(rec.pipeline)
    return {k: d[k] for k in CSV_FIELDS}
