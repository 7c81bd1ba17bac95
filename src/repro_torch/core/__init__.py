"""COPIFTv2 core: the paper's methodology as executable transforms + a
cycle-approximate Snitch/FPSS machine model, a design-space exploration
engine sweeping (kernel x policy x queue geometry x unroll) grids with
Pareto-front extraction, plus the ExecutionPolicy enum that threads the
dual-stream idea through the port's CUDA kernels.  A copy of
``repro.core``: numpy and plain Python on the host, as in the JAX package,
with the same records bit for bit."""
from .batch_cluster import (BatchClusterDeadlock, BatchClusterStepper,
                            BatchClusterUnsupported, batch_cluster_simulate,
                            batch_cluster_supported)
from .batch_machine import (BatchDeadlock, BatchStepper, BatchUnsupported,
                            batch_simulate, batch_supported)
from .bench_kernels import KERNELS
from .cluster import (ClusterConfig, ClusterResult, ClusterStepper,
                      simulate_cluster)
from .dfg import LoopDFG, Node, s
from .isa import Instr, OpKind, Queue, Unit
from .machine import (ENGINES, DeadlockError, MachineConfig, Program,
                      ReferenceStepper, SimResult, Stepper, simulate,
                      stepper_for)
from .metrics import (PAPER_CLAIMS, KernelComparison, best, geomean,
                      group_by, run_suite, summarize)
from .calibrate import (SCHEMA_VERSION, CalibrationError, CalibrationRecord,
                        StaleArtifactError, calibrate, calibration_dir,
                        load_calibration, select_operating_point,
                        validate_artifact, write_artifact)
from .pareto import (dominates, format_front, pareto_by_kernel, pareto_front,
                     read_csv, write_csv)
from .policy import (WORKLOAD_PROXIES, WORKLOAD_QUEUE_LATENCIES,
                     ExecutionPolicy, OperatingPoint, PolicyTable,
                     clear_policy_table_cache, default_table)
from .search import (adaptive_sweep, eps_dominated, front_matches,
                     run_search, scale_fidelity)
from .sweep import (CSV_FIELDS, LEGACY_CSV_FIELDS, PRE_PIPELINE_CSV_FIELDS,
                    STRATEGIES, SWEEP_ENGINES, SweepPoint, SweepRecord,
                    clear_worker_caches, grid, partition_points,
                    resolve_workers, run_point, run_sweep, sweep_summary)
from .transform import (TransformConfig, analyze, lower, partition_kernel,
                        partition_pipeline)

__all__ = [
    "KERNELS", "LoopDFG", "Node", "s", "Instr", "OpKind", "Queue", "Unit",
    "ClusterConfig", "ClusterResult", "ClusterStepper", "simulate_cluster",
    "DeadlockError", "ENGINES", "MachineConfig", "Program",
    "ReferenceStepper", "SimResult", "Stepper", "simulate", "stepper_for",
    "PAPER_CLAIMS", "KernelComparison", "best", "geomean",
    "group_by", "run_suite", "summarize",
    "dominates", "format_front", "pareto_by_kernel", "pareto_front",
    "read_csv", "write_csv",
    "SCHEMA_VERSION", "CalibrationError", "CalibrationRecord",
    "StaleArtifactError", "calibrate", "calibration_dir", "load_calibration",
    "select_operating_point", "validate_artifact", "write_artifact",
    "WORKLOAD_PROXIES", "WORKLOAD_QUEUE_LATENCIES", "ExecutionPolicy",
    "OperatingPoint", "PolicyTable",
    "clear_policy_table_cache", "default_table",
    "TransformConfig", "analyze", "lower", "partition_kernel",
    "partition_pipeline",
    "CSV_FIELDS", "LEGACY_CSV_FIELDS", "PRE_PIPELINE_CSV_FIELDS",
    "STRATEGIES", "SWEEP_ENGINES", "SweepPoint", "SweepRecord",
    "clear_worker_caches", "grid", "partition_points", "resolve_workers",
    "run_point", "run_sweep", "sweep_summary",
    "BatchDeadlock", "BatchStepper", "BatchUnsupported", "batch_simulate",
    "batch_supported",
    "BatchClusterDeadlock", "BatchClusterStepper", "BatchClusterUnsupported",
    "batch_cluster_simulate", "batch_cluster_supported",
    "adaptive_sweep", "eps_dominated", "front_matches", "run_search",
    "scale_fidelity",
]
