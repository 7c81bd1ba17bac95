"""Pipelined-cluster benchmark, the port's counterpart of the JAX package's
``benchmarks/cluster_pipeline.py`` over the port's machine model:
producer/consumer core pairs vs the work partition on a bank-starved
TCDM (``transform.partition_pipeline`` + the ``core.cluster`` channel/DMA
fabric).

The setup is deliberately contention-heavy: ``cluster_matmul`` (two packed
operand loads per sample) on a cluster with ``n_cores // 2`` TCDM banks and
a high conflict penalty.  Under the work partition every core issues
its own loads, so 2N load streams collide on N banks and the ``*_bank``
stall share dominates the makespan.  The pipelined split sends each pair's
loads through the producer core's DMA engine (bulk transfers, conflict-free
by the Snitch cluster's zero-stall premise) and streams unpacked operands
over the inter-core channels, so the consumer cores' FP pipelines stay fed
— back-pressure (bank + ``cq_full`` + DMA-wait) stalls approach zero.

Gates (the acceptance bar):

* the pipelined cluster beats the work partition on aggregate IPC by
  >= :data:`MIN_IPC_RATIO` at every core count;
* the pipelined *back-pressure stall share* — stalled issue slots charged
  to ``*_bank`` + ``*_cq_full`` + ``*_dma``, over ``cycles x 2 x n_cores``
  issue slots — stays <= :data:`MAX_BACKPRESSURE_SHARE` (near-zero), while
  the work partition's stays >= :data:`MIN_PARTITION_SHARE` (the
  contention is binding, so the comparison means something);
* zero FIFO-order violations (intra-core queues and inter-core channels),
  outputs bit-identical to the sequential interpreter, and event/cycle
  engine parity on the headline point.

``cq_empty`` stalls are *excluded* from the back-pressure share on
purpose: a consumer's INT stream idling on an empty channel while its FP
unit drains is slack, not contention — the makespan already charges it.

Writes ``artifacts/BENCH_port_cluster_pipeline.json``
(``BENCH_port_cluster_pipeline_smoke.json`` under ``--smoke``)::

    {
      "points": [{"n_cores", "tcdm_banks", "partition": {...},
                  "pipeline": {...}, "ipc_ratio"}, ...],
      "headline": {"n_cores", "ipc_pipeline", "ipc_partition",
                   "ipc_ratio", "backpressure_share", "max_share"}
    }

Emits ``name,us_per_call,derived`` CSV rows like every other section.

  PYTHONPATH=src python -m repro_torch.benchmarks.cluster_pipeline
"""
import json
import os
import time

from ..core import (ClusterConfig, ClusterStepper, ExecutionPolicy,
                    KERNELS)
from ..core.transform import (TransformConfig, partition_kernel,
                              partition_pipeline)
from . import ART_DIR

OUT_PATH = os.path.join(ART_DIR, "BENCH_port_cluster_pipeline.json")
SMOKE_OUT_PATH = os.path.join(ART_DIR,
                              "BENCH_port_cluster_pipeline_smoke.json")

KERNEL = "cluster_matmul"
#: TCDM pressure: half as many banks as cores, steep conflict penalty —
#: the regime the pipelined split is built for
BANK_CONFLICT_PENALTY = 8
#: pipelined aggregate IPC must beat the work partition by this factor
MIN_IPC_RATIO = 1.5
#: pipelined back-pressure stall share (bank + cq_full + dma slots over
#: all 2*n_cores issue slots per cycle) must stay below this — "near zero"
MAX_BACKPRESSURE_SHARE = 0.05
#: ... while the partition's share must exceed this, or the TCDM pressure
#: is not binding and the comparison is vacuous
MIN_PARTITION_SHARE = 0.15

FULL = dict(cores=(4, 8), n_samples=512)
SMOKE = dict(cores=(4,), n_samples=256)


def _backpressure_share(res, n_cores):
    lost = sum(v for k, v in res.stalls.items()
               if k.endswith(("_bank", "_cq_full", "_dma")))
    return lost / (res.cycles * 2 * n_cores)


def _run_leg(progs, ccfg, engine="event"):
    return ClusterStepper(progs, ccfg, engine=engine).run()


def _check_outputs(res, dfg, n_samples, owners):
    """Bit-exact equivalence of the concatenated owner-core outputs against
    the sequential interpreter."""
    ref = dfg.eval_reference(n_samples)
    chunk = n_samples // len(owners)
    for node in dfg.outputs():
        got = [core.env.get(f"{node.name}@{i}")
               for core in owners for i in range(chunk)]
        if got != ref[node.name]:
            raise AssertionError(
                f"{KERNEL}: output {node.name} diverged from the "
                f"sequential interpreter")


def _leg_entry(res, n_cores):
    s = res.summary()
    return {
        "cycles": s["cycles"],
        "ipc": s["ipc"],
        "bank_stalls": s["bank_stalls"],
        "cq_stalls": s["cq_stalls"],
        "dma_stalls": s["dma_stalls"],
        "backpressure_share": round(_backpressure_share(res, n_cores), 6),
        "energy": s["energy"],
    }


def run(cfg=None, out_path=None):
    cfg = cfg or FULL
    out_path = out_path or OUT_PATH
    dfg = KERNELS[KERNEL]
    n = cfg["n_samples"]
    tcfg = TransformConfig(unroll=8, batch=min(32, n), queue_depth=4,
                           n_samples=n)
    rows, points = [], []
    t0 = time.time()
    headline = None
    for nc in cfg["cores"]:
        banks = nc // 2
        ccfg = ClusterConfig(n_cores=nc, tcdm_banks=banks,
                             bank_conflict_penalty=BANK_CONFLICT_PENALTY,
                             cq_depth=4, dma_buffers=2)
        part_progs = partition_kernel(dfg, ExecutionPolicy.COPIFTV2, tcfg, nc)
        pipe_progs = partition_pipeline(dfg, tcfg, nc, dma_buffers=2)
        part = _run_leg(part_progs, ccfg)
        pipe = _run_leg(pipe_progs, ccfg)

        if part.fifo_violations or pipe.fifo_violations:
            raise AssertionError(
                f"{KERNEL} x{nc}: FIFO-order violations (partition "
                f"{part.fifo_violations}, pipeline {pipe.fifo_violations})")
        _check_outputs(part, dfg, n, part.core_results)
        _check_outputs(pipe, dfg, n, pipe.core_results[1::2])

        pe, qe = _leg_entry(part, nc), _leg_entry(pipe, nc)
        ratio = qe["ipc"] / pe["ipc"]
        if ratio < MIN_IPC_RATIO:
            raise AssertionError(
                f"{KERNEL} x{nc}: pipelined IPC {qe['ipc']:.3f} is only "
                f"{ratio:.2f}x the partition's {pe['ipc']:.3f} "
                f"(need >= {MIN_IPC_RATIO}x)")
        if qe["backpressure_share"] > MAX_BACKPRESSURE_SHARE:
            raise AssertionError(
                f"{KERNEL} x{nc}: pipelined back-pressure share "
                f"{qe['backpressure_share']:.4f} > {MAX_BACKPRESSURE_SHARE} "
                f"— the channel/DMA fabric is not hiding the TCDM")
        if pe["backpressure_share"] < MIN_PARTITION_SHARE:
            raise AssertionError(
                f"{KERNEL} x{nc}: partition back-pressure share "
                f"{pe['backpressure_share']:.4f} < {MIN_PARTITION_SHARE} — "
                f"TCDM pressure is not binding, the comparison is vacuous")

        points.append({"n_cores": nc, "tcdm_banks": banks,
                       "partition": pe, "pipeline": qe,
                       "ipc_ratio": round(ratio, 4)})
        rows.append((f"cluster_pipeline_{KERNEL}_x{nc}_ipc", 0.0, qe["ipc"]))
        rows.append((f"cluster_pipeline_{KERNEL}_x{nc}_ipc_ratio", 0.0,
                     ratio))
        rows.append((f"cluster_pipeline_{KERNEL}_x{nc}_backpressure", 0.0,
                     qe["backpressure_share"]))
        if headline is None:
            headline = {"n_cores": nc, "ipc_pipeline": round(qe["ipc"], 4),
                        "ipc_partition": round(pe["ipc"], 4),
                        "ipc_ratio": round(ratio, 4),
                        "backpressure_share": qe["backpressure_share"],
                        "max_share": MAX_BACKPRESSURE_SHARE}
            # engine parity on the headline point: the event-driven core
            # must agree with the per-cycle reference bit-for-bit
            ref = _run_leg(pipe_progs, ccfg, engine="cycle")
            if (ref.cycles != pipe.cycles or ref.energy != pipe.energy
                    or ref.stalls != pipe.stalls):
                raise AssertionError(
                    f"{KERNEL} x{nc}: event/cycle engine divergence "
                    f"(cycles {pipe.cycles} vs {ref.cycles})")

    us = (time.time() - t0) * 1e6 / max(len(rows), 1)
    rows = [(name, us, derived) for name, _z, derived in rows]

    report = {"points": points, "headline": headline}
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
    return rows


def main():
    for name, us, derived in run():
        print(f"{name},{us:.1f},{derived:.4f}")
    print(f"# wrote {OUT_PATH}")


def smoke():
    """4-core point only, smaller sample count, separate artifact — the CI
    gate still enforces the IPC-ratio and back-pressure bars plus
    event/cycle engine parity."""
    rows = run(cfg=SMOKE, out_path=SMOKE_OUT_PATH)
    if not rows:
        raise AssertionError("cluster pipeline smoke produced no rows")
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived:.4f}")


if __name__ == "__main__":
    main()
