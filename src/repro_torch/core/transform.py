"""Lowering of LoopDFGs to stream programs — the paper's methodologies.

``lower(dfg, policy, ...)`` produces a :class:`Program` for the machine model:

* BASELINE — the original loop, unrolled/interleaved like a compiler would,
  all instructions fetched by the single-issue integer core (FP instructions
  are offloaded to the FPSS but still consume the shared issue port).
* COPIFT — DAC'25 [1], Steps 1–6: partition the DFG into alternating
  integer/FP *phases*, batch samples, spill every cross-thread value to
  memory (store + SSR stream readback), software-pipeline the batches in a
  wavefront with double-buffered spill memory and batch-granular semaphore
  synchronization (FREP launches issued by the integer core).
* COPIFTV2 — this paper, Steps 1–5: partition and schedule once; map every
  cross-thread edge onto the I2F/F2I hardware queues (x31 / integer-operand
  CSR semantics); the FP subgraph runs under a single FREP loop.  No loop
  transformations, no spills, no batch semaphores.

Value/typing model (mirrors the ISA):
 - every value is *int-typed* (produced by an integer-core op, or by an
   FP-unit op with an integer rd such as ``fcvt.w.d``) or *fp-typed*;
 - int-typed values live in the integer RF or in a queue — never the FP RF;
 - under COPIFTv2's CSR, an FP-unit instruction with integer rd *pushes* F2I
   instead of writing a register, and an FP-unit instruction with an integer
   rs *pops* I2F;
 - shim instructions are inserted only where the ISA demands them:
   ``MV x31, rs`` re-pushes (multi-consumer or RF-resident values),
   ``MV rd, x31`` pops to the integer RF (multi-consumer receptions),
   ``FMV_PUSH`` moves an fp-typed value to the integer thread.

FIFO discipline: per queue, push order must equal pop order.  The lowering
reorders movable shims to satisfy it and the tests verify it value-by-value.
"""
from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Tuple

from .dfg import LoopDFG, Node
from .isa import (E_SSR_STREAM, INT_DST_FP_KINDS, Instr, OpKind,
                  Queue, Unit)
from .machine import Program
from .policy import ExecutionPolicy


@dataclass(frozen=True)
class TransformConfig:
    """Lowering parameters.  Frozen (hashable) on purpose: a TransformConfig
    is the memo key for ``core.sweep``'s per-worker lowering cache, so two
    sweep points whose transform-relevant fields agree share one lowered
    Program.  Note there is no ``queue_latency`` here — visibility latency is
    a :class:`~.machine.MachineConfig` property the schedule never sees."""
    unroll: int = 8          # Step 3: samples interleaved in the schedule
    unroll_int: Optional[int] = None   # COPIFTv2 integer-stream interleave
    #   (defaults to ``unroll``; the int stream is scheduled *against* the
    #   realized FP queue order, see lower_copiftv2)
    batch: int = 32          # COPIFT only: samples per batch
    sync_cost: int = 2       # COPIFT: int-core instrs to config/launch a phase
    queue_depth: int = 8     # hardware FIFO depth the schedule targets
    n_samples: int = 512

    #: policies whose lowering actually reads ``queue_depth`` (the COPIFTv2
    #: cross-stream replay gate).  BASELINE has no queues and COPIFT spills
    #: through memory, so for those the depth axis can be normalized out of
    #: the memo key — one lowering serves every swept depth.
    DEPTH_SENSITIVE_POLICIES = frozenset({ExecutionPolicy.COPIFTV2})

    def lowering_key(self, policy: ExecutionPolicy) -> Tuple:
        """Hashable memo key: every field the ``lower()`` output depends on
        under ``policy``."""
        depth = (self.queue_depth
                 if policy in self.DEPTH_SENSITIVE_POLICIES else None)
        return (policy.value, self.unroll, self.unroll_int, self.batch,
                self.sync_cost, depth, self.n_samples)


def vid(name: str, i: int) -> str:
    return f"{name}@{i}"


class _Builder:
    def __init__(self) -> None:
        self._uid = itertools.count()

    def instr(self, kind: OpKind, label: str, srcs=(), dst=None, pushes=(),
              push_val=None, sample=-1, fn=None, extra_energy=0.0,
              expects=(), cq=None, dma_words=0, local=False) -> Instr:
        return Instr(uid=next(self._uid), kind=kind, label=label,
                     srcs=tuple(srcs), dst=dst, pushes=tuple(pushes),
                     push_val=push_val, sample=sample, fn=fn,
                     extra_energy=extra_energy, expects=tuple(expects),
                     cq=cq, dma_words=dma_words, local=local)


def _identity(x):
    return x


# ---------------------------------------------------------------------------
# Steps 1-2: partition & communication analysis
# ---------------------------------------------------------------------------

@dataclass
class CommPlan:
    dfg: LoopDFG
    int_nodes: List[Node]          # executed on the integer core
    fp_nodes: List[Node]           # executed on the FPSS
    exec_unit: Dict[str, Unit]     # producer execution unit per value
    vtype: Dict[str, Unit]         # INT => int-typed, FP => fp-typed
    # int-typed value -> FP-side consumptions (I2F pops), in FP program order
    i2f_uses: Dict[str, List[Tuple[Node, int]]]
    # value produced on the FPSS -> integer-side consumptions (F2I pops)
    int_receives: Dict[str, List[Tuple[Node, int]]]


def analyze(dfg: LoopDFG) -> CommPlan:
    int_nodes, fp_nodes = [], []
    exec_unit: Dict[str, Unit] = {}
    vtype: Dict[str, Unit] = {}
    for name in dfg.inputs:
        home = dfg.input_homes.get(name, Unit.FP)
        exec_unit[name] = home
        vtype[name] = home
    for n in dfg.nodes:
        u = dfg.node_unit(n)
        (fp_nodes if u is Unit.FP else int_nodes).append(n)
        exec_unit[n.name] = u
        vtype[n.name] = Unit.INT if (u is Unit.INT or n.kind in INT_DST_FP_KINDS) else Unit.FP

    i2f: Dict[str, List[Tuple[Node, int]]] = {}
    recv: Dict[str, List[Tuple[Node, int]]] = {}
    for n in dfg.nodes:
        side = dfg.node_unit(n)
        for idx, (src, lag) in enumerate(n.srcs):
            if lag != 0:
                if vtype[src] is not (Unit.INT if side is Unit.INT else Unit.FP) \
                        or exec_unit[src] is not side:
                    raise ValueError(
                        f"{dfg.name}: loop-carried dep {src}->{n.name} must stay "
                        "within one thread; restructure the kernel")
                continue
            if src in dfg.inputs and exec_unit[src] is not side:
                raise ValueError(
                    f"{dfg.name}: input {src} consumed across the partition; "
                    "route it through an explicit load node")
            if side is Unit.FP and vtype[src] is Unit.INT:
                i2f.setdefault(src, []).append((n, idx))
            elif side is Unit.INT and exec_unit[src] is Unit.FP:
                recv.setdefault(src, []).append((n, idx))
    return CommPlan(dfg, int_nodes, fp_nodes, exec_unit, vtype, i2f, recv)


def _int_rf_uses(plan: CommPlan, name: str) -> int:
    """Integer-RF consumptions of an int-core-produced value (lag 0)."""
    return sum(1 for n in plan.int_nodes
               for (src, lag) in n.srcs if src == name and lag == 0)


def _lagged_uses(dfg: LoopDFG, name: str) -> bool:
    return any(src == name and lag > 0 for n in dfg.nodes for (src, lag) in n.srcs)


# ---------------------------------------------------------------------------
# helpers shared by the lowerings
# ---------------------------------------------------------------------------

def _loop_overhead(b: _Builder, g: int, tag: str = "") -> List[Instr]:
    prev = f"lc{tag}@{g-1}" if g > 0 else "init:lc"
    cnt = b.instr(OpKind.IALU, f"lc{tag}@{g}", (prev,), dst=f"lc{tag}@{g}",
                  fn=lambda c: c + 1)
    br = b.instr(OpKind.BR, f"br{tag}@{g}", (f"lc{tag}@{g}",), fn=_identity)
    return [cnt, br]


def _init_env(dfg: LoopDFG, n: int) -> Tuple[Dict[str, Any], List[str]]:
    env: Dict[str, Any] = {"init:lc": 0}
    for name, gen in dfg.inputs.items():
        for i in range(n):
            env[vid(name, i)] = gen(i)
    for name, val in dfg.init.items():
        env[f"init:{name}"] = val
    outputs = [vid(node.name, i) for node in dfg.outputs() for i in range(n)]
    return env, outputs


@dataclass
class CrossSchedule:
    """Constraints for scheduling one stream against the other, already
    fixed, stream (COPIFTv2).  ``fixed`` is replayed lazily against real
    queue-occupancy counters, so the scheduled stream only emits a queue
    operation when the joint in-order execution can actually reach it —
    the structural no-deadlock condition, *including finite queue depth*.

    ``depth_gate_hit`` records whether the finite-depth comparison ever
    constrained the schedule.  When it stays False the produced schedule is
    provably identical for every larger ``queue_depth`` (raising the depth
    only relaxes the two gate comparisons), which is what lets the sweep
    layer reuse one lowered Program across the saturated tail of a depth
    axis."""
    fixed: List[Instr]
    queue_depth: int
    push_order: Dict[Queue, "deque"]    # values this stream must push, FIFO
    pop_order: Dict[Queue, "deque"]     # values this stream will pop, FIFO
    depth_gate_hit: bool = False


def _interleave(per_sample: List[List[Instr]], U: int, b: _Builder,
                loop_overhead: bool, tag: str = "",
                cross: Optional[CrossSchedule] = None,
                pop_avail=None) -> List[Instr]:
    """Step 3: list-schedule the stream, interleaving up to ``U`` samples
    with latency-aware greedy list scheduling, honoring (a) per-sample
    program order, (b) in-stream value dependencies (incl. loop-carried
    chains), and (c) optionally a :class:`CrossSchedule` so the FIFO law
    (global push order == pop order) holds and no cross-stream circular
    wait can arise."""
    out: List[Instr] = []
    n = len(per_sample)
    produced_here = {ins.dst for lst in per_sample for ins in lst if ins.dst}
    done_at: Dict[str, int] = {}     # estimated completion cycle per value
    clock = 0                        # estimated issue clock of this stream
    sample_pops: Dict[int, int] = {} # pops emitted so far, per sample

    # joint queue-state replay of the fixed stream (COPIFTv2 only)
    my_push = {q: 0 for q in Queue}
    my_pop = {q: 0 for q in Queue}
    fx_push = {q: 0 for q in Queue}
    fx_pop = {q: 0 for q in Queue}
    fx_ptr = 0

    def replay_fixed() -> None:
        """Advance the fixed stream as far as the queue state allows."""
        nonlocal fx_ptr
        if cross is None:
            return
        fixed = cross.fixed
        while fx_ptr < len(fixed):
            ins = fixed[fx_ptr]
            need: Dict[Queue, int] = {}
            for q in ins.pops:
                need[q] = need.get(q, 0) + 1
            if any(my_push[q] - fx_pop[q] < k for q, k in need.items()):
                break
            room: Dict[Queue, int] = {}
            for q in ins.pushes:
                room[q] = room.get(q, 0) + 1
            if any(fx_push[q] - my_pop[q] + k > cross.queue_depth
                   for q, k in room.items()):
                cross.depth_gate_hit = True
                break
            for q in ins.pops:
                fx_pop[q] += 1
            for q in ins.pushes:
                fx_push[q] += 1
            fx_ptr += 1

    def gates_ok(ins: Instr) -> bool:
        if cross is None:
            return True
        replay_fixed()
        for q in ins.pushes:
            seq = cross.push_order.get(q)
            if seq is not None and (not seq or seq[0] != ins.push_val):
                return False
            if my_push[q] - fx_pop[q] >= cross.queue_depth:
                cross.depth_gate_hit = True
                return False
        pop_idx: Dict[Queue, int] = {}
        for idx, q in enumerate(ins.pops):
            k = pop_idx.get(q, 0)
            pop_idx[q] = k + 1
            seq = cross.pop_order.get(q)
            if seq is not None:
                want = ins.expects[idx] if idx < len(ins.expects) else None
                if len(seq) <= k or seq[k] != want:
                    return False
            if fx_push[q] - my_pop[q] < k + 1:
                return False
        return True

    def deps_emitted(ins: Instr) -> bool:
        return all(src not in produced_here or src in done_at
                   for src in ins.reg_srcs)

    def t_ready(ins: Instr) -> int:
        t = max((done_at.get(src, 0) for src in ins.reg_srcs), default=0)
        if ins.pops and pop_avail is not None:
            # estimated arrival of this sample's next queue operand(s),
            # given the cross-thread producer's steady-state rate
            k0 = sample_pops.get(ins.sample, 0)
            t = max([t] + [int(pop_avail(ins.sample, k0 + j))
                           for j in range(len(ins.pops))])
        return t

    def emit(ins: Instr) -> None:
        nonlocal clock
        clock = max(clock + 1, t_ready(ins))
        out.append(ins)
        if ins.dst:
            done_at[ins.dst] = clock + ins.spec.latency
        if ins.pops:
            sample_pops[ins.sample] = sample_pops.get(ins.sample, 0) + len(ins.pops)
        if cross is not None:
            for q in ins.pushes:
                my_push[q] += 1
                seq = cross.push_order.get(q)
                if seq is not None and seq:
                    seq.popleft()
            for q in ins.pops:
                my_pop[q] += 1
                seq = cross.pop_order.get(q)
                if seq is not None and seq:
                    seq.popleft()

    # Sliding-window scheduling: up to ``U`` samples in flight; a finished
    # sample immediately admits the next one, so the cross-thread round-trip
    # tail of sample i overlaps the head of sample i+U (the FPSS's FREP loop
    # has no group barrier — neither should the schedule).
    active = list(range(min(U, n)))
    next_idx = len(active)
    ptr = {i: 0 for i in active}
    completed = 0
    groups_done = 0
    rr = 0
    while active:
        best, best_key = None, None
        for off, i in enumerate([active[(rr + o) % len(active)]
                                 for o in range(len(active))]):
            ins = per_sample[i][ptr[i]]
            if not deps_emitted(ins) or not gates_ok(ins):
                continue
            key = (t_ready(ins), off)
            if best_key is None or key < best_key:
                best, best_key = i, key
        if best is None:
            if cross is not None:
                if next_idx < n:
                    # the fixed stream demands a later sample first: widen
                    # the in-flight window instead of failing
                    active.append(next_idx)
                    ptr[next_idx] = 0
                    next_idx += 1
                    continue
                raise ValueError(
                    "infeasible joint schedule: every in-flight sample is "
                    "queue-blocked (increase queue depth or restructure)")
            # blocked only on cross-stream events: emit the oldest
            # instruction; runtime queue semantics order execution.
            best = min(active)
        emit(per_sample[best][ptr[best]])
        ptr[best] += 1
        rr = (active.index(best) + 1) % len(active)
        if ptr[best] >= len(per_sample[best]):
            active.remove(best)
            completed += 1
            if next_idx < n:
                active.append(next_idx)
                ptr[next_idx] = 0
                next_idx += 1
            if loop_overhead and completed % U == 0:
                out.extend(_loop_overhead(b, groups_done, tag))
                groups_done += 1
    if loop_overhead and completed % U:
        out.extend(_loop_overhead(b, groups_done, tag))
    return out


# ---------------------------------------------------------------------------
# BASELINE
# ---------------------------------------------------------------------------

def lower_baseline(dfg: LoopDFG, cfg: TransformConfig) -> Program:
    b = _Builder()
    n, U = cfg.n_samples, cfg.unroll
    init_env, outputs = _init_env(dfg, n)

    per_sample: List[List[Instr]] = []
    for i in range(n):
        lst = []
        for node in dfg.nodes:
            srcs = tuple(f"init:{s}" if i - l < 0 else vid(s, i - l)
                         for (s, l) in node.srcs)
            extra = E_SSR_STREAM if node.out else 0.0   # result streamed out
            lst.append(b.instr(node.kind, f"{node.name}@{i}", srcs,
                               dst=vid(node.name, i), sample=i, fn=node.fn,
                               extra_energy=extra))
        per_sample.append(lst)

    instrs = _interleave(per_sample, U, b, loop_overhead=True)
    return Program(name=dfg.name, policy=ExecutionPolicy.BASELINE,
                   mode="single", streams={Unit.INT: instrs}, n_samples=n,
                   init_env=init_env, output_values=outputs, frep=False)


# ---------------------------------------------------------------------------
# COPIFTv2  (Steps 1-5 of the paper)
# ---------------------------------------------------------------------------

#: process-local cache of the depth-independent prefix of lower_copiftv2
#: (partition, per-sample builds, the scheduled FP stream and its realized
#: queue sequences).  Only the integer stream's joint schedule reads
#: ``queue_depth`` (the CrossSchedule replay gate), so one prefix serves an
#: entire swept depth axis.  Keyed by kernel name + the prefix-relevant
#: config fields, with the LoopDFG identity checked on hit so ad-hoc test
#: graphs reusing a name can never poison the cache.  Each entry is a
#: mutable ``[dfg, prefix, saturation]`` record; ``saturation`` holds
#: ``(depth, Program)`` for the shallowest depth whose integer schedule was
#: built without the depth gate ever firing — that Program is provably what
#: lowering would produce at *any* deeper queue, so the saturated tail of a
#: depth axis shares one Program (and all its cached simulation facts).
_V2_PREFIX_CACHE: Dict[Tuple, List] = {}
_V2_PREFIX_CAP = 32


def _v2_entry(dfg: LoopDFG, cfg: TransformConfig) -> List:
    key = (dfg.name, cfg.unroll, cfg.unroll_int, cfg.n_samples)
    hit = _V2_PREFIX_CACHE.get(key)
    if hit is not None and hit[0] is dfg:
        return hit
    entry = [dfg, _lower_copiftv2_prefix(dfg, cfg), None]
    if len(_V2_PREFIX_CACHE) >= _V2_PREFIX_CAP:
        _V2_PREFIX_CACHE.pop(next(iter(_V2_PREFIX_CACHE)))
    _V2_PREFIX_CACHE[key] = entry
    return entry


def _lower_copiftv2_prefix(dfg: LoopDFG, cfg: TransformConfig) -> Tuple:
    plan = analyze(dfg)
    b = _Builder()
    n, U = cfg.n_samples, cfg.unroll
    init_env, outputs = _init_env(dfg, n)

    i2f_needed = {v: len(uses) for v, uses in plan.i2f_uses.items()}

    # F2I values in the order the FPSS produces them within one sample
    fp_f2i_vals: List[str] = []
    for node in plan.fp_nodes:
        if node.kind in INT_DST_FP_KINDS:
            if node.name in plan.int_receives or node.name in plan.i2f_uses:
                fp_f2i_vals.append(node.name)
        elif node.name in plan.int_receives:
            fp_f2i_vals.append(node.name)

    # The FPSS per-sample queue-event sequence (its schedule preserves
    # per-sample program order, so this is the FIFO reference).  Mirrored,
    # it prescribes the integer thread's queue-op order: an FP pop of v
    # requires the integer push of v before it; an FP push hands v to the
    # integer pop after it.
    events: List[Tuple[str, str]] = []      # (int role: "push"|"pop", value)
    for node in plan.fp_nodes:
        for (sname, lag) in node.srcs:
            if lag == 0 and plan.vtype[sname] is Unit.INT:
                events.append(("push", sname))
        if node.kind in INT_DST_FP_KINDS:
            if node.name in plan.int_receives or node.name in plan.i2f_uses:
                events.append(("pop", node.name))
        elif node.name in plan.int_receives:
            events.append(("pop", node.name))

    # nodes consuming more than one FPSS value would pop several queue
    # entries in one instruction — globally unorderable; alias those values
    multi_recv: set = set()
    for node in plan.int_nodes:
        rv = [sname for (sname, lag) in node.srcs
              if lag == 0 and sname in plan.int_receives]
        if len(rv) > 1:
            multi_recv.update(rv)

    def make_plan(alias_all: bool):
        """Per-value reception shims.  ``alias_all`` forces every reception
        through an MV pop (always sequenceable).  Values that must be pushed
        back to the FPSS are always aliased: a pop+push combo instruction
        would couple the two queues' global orders and can deadlock."""
        alias: Dict[str, str] = {}
        direct_pop: set = set()
        for v in fp_f2i_vals:
            node_uses = len(plan.int_receives.get(v, []))
            repushes = (len(plan.i2f_uses.get(v, []))
                        if plan.exec_unit[v] is Unit.FP else 0)
            if (not alias_all and node_uses == 1 and repushes == 0
                    and v not in multi_recv):
                direct_pop.add(v)
            else:
                alias[v] = f"{v}__i"
        return alias, direct_pop

    alias, direct_pop = make_plan(False)

    def build_sample(i: int) -> Tuple[List[Instr], List[Instr]]:
        # ---- FP stream (the fixed FIFO reference) -----------------------
        fp_list: List[Instr] = []
        for node in plan.fp_nodes:
            srcs: List[object] = []
            expects: List[str] = []
            for (sname, lag) in node.srcs:
                if lag > 0:
                    srcs.append(f"init:{sname}" if i - lag < 0 else vid(sname, i - lag))
                elif plan.vtype[sname] is Unit.INT:
                    srcs.append(Queue.I2F)
                    expects.append(vid(sname, i))
                else:
                    srcs.append(vid(sname, i))
            pushes, push_val, dst = (), None, vid(node.name, i)
            if node.kind in INT_DST_FP_KINDS:
                if node.name in plan.int_receives or node.name in plan.i2f_uses:
                    pushes, push_val = (Queue.F2I,), vid(node.name, i)
                dst = None            # integer rd never writes a register file
                if node.out:
                    raise ValueError(f"{dfg.name}: output {node.name} has integer rd")
            extra = E_SSR_STREAM if node.out else 0.0
            fp_list.append(b.instr(node.kind, f"{node.name}@{i}", tuple(srcs),
                                   dst=dst, pushes=pushes, push_val=push_val,
                                   sample=i, fn=node.fn, extra_energy=extra,
                                   expects=expects))
            if node.kind not in INT_DST_FP_KINDS and node.name in plan.int_receives:
                fp_list.append(b.instr(OpKind.FMV_PUSH, f"fpush:{node.name}@{i}",
                                       (vid(node.name, i),), pushes=(Queue.F2I,),
                                       push_val=vid(node.name, i), sample=i,
                                       fn=_identity))

        # ---- integer stream ---------------------------------------------
        int_list: List[Instr] = []
        for node in plan.int_nodes:
            srcs = []
            expects = []
            for idx, (sname, lag) in enumerate(node.srcs):
                if lag > 0:
                    srcs.append(f"init:{sname}" if i - lag < 0 else vid(sname, i - lag))
                elif sname in direct_pop and (node, idx) == (
                        plan.int_receives[sname][0][0], plan.int_receives[sname][0][1]):
                    srcs.append(Queue.F2I)
                    expects.append(vid(sname, i))
                elif sname in alias:
                    srcs.append(vid(alias[sname], i))
                else:
                    srcs.append(vid(sname, i))
            v = node.name
            pushes, push_val = (), None
            extra_pushes = 0
            if v in plan.i2f_uses and plan.exec_unit[v] is Unit.INT:
                if (i2f_needed[v] == 1 and _int_rf_uses(plan, v) == 0
                        and not _lagged_uses(dfg, v) and not node.out
                        and not expects):
                    pushes, push_val = (Queue.I2F,), vid(v, i)
                else:
                    extra_pushes = i2f_needed[v]
            extra = E_SSR_STREAM if node.out else 0.0
            int_list.append(b.instr(node.kind, f"{v}@{i}", tuple(srcs),
                                    dst=vid(v, i), pushes=pushes,
                                    push_val=push_val, sample=i, fn=node.fn,
                                    extra_energy=extra, expects=expects))
            for _ in range(extra_pushes):
                int_list.append(b.instr(OpKind.MV, f"push:{v}@{i}", (vid(v, i),),
                                        pushes=(Queue.I2F,), push_val=vid(v, i),
                                        sample=i, fn=_identity))

        # MV pops + re-pushes for aliased receptions
        for v in fp_f2i_vals:
            if v not in alias:
                continue
            a = alias[v]
            int_list.append(b.instr(OpKind.MV, f"pop:{v}@{i}", (Queue.F2I,),
                                    dst=vid(a, i), sample=i, fn=_identity,
                                    expects=(vid(v, i),)))
            if plan.exec_unit[v] is Unit.FP:
                for _ in plan.i2f_uses.get(v, []):
                    int_list.append(b.instr(OpKind.MV, f"push:{v}@{i}",
                                            (vid(a, i),), pushes=(Queue.I2F,),
                                            push_val=vid(v, i), sample=i,
                                            fn=_identity))
        int_list = _sequence_by_events(int_list, events, i)
        return int_list, fp_list

    # trial-build sample 0; if the optimized plan cannot be sequenced
    # against the FIFO mirror, fall back to alias-all receptions
    try:
        build_sample(0)
    except ValueError:
        alias, direct_pop = make_plan(True)
        build_sample(0)

    int_samples, fp_samples = [], []
    for i in range(n):
        il, fl = build_sample(i)
        int_samples.append(il)
        fp_samples.append(fl)

    # Two-phase scheduling: the FP stream is scheduled freely (value deps
    # only); its realized queue order then *constrains* the integer stream so
    # the global push order equals the pop order on both queues, and every
    # integer queue op is deferred until the joint in-order execution can
    # actually reach it (replay gate: no deadlock, finite queue depth).
    int_per_sample = len(int_samples[0]) + 2.0 / max(cfg.unroll_int or U, 1)
    fp_per_sample = float(len(fp_samples[0]))
    pushes_per_sample = sum(len(ins.pushes) for ins in int_samples[0])
    pop_avail = None
    if pushes_per_sample:
        # steady-state: the slower stream paces both; the k-th queue operand
        # of sample i arrives roughly when the integer thread has advanced
        # through sample i up to its (k+1)-th push.  If the integer thread
        # itself waits on an F2I value (bidirectional kernels like expf),
        # its chain only *starts* after the FPSS produced that value.
        S = max(int_per_sample, fp_per_sample)
        per_push = int_per_sample / pushes_per_sample
        lead = 0.0
        if any(ins.pops for ins in int_samples[0]):
            f2i_idx = [k for k, ins in enumerate(fp_samples[0])
                       if Queue.F2I in ins.pushes]
            if f2i_idx:
                lead = f2i_idx[-1] + 4.0        # producer pos + lat + queue

        def pop_avail(i, k, _S=S, _pp=per_push, _l=lead):   # noqa: E731
            return _S * i + _l + (k + 1) * _pp + 2.0
    fp_stream = _interleave(fp_samples, U, b, loop_overhead=False,
                            pop_avail=pop_avail)
    i2f_pop_seq: deque = deque()
    f2i_push_seq: deque = deque()
    for ins in fp_stream:
        for q in ins.pushes:
            if q is Queue.F2I:
                f2i_push_seq.append(ins.push_val)
        i2f_pop_seq.extend(ins.expects)
    ui = cfg.unroll_int or U
    # symmetric availability model for the integer stream's F2I pops: the
    # k-th F2I value of sample i appears once the FPSS reaches its producer
    f2i_pos = [k for k, ins in enumerate(fp_samples[0])
               if Queue.F2I in ins.pushes]
    int_pop_avail = None
    if f2i_pos:
        S2 = max(int_per_sample, fp_per_sample)

        def int_pop_avail(i, k, _S=S2, _pos=f2i_pos):   # noqa: E731
            return _S * i + _pos[min(k, len(_pos) - 1)] + 4.0
    return (b, init_env, outputs, n, int_samples, fp_stream,
            tuple(i2f_pop_seq), tuple(f2i_push_seq), ui, int_pop_avail)


def lower_copiftv2(dfg: LoopDFG, cfg: TransformConfig,
                   use_prefix_cache: bool = True) -> Program:
    """Depth-independent prefix (cached, see :func:`_v2_entry`) + the
    per-depth joint schedule of the integer stream against the fixed FP
    stream.  Programs lowered at different depths share the prefix's
    immutable pieces (FP stream, per-sample instruction lists, init env),
    and depths past the gate's saturation point share one Program outright."""
    entry = _v2_entry(dfg, cfg) if use_prefix_cache else None
    if entry is not None:
        sat = entry[2]
        if sat is not None and cfg.queue_depth >= sat[0]:
            return sat[1]            # schedule provably identical up here
        prefix = entry[1]
    else:
        prefix = _lower_copiftv2_prefix(dfg, cfg)
    (b, init_env, outputs, n, int_samples, fp_stream,
     i2f_pop_seq, f2i_push_seq, ui, int_pop_avail) = prefix
    cross = CrossSchedule(fixed=fp_stream, queue_depth=cfg.queue_depth,
                          push_order={Queue.I2F: deque(i2f_pop_seq)},
                          pop_order={Queue.F2I: deque(f2i_push_seq)})
    int_stream = _interleave(int_samples, ui, b, loop_overhead=True,
                             cross=cross, pop_avail=int_pop_avail)
    prog = Program(
        name=dfg.name, policy=ExecutionPolicy.COPIFTV2, mode="dual",
        streams={Unit.INT: int_stream, Unit.FP: fp_stream},
        n_samples=n, init_env=init_env, output_values=outputs, frep=True)
    if entry is not None and not cross.depth_gate_hit:
        if entry[2] is None or cfg.queue_depth < entry[2][0]:
            entry[2] = (cfg.queue_depth, prog)
    return prog


def _sequence_by_events(int_list: List[Instr], events: List[Tuple[str, str]],
                        i: int) -> List[Instr]:
    """Order one sample's integer instructions so its queue operations occur
    exactly in the mirrored FPSS event order (the FIFO law by construction),
    pulling register dependencies forward as needed."""
    by_push: Dict[str, List[Instr]] = {}
    by_pop: Dict[str, List[Instr]] = {}
    for ins in int_list:
        if ins.pushes and ins.push_val is not None:
            by_push.setdefault(ins.push_val, []).append(ins)
        for e in ins.expects:
            by_pop.setdefault(e, []).append(ins)
    prod = {ins.dst: ins for ins in int_list if ins.dst}
    placed: set = set()
    result: List[Instr] = []

    def place(ins: Instr, via_event: bool) -> None:
        if ins.uid in placed:
            return
        if not via_event and (ins.pushes or ins.pops):
            raise ValueError(
                f"sample {i}: queue op {ins.label} needed out of event order")
        placed.add(ins.uid)
        for srcv in ins.reg_srcs:
            p = prod.get(srcv)
            if p is not None and p.uid not in placed:
                place(p, via_event=False)
        result.append(ins)

    for role, v in events:
        key = vid(v, i)
        cands = (by_push if role == "push" else by_pop).get(key)
        if not cands:
            raise ValueError(f"sample {i}: no instruction for event {role} {v}")
        ins = cands[0]
        if ins.uid not in placed:
            place(ins, via_event=True)
        cands.pop(0)
    for ins in int_list:
        place(ins, via_event=True)       # leftovers carry no queue ops
    return result


# ---------------------------------------------------------------------------
# COPIFT  (Steps 1-6 of [1])
# ---------------------------------------------------------------------------

def _phases(dfg: LoopDFG, plan: CommPlan) -> Dict[str, int]:
    """Phase per node = boundary crossings along the longest path.
    Even phases run on the integer core, odd phases on the FPSS."""
    ph: Dict[str, int] = {}
    for n in dfg.nodes:
        side = dfg.node_unit(n)
        want = 0 if side is Unit.INT else 1
        best = want
        for (src, lag) in n.srcs:
            if lag != 0 or src in dfg.inputs:
                continue
            p = ph[src]
            prod_side = Unit.INT if p % 2 == 0 else Unit.FP
            cand = p + (0 if prod_side is side else 1)
            if cand % 2 != want:
                cand += 1
            best = max(best, cand)
        ph[n.name] = best
    return ph


def lower_copift(dfg: LoopDFG, cfg: TransformConfig) -> Program:
    plan = analyze(dfg)
    b = _Builder()
    n, U, B = cfg.n_samples, cfg.unroll, cfg.batch
    if n % B:
        raise ValueError("n_samples must be a multiple of the batch size")
    nb = n // B
    init_env, outputs = _init_env(dfg, n)
    ph = _phases(dfg, plan)
    n_phases = max(ph.values()) + 1

    phase_nodes: List[List[Node]] = [[] for _ in range(n_phases)]
    for node in dfg.nodes:
        phase_nodes[ph[node.name]].append(node)

    # values communicated between threads => spilled to memory buffers
    crossing = set(plan.i2f_uses) | set(plan.int_receives)

    def mem(v: str, i: int) -> str:
        return f"mem:{v}@{i}"

    def build_segment(batch: int, phase: int) -> List[Instr]:
        nodes = phase_nodes[phase]
        side = Unit.INT if phase % 2 == 0 else Unit.FP
        per_sample: List[List[Instr]] = []
        for i in range(batch * B, (batch + 1) * B):
            lst: List[Instr] = []
            spills: List[Instr] = []
            loads: List[Instr] = []
            needs_addr = False
            for node in nodes:
                srcs: List[str] = []
                extra = E_SSR_STREAM if node.out else 0.0
                for (s, l) in node.srcs:
                    if l > 0:
                        srcs.append(f"init:{s}" if i - l < 0 else vid(s, i - l))
                    elif s in crossing and ph.get(s, phase) != phase:
                        if side is Unit.FP:
                            # arrives through an SSR stream: no instruction,
                            # SRAM read energy charged to the consumer
                            srcs.append(mem(s, i))
                            extra += E_SSR_STREAM
                        else:
                            lv = f"ld:{s}@{i}"
                            if not any(x.dst == lv for x in loads):
                                loads.append(b.instr(OpKind.LW, lv,
                                                     (mem(s, i),), dst=lv,
                                                     sample=i, fn=_identity))
                                needs_addr = True
                            srcs.append(lv)
                    else:
                        srcs.append(vid(s, i))
                lst.append(b.instr(node.kind, f"{node.name}@{i}", tuple(srcs),
                                   dst=vid(node.name, i), sample=i, fn=node.fn,
                                   extra_energy=extra))
                if node.name in crossing and ph[node.name] == phase:
                    if side is Unit.INT:
                        spills.append(b.instr(OpKind.SW, f"sw:{node.name}@{i}",
                                              (vid(node.name, i),),
                                              dst=mem(node.name, i), sample=i,
                                              fn=_identity))
                        needs_addr = True
                    else:
                        spills.append(b.instr(OpKind.FSD_SSR,
                                              f"fsw:{node.name}@{i}",
                                              (vid(node.name, i),),
                                              dst=mem(node.name, i), sample=i,
                                              fn=_identity))
            pre: List[Instr] = []
            if needs_addr and side is Unit.INT:
                pre.append(b.instr(OpKind.IALU, f"addr:p{phase}@{i}", (),
                                   dst=f"addr:p{phase}@{i}", sample=i,
                                   fn=lambda: 0))
            per_sample.append(pre + loads + lst + spills)
        return _interleave(per_sample, U, b,
                           loop_overhead=(side is Unit.INT),
                           tag=f"p{phase}b{batch}")

    int_stream: List[Instr] = []
    fp_stream: List[Instr] = []
    segs = [(batch, phase) for batch in range(nb) for phase in range(n_phases)
            if phase_nodes[phase]]
    # wavefront (the software pipeline of Step 5/6 in [1]): process diagonals
    # d = batch + phase; within a diagonal the integer core first emits the
    # FREP launches (keeping the FPSS busy), then its own segment bodies in
    # phase order (producers before consumers).
    segs.sort(key=lambda bp: (bp[0] + bp[1], bp[1] % 2 == 0, bp[1]))

    sem_of: Dict[Tuple[int, int], str] = {}
    for (batch, phase) in segs:
        side = Unit.INT if phase % 2 == 0 else Unit.FP
        body = build_segment(batch, phase)
        deps = [sem_of[d] for d in ((batch, phase - 1), (batch - 2, phase + 1))
                if d in sem_of]
        if side is Unit.FP:
            # integer core configures SSRs and launches the FREP body
            launch = f"launch:b{batch}p{phase}"
            prev: Tuple[str, ...] = tuple(deps)
            for k in range(cfg.sync_cost):
                name = launch if k == cfg.sync_cost - 1 else f"{launch}.{k}"
                int_stream.append(b.instr(OpKind.IALU, name, prev, dst=name,
                                          fn=lambda *a: 0))
                prev = (name,)
            body[0] = _with_extra_deps(body[0], (launch,))
            fp_stream.extend(body)
        else:
            if deps:
                poll = f"poll:b{batch}p{phase}"
                int_stream.append(b.instr(OpKind.LW, poll, tuple(deps),
                                          dst=poll, fn=lambda *a: 0))
                int_stream.append(b.instr(OpKind.BR, f"{poll}.br", (poll,),
                                          fn=_identity))
            int_stream.extend(body)
        sem = f"sem:b{batch}p{phase}"
        last = next((x.dst for x in reversed(body) if x.dst), None)
        kind = OpKind.SYNC if side is Unit.INT else OpKind.FSD_SSR
        (int_stream if side is Unit.INT else fp_stream).append(
            b.instr(kind, sem, (last,) if last else (), dst=sem, fn=lambda *a: 0))
        sem_of[(batch, phase)] = sem

    return Program(name=dfg.name, policy=ExecutionPolicy.COPIFT, mode="dual",
                   streams={Unit.INT: int_stream, Unit.FP: fp_stream},
                   n_samples=n, init_env=init_env, output_values=outputs,
                   frep=True)


def _with_extra_deps(ins: Instr, extra: Tuple[str, ...]) -> Instr:
    fn = ins.fn
    wrapped = (lambda *a, _f=fn, _k=len(extra): _f(*a[_k:])) if fn else None
    return Instr(uid=ins.uid, kind=ins.kind, label=ins.label,
                 srcs=tuple(extra) + ins.srcs, dst=ins.dst, pushes=ins.pushes,
                 push_val=ins.push_val, sample=ins.sample, fn=wrapped,
                 extra_energy=ins.extra_energy)


# ---------------------------------------------------------------------------
# Work partitioning: one kernel across the cores of a cluster
# ---------------------------------------------------------------------------

def _fast_forward_init(dfg: LoopDFG, offset: int) -> Dict[str, Any]:
    """The lag-carried machine state after ``offset`` sequential samples —
    what a core's registers hold when its sample range starts at ``offset``.

    Kernels with loop-carried chains (LCG state, running accumulators,
    address counters) cannot be split by naive index offsetting: core ``c``
    must start from the state the chain reaches at its range boundary, the
    same way production partitioned loops seed per-chunk state (LCG
    skip-ahead, per-chunk base addresses, partial-sum registers).  Evaluated
    with the sequential reference semantics, so the concatenated per-core
    outputs stay bit-identical to the unpartitioned kernel.
    """
    lags = [lag for n in dfg.nodes for (_s, lag) in n.srcs if lag > 0]
    if not lags or offset == 0:
        return dict(dfg.init)
    if max(lags) > 1:
        raise ValueError(
            f"{dfg.name}: work partitioning supports loop-carried lag 1 only "
            f"(got lag {max(lags)}); restructure the kernel")
    lagged = {s for n in dfg.nodes for (s, lag) in n.srcs if lag > 0}
    state = dict(dfg.init)
    for i in range(offset):
        cur = {name: gen(i) for name, gen in dfg.inputs.items()}
        for node in dfg.nodes:
            args = [cur[s] if lag == 0 else state[s]
                    for (s, lag) in node.srcs]
            cur[node.name] = node.fn(*args)
        for name in lagged | set(state):
            if name in cur:
                state[name] = cur[name]
    return state


def _shifted_dfg(dfg: LoopDFG, offset: int, tag: str) -> LoopDFG:
    """A view of ``dfg`` whose sample ``i`` is the base kernel's sample
    ``i + offset``: streamed inputs are index-shifted and lag-carried init
    values are fast-forwarded to the range start."""
    inputs = {name: (lambda i, _g=gen, _o=offset: _g(i + _o))
              for name, gen in dfg.inputs.items()}
    return LoopDFG(name=f"{dfg.name}{tag}", nodes=list(dfg.nodes),
                   inputs=inputs, input_homes=dict(dfg.input_homes),
                   init=_fast_forward_init(dfg, offset))


#: process-local cache of shifted per-core DFG views, keyed by
#: (kernel name, n_cores, chunk, core index) with the base-DFG identity
#: checked on hit (exactly like _V2_PREFIX_CACHE): repeated cluster sweeps
#: over machine axes then reuse one shifted DFG per core, which is what lets
#: the COPIFTv2 prefix cache hit across queue depths for partitioned runs.
_PARTITION_CACHE: Dict[Tuple, List] = {}
_PARTITION_CAP = 256


def _core_dfg(dfg: LoopDFG, c: int, n_cores: int, chunk: int) -> LoopDFG:
    key = (dfg.name, n_cores, chunk, c)
    hit = _PARTITION_CACHE.get(key)
    if hit is not None and hit[0] is dfg:
        return hit[1]
    sub = _shifted_dfg(dfg, c * chunk, f"@core{c}/{n_cores}")
    if len(_PARTITION_CACHE) >= _PARTITION_CAP:
        _PARTITION_CACHE.pop(next(iter(_PARTITION_CACHE)))
    _PARTITION_CACHE[key] = [dfg, sub]
    return sub


def partition_kernel(dfg: LoopDFG, policy: "ExecutionPolicy",
                     cfg: Optional[TransformConfig] = None,
                     n_cores: int = 1,
                     use_prefix_cache: bool = True) -> List[Program]:
    """Split ``cfg.n_samples`` across ``n_cores`` disjoint contiguous sample
    ranges and lower one per-core :class:`Program` each (same policy, same
    schedule parameters, ``n_samples / n_cores`` samples per core).

    Core ``c`` computes samples ``[c*chunk, (c+1)*chunk)``: inputs are
    index-shifted and loop-carried state is fast-forwarded to the range
    start, so the concatenation of the per-core outputs is bit-identical to
    the sequential reference.  ``n_cores=1`` returns ``[lower(...)]``
    verbatim — the cluster of one *is* the single-core program (the
    ``ClusterStepper`` bit-identity contract rests on this).

    Raises ``ValueError`` when the kernel cannot be partitioned
    (``n_samples`` not divisible by ``n_cores``, or loop-carried lag > 1).
    """
    cfg = cfg or TransformConfig()
    if n_cores <= 0:
        raise ValueError(f"n_cores must be positive, got {n_cores}")
    if n_cores == 1:
        return [lower(dfg, policy, cfg, use_prefix_cache)]
    n = cfg.n_samples
    if n % n_cores:
        raise ValueError(
            f"{dfg.name}: n_samples={n} not divisible by n_cores={n_cores}")
    chunk = n // n_cores
    batch = min(cfg.batch, chunk)
    while chunk % batch:              # COPIFT needs batch | n_samples
        batch -= 1
    sub_cfg = replace(cfg, n_samples=chunk, batch=batch)
    progs = [lower(_core_dfg(dfg, c, n_cores, chunk), policy, sub_cfg,
                   use_prefix_cache)
             for c in range(n_cores)]
    for p in progs:
        # carried explicitly so cluster results never parse user-given
        # names (which may themselves contain "@core")
        p.base_name = dfg.name
    return progs


# ---------------------------------------------------------------------------
# Pipeline partitioning: heterogeneous producer/consumer core pairs
# ---------------------------------------------------------------------------

def _stage_dma_loads(stream: List[Instr], b: _Builder, cfg: TransformConfig,
                     dma_buffers: int, chan: int) -> List[Instr]:
    """Rewrite the producer stream's loads into DMA-staged local reads.

    Consecutive loads are grouped (one unroll window's worth per transfer);
    group ``g`` is brought in by a ``DMA_START`` issued ``dma_buffers``
    groups ahead (the rotating-buffer prologue starts the first
    ``dma_buffers`` transfers), and a ``DMA_WAIT`` in front of the group's
    first load blocks until the data has landed.  The loads themselves are
    marked ``local`` — they read the staged buffer, exempt from bank
    arbitration and interconnect energy — and take the wait's token as an
    extra dependency so the functional interpreter preserves ordering."""
    loads = [k for k, ins in enumerate(stream) if ins.kind is OpKind.LW]
    if not loads:
        return stream
    samples = {stream[k].sample for k in loads if stream[k].sample >= 0}
    per_sample = max(1, len(loads) // max(1, len(samples)))
    group_size = max(1, (cfg.unroll_int or cfg.unroll) * per_sample)
    n_groups = (len(loads) + group_size - 1) // group_size
    group_of = {idx: j // group_size for j, idx in enumerate(loads)}
    words = [min(group_size, len(loads) - g * group_size)
             for g in range(n_groups)]

    def start(g: int) -> Instr:
        return b.instr(OpKind.DMA_START, f"dma:start{chan}:{g}",
                       dma_words=words[g])

    def wait(g: int) -> Instr:
        return b.instr(OpKind.DMA_WAIT, f"dma:wait{chan}:{g}",
                       dst=f"dma{chan}:{g}", fn=lambda: 0)

    out: List[Instr] = [start(g) for g in range(min(dma_buffers, n_groups))]
    seen: set = set()
    for idx, ins in enumerate(stream):
        g = group_of.get(idx)
        if g is None:
            out.append(ins)
            continue
        if g not in seen:
            seen.add(g)
            out.append(wait(g))
            if g + dma_buffers < n_groups:
                out.append(start(g + dma_buffers))
        tok = f"dma{chan}:{g}"
        fn = ins.fn
        wrapped = (lambda *a, _f=fn: _f(*a[1:])) if fn else None
        out.append(replace(ins, srcs=(tok,) + ins.srcs, fn=wrapped,
                           local=True))
    return out


def _pipeline_pair(sub: LoopDFG, cfg: TransformConfig, chan: int,
                   dma_buffers: int, use_prefix_cache: bool,
                   base: str, core0: int, n_cores: int
                   ) -> Tuple[Program, Program]:
    """Split one COPIFTv2 lowering of ``sub`` into a producer/consumer
    program pair communicating over inter-core channel ``chan``.

    The producer core keeps the v2 *integer* stream with every I2F push
    rewritten into a ``CQ_PUSH`` (and its loads DMA-staged); the consumer
    core keeps the v2 *FP* stream verbatim, fed by a ``CQ_POP`` prelude on
    its integer unit that relays channel entries into the local I2F queue in
    exactly the producer's push order — so the FP stream's FIFO ``expects``
    keep verifying value-exact delivery across the cluster."""
    plan = analyze(sub)
    if plan.int_receives:
        raise ValueError(
            f"{sub.name}: pipeline partitioning needs a one-directional "
            f"(int -> fp) kernel; {sorted(plan.int_receives)} flow back "
            "to the integer thread")
    v2 = lower_copiftv2(sub, cfg, use_prefix_cache)
    b = _Builder()

    prod_stream: List[Instr] = []
    push_order: List[str] = []
    for ins in v2.streams[Unit.INT]:
        if Queue.I2F not in ins.pushes:
            prod_stream.append(ins)
            continue
        pv = ins.push_val or ins.label
        if ins.dst is None:
            # MV re-push shim: becomes the channel push itself
            prod_stream.append(replace(ins, kind=OpKind.CQ_PUSH, pushes=(),
                                       cq=chan))
        else:
            # producing instruction: keep the register write, relay the
            # result through the channel with a separate push
            prod_stream.append(replace(ins, pushes=(), push_val=None))
            prod_stream.append(b.instr(OpKind.CQ_PUSH, f"cqpush:{pv}",
                                       (ins.dst,), push_val=pv,
                                       sample=ins.sample, fn=_identity,
                                       cq=chan))
        push_order.append(pv)
    prod_stream = _stage_dma_loads(prod_stream, b, cfg, dma_buffers, chan)

    magic = f"%cq{chan}"
    cons_int = [b.instr(OpKind.CQ_POP, f"cqpop:{pv}", (magic,),
                        pushes=(Queue.I2F,), push_val=pv, expects=(pv,),
                        fn=_identity, cq=chan)
                for pv in push_order]
    cons_env = dict(v2.init_env)
    cons_env[magic] = 0

    prod = Program(
        name=f"{base}@core{core0}/{n_cores}",
        policy=ExecutionPolicy.COPIFTV2, mode="dual",
        streams={Unit.INT: prod_stream}, n_samples=0,
        init_env=dict(v2.init_env), output_values=[], frep=False,
        base_name=base)
    cons = Program(
        name=f"{base}@core{core0 + 1}/{n_cores}",
        policy=ExecutionPolicy.COPIFTV2, mode="dual",
        streams={Unit.INT: cons_int, Unit.FP: v2.streams[Unit.FP]},
        n_samples=v2.n_samples, init_env=cons_env,
        output_values=list(v2.output_values), frep=True, base_name=base)
    return prod, cons


def partition_pipeline(dfg: LoopDFG, cfg: Optional[TransformConfig] = None,
                       n_cores: int = 2, dma_buffers: int = 2,
                       use_prefix_cache: bool = True) -> List[Program]:
    """Split ``dfg`` across ``n_cores`` as producer/consumer *pairs* — the
    heterogeneous counterpart of :func:`partition_kernel`.

    Core ``2p`` runs the integer (producer) half of pair ``p`` — loads
    (DMA-double-buffered), index arithmetic, and ``CQ_PUSH`` relays into
    inter-core channel ``p``; core ``2p + 1`` runs the FP (consumer) half —
    the unmodified COPIFTv2 FP stream fed from the channel.  Pairs divide
    the sample range exactly like :func:`partition_kernel` divides it over
    cores (index-shifted inputs, fast-forwarded loop-carried state), so the
    concatenated consumer outputs stay bit-identical to the sequential
    reference.

    ``dma_buffers`` must match the cluster's ``ClusterConfig.dma_buffers``
    (the lowering pipelines that many transfers; a deeper schedule than the
    engine sustains deadlocks, which the cluster detector reports).

    Raises ``ValueError`` for odd/insufficient ``n_cores``, a sample count
    not divisible by the pair count, or a kernel with FP-to-int feedback
    (pipeline pairs are one-directional by construction).
    """
    cfg = cfg or TransformConfig()
    if n_cores < 2 or n_cores % 2:
        raise ValueError(
            f"pipeline partitioning needs an even n_cores >= 2, "
            f"got {n_cores}")
    pairs = n_cores // 2
    n = cfg.n_samples
    if n % pairs:
        raise ValueError(
            f"{dfg.name}: n_samples={n} not divisible by "
            f"{pairs} pipeline pairs")
    chunk = n // pairs
    batch = min(cfg.batch, chunk)
    while chunk % batch:
        batch -= 1
    sub_cfg = replace(cfg, n_samples=chunk, batch=batch)
    progs: List[Program] = []
    for p in range(pairs):
        sub = dfg if pairs == 1 else _core_dfg(dfg, p, pairs, chunk)
        progs.extend(_pipeline_pair(sub, sub_cfg, p, dma_buffers,
                                    use_prefix_cache, base=dfg.name,
                                    core0=2 * p, n_cores=n_cores))
    return progs


# ---------------------------------------------------------------------------

def lower(dfg: LoopDFG, policy: ExecutionPolicy,
          cfg: Optional[TransformConfig] = None,
          use_prefix_cache: bool = True) -> Program:
    """Lower ``dfg`` under ``policy``.  ``use_prefix_cache=False`` bypasses
    the COPIFTv2 depth-independent prefix memo (benchmark baselines)."""
    cfg = cfg or TransformConfig()
    if policy is ExecutionPolicy.BASELINE:
        return lower_baseline(dfg, cfg)
    if policy is ExecutionPolicy.COPIFT:
        return lower_copift(dfg, cfg)
    if policy is ExecutionPolicy.COPIFTV2:
        return lower_copiftv2(dfg, cfg, use_prefix_cache)
    raise ValueError(policy)
