"""Batched cluster simulation: B cluster configs of one partitioned set at once.

``core.batch_machine`` vectorized the single-PE sweep; clustered and
pipelined points (``n_cores > 1``, finite TCDM banks, inter-core channels,
DMA staging) still fell back to the scalar event :class:`~.cluster.ClusterStepper`
— the slowest path exactly where ROADMAP item 2 explodes the grid.  This
module extends the lockstep max-recurrence to the whole cluster: issue
times of *every core's* instructions become one ``(L_total, B)`` array,
cluster config (cq depth/latency, DMA buffers/setup/bandwidth, bank
penalty, interconnect energy) becomes per-point array parameters, and all
B cluster configurations of one partitioned program set advance together.

Bit-identity contract (the single-PE engines' contract, extended to clusters):
:class:`BatchClusterStepper` must match ``ClusterStepper(progs, cfg).run()``
*exactly* — per-core cycles/energy/stall breakdown/FIFO sequences/env,
cluster aggregates (makespan, summed energy in the same float order,
cq push/pop/violation counts), and the cross-core deadlock message —
for every point.  ``tests/test_batch_cluster.py`` fuzzes this
differentially and CI gates it.

What makes the cluster recurrence static
----------------------------------------
The single-PE restrictions (SSA registers, one pusher/popper stream per
intra-core queue) apply per core; three cluster-specific restrictions make
the fabric edges static too (violations raise
:class:`BatchClusterUnsupported` and the caller falls back to the scalar
engine — an optimization boundary, never a semantics fork):

* each inter-core channel has exactly one pushing (core, stream) and one
  popping (core, stream) cluster-wide, so the k-th pop matches the k-th
  push and both serials are program-static;
* a ``CQ_POP``'s magic destination register is only read by the pops that
  write it (the ``transform.partition_pipeline`` idiom), so values stay
  timing-independent;
* all DMA ops of a core live on one stream with every ``DMA_WAIT`` behind
  its matching ``DMA_START``, so the in-flight deque's head is static.

Each fabric condition then clears at a statically-linked time, derived
from the scalar engines' check semantics under the min-(cycle, core)
scheduler (core index, then stream position, orders same-cycle events):

* ``cq_empty``  — pop serial ``k`` waits for push ``k``'s visibility:
  ``t[push_k] + push_latency + cq_latency``;
* ``cq_full``   — push serial ``p`` at depth ``d`` waits for pop ``p - d``
  to issue (+1 cycle when the popper's (core, stream) is ordered after
  the pusher's within a machine cycle);
* ``dma``       — ``DMA_WAIT`` w waits for START w's completion
  (``t[start] + latency + dma_setup + words * cycles_per_word``); a
  ``DMA_START`` finding all ``dma_buffers`` in flight can never unblock
  (its freeing WAIT sits behind it in program order) — a guaranteed
  deadlock, predicted per point from the static buffer demand.

Banks: the oracle, not a fixpoint
---------------------------------
Finite-bank contention is *not* a monotone recurrence (delaying one access
can make another issue earlier), so the batch path does not model bank
windows.  Instead it computes the bank-free schedule and runs a
*zero-contention oracle*: every TCDM access (mem ops by ``crc32(label) %
banks``, channel ops by ``channel % banks``, windows of
``bank_conflict_penalty`` resp. 1 cycle) is checked, per point, for
overlap with the running busy window of its bank in (time, core, stream)
order.  Conflict-free points provably execute identically with the
arbiter enabled — no access ever finds its bank busy, no stall is ever
attributed to ``bank`` — so their bank-free results are exact; points
with any conflict are delegated to the scalar engine.  Deadlock
prediction reuses the ``batch_machine`` gap criterion per core, and
predicted-deadlock points are delegated too, reproducing the scalar
``cross-core deadlock`` message verbatim.  Delegation is always sound:
the scalar result is returned as-is, so a misprediction costs speed,
never identity.
"""
from __future__ import annotations

import zlib
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .batch_machine import _I8, _attribute
from .cluster import ClusterConfig, ClusterResult, ClusterStepper
from .isa import (E_CQ_ACCESS, E_DMA_WORD, E_STATIC_PER_CYCLE, MEM_KINDS,
                  OpKind, QUEUE_INDEX, Queue, Unit)
from .machine import STALL_CAUSES, DeadlockError, Program, SimResult

#: flat per-core stall layout over all cluster causes:
#: ``core * _NK + unit_index * len(_CAUSES) + cause_index``
_CAUSES: Tuple[str, ...] = tuple(STALL_CAUSES) + ("bank", "cq_empty",
                                                  "cq_full", "dma")
_KEY_STRINGS: Tuple[str, ...] = tuple(
    f"{u.value}_{c}" for u in Unit for c in _CAUSES)
_KEY_ID: Dict[str, int] = {k: i for i, k in enumerate(_KEY_STRINGS)}
_NK = len(_KEY_STRINGS)


class BatchClusterUnsupported(ValueError):
    """The partitioned program set falls outside the restrictions that make
    the cluster-wide functional pass and static fabric linkage sound; run
    the scalar :class:`~.cluster.ClusterStepper` instead."""


@dataclass
class BatchClusterDeadlock:
    """Per-point deadlock outcome carrying the scalar engine's exact
    cross-core :class:`~.machine.DeadlockError` message (the predicted
    point is re-run on the scalar cluster engine, so the channel-occupancy
    and per-core-cycle annotations are reference-identical)."""
    name: str
    policy: Any
    message: str

    def error(self) -> DeadlockError:
        return DeadlockError(self.message)


#: one entry of ``BatchClusterStepper.run()``'s output
ClusterOutcome = Union[ClusterResult, BatchClusterDeadlock]


class _ClusterTables:
    """Everything config-independent about one partitioned program set:
    the cluster-global functional pass (fabric-aware) plus the static
    linkage that turns per-point issue times into one max-recurrence.

    Global instruction ids enumerate cores in index order, each core's
    streams in scheduler order — the same (cycle, core, stream) priority
    the scalar scheduler uses, so static tiebreaks replay its interleave.

    Per-instruction records (``self.instrs``):
    ``(prev, busyprev, busykey, lat, srcs, pushes, fab)`` — ``srcs`` and
    ``pushes`` as in ``batch_machine._ProgramTables`` (queue indices are
    core-scoped: ``cqi = core * NQ + qi``), ``fab`` the static fabric
    condition: ``None``, ``(0, chan, push_serial, key)`` for CQ_PUSH
    capacity, ``(1, chan, pop_serial, key)`` for CQ_POP visibility, or
    ``(3, start_gid, start_latency, words, key)`` for DMA_WAIT completion
    (DMA_START never carries a runtime clear: a blocked START is a
    guaranteed deadlock, excluded by the per-point buffer feasibility).
    """

    def __init__(self, progs: Sequence[Program], evaluate: bool):
        n_cores = len(progs)
        self.n_cores = n_cores
        NQ = len(Queue)
        self.NQ = NQ
        qlist = list(Queue)

        orders: List[List[Tuple[Unit, List[Any]]]] = []
        for prog in progs:
            if prog.mode == "single":
                assert len(prog.streams) == 1, \
                    "single mode expects one merged stream"
                order = list(prog.streams.items())
            else:
                order = [(u, prog.streams[u])
                         for u in (Unit.INT, Unit.FP) if u in prog.streams]
            orders.append(order)

        # -- per-core single-PE restrictions (mirrors _ProgramTables) -------
        core_pushers: List[Dict[int, set]] = []
        core_poppers: List[Dict[int, set]] = []
        for prog, order in zip(progs, orders):
            written: Dict[str, int] = {k: 1 for k in prog.init_env}
            pushers: Dict[int, set] = {}
            poppers: Dict[int, set] = {}
            for s, (u, lst) in enumerate(order):
                for ins in lst:
                    f = ins.exec_facts
                    if f[2] < 1:
                        raise BatchClusterUnsupported(
                            f"{prog.name}: zero-latency instruction "
                            f"(completion-time identities need latency >= 1)")
                    if prog.mode != "single" and f[0] is not u:
                        raise BatchClusterUnsupported(
                            f"{prog.name}: {f[0].value} instruction on the "
                            f"{u.value} stream (cross-stream busy coupling "
                            f"would be timing-dependent)")
                    if f[7] is not None:
                        written[f[7]] = written.get(f[7], 0) + 1
                    for op in f[12]:
                        if op[0]:
                            poppers.setdefault(op[5], set()).add(s)
                    for push in f[13]:
                        pushers.setdefault(push[3], set()).add(s)
            multi = [d for d, c in written.items() if c > 1]
            if multi:
                raise BatchClusterUnsupported(
                    f"{prog.name}: registers written more than once "
                    f"(timing could select the value): {sorted(multi)[:4]}")
            if any(len(ss) > 1 for m in (pushers, poppers)
                   for ss in m.values()):
                raise BatchClusterUnsupported(
                    f"{prog.name}: queue pushed/popped by more than one "
                    f"stream (FIFO order would depend on timing)")
            core_pushers.append(pushers)
            core_poppers.append(poppers)

        # -- global layout ---------------------------------------------------
        offsets: List[int] = []
        core_L: List[int] = []
        off = 0
        for order in orders:
            offsets.append(off)
            lc = sum(len(lst) for _u, lst in order)
            core_L.append(lc)
            off += lc
        L = off
        self.L = L
        self.core_off = offsets
        self.core_L = core_L
        self.core_S = [max(1, len(order)) for order in orders]
        rank_of: Dict[Tuple[int, int], int] = {}
        for c, order in enumerate(orders):
            for s in range(len(order)):
                rank_of[(c, s)] = len(rank_of)
        self.n_ranks = max(1, len(rank_of))

        # -- fabric registries + cluster-specific restrictions ---------------
        # chan -> [(gid, push_latency, pushed_name, src_reg)] / pops, plus
        # the unique pusher/popper (core, stream) per channel; DMA starts
        # per core with the static buffer demand.
        chan_push: Dict[int, List[Tuple[int, int, str, Any]]] = {}
        chan_pop: Dict[int, List[Tuple[int, Any, Optional[str], str]]] = {}
        chan_pusher: Dict[int, Tuple[int, int]] = {}
        chan_popper: Dict[int, Tuple[int, int]] = {}
        magic_writer: Dict[Tuple[int, str], Tuple[int, int]] = {}
        core_starts: List[List[Tuple[int, int, int]]] = [[] for _ in progs]
        core_waits: List[int] = [0] * n_cores
        dma_stream: Dict[int, int] = {}
        dma_req = [0] * n_cores
        fabmeta: Dict[int, Tuple] = {}      # gid -> static fabric tuple

        def _one_dma_stream(c: int, s: int, prog: Program) -> None:
            if dma_stream.setdefault(c, s) != s:
                raise BatchClusterUnsupported(
                    f"{prog.name}: DMA ops on more than one stream "
                    f"(in-flight order would be timing-dependent)")

        gid = 0
        for c, (prog, order) in enumerate(zip(progs, orders)):
            for s, (u, lst) in enumerate(order):
                for ins in lst:
                    f = ins.exec_facts
                    kind = ins.kind
                    if kind is OpKind.CQ_PUSH or kind is OpKind.CQ_POP:
                        if ins.cq is None:
                            raise ValueError(
                                f"{ins.label}: {kind.value} needs a channel "
                                f"(Instr.cq)")
                        ch = ins.cq
                        if kind is OpKind.CQ_PUSH:
                            if chan_pusher.setdefault(ch, (c, s)) != (c, s):
                                raise BatchClusterUnsupported(
                                    f"{prog.name}: channel {ch} pushed by "
                                    f"more than one (core, stream)")
                            p = len(chan_push.setdefault(ch, []))
                            src = ins.srcs[0] if ins.srcs else None
                            chan_push[ch].append(
                                (gid, int(f[2]), ins.push_val or ins.label,
                                 src))
                            fabmeta[gid] = (
                                0, ch, p,
                                c * _NK + _KEY_ID[f"{f[1]}_cq_full"])
                        else:
                            if chan_popper.setdefault(ch, (c, s)) != (c, s):
                                raise BatchClusterUnsupported(
                                    f"{prog.name}: channel {ch} popped by "
                                    f"more than one (core, stream)")
                            k = len(chan_pop.setdefault(ch, []))
                            magic = ins.srcs[0]
                            if isinstance(magic, str):
                                if magic_writer.setdefault(
                                        (c, magic), (c, s)) != (c, s):
                                    raise BatchClusterUnsupported(
                                        f"{prog.name}: magic register "
                                        f"{magic!r} written by pops of more "
                                        f"than one stream")
                            expect = ins.expects[0] if ins.expects else None
                            chan_pop[ch].append(
                                (gid, magic, expect, ins.label))
                            fabmeta[gid] = (
                                1, ch, k,
                                c * _NK + _KEY_ID[f"{f[1]}_cq_empty"])
                    elif kind is OpKind.DMA_START:
                        _one_dma_stream(c, s, prog)
                        j = len(core_starts[c])
                        dma_req[c] = max(dma_req[c], j - core_waits[c] + 1)
                        core_starts[c].append(
                            (gid, int(f[2]), ins.dma_words))
                        fabmeta[gid] = (2,)
                    elif kind is OpKind.DMA_WAIT:
                        _one_dma_stream(c, s, prog)
                        w = core_waits[c]
                        if w >= len(core_starts[c]):
                            raise BatchClusterUnsupported(
                                f"{prog.name}: DMA_WAIT without a matching "
                                f"in-flight DMA_START (head would be "
                                f"timing-dependent)")
                        sg, slat, words = core_starts[c][w]
                        core_waits[c] = w + 1
                        fabmeta[gid] = (
                            3, sg, slat, words,
                            c * _NK + _KEY_ID[f"{f[1]}_dma"])
                    gid += 1

        # magic registers feed only their own pops: any other reader would
        # observe a timing-dependent snapshot of the rotating value
        for c, prog in enumerate(progs):
            magics = {name for (cc, name) in magic_writer if cc == c}
            if not magics:
                continue
            for _u, lst in orders[c]:
                for ins in lst:
                    for src in ins.reg_srcs:
                        if src in magics and not (
                                ins.kind is OpKind.CQ_POP
                                and ins.srcs and ins.srcs[0] == src):
                            raise BatchClusterUnsupported(
                                f"{prog.name}: magic register {src!r} read "
                                f"outside its CQ_POP")

        self.dma_req_max = max(dma_req) if dma_req else 0
        self.cq_req_max = max(
            (max(0, len(chan_push.get(ch, []))
                 - len(chan_pop.get(ch, [])))
             for ch in set(chan_push) | set(chan_pop)), default=0)
        #: channel linkage for the runtime recurrence
        self.cq_pushg = {ch: np.array([g for g, _l, _n, _s in lst], _I8)
                         for ch, lst in chan_push.items()}
        self.cq_push_lat = {ch: np.array([l for _g, l, _n, _s in lst], _I8)
                            for ch, lst in chan_push.items()}
        self.cq_popg = {ch: np.array([g for g, _m, _e, _l in lst], _I8)
                        for ch, lst in chan_pop.items()}
        self.cq_adj = {}
        for ch, pu in chan_pusher.items():
            po = chan_popper.get(ch)
            # same-cycle ordering under the min-(cycle, core) scheduler:
            # the popper's issue is visible to the pusher's check iff the
            # popper's (core, stream) slot comes first
            self.cq_adj[ch] = 1 if po is None else (0 if po < pu else 1)

        # -- cluster-global functional pass (fabric-aware) -------------------
        # Greedy fixpoint over every core's streams: execute any instruction
        # whose register sources are produced, whose intra-core pops have
        # matching pushes and whose CQ_POP has a pushed channel value —
        # ignoring capacity, banks and latency.  Confluent (executing an
        # enabled instruction never disables another), so any machine
        # schedule yields these exact values and sequences.
        envs: List[Dict[str, Any]] = [dict(p.init_env) for p in progs]
        produced: List[set] = [set(p.init_env) for p in progs]
        push_vals: List[List[List[Tuple[str, Any]]]] = [
            [[] for _ in qlist] for _ in progs]
        popped: List[List[int]] = [[0] * NQ for _ in progs]
        push_logs = [{q: [] for q in qlist} for _ in progs]
        pop_logs = [{q: [] for q in qlist} for _ in progs]
        chan_vals: Dict[int, List[Tuple[str, Any]]] = {}
        chan_taken: Dict[int, int] = {}
        violations: List[Dict[int, List[Tuple[str, str, str, str]]]] = [
            {} for _ in progs]
        n_cq_push = n_cq_pop = n_cq_viol = 0
        pcs = [[0] * len(order) for order in orders]
        flat_facts = [[[ins.exec_facts for ins in lst] for _u, lst in order]
                      for order in orders]
        stream_off: List[List[int]] = []
        for c, order in enumerate(orders):
            offs, o = [], offsets[c]
            for _u, lst in order:
                offs.append(o)
                o += len(lst)
            stream_off.append(offs)

        progress = True
        while progress:
            progress = False
            for c in range(n_cores):
                for s, fs in enumerate(flat_facts[c]):
                    while pcs[c][s] < len(fs):
                        f = fs[pcs[c][s]]
                        g = stream_off[c][s] + pcs[c][s]
                        fab = fabmeta.get(g)
                        ok = True
                        for is_q, src, k, _key, _qv, qi in f[12]:
                            if is_q:
                                if (len(push_vals[c][qi])
                                        < popped[c][qi] + k + 1):
                                    ok = False
                                    break
                            elif src not in produced[c]:
                                ok = False
                                break
                        if ok and fab is not None and fab[0] == 1:
                            ch = fab[1]
                            if (len(chan_vals.get(ch, []))
                                    <= chan_taken.get(ch, 0)):
                                ok = False
                        if not ok:
                            break
                        # fabric side effects first (the scalar order): a
                        # CQ_POP's value lands in env before the base ops
                        # read it
                        if fab is not None:
                            tag = fab[0]
                            if tag == 0:
                                ch = fab[1]
                                _g, _l, name, src = chan_push[ch][fab[2]]
                                chan_vals.setdefault(ch, []).append(
                                    (name, envs[c].get(src)))
                                n_cq_push += 1
                            elif tag == 1:
                                ch = fab[1]
                                _g, magic, expect, _lbl = chan_pop[ch][fab[2]]
                                nm, val = chan_vals[ch][
                                    chan_taken.get(ch, 0)]
                                chan_taken[ch] = chan_taken.get(ch, 0) + 1
                                envs[c][magic] = val
                                produced[c].add(magic)
                                if expect is not None and expect != nm:
                                    n_cq_viol += 1
                                n_cq_pop += 1
                        opvals = []
                        expects = f[9]
                        n_pop = 0
                        for is_q, src, k, _key, qv, qi in f[12]:
                            if is_q:
                                vname, val = push_vals[c][qi][popped[c][qi]]
                                popped[c][qi] += 1
                                pop_logs[c][qlist[qi]].append(vname)
                                if expects and expects[n_pop] != vname:
                                    violations[c].setdefault(g, []).append(
                                        (f[10], qv, expects[n_pop], vname))
                                n_pop += 1
                                opvals.append(val)
                            else:
                                opvals.append(envs[c].get(src))
                        result = None
                        if evaluate and f[8] is not None:
                            result = f[8](*opvals)
                        if f[7] is not None:
                            envs[c][f[7]] = result
                            produced[c].add(f[7])
                        for _q, _k, _key, qi in f[13]:
                            push_vals[c][qi].append((f[11], result))
                            push_logs[c][qlist[qi]].append(f[11])
                        pcs[c][s] += 1
                        progress = True
        self.value_complete = all(
            pcs[c][s] == len(fs)
            for c in range(n_cores)
            for s, fs in enumerate(flat_facts[c]))
        self.env_c = envs
        self.push_seq_c = push_logs
        self.pop_seq_c = pop_logs
        self.n_cq_pushes = n_cq_push
        self.n_cq_pops = n_cq_pop
        self.n_cq_violations = n_cq_viol
        self.instr_count_c = []
        for order in orders:
            cnt = {"int": 0, "fp": 0}
            for _u, lst in order:
                for ins in lst:
                    cnt[ins.unit.value] += 1
            self.instr_count_c.append(cnt)

        # per-core FIFO-violation re-merge bookkeeping (batch_machine idiom)
        self.tracked_gid_c: List[np.ndarray] = []
        self.tracked_sorder_c: List[np.ndarray] = []
        self.tracked_tuples_c: List[List[List[Tuple[str, str, str, str]]]] = []
        for c in range(n_cores):
            gids = sorted(violations[c])
            self.tracked_gid_c.append(np.array(gids, dtype=_I8))
            sorder = []
            for g in gids:
                s = 0
                while (s + 1 < len(stream_off[c])
                       and g >= stream_off[c][s + 1]):
                    s += 1
                sorder.append(s)
            self.tracked_sorder_c.append(np.array(sorder, dtype=_I8))
            self.tracked_tuples_c.append([violations[c][g] for g in gids])

        # -- static dependence linkage --------------------------------------
        self.g_e = np.zeros(L, np.float64)
        self.e0 = np.zeros(L, np.float64)          # fabric energy at issue
        self.e1m = np.zeros(L, bool)               # charges interconnect
        self.g_sidx = np.zeros(L, _I8)             # local stream index
        self.g_rank = np.zeros(L, _I8)             # global (core, stream)
        pushg_cq: List[List[int]] = [[] for _ in range(n_cores * NQ)]
        popg_cq: List[List[int]] = [[] for _ in range(n_cores * NQ)]
        pop_ev: List[List[Tuple[int, int, int]]] = [
            [] for _ in range(n_cores * NQ)]
        push_ev: List[List[Tuple[int, int, int]]] = [
            [] for _ in range(n_cores * NQ)]
        core_km = [1] * n_cores
        producer: List[Dict[str, int]] = [{} for _ in progs]
        acc_gid: List[int] = []
        acc_hash: List[int] = []
        acc_is_mem: List[bool] = []
        raw: List[Tuple] = []
        for c, (prog, order) in enumerate(zip(progs, orders)):
            for s, (u, lst) in enumerate(order):
                last_blocking: Dict[int, int] = {}
                # busy chains span the whole core, not one stream — but a
                # unit's instructions all live on one stream (checked
                # above for dual mode; single mode has one stream), so
                # per-stream tracking is per-unit tracking
                for i, ins in enumerate(lst):
                    f = ins.exec_facts
                    g = stream_off[c][s] + i
                    (unit, _uval, latency, blocking, e_plain, e_frep,
                     busy_key, dst, _fn, _expects, _label, _pushv, ops,
                     pushes, uidx) = f
                    self.g_sidx[g] = s
                    self.g_rank[g] = rank_of[(c, s)]
                    self.g_e[g] = (e_frep if (prog.frep and unit is Unit.FP)
                                   else e_plain)
                    fab = fabmeta.get(g)
                    if fab is not None:
                        if fab[0] <= 1:
                            self.e0[g] = E_CQ_ACCESS
                            self.e1m[g] = True
                            acc_gid.append(g)
                            acc_hash.append(fab[1])
                            acc_is_mem.append(False)
                        elif fab[0] == 2:
                            self.e0[g] = E_DMA_WORD * ins.dma_words
                    elif ins.kind in MEM_KINDS and not ins.local:
                        self.e1m[g] = True
                        acc_gid.append(g)
                        acc_hash.append(zlib.crc32(ins.label.encode()))
                        acc_is_mem.append(True)
                    prev = g - 1 if i > 0 else -1
                    busyprev = last_blocking.get(uidx, -1)
                    if blocking:
                        last_blocking[uidx] = g
                    if dst is not None:
                        producer[c][dst] = g
                    core_km[c] = max(core_km[c], len(ops) + 1,
                                     len(pushes) + 1)
                    raw_srcs = []
                    pre = [len(popg_cq[c * NQ + qi]) for qi in range(NQ)]
                    for is_q, src, k, key, _qv, qi in ops:
                        if is_q:
                            raw_srcs.append((True, qi, pre[qi] + k,
                                             c * _NK + _KEY_ID[key]))
                        else:
                            raw_srcs.append((False, src, -1,
                                             c * _NK + _KEY_ID[key]))
                    for j, (is_q, _src, _k, _key, _qv, qi) in enumerate(ops):
                        if is_q:
                            popg_cq[c * NQ + qi].append(g)
                            pop_ev[c * NQ + qi].append((g, s * 2 + 0, j))
                    raw_pushes = []
                    pre_push = [len(pushg_cq[c * NQ + qi])
                                for qi in range(NQ)]
                    for j, (_q, k, key, qi) in enumerate(pushes):
                        raw_pushes.append((c * NQ + qi, qi, pre_push[qi] + k,
                                           c * _NK + _KEY_ID[key]))
                        pushg_cq[c * NQ + qi].append(g)
                        push_ev[c * NQ + qi].append((g, s * 2 + 1, j))
                    raw.append((c, prev, busyprev,
                                c * _NK + _KEY_ID[busy_key],
                                int(latency), tuple(raw_srcs),
                                tuple(raw_pushes), fab))
        self.acc_gid = np.array(acc_gid, dtype=_I8)
        self.acc_hash = np.array(acc_hash, dtype=_I8)
        self.acc_is_mem = np.array(acc_is_mem, dtype=bool)

        instrs: List[Tuple] = []
        preds: List[List[int]] = []
        cap_slots: List[Tuple[int, int, int, int]] = []
        cq_cap_slots: List[Tuple[int, int, int]] = []
        for g, (c, prev, busyprev, busykey, lat, raw_srcs, raw_pushes,
                fab) in enumerate(raw):
            srcs = []
            p: List[int] = [prev] if prev >= 0 else []
            for is_q, a, serial, key in raw_srcs:
                if is_q:
                    pg = pushg_cq[c * NQ + a]
                    gg = pg[serial] if serial < len(pg) else -1
                else:
                    gg = (-1 if a in progs[c].init_env
                          else producer[c].get(a, -1))
                if gg >= 0:
                    srcs.append((gg, is_q, key))
                    p.append(gg)
            for cqi, _qi, ps, _key in raw_pushes:
                cap_slots.append((g, cqi, cqi % NQ, ps))
            if fab is not None:
                if fab[0] == 0:
                    cq_cap_slots.append((g, fab[1], fab[2]))
                elif fab[0] == 1:
                    pg = self.cq_pushg.get(fab[1])
                    if pg is not None and fab[2] < len(pg):
                        p.append(int(pg[fab[2]]))
                elif fab[0] == 3:
                    p.append(fab[1])
            instrs.append((prev, busyprev, busykey, lat, tuple(srcs),
                           raw_pushes, fab))
            preds.append(p)
        self.instrs = instrs
        self._preds = preds
        self._cap_slots = cap_slots
        self._cq_cap_slots = cq_cap_slots
        self._topo_cache: Dict[Tuple[int, ...], Optional[List[int]]] = {}
        self.popg = [np.array(gids, dtype=_I8) for gids in popg_cq]
        self.npop = [len(gids) for gids in popg_cq]
        # the stall-key vector of each instruction's clear list is static
        # (which conditions participate never depends on the config values,
        # only on compile-time linkage) — precompute it for the hot loop
        self.clear_keys: List[np.ndarray] = []
        for prev, busyprev, busykey, lat, srcs, pushes, fab in instrs:
            ks: List[int] = []
            if busyprev >= 0:
                ks.append(busykey)
            if fab is not None:
                if fab[0] == 0:
                    pg = self.cq_popg.get(fab[1])
                    if pg is not None and len(pg):
                        ks.append(fab[3])
                elif fab[0] == 1:
                    ks.append(fab[3])
                elif fab[0] == 3:
                    ks.append(fab[4])
            ks.extend(key for _g, _q, key in srcs)
            ks.extend(key for cqi, _qi, _ps, key in pushes
                      if self.npop[cqi])
            self.clear_keys.append(np.array(ks, dtype=_I8))
        req = [0] * NQ
        for _g, cqi, qi, serial in cap_slots:
            req[qi] = max(req[qi], serial - len(popg_cq[cqi]) + 1)
        self.min_depth_req = np.array(req, dtype=_I8)
        self.qadj = []
        for c in range(n_cores):
            for qi in range(NQ):
                pu = next(iter(core_pushers[c].get(qi, {0})))
                po = next(iter(core_poppers[c].get(qi, {0})))
                self.qadj.append(0 if po < pu else 1)
        self.occ_tie_mod_c = [self.core_S[c] * 2 * core_km[c]
                              for c in range(n_cores)]
        self.occ_ev_c = []
        for c in range(n_cores):
            per_q = []
            km = core_km[c]
            for qi in range(NQ):
                cqi = c * NQ + qi
                evs = pop_ev[cqi] + push_ev[cqi]
                gids = np.array([g for g, _ph, _j in evs], dtype=_I8)
                tie = np.array([ph * km + j for _g, ph, j in evs], dtype=_I8)
                delta = np.array([-1] * len(pop_ev[cqi])
                                 + [1] * len(push_ev[cqi]), dtype=_I8)
                per_q.append((gids, tie, delta, len(push_ev[cqi]) > 0))
            self.occ_ev_c.append(per_q)

    def topo(self, dvec: Tuple[int, ...]) -> Optional[List[int]]:
        """Topological order of the global dependence DAG at intra-queue
        depths ``dvec[:NQ]`` and channel depth ``dvec[NQ]`` (``None`` if
        the capacity edges create a cycle — guaranteed deadlock at those
        depths).  As in ``batch_machine``, capacity edges only loosen as
        depths grow, so the order at the batch's componentwise minimum is
        valid for every point."""
        cached = self._topo_cache.get(dvec, False)
        if cached is not False:
            return cached
        L = self.L
        NQ = self.NQ
        indeg = [0] * L
        succ: List[List[int]] = [[] for _ in range(L)]
        for i, ps in enumerate(self._preds):
            for p in ps:
                succ[p].append(i)
                indeg[i] += 1
        for g, cqi, qi, serial in self._cap_slots:
            j = serial - dvec[qi]
            if j >= 0:
                p = int(self.popg[cqi][j])
                succ[p].append(g)
                indeg[g] += 1
        for g, ch, serial in self._cq_cap_slots:
            j = serial - dvec[NQ]
            if j >= 0:
                pg = self.cq_popg.get(ch)
                if pg is None or j >= len(pg):
                    # push that can never find room: guaranteed deadlock,
                    # excluded by the per-point cq feasibility check
                    self._topo_cache[dvec] = None
                    return None
                p = int(pg[j])
                succ[p].append(g)
                indeg[g] += 1
        dq = deque(i for i in range(L) if indeg[i] == 0)
        out: List[int] = []
        while dq:
            i = dq.popleft()
            out.append(i)
            for nxt in succ[i]:
                indeg[nxt] -= 1
                if indeg[nxt] == 0:
                    dq.append(nxt)
        res: Optional[List[int]] = out if len(out) == L else None
        self._topo_cache[dvec] = res
        return res


def _compile_cluster(progs: Sequence[Program],
                     evaluate: bool) -> _ClusterTables:
    """Build (or fetch) the program set's batch tables.  Cached on the
    first program — keyed by the identity of the whole set (pinned by the
    cache entry, so ids stay valid) — mirroring ``batch_machine._compile``
    so the memoized partitioned sets the sweep re-simulates across config
    batches compile once."""
    progs = list(progs)
    key = (tuple(id(p) for p in progs), bool(evaluate))
    anchor = progs[0]
    cached = getattr(anchor, "_batch_cluster_cache", None)
    if cached is not None and cached[0] == key:
        return cached[2]
    tables = _ClusterTables(progs, evaluate)
    anchor._batch_cluster_cache = (key, tuple(progs), tables)
    return tables


class BatchClusterStepper:
    """Advance B cluster configurations of one partitioned program set.

    ``run()`` returns one outcome per config, in input order: a
    :class:`~.cluster.ClusterResult` bit-identical to
    ``ClusterStepper(progs, cfg).run()``, or a :class:`BatchClusterDeadlock`
    carrying the identical cross-core :class:`~.machine.DeadlockError`
    message.  Predicted-deadlock, bank-conflicted and infeasible points are
    delegated to the scalar engine (always sound — the scalar result is
    returned as-is); completing conflict-free points never are.

    Shared config-independent pieces (per-core env, push/pop sequences)
    are shared objects across the returned results — treat them as
    read-only, exactly like the memoized Programs the sweep shares.

    Raises :class:`BatchClusterUnsupported` (at construction) for program
    sets outside the restrictions in the module docstring, and
    ``ValueError`` when a config's ``n_cores`` does not match the program
    count (the scalar constructor's contract).
    """

    def __init__(self, progs: Sequence[Program],
                 cfgs: Sequence[Optional[ClusterConfig]]):
        self.progs = list(progs)
        self.cfgs = [c if c is not None
                     else ClusterConfig(n_cores=len(self.progs))
                     for c in cfgs]
        for cfg in self.cfgs:
            if len(self.progs) != cfg.n_cores:
                raise ValueError(
                    f"got {len(self.progs)} per-core programs for "
                    f"n_cores={cfg.n_cores}")
        evals = {bool(c.machine.evaluate) for c in self.cfgs}
        if len(evals) > 1:
            raise BatchClusterUnsupported(
                "mixed cfg.machine.evaluate across a batch "
                "(env would differ)")
        self._evaluate = evals.pop() if evals else True
        if not self.progs:
            raise ValueError("got 0 per-core programs")
        self._t = _compile_cluster(self.progs, self._evaluate)

    def run(self) -> List[ClusterOutcome]:
        t = self._t
        B = len(self.cfgs)
        if B == 0:
            return []
        out: List[Optional[ClusterOutcome]] = [None] * B
        if t.L == 0 or not t.value_complete:
            # empty sets are trivial, circular dataflow deadlocks every
            # config: the scalar engine is exact (and cheap) for both
            for b in range(B):
                out[b] = self._scalar(b)
            return out  # type: ignore[return-value]

        qlist = list(Queue)
        depths = np.array([[c.machine.depth_of(q) for q in qlist]
                           for c in self.cfgs], _I8)
        cqd = np.array([c.cq_depth for c in self.cfgs], _I8)
        bufs = np.array([c.dma_buffers for c in self.cfgs], _I8)
        feasible = ~(depths < t.min_depth_req[None, :]).any(axis=1)
        feasible &= cqd >= t.cq_req_max
        feasible &= bufs >= t.dma_req_max
        for b in np.nonzero(~feasible)[0]:
            out[int(b)] = self._scalar(int(b))
        rows = np.nonzero(feasible)[0].astype(_I8)
        groups: List[Tuple[np.ndarray, List[int]]] = []
        if rows.size:
            dmin = tuple(int(x) for x in depths[rows].min(axis=0)) + (
                int(cqd[rows].min()),)
            order = t.topo(dmin)
            if order is not None:
                groups.append((rows, order))
            else:
                classes: Dict[Tuple[int, ...], List[int]] = {}
                for b in rows:
                    dv = tuple(int(x) for x in depths[b]) + (int(cqd[b]),)
                    classes.setdefault(dv, []).append(int(b))
                for dvec, bs in classes.items():
                    o = t.topo(dvec)
                    if o is None:
                        for b in bs:
                            out[b] = self._scalar(b)
                    else:
                        groups.append((np.array(bs, _I8), o))

        stalls = np.zeros((B, t.n_cores * _NK), _I8)
        for rows_g, order in groups:
            self._run_group(rows_g, order, depths, stalls, out)
        return out  # type: ignore[return-value]

    # -- the max-recurrence over one topologically-ordered group -------------

    def _run_group(self, rows: np.ndarray, order: List[int],
                   depths: np.ndarray, stalls: np.ndarray,
                   out: List[Optional[ClusterOutcome]]) -> None:
        t = self._t
        L = t.L
        R = rows.size
        n_cores = t.n_cores
        NQ = t.NQ
        cl = [self.cfgs[int(b)] for b in rows]
        dR = depths[rows]
        qR = np.array([c.machine.queue_latency for c in cl], _I8)
        limR = np.array([c.machine.deadlock_limit for c in cl], _I8)
        cqdR = np.array([c.cq_depth for c in cl], _I8)
        cqlR = np.array([c.cq_latency for c in cl], _I8)
        setR = np.array([c.dma_setup for c in cl], _I8)
        cpwR = np.array([c.dma_cycles_per_word for c in cl], _I8)
        penR = np.array([c.bank_conflict_penalty for c in cl], _I8)
        eaccR = np.array([c.interconnect_energy if c.n_cores > 1 else 0.0
                          for c in cl], np.float64)
        banksR = np.array([c.tcdm_banks or 0 for c in cl], _I8)
        ar = np.arange(R)
        zeros = np.zeros(R, _I8)
        ti = np.zeros((L, R), _I8)
        td = np.zeros((L, R), _I8)
        instrs = t.instrs
        popg = t.popg
        npop = t.npop
        qadj = t.qadj
        base_buf = np.empty(R, _I8)
        acc = np.empty(R, _I8)
        for i in order:
            prev, busyprev, busykey, lat, srcs, pushes, fab = instrs[i]
            if prev >= 0:
                np.add(ti[prev], 1, out=base_buf)
                base = base_buf
            else:
                base = zeros
            np.copyto(acc, base)
            # scalar check order: busy -> fabric -> sources -> capacity;
            # the bank gate (last) is omitted — the zero-contention oracle
            # guarantees it neither blocks nor owns a stall for surviving
            # points, and conflicted points are delegated.  The key of each
            # clear is static (``t.clear_keys[i]``, same order as appended).
            clears: List[np.ndarray] = []
            if busyprev >= 0:
                c = td[busyprev]
                clears.append(c)
                np.maximum(acc, c, out=acc)
            if fab is not None:
                tag = fab[0]
                if tag == 0:
                    ch = fab[1]
                    pg = t.cq_popg.get(ch)
                    if pg is not None and len(pg):
                        jv = fab[2] - cqdR
                        jc = np.clip(jv, 0, len(pg) - 1)
                        c = ti[pg[jc], ar] + t.cq_adj[ch]
                        c = np.where(jv < 0, 0, c)
                        clears.append(c)
                        np.maximum(acc, c, out=acc)
                    # else: feasibility guarantees depth >= total pushes
                elif tag == 1:
                    ch = fab[1]
                    c = (ti[t.cq_pushg[ch][fab[2]]]
                         + int(t.cq_push_lat[ch][fab[2]]) + cqlR)
                    clears.append(c)
                    np.maximum(acc, c, out=acc)
                elif tag == 3:
                    c = ti[fab[1]] + fab[2] + setR + fab[3] * cpwR
                    clears.append(c)
                    np.maximum(acc, c, out=acc)
            for g, is_q, _key in srcs:
                c = td[g] + qR if is_q else td[g]
                clears.append(c)
                np.maximum(acc, c, out=acc)
            for cqi, qi, ps, _key in pushes:
                if npop[cqi] == 0:
                    continue
                jv = ps - dR[:, qi]
                jc = np.clip(jv, 0, npop[cqi] - 1)
                c = ti[popg[cqi][jc], ar] + qadj[cqi]
                c = np.where(jv < 0, 0, c)
                clears.append(c)
                np.maximum(acc, c, out=acc)
            ti[i] = acc
            np.add(acc, lat, out=td[i])
            if clears:
                m = acc > base
                if m.any():
                    sub = np.nonzero(m)[0]
                    ct = np.empty((sub.size, len(clears)), _I8)
                    for j, c in enumerate(clears):
                        ct[:, j] = c[sub]
                    karr = t.clear_keys[i]
                    keys = np.broadcast_to(karr, (sub.size, karr.size))
                    _attribute(stalls, rows[sub], ct, keys,
                               base[sub], acc[sub] - 1)

        # per-core deadlock prediction (the batch_machine gap criterion:
        # the schedule is the no-horizon machine's exact schedule, and a
        # core's detector fires iff some inter-issue wait exceeds limit+1)
        lim1 = limR + 1
        dead = np.zeros(R, bool)
        for c in range(n_cores):
            off, Lc = t.core_off[c], t.core_L[c]
            if Lc == 0:
                continue
            ts = np.sort(ti[off:off + Lc], axis=0)
            dc = ts[0] > lim1
            if Lc > 1:
                dc |= (np.diff(ts, axis=0) > lim1[None, :]).any(axis=0)
            dead |= dc

        # zero-contention bank oracle: any access overlapping the running
        # busy window of its bank (in (time, core, stream) arbiter order)
        # breaks the bank-free-schedule equivalence -> delegate that point
        confl = np.zeros(R, bool)
        if t.acc_gid.size and (banksR > 0).any():
            acc_t = ti[t.acc_gid]
            acc_rank = t.g_rank[t.acc_gid]
            for nb in np.unique(banksR[banksR > 0]):
                cols = np.nonzero(banksR == nb)[0]
                ids = t.acc_hash % int(nb)
                for bank in np.unique(ids):
                    sel = np.nonzero(ids == bank)[0]
                    if sel.size < 2:
                        continue
                    times = acc_t[np.ix_(sel, cols)]
                    w = np.where(t.acc_is_mem[sel][:, None],
                                 penR[cols][None, :], 1)
                    key = times * t.n_ranks + acc_rank[sel][:, None]
                    p = np.argsort(key, axis=0, kind="stable")
                    tsrt = np.take_along_axis(times, p, 0)
                    wsrt = np.take_along_axis(w, p, 0)
                    endmax = np.maximum.accumulate(tsrt + wsrt, axis=0)
                    cc = (tsrt[1:] < endmax[:-1]).any(axis=0)
                    if cc.any():
                        confl[cols[np.nonzero(cc)[0]]] = True

        delegate = dead | confl
        for r in np.nonzero(delegate)[0]:
            out[int(rows[r])] = self._scalar(int(rows[r]))
        surv = np.nonzero(~delegate)[0]
        if not surv.size:
            return

        # per-core cycles, issue-order energy, occupancy highwaters
        core_cyc = np.zeros((n_cores, R), _I8)
        core_dyn = np.zeros((n_cores, R), np.float64)
        mx_all = np.zeros((n_cores, NQ, R), _I8)
        for c in range(n_cores):
            off, Lc = t.core_off[c], t.core_L[c]
            if Lc == 0:
                continue
            tic = ti[off:off + Lc]
            core_cyc[c] = td[off:off + Lc].max(axis=0)
            sidx = t.g_sidx[off:off + Lc]
            perm = np.argsort(tic * t.core_S[c] + sidx[:, None],
                              axis=0, kind="stable")
            # three energy terms per issue, in the scalar's accumulation
            # order: fabric (E_CQ_ACCESS / DMA words), interconnect access,
            # instruction energy.  Zero terms add +0.0 — IEEE-exact for the
            # non-negative accumulator, so cumsum replays the scalar sums.
            mat = np.empty((Lc, 3, R), np.float64)
            mat[:, 0, :] = t.e0[off:off + Lc, None]
            mat[:, 1, :] = np.where(t.e1m[off:off + Lc, None],
                                    eaccR[None, :], 0.0)
            mat[:, 2, :] = t.g_e[off:off + Lc, None]
            matp = np.take_along_axis(mat, perm[:, None, :], axis=0)
            core_dyn[c] = np.cumsum(matp.reshape(Lc * 3, R), axis=0)[-1]
            for qi in range(NQ):
                gids, tie, delta, has_push = t.occ_ev_c[c][qi]
                if not has_push:
                    continue
                key = ti[gids] * t.occ_tie_mod_c[c] + tie[:, None]
                p = np.argsort(key, axis=0, kind="stable")
                d = delta[p]
                cs = np.cumsum(d, axis=0)
                mx_all[c, qi] = np.max(np.where(d > 0, cs, 0), axis=0)
        issue_c = [ti[t.tracked_gid_c[c]] if len(t.tracked_gid_c[c]) else None
                   for c in range(n_cores)]

        for r in surv:
            b = int(rows[r])
            out[b] = self._assemble(b, r, core_cyc, core_dyn, mx_all,
                                    issue_c, stalls)

    # -- result assembly / scalar delegation ---------------------------------

    def _assemble(self, b: int, r: int, core_cyc, core_dyn, mx_all,
                  issue_c, stalls) -> ClusterResult:
        t = self._t
        cfg = self.cfgs[b]
        results: List[SimResult] = []
        for c, prog in enumerate(self.progs):
            cyc = int(core_cyc[c, r])
            sl = stalls[b, c * _NK:(c + 1) * _NK]
            sd = {_KEY_STRINGS[k]: int(sl[k]) for k in range(_NK) if sl[k]}
            viol: List[Tuple[str, str, str, str]] = []
            if issue_c[c] is not None:
                iss = issue_c[c][:, r]
                merged = sorted(
                    range(len(t.tracked_tuples_c[c])),
                    key=lambda tid: (int(iss[tid]),
                                     int(t.tracked_sorder_c[c][tid])))
                for tid in merged:
                    viol.extend(t.tracked_tuples_c[c][tid])
            results.append(SimResult(
                name=prog.name,
                policy=prog.policy,
                cycles=cyc,
                n_samples=prog.n_samples,
                instrs=dict(t.instr_count_c[c]),
                energy=float(core_dyn[c, r]) + E_STATIC_PER_CYCLE * cyc,
                env=t.env_c[c],
                push_seq=t.push_seq_c[c],
                pop_seq=t.pop_seq_c[c],
                max_queue_occupancy={q: int(mx_all[c, qi, r])
                                     for q, qi in QUEUE_INDEX.items()},
                fifo_violations=viol,
                stalls=sd,
            ))
        prog0 = self.progs[0]
        return ClusterResult(
            name=prog0.kernel_name,
            policy=prog0.policy,
            n_cores=cfg.n_cores,
            tcdm_banks=cfg.tcdm_banks,
            cycles=max((res.cycles for res in results), default=0),
            n_samples=sum(res.n_samples for res in results),
            energy=sum(res.energy for res in results),
            core_results=results,
            cq_pushes=t.n_cq_pushes,
            cq_pops=t.n_cq_pops,
            cq_violations=t.n_cq_violations,
        )

    def _scalar(self, b: int) -> ClusterOutcome:
        """Run one point on the scalar cluster engine — used for predicted
        deadlocks, bank conflicts and infeasible geometries.  Always sound:
        a completing scalar result is returned as-is, so mispredictions
        cost speed, never identity."""
        try:
            return ClusterStepper(self.progs, self.cfgs[b]).run()
        except DeadlockError as e:
            prog0 = self.progs[0]
            return BatchClusterDeadlock(
                name=prog0.kernel_name, policy=prog0.policy, message=str(e))


def batch_cluster_simulate(
        progs: Sequence[Program],
        cfgs: Sequence[Optional[ClusterConfig]]) -> List[ClusterOutcome]:
    """One-shot convenience twin of :func:`~.cluster.simulate_cluster`
    for a batch of cluster configs."""
    return BatchClusterStepper(progs, cfgs).run()


def batch_cluster_supported(progs: Sequence[Program],
                            evaluate: bool = True) -> Optional[str]:
    """``None`` if the program set can run on the batch cluster engine,
    else the reason string.  Compiling here primes the cache the stepper
    uses, so a supported-check followed by a run costs one compile."""
    try:
        _compile_cluster(list(progs), evaluate)
        return None
    except BatchClusterUnsupported as e:
        return str(e)
