"""Batched simulation: B machine configs of one program at once.

The DSE sweep (``core.sweep``) spends almost all of its time stepping the
*same lowered program* under many machine configurations — the lowering
memos already collapse the grid to a handful of distinct programs, but each
(depth x latency) point still pays a full Python interpreter loop in
:class:`~.machine.Stepper`.  This module vectorizes that work **across
points**: issue times, stall accumulators and energy counters become
``(B,)`` numpy arrays, per-point config (queue depths, queue latency,
deadlock limit) becomes array parameters, and the whole batch is advanced
with a handful of numpy operations per *instruction* instead of a Python
loop iteration per *cycle*.  Points that deadlock are delegated to the
scalar engine (they are the slow exception, not the common case), never
looped over in the hot path.

Bit-identity contract (the event engine's contract, extended):
:class:`BatchStepper` must match :class:`~.machine.Stepper` *exactly* —
cycles, energy (same float operations in the same order), per-cause stall
breakdown, push/pop sequences, occupancy highwater, FIFO violations, the
functional environment, and deadlock cycle/message — for every point.
``tests/test_batch_machine.py`` fuzzes this differentially and CI gates it.

How the batch engine gets away with one functional pass
-------------------------------------------------------
Timing never feeds back into *values* for the programs the sweep lowers:

* every register is written at most once program-wide (SSA; ``init_env``
  counts as a first write), so a consumer always reads the unique value;
* each queue is pushed by at most one stream and popped by at most one
  stream, so push order and pop order are the streams' program order —
  independent of machine timing — and the k-th pop always observes the
  k-th push.

Under those restrictions the environment, push/pop sequences, FIFO
violations, instruction counts and per-instruction energies are computed
once per program by a greedy dataflow pass (:func:`_compile`), shared by
all B points; only *when* things happen differs per point.  Programs that
violate the restrictions raise :class:`BatchUnsupported` — callers
(``core.sweep``) fall back to the scalar event engine, keeping the batch
path an optimization, never a semantics fork.

Why issue times are a max-recurrence
------------------------------------
The same restrictions make every blocking condition a *statically linked*
timestamp.  In-order issue means instruction ``i`` of a stream is first
attempted the cycle after its predecessor issues; each condition in the
scalar engine's check order then clears at a time that is a pure function
of other instructions' issue/completion times:

* ``busy``        — completion of the nearest prior blocking instruction
  of the same unit in the same stream (issue order = program order);
* ``dep``         — completion of the register's unique producer;
* ``queue_empty`` — the matching push (k-th pop reads k-th push, both
  serials static) becomes visible at producer completion + queue latency;
* ``queue_full``  — room for push serial ``p`` at depth ``d`` appears when
  pop serial ``p - d`` issues (+1 cycle when the popper's unit is checked
  after the pusher's in the same machine cycle).

So ``t[i] = max(t[prev]+1, busy, deps…, visibility…, room…)`` — and with
the dependence edges (including the depth-dependent capacity edges) forming
a DAG, one pass over the instructions in topological order evaluates the
whole batch with ~a dozen numpy ops per instruction.  The capacity edges
only get *looser* as depths grow, so a topological order computed at the
batch's componentwise-minimum depths is valid for every point; capacity
cycles (push that can never make room) and incomplete dataflow are
guaranteed deadlocks and are delegated to the scalar engine, as are points
whose issue-time gaps exceed their deadlock limit (detected post-hoc from
the computed schedule, which is exact up to the deadlock horizon).

Stall attribution reuses the event engine's bulk walk: while ``i`` is
blocked, every clear-time above is a constant, so the per-cycle "first
failing condition" decomposes into interval sums (:func:`_attribute`).
Energy is bit-exact, not just close: per point, the shared per-instruction
energies are permuted into issue order (cycle, then unit order) and summed
left-to-right with ``np.cumsum`` — the same IEEE additions the scalar
engines perform — and the static term is applied once at result time
exactly like ``ReferenceStepper.result``.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .isa import E_STATIC_PER_CYCLE, QUEUE_INDEX, Queue, Unit
from .machine import (STALL_CAUSES, DeadlockError, MachineConfig, Program,
                      SimResult, Stepper)

#: flat stall-counter layout: ``unit_index * len(STALL_CAUSES) + cause_index``
_STALL_KEY_STRINGS: Tuple[str, ...] = tuple(
    f"{u.value}_{c}" for u in Unit for c in STALL_CAUSES)
_STALL_KEY_ID: Dict[str, int] = {k: i for i, k in enumerate(_STALL_KEY_STRINGS)}
_NKEYS = len(_STALL_KEY_STRINGS)

_I8 = np.int64


class BatchUnsupported(ValueError):
    """The program (or config batch) falls outside the restrictions that
    make one shared functional pass sound; run the scalar engine instead."""


@dataclass
class BatchDeadlock:
    """Per-point deadlock outcome, carrying exactly what
    :class:`~.machine.Stepper` raises: the reference-identical message, the
    cycle at the deadlock horizon, and the stall breakdown at raise time."""
    name: str
    policy: Any
    message: str
    cycle: int
    stalls: Dict[str, int] = field(default_factory=dict)

    def error(self) -> DeadlockError:
        return DeadlockError(self.message)


#: one entry of ``BatchStepper.run()``'s output
BatchOutcome = Union[SimResult, BatchDeadlock]


class _ProgramTables:
    """Everything config-independent about one program: the shared
    functional-pass outputs plus the static dependence linkage that turns
    per-point issue times into a max-recurrence (see module docstring).

    Per-instruction records (``self.instrs``, global issue order of the
    streams = INT then FP):

    ``(prev, busyprev, busykey, lat, srcs, pushes)`` where ``srcs`` is a
    tuple of ``(clear_gid, is_queue, key)`` in the scalar engine's semantic
    check order (entries whose clear time is identically 0 — init-env
    registers — are dropped; a zero clear time can never block or own a
    stall) and ``pushes`` is a tuple of ``(queue_index, push_serial, key)``.
    """

    def __init__(self, prog: Program, evaluate: bool):
        if prog.mode == "single":
            assert len(prog.streams) == 1, "single mode expects one merged stream"
            order = list(prog.streams.items())
        else:
            order = [(u, prog.streams[u])
                     for u in (Unit.INT, Unit.FP) if u in prog.streams]
        self.order: List[Tuple[Unit, List[Any]]] = order
        facts = [[ins.exec_facts for ins in lst] for _u, lst in order]
        S = len(order)
        self.S = max(1, S)

        # -- supported-program restrictions (see module docstring) ----------
        written: Dict[str, int] = {k: 1 for k in prog.init_env}
        pushers: Dict[int, set] = {}
        poppers: Dict[int, set] = {}
        for s, ((u, _lst), fs) in enumerate(zip(order, facts)):
            for f in fs:
                if f[2] < 1:
                    raise BatchUnsupported(
                        f"{prog.name}: zero-latency instruction "
                        f"(completion-time identities need latency >= 1)")
                if prog.mode != "single" and f[0] is not u:
                    raise BatchUnsupported(
                        f"{prog.name}: {f[0].value} instruction scheduled on "
                        f"the {u.value} stream (cross-stream busy coupling "
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
            raise BatchUnsupported(
                f"{prog.name}: registers written more than once "
                f"(timing could select the value): {sorted(multi)[:4]}")
        shared = [qi for m in (pushers, poppers)
                  for qi, ss in m.items() if len(ss) > 1]
        if shared:
            raise BatchUnsupported(
                f"{prog.name}: queue pushed/popped by more than one stream "
                f"(FIFO order would depend on timing)")

        # -- shared functional pass (greedy dataflow execution) -------------
        # Executes every instruction whose register sources are produced and
        # whose queue pops have matching pushes, ignoring capacity and
        # latency: with the restrictions above, any machine-feasible issue
        # order yields these exact values/sequences.  A greedy fixpoint over
        # in-order streams reaches the maximal executable prefix of each
        # stream; if that leaves instructions stranded, the dataflow itself
        # is circular and *every* machine config deadlocks before needing
        # the missing values.
        env: Dict[str, Any] = dict(prog.init_env)
        produced = set(prog.init_env)
        push_log: Dict[Queue, List[str]] = {q: [] for q in Queue}
        pop_log: Dict[Queue, List[str]] = {q: [] for q in Queue}
        push_vals: List[List[Any]] = [[] for _ in Queue]
        popped = [0 for _ in Queue]
        violations: Dict[int, List[Tuple[str, str, str, str]]] = {}
        pcs = [0] * len(order)
        progress = True
        while progress:
            progress = False
            for s, fs in enumerate(facts):
                while pcs[s] < len(fs):
                    f = fs[pcs[s]]
                    ops = f[12]
                    ok = True
                    for is_q, src, k, _key, _qv, qi in ops:
                        if is_q:
                            if len(push_vals[qi]) < popped[qi] + k + 1:
                                ok = False
                                break
                        elif src not in produced:
                            ok = False
                            break
                    if not ok:
                        break
                    opvals = []
                    expects = f[9]
                    n_pop = 0
                    for is_q, src, k, _key, qv, qi in ops:
                        if is_q:
                            vname, val = push_vals[qi][popped[qi]]
                            popped[qi] += 1
                            pop_log[list(Queue)[qi]].append(vname)
                            if expects and expects[n_pop] != vname:
                                gid = self._gid(s, pcs[s], facts)
                                violations.setdefault(gid, []).append(
                                    (f[10], qv, expects[n_pop], vname))
                            n_pop += 1
                            opvals.append(val)
                        else:
                            opvals.append(env.get(src))
                    result = None
                    if evaluate and f[8] is not None:
                        result = f[8](*opvals)
                    if f[7] is not None:
                        env[f[7]] = result
                        produced.add(f[7])
                    for _q, _k, _key, qi in f[13]:
                        push_vals[qi].append((f[11], result))
                        push_log[list(Queue)[qi]].append(f[11])
                    pcs[s] += 1
                    progress = True
        self.value_complete = all(pcs[s] == len(fs)
                                  for s, fs in enumerate(facts))
        self.env = env
        self.push_seq = push_log
        self.pop_seq = pop_log
        self.instr_count = {"int": 0, "fp": 0}
        for _u, lst in order:
            for ins in lst:
                self.instr_count[ins.unit.value] += 1

        # -- FIFO-violation interleaving bookkeeping ------------------------
        # Violating instructions are "tracked": the engine records their
        # per-point issue cycles and the result builder re-merges the global
        # violation list by (issue cycle, stream order) — the exact append
        # order of the scalar engines.
        tracked_gids = sorted(violations)
        self.n_tracked = len(tracked_gids)
        self.tracked_gid = np.array(tracked_gids, dtype=_I8)
        self.tracked_sorder = np.array(
            [self._stream_of(gid, facts) for gid in tracked_gids],
            dtype=_I8)
        self.tracked_tuples: List[List[Tuple[str, str, str, str]]] = [
            violations[gid] for gid in tracked_gids]

        # -- static dependence linkage --------------------------------------
        offsets: List[int] = []
        off = 0
        for fs in facts:
            offsets.append(off)
            off += len(fs)
        L = off
        self.L = L
        NQ = len(Queue)
        self.g_e = np.zeros(L, np.float64)
        self.g_sidx = np.zeros(L, _I8)
        producer: Dict[str, int] = {}
        pushg: List[List[int]] = [[] for _ in range(NQ)]  # push serial -> gid
        popg: List[List[int]] = [[] for _ in range(NQ)]   # pop serial -> gid
        pop_ev: List[List[Tuple[int, int, int]]] = [[] for _ in range(NQ)]
        push_ev: List[List[Tuple[int, int, int]]] = [[] for _ in range(NQ)]
        km = 1
        raw: List[Tuple] = []  # (prev, busyprev, busykey, lat, raw_srcs, raw_pushes)
        for s, fs in enumerate(facts):
            last_blocking: Dict[int, int] = {}
            for i, f in enumerate(fs):
                gid = offsets[s] + i
                (unit, _uval, latency, blocking, e_plain, e_frep, busy_key,
                 dst, _fn, _expects, _label, _pushv, ops, pushes, uidx) = f
                self.g_sidx[gid] = s
                self.g_e[gid] = (e_frep if (prog.frep and unit is Unit.FP)
                                 else e_plain)
                prev = gid - 1 if i > 0 else -1
                busyprev = last_blocking.get(uidx, -1)
                if blocking:
                    last_blocking[uidx] = gid
                if dst is not None:
                    producer[dst] = gid
                km = max(km, len(ops) + 1, len(pushes) + 1)
                # visibility serials use the pre-instruction pop counts
                raw_srcs = []
                pre = [len(popg[qi]) for qi in range(NQ)]
                for is_q, src, k, key, _qv, qi in ops:
                    if is_q:
                        raw_srcs.append((True, qi, pre[qi] + k,
                                         _STALL_KEY_ID[key]))
                    else:
                        raw_srcs.append((False, src, -1, _STALL_KEY_ID[key]))
                for j, (is_q, _src, _k, _key, _qv, qi) in enumerate(ops):
                    if is_q:
                        popg[qi].append(gid)
                        pop_ev[qi].append((gid, s * 2 + 0, j))
                raw_pushes = []
                # room serials use the scalar check's k (relative to the
                # pre-instruction occupancy), FIFO serials the append order
                pre_push = [len(pushg[qi]) for qi in range(NQ)]
                for j, (_q, k, key, qi) in enumerate(pushes):
                    raw_pushes.append((qi, pre_push[qi] + k,
                                       _STALL_KEY_ID[key]))
                    pushg[qi].append(gid)
                    push_ev[qi].append((gid, s * 2 + 1, j))
                raw.append((prev, busyprev, _STALL_KEY_ID[busy_key],
                            int(latency), tuple(raw_srcs), tuple(raw_pushes)))

        init = set(prog.init_env)
        instrs: List[Tuple] = []
        preds: List[List[int]] = []
        cap_slots: List[Tuple[int, int, int]] = []
        for gid, (prev, busyprev, busykey, lat, raw_srcs, raw_pushes) \
                in enumerate(raw):
            srcs = []
            p: List[int] = [prev] if prev >= 0 else []
            for is_q, a, serial, key in raw_srcs:
                if is_q:
                    pg = pushg[a]
                    g = pg[serial] if serial < len(pg) else -1
                else:
                    g = -1 if a in init else producer.get(a, -1)
                if g >= 0:
                    srcs.append((g, is_q, key))
                    p.append(g)
            for qi, ps, _key in raw_pushes:
                cap_slots.append((gid, qi, ps))
            instrs.append((prev, busyprev, busykey, lat,
                           tuple(srcs), raw_pushes))
            preds.append(p)
        self.instrs = instrs
        self._preds = preds
        self._cap_slots = cap_slots
        self._topo_cache: Dict[Tuple[int, ...], Optional[List[int]]] = {}

        self.popg = [np.array(g, dtype=_I8) for g in popg]
        self.npop = [len(g) for g in popg]
        #: depth below which some push needs a pop that never happens —
        #: guaranteed deadlock, delegated to the scalar engine
        req = [0] * NQ
        for _gid, qi, serial in cap_slots:
            req[qi] = max(req[qi], serial - len(popg[qi]) + 1)
        self.min_depth_req = np.array(req, dtype=_I8)
        self.adj = []
        for qi in range(NQ):
            pu = next(iter(pushers.get(qi, {0})))
            po = next(iter(poppers.get(qi, {0})))
            self.adj.append(0 if po < pu else 1)
        #: occupancy events per queue: gid / static tiebreak / +-1 delta.
        #: Within a machine cycle the scalar engine applies units in stream
        #: order and, within an instruction, pops before pushes — encoded in
        #: the tiebreak so a per-point argsort replays the exact interleave.
        self.occ_tie_mod = self.S * 2 * km
        self.occ_ev = []
        for qi in range(NQ):
            evs = pop_ev[qi] + push_ev[qi]
            gids = np.array([g for g, _ph, _j in evs], dtype=_I8)
            tie = np.array([ph * km + j for _g, ph, j in evs], dtype=_I8)
            delta = np.array([-1] * len(pop_ev[qi]) + [1] * len(push_ev[qi]),
                             dtype=_I8)
            self.occ_ev.append((gids, tie, delta, len(push_ev[qi]) > 0))

    def topo(self, dvec: Tuple[int, ...]) -> Optional[List[int]]:
        """Topological order of the dependence DAG at queue depths ``dvec``
        (``None`` if the capacity edges create a cycle — a guaranteed
        deadlock for every point at those depths).  Cached per program; a
        capacity edge at depth ``d`` is implied by the edge at any tighter
        depth plus stream order, so the order for the componentwise-minimum
        depths of a batch is valid for the entire batch."""
        cached = self._topo_cache.get(dvec, False)
        if cached is not False:
            return cached
        L = self.L
        indeg = [0] * L
        succ: List[List[int]] = [[] for _ in range(L)]
        for i, ps in enumerate(self._preds):
            for p in ps:
                succ[p].append(i)
                indeg[i] += 1
        for gid, qi, serial in self._cap_slots:
            j = serial - dvec[qi]
            if j >= 0:
                # feasibility (min_depth_req) guarantees j < npop here
                p = int(self.popg[qi][j])
                succ[p].append(gid)
                indeg[gid] += 1
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

    @staticmethod
    def _gid(s: int, i: int, facts: List[List[Tuple]]) -> int:
        return sum(len(facts[t]) for t in range(s)) + i

    @staticmethod
    def _stream_of(gid: int, facts: List[List[Tuple]]) -> int:
        for s, fs in enumerate(facts):
            if gid < len(fs):
                return s
            gid -= len(fs)
        raise AssertionError("tracked instruction out of range")


def _compile(prog: Program, evaluate: bool) -> _ProgramTables:
    """Build (or fetch) the program's batch tables.  Cached on the Program
    object — mirroring ``Stepper``'s ``_event_engine_cache`` — so memoized
    programs re-simulated across config batches compile once per
    ``(mode, evaluate)``."""
    key = (prog.mode, bool(evaluate))
    cached = getattr(prog, "_batch_engine_cache", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    tables = _ProgramTables(prog, evaluate)
    prog._batch_engine_cache = (key, tables)
    return tables


class BatchStepper:
    """Advance B machine configurations of one program at once.

    ``run()`` returns one outcome per config, in input order: a
    :class:`~.machine.SimResult` bit-identical to what
    ``Stepper(prog, cfg).run()`` would produce, or a :class:`BatchDeadlock`
    carrying the identical :class:`DeadlockError` message/cycle/stalls
    (deadlocking points are delegated to the scalar engine — exactness by
    construction; completing points never are).

    Shared, config-independent pieces (``env``, push/pop sequences) are
    *shared objects* across the returned results — treat them as read-only,
    exactly like the memoized Programs the sweep already shares.

    Raises :class:`BatchUnsupported` (at construction) for programs outside
    the one-writer/one-pusher/one-popper restrictions or for mixed
    ``evaluate`` flags across the batch.
    """

    def __init__(self, prog: Program, cfgs: Sequence[MachineConfig]):
        self.prog = prog
        self.cfgs = [c if c is not None else MachineConfig() for c in cfgs]
        evals = {bool(c.evaluate) for c in self.cfgs}
        if len(evals) > 1:
            raise BatchUnsupported(
                "mixed cfg.evaluate across a batch (env would differ)")
        self._evaluate = evals.pop() if evals else True
        self._t = _compile(prog, self._evaluate)

    def run(self) -> List[BatchOutcome]:
        t = self._t
        B = len(self.cfgs)
        if B == 0:
            return []
        qlist = list(Queue)
        depths = np.array([[c.depth_of(q) for q in qlist]
                           for c in self.cfgs], _I8)

        out: List[Optional[BatchOutcome]] = [None] * B
        if t.L == 0:
            zero = np.zeros(_NKEYS, _I8)
            for b in range(B):
                out[b] = self._result(0, 0.0, zero, [0] * len(qlist), None)
            return out  # type: ignore[return-value]
        if not t.value_complete:
            # circular dataflow: every config deadlocks before the missing
            # values are needed — the scalar engine is exact and cheap here.
            return [self._scalar(b) for b in range(B)]

        feasible = ~(depths < t.min_depth_req[None, :]).any(axis=1)
        for b in np.nonzero(~feasible)[0]:
            out[int(b)] = self._scalar(int(b))
        rows = np.nonzero(feasible)[0].astype(_I8)
        groups: List[Tuple[np.ndarray, List[int]]] = []
        if rows.size:
            dmin = tuple(int(x) for x in depths[rows].min(axis=0))
            order = t.topo(dmin)
            if order is not None:
                groups.append((rows, order))
            else:
                # the batch's min-depth envelope is capacity-cyclic but
                # individual depth classes may not be: split per class.
                classes: Dict[Tuple[int, ...], List[int]] = {}
                for b in rows:
                    classes.setdefault(
                        tuple(int(x) for x in depths[b]), []).append(int(b))
                for dvec, bs in classes.items():
                    o = t.topo(dvec)
                    if o is None:
                        for b in bs:
                            out[b] = self._scalar(b)
                    else:
                        groups.append((np.array(bs, _I8), o))

        stalls = np.zeros((B, _NKEYS), _I8)
        for rows_g, order in groups:
            self._run_group(rows_g, order, depths, stalls, out)
        return out  # type: ignore[return-value]

    # -- the max-recurrence over one topologically-ordered group -------------

    def _run_group(self, rows: np.ndarray, order: List[int],
                   depths: np.ndarray, stalls: np.ndarray,
                   out: List[Optional[BatchOutcome]]) -> None:
        t = self._t
        L = t.L
        R = rows.size
        cfgs = self.cfgs
        dR = depths[rows]
        qR = np.array([cfgs[int(b)].queue_latency for b in rows], _I8)
        limR = np.array([cfgs[int(b)].deadlock_limit for b in rows], _I8)
        ar = np.arange(R)
        zeros = np.zeros(R, _I8)
        ti = np.zeros((L, R), _I8)
        td = np.zeros((L, R), _I8)
        instrs = t.instrs
        popg = t.popg
        npop = t.npop
        adj = t.adj
        for i in order:
            prev, busyprev, busykey, lat, srcs, pushes = instrs[i]
            base = ti[prev] + 1 if prev >= 0 else zeros
            acc = base
            clears: List[Tuple[np.ndarray, int]] = []
            if busyprev >= 0:
                c = td[busyprev]
                clears.append((c, busykey))
                acc = np.maximum(acc, c)
            for g, is_q, key in srcs:
                c = td[g] + qR if is_q else td[g]
                clears.append((c, key))
                acc = np.maximum(acc, c)
            for qi, ps, key in pushes:
                jv = ps - dR[:, qi]
                if npop[qi] == 0:
                    # feasibility guarantees jv < 0 for every surviving
                    # point: depth >= total pushes, so room always exists
                    continue
                jc = np.clip(jv, 0, npop[qi] - 1)
                c = ti[popg[qi][jc], ar] + adj[qi]
                c = np.where(jv < 0, 0, c)
                clears.append((c, key))
                acc = np.maximum(acc, c)
            ti[i] = acc
            td[i] = acc + lat
            if clears and acc is not base:
                m = acc > base
                if m.any():
                    sub = np.nonzero(m)[0]
                    ct = np.stack([c[sub] for c, _k in clears], axis=1)
                    keys = np.broadcast_to(
                        np.array([k for _c, k in clears], _I8),
                        (sub.size, len(clears)))
                    _attribute(stalls, rows[sub], ct, keys,
                               base[sub], acc[sub] - 1)

        # deadlock-limit detection: the schedule above is the no-horizon
        # machine's exact schedule, so the reference deadlocks iff the wait
        # for the first/next issue exceeds limit+1 cycles.
        lim1 = limR + 1
        ts = np.sort(ti, axis=0)
        dead = ts[0] > lim1
        if L > 1:
            dead |= (np.diff(ts, axis=0) > lim1[None, :]).any(axis=0)

        cycles = td.max(axis=0)
        # energy in exact issue order: cumsum is sequential left-to-right
        # addition (unlike np.sum's pairwise reduction), matching the scalar
        # engines' accumulate-at-issue float ops bit for bit.
        perm = np.argsort(ti * t.S + t.g_sidx[:, None], axis=0, kind="stable")
        energy = np.cumsum(t.g_e[perm], axis=0)[-1]
        NQ = len(t.occ_ev)
        mx = np.zeros((NQ, R), _I8)
        for qi in range(NQ):
            gids, tie, delta, has_push = t.occ_ev[qi]
            if not has_push:
                continue
            key = ti[gids] * t.occ_tie_mod + tie[:, None]
            p = np.argsort(key, axis=0, kind="stable")
            d = delta[p]
            cs = np.cumsum(d, axis=0)
            mx[qi] = np.max(np.where(d > 0, cs, 0), axis=0)
        issue = ti[t.tracked_gid] if t.n_tracked else None

        for r in range(R):
            b = int(rows[r])
            if dead[r]:
                out[b] = self._scalar(b)
                continue
            out[b] = self._result(
                int(cycles[r]), float(energy[r]), stalls[b], mx[:, r],
                issue[:, r] if issue is not None else None)

    # -- result assembly / scalar delegation ---------------------------------

    def _result(self, cycles: int, dyn_energy: float, stall_row, mx_row,
                issue_row) -> SimResult:
        t = self._t
        prog = self.prog
        sd = {_STALL_KEY_STRINGS[k]: int(stall_row[k])
              for k in range(_NKEYS) if stall_row[k]}
        viol: List[Tuple[str, str, str, str]] = []
        if t.n_tracked and issue_row is not None:
            merged = sorted(
                range(t.n_tracked),
                key=lambda tid: (int(issue_row[tid]),
                                 int(t.tracked_sorder[tid])))
            for tid in merged:
                viol.extend(t.tracked_tuples[tid])
        return SimResult(
            name=prog.name,
            policy=prog.policy,
            cycles=cycles,
            n_samples=prog.n_samples,
            instrs=dict(t.instr_count),
            energy=dyn_energy + E_STATIC_PER_CYCLE * cycles,
            env=t.env,
            push_seq=t.push_seq,
            pop_seq=t.pop_seq,
            max_queue_occupancy={q: int(mx_row[qi])
                                 for q, qi in QUEUE_INDEX.items()},
            fifo_violations=viol,
            stalls=sd,
        )

    def _scalar(self, b: int) -> BatchOutcome:
        """Run one point on the scalar event engine — used for points the
        recurrence predicts (or cannot rule out) to deadlock.  Delegation is
        always sound: if the prediction were ever wrong, the scalar result
        is returned as-is, so mispredictions cost speed, never identity."""
        st = Stepper(self.prog, self.cfgs[b])
        try:
            return st.run()
        except DeadlockError as e:
            return BatchDeadlock(
                name=self.prog.name, policy=self.prog.policy,
                message=str(e), cycle=int(st.cycle), stalls=dict(st.stalls))


def _attribute(stalls: np.ndarray, rows: np.ndarray, ct: np.ndarray,
               keys: np.ndarray, a: np.ndarray, b: np.ndarray) -> None:
    """Vectorized twin of ``Stepper._attribute_stalls`` over many points.

    For each row, walk the clear-time columns in check order: while the
    cursor ``c`` is within ``[a, b]``, the first column with clear-time
    ``t > c`` owns the stall cycles ``[c, min(b, t-1)]``.  Columns whose
    clear-time is already past (including absent conditions encoded as 0)
    are skipped, exactly like the scalar walk.
    """
    c = a.astype(np.int64, copy=True)
    for j in range(ct.shape[1]):
        tj = ct[:, j]
        m = (tj > c) & (c <= b)
        if not m.any():
            continue
        end = np.minimum(b, tj - 1)
        amt = np.where(m, end - c + 1, 0)
        np.add.at(stalls, (rows, keys[:, j]), amt)
        c = np.where(m, np.minimum(tj, b + 1), c)


def batch_simulate(prog: Program,
                   cfgs: Sequence[MachineConfig]) -> List[BatchOutcome]:
    """One-shot convenience twin of :func:`~.machine.simulate` for a batch."""
    return BatchStepper(prog, cfgs).run()


def batch_supported(prog: Program,
                    evaluate: bool = True) -> Optional[str]:
    """``None`` if ``prog`` can run on the batch engine, else the reason."""
    try:
        _compile(prog, evaluate)
        return None
    except BatchUnsupported as e:
        return str(e)
