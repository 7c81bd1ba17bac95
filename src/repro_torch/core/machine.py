"""Cycle-approximate model of Snitch + FPSS + COPIFTv2 queues.

Two in-order issue units (the integer core and the FPSS), each issuing at
most one instruction per cycle.  In ``single`` mode (the Snitch baseline) a
single shared issue port models the integer core fetching *all* instructions
and offloading FP ones to the FPSS; in ``dual`` mode (COPIFT / COPIFTv2) the
FPSS replays its FREP loop buffer independently, so both units issue
concurrently — IPC is bounded by 2.

Queues have finite depth with blocking push/pop semantics: a pop stalls the
consuming unit until the head entry is visible; a push stalls the producer
while the queue is full.  Stalls, overlap and IPC *emerge* from the model;
nothing is hard-coded per policy.  Every cycle a unit fails to issue is
attributed to one cause (``busy`` / ``dep`` / ``queue_empty`` /
``queue_full``), giving the stall breakdown the DSE sweep reports.

The simulator doubles as a functional interpreter: when instructions carry
``fn``, values flow through registers, queues and memory channels, letting
tests assert that every transform preserves the kernel's semantics.

The whole simulation state lives in a stepper class — re-entrant, cheap to
instantiate, and independent of any module-level state — so design-space
sweeps (``core.sweep``) can run many simulations concurrently in process-pool
workers.  :func:`simulate` remains the one-shot convenience entry point.

Two engines share that state and are required to agree bit-for-bit:

* :class:`ReferenceStepper` — the naive cycle stepper: one Python iteration
  per simulated cycle, attributing each unit's stall cause cycle by cycle.
  Trusted because it is obvious; O(cycles) host work.
* :class:`Stepper` — the event-driven time-skip engine (the default).  A
  cycle in which at least one unit issues runs exactly like the reference.
  When *every* runnable unit is blocked, nothing in the machine state can
  change until a pending timestamp expires, so the stepper computes each
  blocked unit's clear-times — ``unit_busy`` expiry, register ``ready``
  times, queue-head visibility timestamps (push completion + queue latency)
  — takes the earliest cycle any unit can issue, attributes the skipped
  cycles to the same per-unit stall causes in bulk (the blocking cause of a
  waiting unit changes at known breakpoints: the check order of
  ``_block_reason`` is monotone in time while state is frozen), and jumps
  ``self.cycle`` straight there.  ``queue_full`` (and a missing queue entry
  or an unproduced register value) never clears by time alone; if no unit
  has a finite issue time the machine is deadlocked and the engine fails at
  the exact cycle the reference would.  Host work is O(instructions), not
  O(cycles): deep stalls (high queue latency, long FP latencies, depth-1
  back-pressure) cost one jump instead of thousands of idle iterations.

The invariant, enforced by differential tests (tests/test_machine_event.py)
and by every swept point in ``core.sweep``: cycles, energy, stall breakdown,
push/pop sequences, occupancy highwater and the functional environment are
identical between the two engines on every program.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .isa import (E_STATIC_PER_CYCLE, QUEUE_INDEX, UNIT_INDEX, Instr, Queue,
                  Unit)
from .policy import ExecutionPolicy


@dataclass
class MachineConfig:
    queue_depth: int = 4
    queue_latency: int = 1          # cycles from producer completion to visibility
    evaluate: bool = True           # run the functional interpreter too
    deadlock_limit: int = 20_000    # cycles without progress => deadlock
    #: optional per-queue depth overrides (asymmetric I2F vs F2I FIFOs);
    #: queues absent from the map fall back to ``queue_depth``
    queue_depths: Optional[Dict[Queue, int]] = None

    def depth_of(self, q: Queue) -> int:
        if self.queue_depths is not None:
            return self.queue_depths.get(q, self.queue_depth)
        return self.queue_depth


@dataclass
class Program:
    name: str
    policy: ExecutionPolicy
    mode: str                        # "single" | "dual"
    streams: Dict[Unit, List[Instr]]
    n_samples: int
    init_env: Dict[str, Any] = field(default_factory=dict)
    output_values: List[str] = field(default_factory=list)  # SSA ids
    frep: bool = False               # FP stream replayed from the loop buffer
    #: kernel name before any per-core decoration (``transform`` partitioning
    #: names per-core programs ``f"{base}@core{c}/{n}"``); ``None`` means the
    #: program was never partitioned and ``name`` *is* the base name.  Kept
    #: explicit so cluster results never have to parse user-given names.
    base_name: Optional[str] = None

    def total_instrs(self) -> int:
        return sum(len(v) for v in self.streams.values())

    @property
    def kernel_name(self) -> str:
        """The undecorated kernel name this program was lowered from."""
        return self.base_name if self.base_name is not None else self.name


@dataclass
class SimResult:
    """Simulation outcome.  Everything here is plain data (strings, numbers,
    enums, containers thereof) so a result pickles cleanly across process
    boundaries; ``summary()`` flattens it further into primitives for CSV /
    JSON emission when the (possibly large) ``env`` is not wanted."""
    name: str
    policy: ExecutionPolicy
    cycles: int
    n_samples: int
    instrs: Dict[str, int]
    energy: float
    env: Dict[str, Any]
    push_seq: Dict[Queue, List[str]]
    pop_seq: Dict[Queue, List[str]]
    max_queue_occupancy: Dict[Queue, int]
    fifo_violations: List[Tuple[str, str, str, str]] = field(default_factory=list)
    stalls: Dict[str, int] = field(default_factory=dict)

    @property
    def total_instrs(self) -> int:
        return sum(self.instrs.values())

    # Degenerate programs (empty streams => cycles == 0, energy == 0) must
    # come back as zero-rate records, not ZeroDivisionErrors killing a pool
    # worker mid-sweep.

    @property
    def ipc(self) -> float:
        return self.total_instrs / self.cycles if self.cycles else 0.0

    @property
    def throughput(self) -> float:          # samples / cycle
        return self.n_samples / self.cycles if self.cycles else 0.0

    @property
    def power(self) -> float:               # energy / cycle (relative units)
        return self.energy / self.cycles if self.cycles else 0.0

    @property
    def efficiency(self) -> float:          # samples / energy
        return self.n_samples / self.energy if self.energy else 0.0

    def outputs(self, output_values: List[str]) -> Dict[str, Any]:
        return {v: self.env.get(v) for v in output_values}

    def summary(self) -> Dict[str, Any]:
        """Primitive-typed record (no env, no enum keys) for aggregation."""
        return {
            "name": self.name,
            "policy": self.policy.value,
            "cycles": self.cycles,
            "n_samples": self.n_samples,
            "instrs_int": self.instrs.get("int", 0),
            "instrs_fp": self.instrs.get("fp", 0),
            "ipc": self.ipc,
            "energy": self.energy,
            "power": self.power,
            "throughput": self.throughput,
            "efficiency": self.efficiency,
            "max_occ_i2f": self.max_queue_occupancy.get(Queue.I2F, 0),
            "max_occ_f2i": self.max_queue_occupancy.get(Queue.F2I, 0),
            "fifo_violations": len(self.fifo_violations),
            "stalls": dict(self.stalls),
        }


class DeadlockError(RuntimeError):
    pass


#: stall-cause keys recorded by the stepper (per unit: ``f"{unit}_{cause}"``)
STALL_CAUSES = ("busy", "dep", "queue_empty", "queue_full")


class ReferenceStepper:
    """Re-entrant naive cycle stepper for one :class:`Program`.

    All simulation state is instance state; ``step()`` advances exactly one
    cycle and ``run()`` drives the program to completion.  Construction is
    cheap (a few dicts over the program's streams), which is what lets
    ``core.sweep`` spin one up per configuration inside process-pool workers.

    This is the trusted O(cycles) engine: every simulated cycle costs one
    Python iteration, including cycles where both units idle.  The default
    :class:`Stepper` subclass skips those dead stretches; this class is kept
    verbatim as the differential-testing oracle.
    """

    def __init__(self, prog: Program, cfg: Optional[MachineConfig] = None):
        self.prog = prog
        self.cfg = cfg or MachineConfig()
        self.ready: Dict[str, int] = {k: 0 for k in prog.init_env}
        self.env: Dict[str, Any] = dict(prog.init_env)

        self.queues: Dict[Queue, deque] = {q: deque() for q in Queue}
        self.depths: Dict[Queue, int] = {q: self.cfg.depth_of(q)
                                         for q in Queue}
        self.occupancy: Dict[Queue, int] = {q: 0 for q in Queue}  # incl. in-flight
        self.max_occ: Dict[Queue, int] = {q: 0 for q in Queue}
        self.push_seq: Dict[Queue, List[str]] = {q: [] for q in Queue}
        self.pop_seq: Dict[Queue, List[str]] = {q: [] for q in Queue}
        self.fifo_violations: List[Tuple[str, str, str, str]] = []

        if prog.mode == "single":
            # the lowering merges everything into one stream (the integer core
            # fetches all instructions, offloading FP ones to the FPSS)
            assert len(prog.streams) == 1, "single mode expects one merged stream"
            self.order: List[Tuple[Unit, List[Instr]]] = list(prog.streams.items())
        else:
            # INT first: gives the integer core priority on shared resources.
            self.order = [(u, prog.streams[u])
                          for u in (Unit.INT, Unit.FP) if u in prog.streams]

        self.pcs = {u: 0 for u, _ in self.order}
        self.unit_busy = {Unit.INT: 0, Unit.FP: 0}
        self.instr_count = {"int": 0, "fp": 0}
        self.energy = 0.0
        self.cycle = 0
        self.last_progress = 0
        self.finish = 0
        self.stalls: Dict[str, int] = {}

    # -- issue logic --------------------------------------------------------

    def _block_reason(self, ins: Instr, now: int) -> Optional[str]:
        """None if ``ins`` can issue at ``now``; else the first stall cause."""
        if self.unit_busy[ins.unit] > now:
            return "busy"
        need: Dict[Queue, int] = {}
        for src in ins.srcs:
            if isinstance(src, Queue):
                k = need.get(src, 0)
                q = self.queues[src]
                if len(q) <= k or q[k][0] > now:
                    return "queue_empty"
                need[src] = k + 1
            else:
                t = self.ready.get(src)
                if t is None or t > now:
                    return "dep"
        room: Dict[Queue, int] = {}
        for q in ins.pushes:
            room[q] = room.get(q, 0) + 1
            if self.occupancy[q] + room[q] > self.depths[q]:
                return "queue_full"
        return None

    def _do_issue(self, ins: Instr, now: int) -> int:
        cfg = self.cfg
        t_done = now + ins.spec.latency
        opvals = []
        n_pop = 0
        for src in ins.srcs:
            if isinstance(src, Queue):
                _, vname, val = self.queues[src].popleft()
                self.occupancy[src] -= 1
                self.pop_seq[src].append(vname)
                if ins.expects and ins.expects[n_pop] != vname:
                    self.fifo_violations.append(
                        (ins.label, src.value, ins.expects[n_pop], vname))
                n_pop += 1
                opvals.append(val)
            else:
                opvals.append(self.env.get(src))
        result = None
        if cfg.evaluate and ins.fn is not None:
            result = ins.fn(*opvals)
        if ins.dst is not None:
            self.ready[ins.dst] = t_done
            self.env[ins.dst] = result
        for q in ins.pushes:
            self.queues[q].append(
                (t_done + cfg.queue_latency, ins.push_val or ins.label, result))
            self.occupancy[q] += 1
            self.max_occ[q] = max(self.max_occ[q], self.occupancy[q])
            self.push_seq[q].append(ins.push_val or ins.label)
        if ins.spec.blocking:
            self.unit_busy[ins.unit] = t_done
        self.energy += ins.energy(frep=self.prog.frep and ins.unit is Unit.FP)
        self.instr_count[ins.unit.value] += 1
        return t_done

    # -- stepping -----------------------------------------------------------

    @property
    def done(self) -> bool:
        return all(self.pcs[u] >= len(lst) for u, lst in self.order)

    def step(self) -> bool:
        """Advance one cycle; returns False once the program has retired."""
        if self.done:
            return False
        issued = False
        for u, lst in self.order:
            pc = self.pcs[u]
            if pc >= len(lst):
                continue
            ins = lst[pc]
            reason = self._block_reason(ins, self.cycle)
            if reason is None:
                t_done = self._do_issue(ins, self.cycle)
                self.finish = max(self.finish, t_done)
                self.pcs[u] = pc + 1
                issued = True
            else:
                key = f"{ins.unit.value}_{reason}"
                self.stalls[key] = self.stalls.get(key, 0) + 1
        if issued:
            self.last_progress = self.cycle
        if self.cycle - self.last_progress > self.cfg.deadlock_limit:
            raise self._deadlock()
        self.cycle += 1
        return True

    def _deadlock(self) -> DeadlockError:
        stuck = {u.value: (self.pcs[u], len(lst),
                           str(lst[self.pcs[u]]) if self.pcs[u] < len(lst) else "-")
                 for u, lst in self.order}
        return DeadlockError(
            f"{self.prog.name}/{self.prog.policy.value}: no progress; {stuck}")

    def run(self) -> SimResult:
        while self.step():
            pass
        return self.result()

    def result(self) -> SimResult:
        cycles = max(self.finish, self.cycle)
        return SimResult(
            name=self.prog.name,
            policy=self.prog.policy,
            cycles=cycles,
            n_samples=self.prog.n_samples,
            instrs=dict(self.instr_count),
            energy=self.energy + E_STATIC_PER_CYCLE * cycles,
            env=self.env,
            push_seq=self.push_seq,
            pop_seq=self.pop_seq,
            max_queue_occupancy=self.max_occ,
            fifo_violations=self.fifo_violations,
            stalls=dict(self.stalls),
        )


#: a clear-time meaning "never clears by the passage of time alone"
_NEVER = float("inf")


class Stepper(ReferenceStepper):
    """Event-driven time-skip stepper — the default simulation engine.

    Identical to :class:`ReferenceStepper` on every cycle in which some unit
    issues.  On a fully-blocked cycle it computes, per blocked unit, the
    ordered clear-times of its issue conditions (operand order per
    ``Instr.issue_plan``, with the unit-busy check prepended), jumps
    ``self.cycle`` to the earliest cycle any unit becomes issuable, and
    attributes every skipped cycle to the stall cause the reference would
    have recorded: while no instruction issues the machine state is frozen,
    so a unit's blocking cause is a pure function of time — the first
    condition (in check order) whose clear-time is still in the future — and
    changes only at those clear-times.

    If no blocked unit has a finite issue time, no timestamp expiry can ever
    unblock the machine: the engine attributes stalls up to the reference's
    deadlock horizon (``last_progress + deadlock_limit + 1``) and raises the
    same :class:`DeadlockError` at the same cycle.
    """

    def __init__(self, prog: Program, cfg: Optional[MachineConfig] = None):
        super().__init__(prog, cfg)
        self._eval = self.cfg.evaluate
        self._frep = prog.frep
        cached = getattr(prog, "_event_engine_cache", None)
        if cached is None or cached[0] != prog.mode:
            cached = (prog.mode, self._build_program_facts())
            prog._event_engine_cache = cached
        facts_order, skip_ok = cached[1]
        # Hot state is list-indexed (enum-keyed dict lookups hash the member
        # on every access); the canonical ReferenceStepper dicts are synced
        # back at every exit point (_sync_canonical).  Queue deques and the
        # push/pop logs are shared objects, so only scalars need syncing.
        # Unit row layout: [unit, facts, skip_ok, pc, next_try].  next_try
        # starts at -1 (never a valid cycle) so ``next_try == cycle`` holds
        # only at a skip-granted exact wake.
        self._rows = [[u, facts, skip_ok[u], 0, -1]
                      for u, facts in facts_order]
        self._busy = [0] * len(Unit)             # by UNIT_INDEX
        self._qs = [self.queues[q] for q in Queue]        # by QUEUE_INDEX
        self._poplog = [self.pop_seq[q] for q in Queue]
        self._pushlog = [self.push_seq[q] for q in Queue]
        self._depths = [self.depths[q] for q in Queue]
        self._occ = [0] * len(Queue)
        self._mx = [0] * len(Queue)

    def _build_program_facts(self):
        """Program-static tables, cached on the Program object so memoized
        programs re-simulated across machine configs build them once:

        * per-unit lists of ``Instr.exec_facts`` in stream order;
        * per-instruction *skip soundness*: whether a blocked instruction
          with an all-finite issue time can be left unchecked until that
          cycle.  Sound iff no **other** unit can perturb its clear-times —
          every register source is written exactly once program-wide (SSA;
          ``ready`` entries are then final once present), no other unit pops
          the queues it pops (FIFO heads can't shift under it), and no other
          unit pushes the queues it pushes (a passing depth check can't
          start failing while it waits).  Busy is always own-unit state.
        """
        facts_order = [(u, [ins.exec_facts for ins in lst])
                       for u, lst in self.order]
        # init_env entries count as a first write: a seeded register that one
        # instruction overwrites has two effective writes, so its ready time
        # is NOT final once present and must disqualify the skip
        written: Dict[str, int] = {k: 1 for k in self.prog.init_env}
        poppers: Dict[Queue, set] = {}
        pushers: Dict[Queue, set] = {}
        for u, facts in facts_order:
            for f in facts:
                if f[7] is not None:
                    written[f[7]] = written.get(f[7], 0) + 1
                for op in f[12]:
                    if op[0]:
                        poppers.setdefault(op[1], set()).add(u)
                for push in f[13]:
                    pushers.setdefault(push[0], set()).add(u)
        multi = frozenset(d for d, c in written.items() if c > 1)

        def sound(u, f):
            for op in f[12]:
                if op[0]:
                    if poppers.get(op[1], set()) - {u}:
                        return False
                elif op[1] in multi:
                    return False
            return not any(pushers.get(push[0], set()) - {u}
                           for push in f[13])

        skip_ok = {u: [sound(u, f) for f in facts]
                   for u, facts in facts_order}
        return facts_order, skip_ok

    # -- hot-path twins of _block_reason / _do_issue ------------------------
    # ``f`` is an Instr.exec_facts tuple; see isa.Instr.exec_facts for the
    # layout.  Queue deques and push/pop logs are the canonical shared
    # objects; scalar state (pcs, busy, occupancy highwater) lives in the
    # list-indexed overlay and is synced back at exit points.

    def _reason_key(self, f, now: int) -> Optional[str]:
        """None if issuable at ``now``; else the ready-made stall key."""
        if self._busy[f[14]] > now:
            return f[6]
        qs = self._qs
        ready = self.ready
        for is_q, src, k, key, _qv, qi in f[12]:
            if is_q:
                dq = qs[qi]
                if len(dq) <= k or dq[k][0] > now:
                    return key
            else:
                t = ready.get(src)
                if t is None or t > now:
                    return key
        pushes = f[13]
        if pushes:
            depths = self._depths
            occ = self._occ
            for _q, k, key, qi in pushes:
                if occ[qi] + k + 1 > depths[qi]:
                    return key
        return None

    def _issue(self, f, now: int) -> int:
        (unit, unit_val, latency, blocking, e_plain, e_frep, _busy_key, dst,
         fn, expects, label, pushv, ops, pushes, uidx) = f
        t_done = now + latency
        opvals = []
        n_pop = 0
        for is_q, src, _k, _key, qv, qi in ops:
            if is_q:
                _, vname, val = self._qs[qi].popleft()
                self._occ[qi] -= 1
                self._poplog[qi].append(vname)
                if expects and expects[n_pop] != vname:
                    self.fifo_violations.append((label, qv,
                                                 expects[n_pop], vname))
                n_pop += 1
                opvals.append(val)
            else:
                opvals.append(self.env.get(src))
        result = None
        if self._eval and fn is not None:
            result = fn(*opvals)
        if dst is not None:
            self.ready[dst] = t_done
            self.env[dst] = result
        if pushes:
            t_vis = t_done + self.cfg.queue_latency
            occ, mx = self._occ, self._mx
            for _q, _k, _key, qi in pushes:
                self._qs[qi].append((t_vis, pushv, result))
                occ[qi] += 1
                if occ[qi] > mx[qi]:
                    mx[qi] = occ[qi]
                self._pushlog[qi].append(pushv)
        if blocking:
            self._busy[uidx] = t_done
        self.energy += e_frep if (self._frep and unit is Unit.FP) else e_plain
        self.instr_count[unit_val] += 1
        return t_done

    # -- time-skip stepping -------------------------------------------------

    def step(self) -> bool:
        """Advance to the next cycle in which the machine state changes.

        Two time-skips compose here, both bit-exact against the reference:

        * **per-unit**: a blocked unit whose issue conditions all clear at
          known times — and are *skip-sound* (no other unit can perturb
          them, see ``_build_program_facts``) — gets its stalls attributed
          in bulk through its exact wake cycle and is not re-checked until
          then, even while the other unit keeps issuing;
        * **whole-machine**: when nothing issued this cycle, the state is
          frozen until the earliest pending wake or clear-time, so the
          clock jumps there directly (or to the deadlock horizon).
        """
        cycle = self.cycle
        issued = False
        exhausted = 0
        wake = _NEVER                        # earliest per-unit skip expiry
        blocked: List[tuple] = []            # ev lists for this cycle's blocks
        stalls = self.stalls
        horizon = self.last_progress + self.cfg.deadlock_limit + 1
        for row in self._rows:
            lst = row[1]
            pc = row[3]
            if pc >= len(lst):
                exhausted += 1
                continue
            nt = row[4]
            if nt > cycle:                   # skip-pending: pre-attributed
                if nt < wake:
                    wake = nt
                continue
            f = lst[pc]
            # at the exact wake cycle of a sound skip the instruction is
            # guaranteed issuable — skip the redundant re-check
            key = None if nt == cycle else self._reason_key(f, cycle)
            if key is None:
                t_done = self._issue(f, cycle)
                if t_done > self.finish:
                    self.finish = t_done
                row[3] = pc + 1
                issued = True
                continue
            ev, t_issue = self._clear_times(f)
            if t_issue <= horizon and row[2][pc]:
                # exact wake time: attribute now, ignore the unit until then
                self._attribute_stalls(ev, cycle, int(t_issue) - 1)
                row[4] = int(t_issue)
                if t_issue < wake:
                    wake = int(t_issue)
            else:
                stalls[key] = stalls.get(key, 0) + 1
                blocked.append((ev, t_issue))
        if issued:
            self.last_progress = cycle
            self.cycle = cycle + 1
            return True
        if exhausted == len(self._rows):
            self._sync_canonical()
            return False                     # program retired
        # Nothing issued: the state is frozen until a pending timestamp
        # expires — the earliest skip wake or blocked clear-time.
        t_next = min([wake] + [t for _ev, t in blocked])
        if t_next > horizon:                 # deadlock (or past the limit)
            for ev, _t in blocked:
                self._attribute_stalls(ev, cycle + 1, horizon)
            self.cycle = horizon
            self._sync_canonical()
            raise self._deadlock()
        for ev, _t in blocked:
            self._attribute_stalls(ev, cycle + 1, int(t_next) - 1)
        self.cycle = int(t_next)
        return True

    @property
    def done(self) -> bool:
        return all(row[3] >= len(row[1]) for row in self._rows)

    def _sync_canonical(self) -> None:
        """Copy the list-indexed overlay back onto the canonical
        ReferenceStepper dicts (pcs / unit_busy / occupancy / max_occ) so
        result(), the deadlock message and external inspection see the same
        state the reference engine would leave behind."""
        for row in self._rows:
            self.pcs[row[0]] = row[3]
        for u, ui in UNIT_INDEX.items():
            self.unit_busy[u] = self._busy[ui]
        for q, qi in QUEUE_INDEX.items():
            self.occupancy[q] = self._occ[qi]
            self.max_occ[q] = self._mx[qi]

    def result(self) -> SimResult:
        self._sync_canonical()
        return super().result()

    def _clear_times(self, f) -> Tuple[List[Tuple[str, float]], float]:
        """((stall key, clear-time) per issue condition in check order,
        max clear-time).

        A condition blocks issue at cycle ``c`` iff its clear-time exceeds
        ``c``; conditions that depend on state rather than time (missing
        queue entry, unproduced register value, full queue) get ``inf``
        because only another unit's issue — impossible while all units are
        blocked — could satisfy them.
        """
        t_max = self._busy[f[14]]
        ev: List[Tuple[str, float]] = [(f[6], t_max)]
        for is_q, src, k, key, _qv, qi in f[12]:
            if is_q:
                dq = self._qs[qi]
                t = dq[k][0] if len(dq) > k else _NEVER
            else:
                t = self.ready.get(src)
                t = t if t is not None else _NEVER
            ev.append((key, t))
            if t > t_max:
                t_max = t
        pushes = f[13]
        if pushes:
            depths = self._depths
            for _q, k, key, qi in pushes:
                if self._occ[qi] + k + 1 > depths[qi]:
                    ev.append((key, _NEVER))
                    t_max = _NEVER
        return ev, t_max

    def _attribute_stalls(self, ev: List[Tuple[str, float]],
                          a: int, b: int) -> None:
        """Record the stalls the reference would for cycles ``a..b`` incl.

        At cycle ``c`` the recorded cause is the first condition with
        clear-time > ``c``; that index is non-decreasing in ``c`` (earlier
        conditions, once cleared, stay cleared while the state is frozen), so
        one ordered walk over ``ev`` yields the per-cause segment lengths.
        """
        if a > b:
            return
        c = a
        stalls = self.stalls
        for key, t in ev:
            if t <= c:
                continue
            end = b if t - 1 > b else int(t) - 1
            stalls[key] = stalls.get(key, 0) + (end - c + 1)
            if t - 1 >= b:
                return
            c = int(t)


#: available simulation engines, default first
ENGINES: Tuple[str, ...] = ("event", "cycle")


def stepper_for(prog: Program, cfg: Optional[MachineConfig] = None,
                engine: str = "event") -> ReferenceStepper:
    """Instantiate the requested engine: ``event`` (time-skip, default) or
    ``cycle`` (the naive reference)."""
    if engine == "event":
        return Stepper(prog, cfg)
    if engine == "cycle":
        return ReferenceStepper(prog, cfg)
    raise ValueError(f"unknown engine {engine!r} (have {ENGINES})")


def simulate(prog: Program, cfg: Optional[MachineConfig] = None,
             engine: str = "event") -> SimResult:
    return stepper_for(prog, cfg, engine).run()
