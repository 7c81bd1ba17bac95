"""Cluster-scale machine model: N dual-issue PEs sharing a banked TCDM.

The single-PE model (``core.machine``) reproduces the paper's dual-issue
core; large-scale ML accelerators deploy *many* of them — a Snitch cluster
couples N cores to a word-interleaved multi-bank TCDM through a single-cycle
logarithmic interconnect (Zaruba et al., TC'21; Colagrande et al.,
"Towards Zero-Stall Matrix Multiplication on Energy-Efficient RISC-V
Clusters").  This module scales the machine model to that shape:

* :class:`ClusterConfig` — cluster geometry: core count, TCDM bank count
  (``None`` = conflict-free, the ∞-bank idealization), the bank service
  window (``bank_conflict_penalty``: cycles a bank stays busy per access, 1
  = fully pipelined single-port SRAM), the per-access interconnect energy,
  and the per-core :class:`~.machine.MachineConfig`.
* :class:`ClusterStepper` — advances N per-core steppers (the event-driven
  :class:`~.machine.Stepper` by default, the naive
  :class:`~.machine.ReferenceStepper` under ``engine="cycle"``) under a
  shared bank arbiter.  Host work stays O(total instructions): each core
  keeps its own event-driven time-skip machinery, and the scheduler always
  advances the core with the smallest local cycle (ties broken by core
  index — the deterministic interconnect priority), so every arbiter
  decision at cycle ``t`` happens after all accesses at cycles ``< t`` and
  after lower-indexed cores' accesses at ``t``.
* :class:`ClusterResult` — per-core :class:`~.machine.SimResult` plus the
  cluster aggregates: makespan cycles, aggregate IPC / throughput, summed
  energy *including interconnect energy*, merged stall breakdown (with the
  cluster-only ``*_bank`` causes), and per-core IPC.

Contention model: every TCDM access (``isa.MEM_KINDS``: loads, stores, SSR
stores) maps to ``crc32(label) % banks`` — a deterministic stand-in for
address-interleaved bank mapping — and occupies its bank for
``bank_conflict_penalty`` cycles.  An access finding its bank busy stalls
its unit with the ``bank`` cause until the bank frees.  Banks only ever get
*busier* over time, which is what makes the per-core time-skip sound: a
blocked core that jumped to its computed wake cycle re-checks every issue
condition there, and no bank can have become free earlier than the core
assumed.  (The per-unit *exact-wake* skip is disabled under finite banks —
another core can extend a bank window while a unit waits — so those
configurations pay a few more host steps; the whole-machine jump, which
re-checks on wake, is kept.)

Inter-core channels and DMA (the pipelined-cluster fabric): programs may
carry ``CQ_PUSH`` / ``CQ_POP`` ops (``Instr.cq`` names the channel) and
``DMA_START`` / ``DMA_WAIT`` descriptors (``Instr.dma_words`` sizes the
transfer).  Channels are bounded FIFOs living in the TCDM, shared by every
core of the cluster:

* **Determinism** — channel order is decided by the same min-(cycle, core)
  scheduler as the bank arbiter: a push at cycle ``t`` is ordered after all
  channel traffic at cycles ``< t`` and after lower-indexed cores' traffic
  at ``t``, so push/pop sequences are bit-reproducible across runs and
  engines.  A pushed entry becomes visible to the consumer ``cq_latency``
  cycles after the push completes (one interconnect traversal), mirroring
  the intra-core ``queue_latency``.
* **Blocking + stall causes** — a ``CQ_PUSH`` into a channel holding
  ``cq_depth`` entries stalls its unit with the ``cq_full`` cause; a
  ``CQ_POP`` of an empty (or not-yet-visible) channel stalls with
  ``cq_empty``; a ``DMA_START`` past ``dma_buffers`` in-flight transfers
  and a ``DMA_WAIT`` for an unfinished transfer stall with ``dma``.
  Because channel state is mutable by *other* cores, a core blocked on a
  channel op abandons time-skipping and re-checks every cycle (the clear
  time is capped at ``cycle + 1``), which keeps the event engine's stall
  attribution bit-identical to the per-cycle reference.  DMA state is
  core-local and final at issue time, so DMA waits keep the full time-skip.
* **Energy + bank occupancy** — each channel op charges the interconnect
  access energy plus ``E_CQ_ACCESS`` (FIFO pointer maintenance) and
  occupies the channel's TCDM bank (``channel % banks``) for one cycle — a
  single-word pipelined access, *not* the full ``bank_conflict_penalty``
  window.  A DMA transfer charges ``E_DMA_WORD`` per word at START; the
  bulk transfer itself is modeled conflict-free (the engine schedules
  around cores — the zero-stall premise of Colagrande et al.), and loads
  marked ``Instr.local`` (reads from a DMA-staged buffer) bypass bank
  arbitration and interconnect energy entirely.
* **Deadlock** — each core keeps its own no-progress detector, so a cyclic
  cross-core wait (A pops what only B pushes while B pops what only A
  pushes) raises :class:`~.machine.DeadlockError` — annotated with the
  cluster-wide channel occupancy — at the first core to exhaust its
  ``deadlock_limit`` horizon instead of hanging.  A ``DMA_START`` blocked
  on a full engine can never unblock (the freeing ``DMA_WAIT`` sits behind
  it on the same in-order unit) and is likewise reported as a deadlock.

The hard contract, enforced by ``tests/test_cluster.py`` differentially
against :class:`~.machine.Stepper` across the default sweep grid:
``n_cores=1, tcdm_banks=None`` is **bit-identical** to the single-core
engine — cycles, energy, stall breakdown, FIFO push/pop sequences,
occupancy highwater and the functional environment.  A single PE owns its
scratchpad port (no interconnect energy, no arbiter), so the degenerate
cluster runs the exact single-core code path.  Contention-free N-core
clusters additionally equal N independent single-core runs per core.

Engine parity under contention: issue timing, energy, FIFO sequences and
the environment are identical between ``event`` and ``cycle`` cluster runs
(bank windows only move later, so a jump target is never early).  The
*attribution* of bank-blocked cycles can differ when another core extends a
bank window inside a stretch the event engine already attributed — per-unit
stall totals still agree, only the cause split within the window may shift.
"""
from __future__ import annotations

import zlib
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .isa import (BANK_STALL_KEYS, CQ_EMPTY_STALL_KEYS, CQ_FULL_STALL_KEYS,
                  DMA_STALL_KEYS, E_CQ_ACCESS, E_DMA_WORD,
                  E_TCDM_INTERCONNECT, MEM_KINDS, OpKind, Queue)
from .machine import (ENGINES, DeadlockError, MachineConfig, Program,
                      ReferenceStepper, SimResult, Stepper)
from .policy import ExecutionPolicy


@dataclass
class ClusterConfig:
    """Cluster geometry.  The defaults (one core, conflict-free TCDM) are
    the degenerate cluster that must match ``core.machine`` bit-for-bit."""
    n_cores: int = 1
    #: TCDM bank count; ``None`` models an infinitely-banked (conflict-free)
    #: scratchpad — the idealization the bit-identity contract pins
    tcdm_banks: Optional[int] = None
    #: cycles a bank stays busy per access (1 = pipelined single-port SRAM);
    #: a conflicting access waits out the remainder of the window
    bank_conflict_penalty: int = 1
    #: energy per TCDM access through the shared interconnect; charged only
    #: when ``n_cores > 1`` (a single PE owns its scratchpad port)
    interconnect_energy: float = E_TCDM_INTERCONNECT
    #: inter-core channel depth (entries per bounded FIFO through the TCDM)
    cq_depth: int = 4
    #: cycles from a channel push's completion to consumer-side visibility
    #: (one interconnect traversal each way, mirroring ``queue_latency``)
    cq_latency: int = 1
    #: in-flight DMA transfers each per-core engine sustains (2 = the
    #: classic double-buffering; a DMA_START past the cap stalls ``dma``)
    dma_buffers: int = 2
    #: DMA descriptor programming + engine start overhead, cycles
    dma_setup: int = 8
    #: DMA streaming bandwidth, cycles per word moved
    dma_cycles_per_word: int = 1
    #: per-core machine configuration (queue geometry, latency, ...)
    machine: MachineConfig = field(default_factory=MachineConfig)

    def __post_init__(self) -> None:
        if self.n_cores <= 0:
            raise ValueError(f"n_cores must be positive, got {self.n_cores}")
        if self.tcdm_banks is not None and self.tcdm_banks <= 0:
            raise ValueError(
                f"tcdm_banks must be positive or None, got {self.tcdm_banks}")
        if self.bank_conflict_penalty < 1:
            raise ValueError("bank_conflict_penalty must be >= 1")
        if self.cq_depth < 1:
            raise ValueError(f"cq_depth must be >= 1, got {self.cq_depth}")
        if self.cq_latency < 0:
            raise ValueError(
                f"cq_latency must be >= 0, got {self.cq_latency}")
        if self.dma_buffers < 1:
            raise ValueError(
                f"dma_buffers must be >= 1, got {self.dma_buffers}")
        if self.dma_setup < 0 or self.dma_cycles_per_word < 1:
            raise ValueError("invalid DMA timing parameters")


class _Interconnect:
    """Shared TCDM bank arbiter: per-bank busy-until timestamps.

    ``banks=None`` disables arbitration entirely (conflict-free);
    ``e_access`` is the per-access interconnect energy (0 for one core).
    Timestamps only move forward — an acquired window never shrinks — which
    the per-core time-skip relies on (see the module docstring).
    """
    __slots__ = ("banks", "penalty", "e_access", "busy_until")

    def __init__(self, banks: Optional[int], penalty: int, e_access: float):
        self.banks = banks
        self.penalty = penalty
        self.e_access = e_access
        self.busy_until: Dict[int, int] = {}

    def bank_of(self, label: str) -> int:
        # deterministic address-hash proxy for word-interleaved bank mapping
        return zlib.crc32(label.encode()) % self.banks

    def free_at(self, bank: int) -> int:
        return self.busy_until.get(bank, 0)

    def acquire(self, bank: int, now: int,
                penalty: Optional[int] = None) -> None:
        """Occupy ``bank`` from ``now``.  ``penalty`` overrides the bulk
        service window — channel ops pass 1 (a single-word pipelined access
        does not hold the bank for the full conflict window)."""
        self.busy_until[bank] = now + (self.penalty if penalty is None
                                       else penalty)


class _ChannelFabric:
    """Cluster-wide inter-core channel state: one bounded FIFO per channel
    index, shared by every core stepper.  Entries are
    ``(visible_at, value_name, value)`` — the same shape as the intra-core
    COPIFT queues — and the cluster-level push/pop logs keep
    ``(channel, value_name)`` tuples for FIFO-order verification."""
    __slots__ = ("depth", "channels", "push_seq", "pop_seq", "violations")

    def __init__(self, depth: int):
        self.depth = depth
        self.channels: Dict[int, deque] = {}
        self.push_seq: List[Tuple[int, str]] = []
        self.pop_seq: List[Tuple[int, str]] = []
        #: (label, channel, expected value name, got value name)
        self.violations: List[Tuple[str, int, str, str]] = []

    def channel(self, c: int) -> deque:
        ch = self.channels.get(c)
        if ch is None:
            ch = self.channels[c] = deque()
        return ch

    def push(self, c: int, visible_at: int, name: str, value) -> None:
        self.channel(c).append((visible_at, name, value))
        self.push_seq.append((c, name))

    def pop(self, c: int) -> Tuple[int, str, object]:
        entry = self.channels[c].popleft()
        self.pop_seq.append((c, entry[1]))
        return entry


class _DmaEngine:
    """Per-core DMA engine: a deque of in-flight transfer completion times.
    A transfer's buffer stays occupied until its ``DMA_WAIT`` retires it —
    that is what bounds the pipeline to ``dma_buffers`` stages."""
    __slots__ = ("buffers", "inflight")

    def __init__(self, buffers: int):
        self.buffers = buffers
        self.inflight: deque = deque()


def _fabric_meta(ins, ccfg: "ClusterConfig") -> Optional[Tuple]:
    """Pre-resolved fabric semantics for one instruction, or ``None`` for
    ordinary ops.  Tag layout (first element):

    * ``(0, chan, src_reg, pushed_name, visibility_delay)`` — CQ_PUSH
    * ``(1, chan, dst_magic, expected_name|None, label)``   — CQ_POP
    * ``(2, completion_delay, transfer_energy)``            — DMA_START
    * ``(3,)``                                              — DMA_WAIT
    """
    if ins.kind is OpKind.CQ_PUSH or ins.kind is OpKind.CQ_POP:
        if ins.cq is None:
            raise ValueError(
                f"{ins.label}: {ins.kind.value} needs a channel (Instr.cq)")
        if ins.kind is OpKind.CQ_PUSH:
            src = ins.srcs[0] if ins.srcs else None
            return (0, ins.cq, src, ins.push_val or ins.label,
                    ins.spec.latency + ccfg.cq_latency)
        expect = ins.expects[0] if ins.expects else None
        return (1, ins.cq, ins.srcs[0], expect, ins.label)
    if ins.kind is OpKind.DMA_START:
        return (2, ins.spec.latency + ccfg.dma_setup
                + ins.dma_words * ccfg.dma_cycles_per_word,
                E_DMA_WORD * ins.dma_words)
    if ins.kind is OpKind.DMA_WAIT:
        return (3,)
    return None


def _fabric_reason(core, m: Tuple, now: int) -> Optional[str]:
    """The fabric stall cause blocking ``m`` at ``now``, or ``None``.
    Shared verbatim by both engines (cause-string level; the event core
    maps causes to pre-formatted keys)."""
    tag = m[0]
    if tag == 0:
        if len(core._fabric.channel(m[1])) >= core._fabric.depth:
            return "cq_full"
    elif tag == 1:
        ch = core._fabric.channel(m[1])
        if not ch or ch[0][0] > now:
            return "cq_empty"
    elif tag == 2:
        if len(core._dma.inflight) >= core._dma.buffers:
            return "dma"
    else:
        infl = core._dma.inflight
        if infl and infl[0] > now:
            return "dma"
    return None


def _fabric_issue(core, m: Tuple, now: int) -> None:
    """Apply ``m``'s fabric side effects at issue time.  Runs *before* the
    base issue path so a CQ_POP's value lands in ``env`` for the base
    machinery (fn / dst / intra-core pushes) to consume."""
    tag = m[0]
    if tag == 0:
        core._fabric.push(m[1], now + m[4], m[3], core.env.get(m[2]))
        core.energy += E_CQ_ACCESS
    elif tag == 1:
        _vis, name, val = core._fabric.pop(m[1])
        core.env[m[2]] = val
        if m[3] is not None and m[3] != name:
            core._fabric.violations.append((m[4], m[1], m[3], name))
        core.energy += E_CQ_ACCESS
    elif tag == 2:
        core._dma.inflight.append(now + m[1])
        core.energy += m[2]
    else:
        if core._dma.inflight:
            core._dma.inflight.popleft()


#: event-engine stall-key maps per fabric cause string
_FAB_KEYS = {"cq_full": CQ_FULL_STALL_KEYS,
             "cq_empty": CQ_EMPTY_STALL_KEYS,
             "dma": DMA_STALL_KEYS}

_NEVER = float("inf")


class _CoreStepper(Stepper):
    """One cluster core: the event-driven engine + the shared bank gate.

    With no interconnect pressure (one core, infinite banks) and no fabric
    ops every override below is a no-op pass-through — the degenerate
    cluster core runs the exact single-core code path, which is the
    bit-identity contract.
    """

    def __init__(self, prog: Program, ccfg: "ClusterConfig",
                 ic: _Interconnect, fabric: _ChannelFabric):
        super().__init__(prog, ccfg.machine)
        self._ic = ic
        self._fabric = fabric
        self._dma = _DmaEngine(ccfg.dma_buffers)
        #: id(exec_facts) -> bank, for TCDM-touching instructions only
        self._bank: Dict[int, int] = {}
        self._mem_ids: set = set()
        #: id(exec_facts) -> fabric meta (see ``_fabric_meta``)
        self._fab: Dict[int, Tuple] = {}
        for _u, lst in self.order:
            for ins in lst:
                m = _fabric_meta(ins, ccfg)
                if m is not None:
                    fid = id(ins.exec_facts)
                    self._fab[fid] = m
                    # channel ops touch the channel's TCDM bank for one
                    # cycle; DMA descriptors and transfers stay bank-free
                    if m[0] <= 1 and ic.banks is not None:
                        self._bank[fid] = m[1] % ic.banks
                elif ins.kind in MEM_KINDS and not ins.local:
                    self._mem_ids.add(id(ins.exec_facts))
                    if ic.banks is not None:
                        self._bank[id(ins.exec_facts)] = ic.bank_of(ins.label)
        if self._bank or self._fab:
            # another core can extend a bank window or mutate a channel
            # while a unit waits, so the per-unit exact-wake skip is unsound
            # here; replace (never mutate: the skip table is cached on the
            # Program) each row's skip flags with all-False.  The
            # whole-machine jump re-checks conditions on wake and stays
            # sound (channel clear-times are additionally capped below).
            for row in self._rows:
                row[2] = [False] * len(row[2])

    # -- fabric + bank gates around the single-core issue conditions --------
    # Check order, identical in both engines: busy -> fabric -> the
    # single-core conditions -> bank.

    def _reason_key(self, f, now: int) -> Optional[str]:
        m = self._fab.get(id(f))
        if m is not None:
            if self._busy[f[14]] > now:
                return f[6]
            cause = _fabric_reason(self, m, now)
            if cause is not None:
                return _FAB_KEYS[cause][f[0]]
        key = super()._reason_key(f, now)
        if key is None and self._bank:
            b = self._bank.get(id(f))
            if b is not None and self._ic.free_at(b) > now:
                return BANK_STALL_KEYS[f[0]]
        return key

    def _clear_times(self, f) -> Tuple[List[Tuple[str, float]], float]:
        m = self._fab.get(id(f))
        if m is not None and m[0] <= 1:
            # channel state is mutable by other cores, so no clear-time a
            # blocked core computes is trustworthy: cap the jump at one
            # cycle (per-cycle re-check; empty bulk-attribution ranges keep
            # the stall split bit-identical to the reference)
            key = _FAB_KEYS["cq_full" if m[0] == 0 else "cq_empty"][f[0]]
            t = self.cycle + 1
            return [(key, t)], t
        ev, t_max = super()._clear_times(f)
        if m is not None:
            # DMA state is core-local and final at issue: exact clear-times.
            # Insert after the busy entry so the bulk-attribution walk sees
            # the same check order as _reason_key / _block_reason.
            if m[0] == 2:
                if len(self._dma.inflight) >= self._dma.buffers:
                    # only a later same-unit DMA_WAIT could free a buffer —
                    # impossible while this op blocks the unit: deadlock
                    ev.insert(1, (DMA_STALL_KEYS[f[0]], _NEVER))
                    t_max = _NEVER
            else:
                infl = self._dma.inflight
                if infl:
                    t = infl[0]
                    ev.insert(1, (DMA_STALL_KEYS[f[0]], t))
                    if t > t_max:
                        t_max = t
        if self._bank:
            b = self._bank.get(id(f))
            if b is not None:
                t = self._ic.free_at(b)
                ev.append((BANK_STALL_KEYS[f[0]], t))
                if t > t_max:
                    t_max = t
        return ev, t_max

    def _issue(self, f, now: int) -> int:
        fid = id(f)
        m = self._fab.get(fid)
        if m is not None:
            _fabric_issue(self, m, now)
            if m[0] <= 1:
                b = self._bank.get(fid)
                if b is not None:
                    self._ic.acquire(b, now, penalty=1)
                self.energy += self._ic.e_access
        elif fid in self._mem_ids:
            if self._bank:
                self._ic.acquire(self._bank[fid], now)
            self.energy += self._ic.e_access
        return super()._issue(f, now)


class _RefCoreStepper(ReferenceStepper):
    """Naive per-cycle cluster core — the differential oracle for
    :class:`_CoreStepper` (``engine="cycle"``), with the same fabric and
    bank gates in the same check order."""

    def __init__(self, prog: Program, ccfg: "ClusterConfig",
                 ic: _Interconnect, fabric: _ChannelFabric):
        super().__init__(prog, ccfg.machine)
        self._ic = ic
        self._fabric = fabric
        self._dma = _DmaEngine(ccfg.dma_buffers)
        self._bank: Dict[int, int] = {}
        self._mem_ids: set = set()
        self._fab: Dict[int, Tuple] = {}
        for _u, lst in self.order:
            for ins in lst:
                m = _fabric_meta(ins, ccfg)
                if m is not None:
                    self._fab[id(ins)] = m
                    if m[0] <= 1 and ic.banks is not None:
                        self._bank[id(ins)] = m[1] % ic.banks
                elif ins.kind in MEM_KINDS and not ins.local:
                    self._mem_ids.add(id(ins))
                    if ic.banks is not None:
                        self._bank[id(ins)] = ic.bank_of(ins.label)

    def _block_reason(self, ins, now: int) -> Optional[str]:
        m = self._fab.get(id(ins))
        if m is not None:
            if self.unit_busy[ins.unit] > now:
                return "busy"
            cause = _fabric_reason(self, m, now)
            if cause is not None:
                return cause
        reason = super()._block_reason(ins, now)
        if reason is None and self._bank:
            b = self._bank.get(id(ins))
            if b is not None and self._ic.free_at(b) > now:
                return "bank"
        return reason

    def _do_issue(self, ins, now: int) -> int:
        iid = id(ins)
        m = self._fab.get(iid)
        if m is not None:
            _fabric_issue(self, m, now)
            if m[0] <= 1:
                b = self._bank.get(iid)
                if b is not None:
                    self._ic.acquire(b, now, penalty=1)
                self.energy += self._ic.e_access
        elif iid in self._mem_ids:
            if self._bank:
                self._ic.acquire(self._bank[iid], now)
            self.energy += self._ic.e_access
        return super()._do_issue(ins, now)


@dataclass
class ClusterResult:
    """Aggregate outcome of one cluster run.  ``cycles`` is the makespan
    (slowest core); energy is the sum over cores *including* interconnect
    energy; the per-core :class:`~.machine.SimResult`\\ s keep full detail
    (env, FIFO sequences) for equivalence checking."""
    name: str
    policy: ExecutionPolicy
    n_cores: int
    tcdm_banks: Optional[int]
    cycles: int
    n_samples: int
    energy: float
    core_results: List[SimResult]
    #: inter-core channel traffic (cluster-wide, ordered by the scheduler)
    cq_pushes: int = 0
    cq_pops: int = 0
    #: channel entries popped out of expected value order
    cq_violations: int = 0

    @property
    def total_instrs(self) -> int:
        return sum(r.total_instrs for r in self.core_results)

    @property
    def ipc(self) -> float:
        """Aggregate IPC over the makespan — up to ``2 * n_cores``."""
        return self.total_instrs / self.cycles if self.cycles else 0.0

    @property
    def ipc_per_core(self) -> float:
        """Mean per-core IPC (each core over its own busy cycles)."""
        if not self.core_results:
            return 0.0
        return sum(r.ipc for r in self.core_results) / len(self.core_results)

    @property
    def throughput(self) -> float:          # samples / cycle, aggregate
        return self.n_samples / self.cycles if self.cycles else 0.0

    @property
    def power(self) -> float:
        return self.energy / self.cycles if self.cycles else 0.0

    @property
    def efficiency(self) -> float:          # samples / energy
        return self.n_samples / self.energy if self.energy else 0.0

    @property
    def instrs(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for r in self.core_results:
            for k, v in r.instrs.items():
                out[k] = out.get(k, 0) + v
        return out

    @property
    def stalls(self) -> Dict[str, int]:
        """Merged stall breakdown; ``*_bank`` keys are the contention."""
        out: Dict[str, int] = {}
        for r in self.core_results:
            for k, v in r.stalls.items():
                out[k] = out.get(k, 0) + v
        return out

    @property
    def bank_stalls(self) -> int:
        return sum(v for k, v in self.stalls.items() if k.endswith("_bank"))

    @property
    def cq_stalls(self) -> int:
        """Cycles lost to inter-core channel back-pressure (full + empty)."""
        return sum(v for k, v in self.stalls.items()
                   if k.endswith("_cq_empty") or k.endswith("_cq_full"))

    @property
    def dma_stalls(self) -> int:
        return sum(v for k, v in self.stalls.items() if k.endswith("_dma"))

    @property
    def max_queue_occupancy(self) -> Dict[Queue, int]:
        out = {q: 0 for q in Queue}
        for r in self.core_results:
            for q, v in r.max_queue_occupancy.items():
                if v > out[q]:
                    out[q] = v
        return out

    @property
    def fifo_violations(self) -> int:
        return (sum(len(r.fifo_violations) for r in self.core_results)
                + self.cq_violations)

    def summary(self) -> Dict[str, object]:
        """Primitive-typed record mirroring ``SimResult.summary`` with the
        cluster aggregates added."""
        return {
            "name": self.name,
            "policy": self.policy.value,
            "n_cores": self.n_cores,
            "tcdm_banks": self.tcdm_banks,
            "cycles": self.cycles,
            "n_samples": self.n_samples,
            "instrs_int": self.instrs.get("int", 0),
            "instrs_fp": self.instrs.get("fp", 0),
            "ipc": self.ipc,
            "ipc_per_core": self.ipc_per_core,
            "energy": self.energy,
            "power": self.power,
            "throughput": self.throughput,
            "efficiency": self.efficiency,
            "max_occ_i2f": self.max_queue_occupancy.get(Queue.I2F, 0),
            "max_occ_f2i": self.max_queue_occupancy.get(Queue.F2I, 0),
            "fifo_violations": self.fifo_violations,
            "bank_stalls": self.bank_stalls,
            "cq_stalls": self.cq_stalls,
            "dma_stalls": self.dma_stalls,
            "cq_pushes": self.cq_pushes,
            "stalls": dict(self.stalls),
        }


class ClusterStepper:
    """Advance N per-core steppers under the shared TCDM arbiter.

    ``progs`` are the per-core programs (``transform.partition_kernel``
    output, or any list of independent Programs — one per core).  The
    scheduler always steps the core with the smallest local cycle, ties
    broken by core index (core 0 has interconnect priority), which makes
    the contention semantics deterministic and engine-independent.
    """

    def __init__(self, progs: Sequence[Program],
                 cfg: Optional[ClusterConfig] = None,
                 engine: str = "event"):
        progs = list(progs)
        cfg = cfg or ClusterConfig(n_cores=len(progs))
        if len(progs) != cfg.n_cores:
            raise ValueError(
                f"got {len(progs)} per-core programs for n_cores={cfg.n_cores}")
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r} (have {ENGINES})")
        self.cfg = cfg
        self.interconnect = _Interconnect(
            banks=cfg.tcdm_banks, penalty=cfg.bank_conflict_penalty,
            e_access=cfg.interconnect_energy if cfg.n_cores > 1 else 0.0)
        self.fabric = _ChannelFabric(cfg.cq_depth)
        core_cls = _CoreStepper if engine == "event" else _RefCoreStepper
        self.cores = [core_cls(p, cfg, self.interconnect, self.fabric)
                      for p in progs]

    def run(self) -> ClusterResult:
        cores = self.cores
        live = list(range(len(cores)))
        while live:
            # global-time-ordered advance: the min-cycle core acts next, so
            # every arbiter decision at cycle t already saw all accesses at
            # cycles < t and lower-indexed cores' accesses at t
            c = min(live, key=lambda i: (cores[i].cycle, i))
            try:
                if not cores[c].step():
                    live.remove(c)
            except DeadlockError as err:
                raise self._cluster_deadlock(c, err) from err
        return self.result()

    def _cluster_deadlock(self, c: int, err: DeadlockError) -> DeadlockError:
        """Annotate a per-core deadlock with the cluster-wide picture: a
        cyclic cross-core channel wait surfaces here (the first core to
        exhaust its no-progress horizon raises), and the channel occupancy
        plus every core's local cycle make the cycle legible."""
        chans = {ch: len(q) for ch, q in sorted(self.fabric.channels.items())}
        cycles = [core.cycle for core in self.cores]
        return DeadlockError(
            f"cross-core deadlock detected at core {c}: {err}; "
            f"channel occupancy {chans}; per-core cycles {cycles}")

    def result(self) -> ClusterResult:
        results = [c.result() for c in self.cores]
        prog0 = self.cores[0].prog
        return ClusterResult(
            name=prog0.kernel_name,
            policy=prog0.policy,
            n_cores=self.cfg.n_cores,
            tcdm_banks=self.cfg.tcdm_banks,
            cycles=max((r.cycles for r in results), default=0),
            n_samples=sum(r.n_samples for r in results),
            energy=sum(r.energy for r in results),
            core_results=results,
            cq_pushes=len(self.fabric.push_seq),
            cq_pops=len(self.fabric.pop_seq),
            cq_violations=len(self.fabric.violations),
        )


def simulate_cluster(progs: Sequence[Program],
                     cfg: Optional[ClusterConfig] = None,
                     engine: str = "event") -> ClusterResult:
    """One-shot convenience entry point, mirroring ``machine.simulate``."""
    return ClusterStepper(progs, cfg, engine).run()
