"""Abstract ISA for the Snitch + FPSS machine model.

The paper's platform is a Snitch cluster core [Zaruba et al., TC'21]: a
single-issue in-order integer core ("INT" unit) with a decoupled FP
coprocessor ("FP" unit, the FPSS) that supports FREP hardware loops and SSR
streaming registers.  COPIFTv2 adds two blocking FIFO queues (I2F, F2I)
between the units.

We model instructions abstractly: each OpKind carries the executing unit, a
result latency (cycles until the destination value is usable), an energy
weight (relative units — we only ever report *ratios*, see DESIGN.md §3.1),
and whether it blocks its unit (non-pipelined, e.g. fdiv/fsqrt).
"""
from __future__ import annotations

import enum
import functools
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple


class Unit(enum.Enum):
    INT = "int"
    FP = "fp"


@dataclass(frozen=True)
class OpSpec:
    unit: Unit
    latency: int
    energy: float
    blocking: bool = False


class OpKind(enum.Enum):
    # Integer core
    IALU = "ialu"          # add/sub/shift/and/or/lui...
    IMUL = "imul"
    LW = "lw"              # integer load (TCDM hit)
    SW = "sw"              # integer store
    MV = "mv"              # register move; also queue push/pop shim
    BR = "br"              # branch / loop bookkeeping
    SYNC = "sync"          # COPIFT batch-semaphore bookkeeping (flag store)
    # FPSS
    FLD = "fld"
    FSD = "fsd"
    FSD_SSR = "fsd_ssr"    # store through an SSR stream (COPIFT F2I spill)
    FADD = "fadd"
    FMUL = "fmul"
    FMA = "fma"
    FDIV = "fdiv"
    FSQRT = "fsqrt"
    CVT_I2F = "cvt_i2f"    # fcvt.d.w / fmv.d.x : int operand -> FP result
    CVT_F2I = "cvt_f2i"    # fcvt.w.d / fmv.x.d : FP operand -> int result
    FMV_PUSH = "fmv_push"  # fmv.x.d used purely to push an FP value to F2I
    # Cluster-level communication (``core.cluster``): inter-core queue ops
    # and DMA transfer descriptors, all issued by the integer core.  Outside
    # a cluster these degrade to plain register moves — the cluster core
    # steppers attach the channel / engine semantics (see ``Instr.cq`` /
    # ``Instr.dma_words``).
    CQ_PUSH = "cq_push"    # push a register value into an inter-core channel
    CQ_POP = "cq_pop"      # pop an inter-core channel head into a register
    DMA_START = "dma_start"  # program a bulk TCDM transfer descriptor
    DMA_WAIT = "dma_wait"    # retire the oldest in-flight DMA transfer


#: Latency / energy table, loosely calibrated to Snitch (GF12, 1 GHz).
#: Energies are relative units; see DESIGN.md §3.1 for the calibration stance.
OP_TABLE: dict[OpKind, OpSpec] = {
    OpKind.IALU:     OpSpec(Unit.INT, 1, 1.0),
    OpKind.IMUL:     OpSpec(Unit.INT, 3, 1.8),
    OpKind.LW:       OpSpec(Unit.INT, 3, 4.5),
    OpKind.SW:       OpSpec(Unit.INT, 1, 4.0),
    OpKind.MV:       OpSpec(Unit.INT, 1, 0.8),
    OpKind.BR:       OpSpec(Unit.INT, 1, 0.9),
    OpKind.SYNC:     OpSpec(Unit.INT, 1, 1.1),
    OpKind.FLD:      OpSpec(Unit.FP, 3, 5.0),
    OpKind.FSD:      OpSpec(Unit.FP, 1, 4.5),
    OpKind.FSD_SSR:  OpSpec(Unit.FP, 1, 4.2),
    OpKind.FADD:     OpSpec(Unit.FP, 3, 2.2),
    OpKind.FMUL:     OpSpec(Unit.FP, 3, 2.4),
    OpKind.FMA:      OpSpec(Unit.FP, 4, 3.4),
    OpKind.FDIV:     OpSpec(Unit.FP, 11, 7.0, blocking=True),
    OpKind.FSQRT:    OpSpec(Unit.FP, 13, 7.5, blocking=True),
    OpKind.CVT_I2F:  OpSpec(Unit.FP, 2, 1.6),
    OpKind.CVT_F2I:  OpSpec(Unit.FP, 2, 1.6),
    OpKind.FMV_PUSH: OpSpec(Unit.FP, 1, 0.9),
    OpKind.CQ_PUSH:  OpSpec(Unit.INT, 1, 1.2),
    OpKind.CQ_POP:   OpSpec(Unit.INT, 1, 1.2),
    OpKind.DMA_START: OpSpec(Unit.INT, 1, 1.5),
    OpKind.DMA_WAIT: OpSpec(Unit.INT, 1, 0.8),
}

#: Kinds executed on the FPSS whose *destination* is integer-homed.
INT_DST_FP_KINDS = frozenset({OpKind.CVT_F2I, OpKind.FMV_PUSH})
#: Kinds executed on the FPSS.
FP_KINDS = frozenset(k for k, s in OP_TABLE.items() if s.unit is Unit.FP)
#: Kinds that touch the TCDM (loads/stores, SSR-backed stores) — the accesses
#: a shared-memory cluster arbitrates over banks (``core.cluster``).
MEM_KINDS = frozenset({OpKind.LW, OpKind.SW, OpKind.FLD, OpKind.FSD,
                       OpKind.FSD_SSR})
#: Inter-core channel accesses: the bounded FIFOs live in TCDM, so pushes
#: and pops also occupy a bank and cross the cluster interconnect.
CQ_KINDS = frozenset({OpKind.CQ_PUSH, OpKind.CQ_POP})
#: DMA descriptor management ops (per-core engine, ``core.cluster``).
DMA_KINDS = frozenset({OpKind.DMA_START, OpKind.DMA_WAIT})

# --- Energy model knobs (relative units) -----------------------------------
#: extra energy for a queue push or pop (lightweight FIFO access)
E_QUEUE_ACCESS = 0.4
#: extra energy when a value arrives through an SSR memory stream (COPIFT
#: spill readback): an SRAM read the hardware performs on the FPSS's behalf.
E_SSR_STREAM = 3.8
#: fetch/decode overhead for an instruction issued by the integer core
E_FETCH_INT = 0.6
#: re-issue overhead for an instruction replayed from the FREP loop buffer
E_FETCH_FREP = 0.2
#: background (clock tree, icache, idle datapath, leakage) energy per cycle
#: for the core pair.  Dominant for a tiny in-order core at 1 GHz; calibrated
#: so the published COPIFT/COPIFTv2 energy-efficiency ratios are reproduced
#: (DESIGN.md §3.1 — we report energy *ratios* only).
E_STATIC_PER_CYCLE = 22.0
#: energy per TCDM access crossing the cluster's shared interconnect (the
#: log-depth crossbar between N cores and the banked TCDM).  Charged only in
#: multi-core clusters (``core.cluster``): a single PE owns its scratchpad
#: port, so the ``n_cores=1`` machine stays bit-identical to ``machine``.
E_TCDM_INTERCONNECT = 0.9
#: extra energy for an inter-core channel push or pop on top of the TCDM
#: access itself (head/tail pointer maintenance in the producer/consumer
#: cores — the channels are plain TCDM ring buffers, ``core.cluster``)
E_CQ_ACCESS = 0.5
#: energy per word moved by the cluster DMA engine (SRAM read + interconnect
#: traversal + SRAM write, no core fetch/decode on either side).  A
#: DMA-staged word is then re-read locally without interconnect energy
#: (``Instr.local``), trading one extra copy for conflict-free access.
E_DMA_WORD = 2.0


class Queue(enum.Enum):
    I2F = "i2f"
    F2I = "f2i"


#: pre-interned per-unit stall-counter keys (``"<unit>_<cause>"``), so the
#: simulator hot path never string-formats; causes mirror
#: ``machine.STALL_CAUSES`` plus the unit-busy check.  ``bank`` /
#: ``cq_empty`` / ``cq_full`` / ``dma`` are the cluster-only causes (TCDM
#: bank busy, inter-core channel empty/full, DMA engine busy —
#: ``core.cluster``).
_STALL_KEYS = {
    u.value: {c: f"{u.value}_{c}"
              for c in ("busy", "dep", "queue_empty", "queue_full", "bank",
                        "cq_empty", "cq_full", "dma")}
    for u in Unit
}

#: per-unit stall key for a TCDM bank conflict (``core.cluster``)
BANK_STALL_KEYS = {u: _STALL_KEYS[u.value]["bank"] for u in Unit}
#: per-unit stall keys for the cluster communication causes (``core.cluster``)
CQ_EMPTY_STALL_KEYS = {u: _STALL_KEYS[u.value]["cq_empty"] for u in Unit}
CQ_FULL_STALL_KEYS = {u: _STALL_KEYS[u.value]["cq_full"] for u in Unit}
DMA_STALL_KEYS = {u: _STALL_KEYS[u.value]["dma"] for u in Unit}

#: dense indices for the hot-path list layouts (enum-keyed dicts hash the
#: member on every access; a list index does not)
UNIT_INDEX = {u: i for i, u in enumerate(Unit)}
QUEUE_INDEX = {q: i for i, q in enumerate(Queue)}

#: (busy, dep, queue_empty, queue_full) stall keys per unit, pre-unpacked
#: for the exec_facts builder
_HOT_KEYS = {
    u: (_STALL_KEYS[u.value]["busy"], _STALL_KEYS[u.value]["dep"],
        _STALL_KEYS[u.value]["queue_empty"],
        _STALL_KEYS[u.value]["queue_full"])
    for u in Unit
}


@dataclass(frozen=True)
class Instr:
    """One concrete instruction instance in a lowered stream program.

    ``srcs`` holds operands *in semantic order*: each element is either an
    SSA value name ("t@3" = value t of sample 3) or a :class:`Queue`, which
    means "pop the head of that queue as this operand" (the x31 / integer-rs
    semantics of the EnCopiftQueues CSR).  ``pushes`` enqueues the computed
    result; ``push_val`` records the semantic value name pushed, used to
    verify FIFO order correctness.  ``fn`` (optional) gives concrete
    semantics so the simulator doubles as a functional interpreter for
    transform-correctness checks.
    """
    uid: int
    kind: OpKind
    label: str
    srcs: Tuple[object, ...] = ()
    dst: Optional[str] = None
    pushes: Tuple[Queue, ...] = ()
    push_val: Optional[str] = None
    expects: Tuple[str, ...] = ()         # value names expected by pops, in order
    sample: int = -1                      # -1 => overhead instruction
    fn: Optional[Callable[..., Any]] = None
    extra_energy: float = 0.0             # e.g. SSR stream read on behalf
    #: inter-core channel index for CQ_PUSH / CQ_POP.  The channel gate,
    #: value transport and energy live entirely in the cluster core steppers
    #: (``core.cluster``); the single-core engines treat these ops as plain
    #: register moves, so ``None`` (every non-cluster program) changes
    #: nothing.
    cq: Optional[int] = None
    #: words moved by a DMA_START transfer (0 for every other kind)
    dma_words: int = 0
    #: TCDM access served from a DMA-staged local buffer: exempt from bank
    #: arbitration and interconnect energy in a cluster (the DMA already
    #: paid the interconnect crossing per word, ``E_DMA_WORD``)
    local: bool = False

    # cached: Instr is immutable and these are hammered by both the list
    # schedulers (transform._interleave) and the simulator issue loop
    @functools.cached_property
    def spec(self) -> OpSpec:
        return OP_TABLE[self.kind]

    @functools.cached_property
    def unit(self) -> Unit:
        return self.spec.unit

    @functools.cached_property
    def pops(self) -> Tuple[Queue, ...]:
        return tuple(s for s in self.srcs if isinstance(s, Queue))

    @functools.cached_property
    def reg_srcs(self) -> Tuple[str, ...]:
        return tuple(s for s in self.srcs if isinstance(s, str))

    @functools.cached_property
    def issue_plan(self) -> Tuple[Tuple[str, object, int], ...]:
        """Issue conditions in machine-check order, pre-resolved once.

        Each entry is ``(check, operand, k)``:

        * ``("queue_empty", queue, k)`` — this operand pops the ``k``-th
          pending entry of ``queue`` (k counts this instruction's earlier pops
          of the same queue); blocked until that entry is *visible*, i.e. its
          queue timestamp (producer completion + queue latency) has passed.
        * ``("dep", name, 0)`` — register operand; blocked until the
          producer's result latency has elapsed (``ready[name]``).
        * ``("queue_full", queue, k)`` — this push needs the queue's
          occupancy (in-flight included) to be at most ``depth - k - 1``;
          cleared only by a consumer pop, never by time alone.

        The event-driven stepper turns each entry into a clear-time and
        time-skips to the earliest cycle every condition holds; the order here
        matches ``ReferenceStepper._block_reason`` so bulk stall attribution
        is bit-identical to per-cycle attribution.  (The unit-busy check is
        state-only and is prepended by the stepper.)
        """
        plan = []
        need: dict = {}
        for src in self.srcs:
            if isinstance(src, Queue):
                k = need.get(src, 0)
                plan.append(("queue_empty", src, k))
                need[src] = k + 1
            else:
                plan.append(("dep", src, 0))
        room: dict = {}
        for q in self.pushes:
            k = room.get(q, 0)
            plan.append(("queue_full", q, k))
            room[q] = k + 1
        return tuple(plan)

    @functools.cached_property
    def exec_facts(self) -> Tuple:
        """Hot-path companion of :attr:`issue_plan`: every instruction-static
        fact the simulator needs at issue time, resolved once per ``Instr``
        and cached on the instance — so memoized programs re-simulated across
        machine configs (``core.sweep``) never re-derive latencies, energies
        or stall-counter keys.  Layout::

            (unit, unit_value, latency, blocking,
             energy_no_frep, energy_frep, busy_stall_key,
             dst, fn, expects, label, pushed_value_name,
             ops,    # per source operand, in semantic order:
                     #   (is_queue, operand, k, stall_key, queue_value_str,
                     #    queue_index)           (queue_index -1 for registers)
             pushes, # per push: (queue, k, stall_key, queue_index)
             unit_index)

        ``ops``/``pushes`` are split out of :attr:`issue_plan` (same order,
        same ``k`` bookkeeping), with the stall keys pre-formatted and
        :data:`QUEUE_INDEX`/:data:`UNIT_INDEX` positions resolved for the
        event engine's list-indexed hot state.
        """
        spec = OP_TABLE[self.kind]
        unit = spec.unit
        busy_key, dep_key, qe_key, qf_key = _HOT_KEYS[unit]
        qindex = QUEUE_INDEX
        ops = []
        n_pop = 0
        need: dict = {}
        for src in self.srcs:                   # same walk as issue_plan
            if type(src) is Queue:
                k = need.get(src, 0)
                need[src] = k + 1
                n_pop += 1
                ops.append((True, src, k, qe_key, src.value, qindex[src]))
            else:
                ops.append((False, src, 0, dep_key, None, -1))
        pushes = []
        room: dict = {}
        for q in self.pushes:
            k = room.get(q, 0)
            room[q] = k + 1
            pushes.append((q, k, qf_key, qindex[q]))
        e = spec.energy + self.extra_energy
        e += E_QUEUE_ACCESS * (len(pushes) + n_pop)
        return (unit, unit.value, spec.latency, spec.blocking,
                e + E_FETCH_INT,
                e + (E_FETCH_INT if unit is Unit.INT else E_FETCH_FREP),
                busy_key, self.dst, self.fn, self.expects, self.label,
                self.push_val or self.label, tuple(ops), tuple(pushes),
                UNIT_INDEX[unit])

    def energy(self, *, frep: bool) -> float:
        e = self.spec.energy + self.extra_energy
        e += E_QUEUE_ACCESS * (len(self.pops) + len(self.pushes))
        if self.unit is Unit.INT or not frep:
            e += E_FETCH_INT
        else:
            e += E_FETCH_FREP
        return e
