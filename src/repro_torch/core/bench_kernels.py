"""Mixed integer/FP benchmark kernels (the suite of COPIFT [1], Fig. 3).

The paper evaluates COPIFTv2 on "a set of mixed integer and FP codes
presented in [1]"; the figure names ``exp`` and ``poly lcg`` explicitly.  We
reconstruct a representative suite (see DESIGN.md §3.1): each kernel is a
LoopDFG whose integer/FP instruction mix matches the workload class —
math-library range reduction (exp/log), LCG-fed polynomial evaluation,
int8 dequantization dot products, Box–Muller sampling and FP histogramming.

Every node carries a concrete ``fn`` so the machine model doubles as an
interpreter: tests assert that COPIFT/COPIFTv2 lowerings compute exactly the
same outputs as the sequential baseline.
"""
from __future__ import annotations

import math
import struct
from typing import Dict

from .dfg import LoopDFG, Node, s
from .isa import OpKind, Unit

LN2 = 0.6931471805599453
INV_LN2 = 1.4426950408889634
_M52 = (1 << 52) - 1


def _f2b(x: float) -> int:
    return struct.unpack("<Q", struct.pack("<d", x))[0]


def _b2f(b: int) -> float:
    return struct.unpack("<d", struct.pack("<Q", b & ((1 << 64) - 1)))[0]


# ---------------------------------------------------------------------------
_MAGIC = 6755399441055744.0          # 1.5 * 2^52: round-to-nearest-int trick
_INF_BITS = 0x7FF0000000000000


def make_expf() -> LoopDFG:
    """exp(x) by range reduction: x = k·ln2 + r; e^r by a polynomial; 2^k
    built by integer bit manipulation with full underflow/overflow handling
    (the "integer phase" of Fig. 1b).  kf is recovered on the FPSS via the
    magic-number rounding trick, so only k crosses F2I and only the final
    2^k bit pattern crosses I2F — production Snitch expf avoids round trips
    exactly this way."""
    nodes = [
        Node("t", OpKind.FMUL, (s("x"),), fn=lambda x: x * INV_LN2),
        Node("tm", OpKind.FADD, (s("t"),), fn=lambda t: t + _MAGIC),
        Node("kf", OpKind.FADD, (s("tm"),), fn=lambda tm: tm - _MAGIC),
        Node("k", OpKind.CVT_F2I, (s("tm"),),
             fn=lambda tm: int(tm - _MAGIC)),
        # --- integer thread: clamp, under/overflow guards, 2^k pattern -----
        Node("klo", OpKind.IALU, (s("k"),), fn=lambda k: max(k, -1022)),
        Node("kcl", OpKind.IALU, (s("klo"),), fn=lambda k: min(k, 1024)),
        Node("e", OpKind.IALU, (s("kcl"),), fn=lambda k: k + 1023),
        Node("b0", OpKind.IALU, (s("e"),), fn=lambda e: (e << 52) & ((1 << 63) - 1)),
        Node("gz", OpKind.IALU, (s("kcl"),),
             fn=lambda k: -1 if k > -1022 else 0),          # underflow mask
        Node("ovf", OpKind.IALU, (s("kcl"),),
             fn=lambda k: _INF_BITS if k >= 1024 else 0),   # overflow -> inf
        Node("b1", OpKind.IALU, (s("b0"), s("gz")), fn=lambda b, g: b & g),
        Node("bits", OpKind.IALU, (s("b1"), s("ovf")), fn=lambda b, o: b | o),
        # --- FP thread ------------------------------------------------------
        Node("r", OpKind.FMA, (s("kf"), s("x")), fn=lambda kf, x: x - kf * LN2),
        Node("p1", OpKind.FMA, (s("r"),), fn=lambda r: r / 24.0 + 1.0 / 6.0),
        Node("p2", OpKind.FMA, (s("p1"), s("r")), fn=lambda p, r: p * r + 0.5),
        Node("p3", OpKind.FMA, (s("p2"), s("r")), fn=lambda p, r: p * r + 1.0),
        Node("p4", OpKind.FMA, (s("p3"), s("r")), fn=lambda p, r: p * r + 1.0),
        Node("sc", OpKind.CVT_I2F, (s("bits"),),
             fn=lambda b: math.inf if b == _INF_BITS
             else (0.0 if b == 0 else 2.0 ** ((b >> 52) - 1023))),
        Node("y", OpKind.FMUL, (s("p4"), s("sc")), fn=lambda p, sc: p * sc,
             out=True),
    ]
    return LoopDFG("expf", nodes,
                   inputs={"x": lambda i: -8.0 + (i % 41) * 0.4},
                   input_homes={"x": Unit.FP})


# ---------------------------------------------------------------------------
def make_logf() -> LoopDFG:
    """log(x): integer thread loads raw IEEE-754 bits and extracts
    exponent/mantissa; FP thread evaluates log1p on the mantissa."""
    def data(i: int) -> float:
        return 0.5 + (i % 97) * 0.37

    nodes = [
        Node("addr", OpKind.IALU, (s("addr", 1),), fn=lambda a: a + 8),
        Node("xb", OpKind.LW, (s("addr"),), fn=lambda a: _f2b(data(a // 8))),
        Node("eraw", OpKind.IALU, (s("xb"),), fn=lambda b: (b >> 52) & 0x7FF),
        Node("eunb", OpKind.IALU, (s("eraw"),), fn=lambda e: e - 1023),
        Node("mbits", OpKind.IALU, (s("xb"),),
             fn=lambda b: (b & _M52) | (1023 << 52)),
        Node("mf", OpKind.CVT_I2F, (s("mbits"),), fn=lambda b: _b2f(b)),
        Node("u", OpKind.FADD, (s("mf"),), fn=lambda m: m - 1.0),
        Node("q1", OpKind.FMA, (s("u"),), fn=lambda u: 0.2 * u - 0.25),
        Node("q2", OpKind.FMA, (s("q1"), s("u")), fn=lambda q, u: q * u + 1.0 / 3.0),
        Node("q3", OpKind.FMA, (s("q2"), s("u")), fn=lambda q, u: q * u - 0.5),
        Node("q4", OpKind.FMA, (s("q3"), s("u")), fn=lambda q, u: q * u + 1.0),
        Node("q5", OpKind.FMUL, (s("q4"), s("u")), fn=lambda q, u: q * u),
        Node("ef", OpKind.CVT_I2F, (s("eunb"),), fn=float),
        Node("y", OpKind.FMA, (s("ef"), s("q5")),
             fn=lambda ef, q: ef * LN2 + q, out=True),
    ]
    return LoopDFG("logf", nodes, init={"addr": -8})


# ---------------------------------------------------------------------------
def make_poly_lcg() -> LoopDFG:
    """Polynomial over LCG-generated pseudo-random inputs ("poly lcg").
    The LCG is a *serial* integer dependency chain — the kernel where
    COPIFT's spill loads/stores help balance the threads (paper §III)."""
    nodes = [
        Node("st1", OpKind.IMUL, (s("st", 1),),
             fn=lambda v: (v * 1103515245) & 0xFFFFFFFF),
        Node("st", OpKind.IALU, (s("st1"),),
             fn=lambda v: (v + 12345) & 0x7FFFFFFF),
        Node("u", OpKind.IALU, (s("st"),), fn=lambda v: v >> 7),
        Node("xf", OpKind.CVT_I2F, (s("u"),), fn=lambda u: u * 2.0 ** -24),
        Node("h1", OpKind.FMA, (s("xf"),), fn=lambda x: -0.1187 * x + 0.4312),
        Node("h2", OpKind.FMA, (s("h1"), s("xf")), fn=lambda h, x: h * x - 0.8901),
        Node("h3", OpKind.FMA, (s("h2"), s("xf")), fn=lambda h, x: h * x + 1.4142),
        Node("h4", OpKind.FMA, (s("h3"), s("xf")), fn=lambda h, x: h * x - 0.5772),
        Node("h5", OpKind.FMA, (s("h4"), s("xf")),
             fn=lambda h, x: h * x + 0.9159, out=True),
    ]
    return LoopDFG("poly_lcg", nodes, init={"st": 42})


# ---------------------------------------------------------------------------
def make_dequant_dot() -> LoopDFG:
    """int16-packed dequantization feeding a two-lane FP accumulator — the
    Turing-style INT/FP co-execution pattern; near-balanced threads."""
    def packed(i: int) -> int:
        return (((i * 37) % 1024) << 16) | ((i * 53) % 1024)

    nodes = [
        Node("addr", OpKind.IALU, (s("addr", 1),), fn=lambda a: a + 4),
        Node("pk", OpKind.LW, (s("addr"),), fn=lambda a: packed(a // 4)),
        Node("a0", OpKind.IALU, (s("pk"),), fn=lambda p: (p >> 16) & 0xFFFF),
        Node("a1", OpKind.IALU, (s("pk"),), fn=lambda p: p & 0xFFFF),
        Node("z0", OpKind.IALU, (s("a0"),), fn=lambda v: v - 512),
        Node("z1", OpKind.IALU, (s("a1"),), fn=lambda v: v - 512),
        Node("f0", OpKind.CVT_I2F, (s("z0"),), fn=float),
        Node("f1", OpKind.CVT_I2F, (s("z1"),), fn=float),
        Node("s0", OpKind.FMUL, (s("f0"),), fn=lambda x: x * 0.0078125),
        Node("s1", OpKind.FMUL, (s("f1"),), fn=lambda x: x * 0.0078125),
        Node("acc0", OpKind.FMA, (s("s0"), s("acc0", 1)),
             fn=lambda x, a: a + x, out=True),
        Node("acc1", OpKind.FMA, (s("s1"), s("acc1", 1)),
             fn=lambda x, a: a + x, out=True),
    ]
    return LoopDFG("dequant_dot", nodes, init={"addr": -4, "acc0": 0.0, "acc1": 0.0})


# ---------------------------------------------------------------------------
def make_box_muller() -> LoopDFG:
    """Box–Muller-style sampling: LCG + polynomial -2·ln(u) approximation +
    a *blocking* fsqrt — the low-ILP case (dual-issue gains are small)."""
    nodes = [
        Node("st1", OpKind.IMUL, (s("st", 1),),
             fn=lambda v: (v * 1103515245) & 0xFFFFFFFF),
        Node("st", OpKind.IALU, (s("st1"),),
             fn=lambda v: (v + 12345) & 0x7FFFFFFF),
        Node("u1", OpKind.IALU, (s("st"),), fn=lambda v: (v >> 8) | 1),
        Node("uf", OpKind.CVT_I2F, (s("u1"),), fn=lambda u: u * 2.0 ** -23),
        Node("l1", OpKind.FMA, (s("uf"),), fn=lambda u: -0.8 * u + 2.1),
        Node("l2", OpKind.FMA, (s("l1"), s("uf")), fn=lambda l, u: l * u - 3.4),
        Node("l3", OpKind.FMA, (s("l2"), s("uf")), fn=lambda l, u: l * u + 3.9),
        Node("rt", OpKind.FSQRT, (s("l3"),), fn=math.sqrt),
        Node("ang", OpKind.FMUL, (s("uf"),), fn=lambda u: 6.283185307 * u),
        Node("w1", OpKind.FMA, (s("ang"),), fn=lambda a: -0.4967 * a + 0.03705),
        Node("w2", OpKind.FMA, (s("w1"), s("ang")), fn=lambda w, a: w * a + 1.0),
        Node("z", OpKind.FMUL, (s("rt"), s("w2")),
             fn=lambda r, w: r * w, out=True),
    ]
    return LoopDFG("box_muller", nodes, init={"st": 7777})


# ---------------------------------------------------------------------------
def make_cluster_matmul() -> LoopDFG:
    """int8-quantized matmul micro-tile: two packed operand loads, integer
    unpack, FP dequantize (zero-point + scale folded into the FP thread) and
    a two-lane accumulator.  Strictly one-directional (int -> fp, four I2F
    crossings per sample) with an integer half (~11 instrs) balancing the FP
    half (12 instrs) — the cluster *pipeline* target: a producer core
    streams unpacked operands through an inter-core channel to a consumer
    core running the FP stream (``transform.partition_pipeline``)."""
    def packed_a(i: int) -> int:
        return (((i * 37) % 256) << 16) | ((i * 59) % 256)

    def packed_b(i: int) -> int:
        return (((i * 41) % 256) << 16) | ((i * 67) % 256)

    nodes = [
        Node("addr", OpKind.IALU, (s("addr", 1),), fn=lambda a: a + 4),
        Node("pa", OpKind.LW, (s("addr"),), fn=lambda a: packed_a(a // 4)),
        Node("pb", OpKind.LW, (s("addr"),), fn=lambda a: packed_b(a // 4)),
        Node("a0", OpKind.IALU, (s("pa"),), fn=lambda p: (p >> 16) & 0xFFFF),
        Node("a1", OpKind.IALU, (s("pa"),), fn=lambda p: p & 0xFFFF),
        Node("b0", OpKind.IALU, (s("pb"),), fn=lambda p: (p >> 16) & 0xFFFF),
        Node("b1", OpKind.IALU, (s("pb"),), fn=lambda p: p & 0xFFFF),
        Node("fa0", OpKind.CVT_I2F, (s("a0"),), fn=float),
        Node("fa1", OpKind.CVT_I2F, (s("a1"),), fn=float),
        Node("fb0", OpKind.CVT_I2F, (s("b0"),), fn=float),
        Node("fb1", OpKind.CVT_I2F, (s("b1"),), fn=float),
        Node("za0", OpKind.FADD, (s("fa0"),), fn=lambda x: x - 128.0),
        Node("za1", OpKind.FADD, (s("fa1"),), fn=lambda x: x - 128.0),
        Node("zb0", OpKind.FADD, (s("fb0"),), fn=lambda x: x - 128.0),
        Node("zb1", OpKind.FADD, (s("fb1"),), fn=lambda x: x - 128.0),
        Node("p0", OpKind.FMUL, (s("za0"), s("zb0")), fn=lambda x, y: x * y),
        Node("p1", OpKind.FMUL, (s("za1"), s("zb1")), fn=lambda x, y: x * y),
        Node("acc0", OpKind.FMA, (s("p0"), s("acc0", 1)),
             fn=lambda x, a: a + x * 0.0078125, out=True),
        Node("acc1", OpKind.FMA, (s("p1"), s("acc1", 1)),
             fn=lambda x, a: a + x * 0.0078125, out=True),
    ]
    return LoopDFG("cluster_matmul", nodes,
                   init={"addr": -4, "acc0": 0.0, "acc1": 0.0})


# ---------------------------------------------------------------------------
def make_histf() -> LoopDFG:
    """FP histogramming: FP thread scales/converts, integer thread updates
    bins — the F2I-dominant direction."""
    nodes = [
        Node("t", OpKind.FMUL, (s("x"),), fn=lambda x: x * 64.0),
        Node("k", OpKind.CVT_F2I, (s("t"),),
             fn=lambda t: min(63, max(0, int(t)))),
        Node("sh", OpKind.IALU, (s("k"),), fn=lambda k: k << 3),
        Node("ad", OpKind.IALU, (s("sh"),), fn=lambda v: 4096 + v),
        Node("cnt", OpKind.LW, (s("ad"),), fn=lambda a: 0),
        Node("inc", OpKind.IALU, (s("cnt"),), fn=lambda c: c + 1),
        Node("upd", OpKind.SW, (s("ad"), s("inc")),
             fn=lambda a, v: (a, v), out=True),
    ]
    return LoopDFG("histf", nodes,
                   inputs={"x": lambda i: ((i * 7) % 64) / 64.0 + 1e-4},
                   input_homes={"x": Unit.FP})


KERNELS: Dict[str, LoopDFG] = {}
for _mk in (make_expf, make_logf, make_poly_lcg, make_dequant_dot,
            make_cluster_matmul, make_box_muller, make_histf):
    _k = _mk()
    KERNELS[_k.name] = _k
