"""The decomposition and launch geometry of ``csrc/decode_attention.cu``, on
the host.

A query row (one query head of one column of one slot) attends to the
first ``walk`` positions of its slot's K/V head: ``walk`` is its visible
length ``valid`` clamped to T, or all T positions when ``valid`` is 0 (all
masked, the mean of V).  Its work is cut the same way whatever runs with
it, by constants of the kernel and (D, dtype) alone:

- spans of :func:`span` positions (64; 32 where a cache row is over
  :data:`SPAN_ROW_BYTES`), span s covering [s * span, (s + 1) * span), and
  groups of :data:`GROUP` positions; a row walks the spans below ``walk``;
- each span split among a team of :data:`WARPS` warps, warp w taking the
  :func:`sub_span` positions from s * span + w * sub_span and computing
  their partial (max, sum, weighted V);
- a score split over :data:`LANES_A_POSITION` lanes, lane j summing the
  16-byte vectors j, j + 8, ... of the head dim (:func:`vec` elements
  each, in order) and the lanes' sums added by a butterfly;
- within a group, the spans folded into the row's running partial in span
  order, each span's warp partials in warp order; a row of one group
  writes its output from the block, a longer row's group partials are
  folded in group order by the merge kernel.

Which block, team or warp runs which work is the launch's business and
never changes a row's bits: a block serves one group of up to
:func:`rows_a_block` rows of one (slot, K/V head) pair (its GQA group times
the chunk's columns), which share each span's K/V tile, with one team a
row up to :data:`MAX_TEAMS` teams (:func:`teams`).  The grid is
(``row_blocks`` x B x Hkv, ``n_groups``), sized from the cache's T and
never from ``valid``: a block whose group lies past its rows' walks exits
at once, so the launch is one node of a CUDA graph with no host read.

:func:`items` lists the (row, span, warp, positions) work of a launch in
the kernel's index arithmetic, which the CPU tests hold to the index space
(every visible position of every row exactly once) and to the rule that a
row's work does not depend on B, C, G or T.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

#: warps a team: the warps that split a span
WARPS = 4
#: lanes that score one position together
LANES_A_POSITION = 8
#: the longest span (positions a work item)
MAX_SPAN = 64
#: cache rows longer than this many bytes take half spans
SPAN_ROW_BYTES = 256
#: positions a block walks (a group of spans)
GROUP = 256
#: query rows a block at most
MAX_ROWS = 8
#: the fewest blocks a launch keeps before a block takes fewer rows (two
#: an SM of an H100, about)
MIN_BLOCKS = 256
#: teams of warps a block at most
MAX_TEAMS = 4
#: stages of the cp.async ring
STAGES = 2
#: bytes of one cp.async copy
COPY_BYTES = 16
#: the largest head dim
MAX_D = 256
#: shared memory a block may use on an H100 (227 KB)
SMEM_LIMIT = 232448
#: CUDA's grid limits (x, y)
GRID_LIMITS = (2 ** 31 - 1, 65535)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def span(D: int, esize: int) -> int:
    """Positions a span: 64, or 32 where a cache row is over
    :data:`SPAN_ROW_BYTES` (so a ring of two spans' K and V fits)."""
    return MAX_SPAN if D * esize <= SPAN_ROW_BYTES else MAX_SPAN // 2


def sub_span(D: int, esize: int) -> int:
    """Positions a warp of the team takes of each span."""
    return span(D, esize) // WARPS


def vec(esize: int) -> int:
    """Elements of one 16-byte copy."""
    return COPY_BYTES // esize


def takes(D: int, esize: int) -> bool:
    """Whether the kernel takes head dim D: at most MAX_D, whole 16-byte
    vectors a row."""
    return 0 < D <= MAX_D and D % vec(esize) == 0


def rows_a_block(G: int, C: int, pairs: int, n_groups: int) -> int:
    """Query rows a block, of a (slot, K/V head) pair's G x C rows: G x C
    up to :data:`MAX_ROWS`, halved while the launch over ``pairs`` pairs
    and ``n_groups`` groups would have fewer than :data:`MIN_BLOCKS`
    blocks, down to one."""
    rows = min(MAX_ROWS, G * C)
    while rows > 1 and _ceil(G * C, rows) * pairs * n_groups < MIN_BLOCKS:
        rows //= 2
    return rows


def teams(rows: int) -> int:
    """Teams of warps a block: one a row, up to :data:`MAX_TEAMS`."""
    return min(rows, MAX_TEAMS)


def smem_bytes(D: int, esize: int, rows: int) -> int:
    """Dynamic shared memory of a block of ``rows`` rows: the ring's K and
    V tiles in the cache's dtype, the rows' queries in fp32, each (row,
    warp) partial's weighted V, max and sum."""
    ring = STAGES * 2 * span(D, esize) * D * esize
    return ring + rows * D * 4 + rows * WARPS * (D + 2) * 4


@dataclasses.dataclass(frozen=True)
class Geometry:
    """One launch over q (C, B, Hq, D) and caches (B, Hkv, T, D)."""
    B: int
    C: int
    Hq: int
    Hkv: int
    T: int
    D: int
    esize: int
    rows: int           # rows a block
    row_blocks: int     # blocks a (slot, K/V head) pair

    @property
    def G(self) -> int:
        return self.Hq // self.Hkv

    @property
    def span(self) -> int:
        return span(self.D, self.esize)

    @property
    def n_spans(self) -> int:
        return _ceil(self.T, self.span)

    @property
    def spans_a_group(self) -> int:
        return GROUP // self.span

    @property
    def n_groups(self) -> int:
        return _ceil(self.T, GROUP)

    @property
    def threads(self) -> int:
        return 32 * WARPS * teams(self.rows)

    @property
    def grid(self) -> Tuple[int, int]:
        return (self.row_blocks * self.B * self.Hkv, self.n_groups)

    @property
    def merges(self) -> bool:
        """Whether the merge kernel runs (a row may cross groups)."""
        return self.n_groups > 1

    @property
    def work_floats(self) -> int:
        """fp32 words of the partials' workspace: (max, sum, weighted V) a
        (query row, group)."""
        return (self.C * self.B * self.Hq * self.n_groups * (self.D + 2)
                if self.merges else 0)


def geometry(B: int, C: int, Hq: int, Hkv: int, T: int, D: int,
             esize: int) -> Geometry:
    """The launch for q (C, B, Hq, D), caches (B, Hkv, T, D) of ``esize``
    bytes an element."""
    G = Hq // Hkv
    rows = rows_a_block(G, C, B * Hkv, _ceil(T, GROUP))
    return Geometry(B, C, Hq, Hkv, T, D, esize, rows, _ceil(G * C, rows))


def walk(valid: int, T: int) -> int:
    """Positions a row walks: its visible length clamped to T, or all T
    when it sees none."""
    vis = min(valid, T)
    return vis if vis > 0 else T


def row_of(geo: Geometry, bx: int, i: int) -> Tuple[int, int, int]:
    """(c, b, hq) of row i of block x ``bx``, in the kernel's arithmetic
    (None past the group's rows)."""
    rb, bh = bx % geo.row_blocks, bx // geo.row_blocks
    b, hkv = bh // geo.Hkv, bh % geo.Hkv
    qi = rb * geo.rows + i
    if i >= geo.rows or qi >= geo.G * geo.C:
        return None
    return qi // geo.G, b, hkv * geo.G + qi % geo.G


def items(geo: Geometry, valid) -> Dict[Tuple[int, int, int],
                                        List[Tuple[int, int, int, int]]]:
    """Every (span, warp, first position, positions) a launch computes,
    by query row (c, b, hq), in the kernel's index arithmetic: block (x,
    y) serves its rows over group y's spans below the block's longest
    walk; warp w of a span takes its sub-span's positions below the row's
    walk (none: an empty partial the fold skips).  ``valid`` is (C, B)."""
    sub = sub_span(geo.D, geo.esize)
    out: Dict[Tuple[int, int, int], list] = {}
    gx, gy = geo.grid
    for bx in range(gx):
        rows = [r for r in (row_of(geo, bx, i) for i in range(geo.rows))
                if r is not None]
        walks = [walk(int(valid[c][b]), geo.T) for c, b, _ in rows]
        longest = max(walks)
        k = geo.spans_a_group
        for by in range(gy):
            for s in range(by * k, min(by * k + k, geo.n_spans)):
                if s * geo.span >= longest:
                    break
                for row, wk in zip(rows, walks):
                    if s * geo.span >= wk:
                        continue
                    for w in range(WARPS):
                        lo = s * geo.span + w * sub
                        n = max(0, min(sub, wk - lo))
                        out.setdefault(row, []).append((s, w, lo, n))
    for row in out:
        out[row].sort()
    return out
