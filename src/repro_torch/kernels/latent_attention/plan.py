"""The decomposition and launch geometry of ``csrc/latent_attention.cu``, on
the host.

A query row (one head of one column of one slot) reads the first ``walk``
rows of its slot's latent and rope caches, ``walk`` its ``rows`` clamped to
[0, T], then its column's own new row.  Its work is cut the same way
whatever runs with it, by constants of the kernel and (r, dr, dtype) alone:

- spans of :data:`SPAN` positions, span s covering [s * SPAN, (s + 1) *
  SPAN), and groups of :data:`GROUP` positions; a row walks the spans below
  its walk, one warp a row;
- a score split over :data:`LANES_A_POSITION` lanes, lane j summing the
  latent's 16-byte vectors j, j + 8, ... (:func:`vec` elements each, in
  order) and the rope's elements j, j + 8, ..., each sum added over the
  lanes by a butterfly, the two then added: four positions scored at once a
  warp, in :data:`SPAN` / 4 passes;
- within a group the spans folded into the row's online softmax in span
  order, a span's positions in order; the self row folded last.  A row of
  at most one group (walk <= :data:`GROUP`) writes its output from the
  block of group 0; a longer row's group partials are folded in group
  order by the merge kernel, then its self row.

Which block or warp runs which row is the launch's business and never
changes a row's bits: a block serves :func:`rows_a_block` rows of one slot
(its H x C rows in column-major order, one warp each), which share each
span's latent and rope tile in shared memory.  The grid is (``row_blocks``
x B, ``n_groups``), sized from the cache's T and never from ``rows``: a
block of a group past its rows' walks exits at once, so the launch is one
node of a CUDA graph with no host read.

:func:`items` lists the (group, span, first position, positions) work of a
launch, and the self row last, in the kernel's index arithmetic, which the
CPU tests hold to the index space (every visible position of every row
exactly once, the self row last) and to the rule that a row's work does
not depend on B, C, H or T.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

#: positions a span (a tile of the ring)
SPAN = 64
#: positions a block walks (a group of spans)
GROUP = 256
#: lanes that score one position together
LANES_A_POSITION = 8
#: query rows a block at most (one warp each)
MAX_ROWS = 8
#: the fewest blocks a launch keeps before a block takes fewer rows (the
#: H100's 132 SMs)
MIN_BLOCKS = 132
#: stages of the cp.async ring
STAGES = 2
#: bytes of one latent copy; the rope's are 4
COPY_BYTES = 16
ROPE_COPY_BYTES = 4
#: the widest latent and rope rows, in elements
MAX_R = 256
MAX_ROPE = 64
#: shared memory a block may use on an H100 (227 KB)
SMEM_LIMIT = 232448
#: CUDA's grid limits (x, y)
GRID_LIMITS = (2 ** 31 - 1, 65535)
#: rows a block of the merge kernel (one warp each)
MERGE_ROWS = 4
#: a row's last item: its column's own new row
SELF = ("self",)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def vec(esize: int) -> int:
    """Elements of one 16-byte copy."""
    return COPY_BYTES // esize


def takes(r: int, dr: int, esize: int) -> bool:
    """Whether the kernel takes a latent of r and a rope key of dr
    elements: r at most :data:`MAX_R` in whole 16-byte vectors, dr at most
    :data:`MAX_ROPE` in whole 4-byte words."""
    return (0 < r <= MAX_R and r % vec(esize) == 0 and 0 < dr <= MAX_ROPE
            and (dr * esize) % ROPE_COPY_BYTES == 0)


def rows_a_block(H: int, C: int, B: int, n_groups: int) -> int:
    """Query rows a block, of a slot's H x C rows: up to :data:`MAX_ROWS`,
    halved while the launch would have fewer than :data:`MIN_BLOCKS`
    blocks, down to one."""
    rows = min(MAX_ROWS, H * C)
    while rows > 1 and _ceil(H * C, rows) * B * n_groups < MIN_BLOCKS:
        rows //= 2
    return rows


def smem_bytes(r: int, dr: int, esize: int) -> int:
    """Dynamic shared memory of a block: the ring's latent and rope tiles
    in the caches' dtype."""
    return STAGES * SPAN * (r + dr) * esize


@dataclasses.dataclass(frozen=True)
class Geometry:
    """One launch over q_eff (C, B, H, r) and caches (B, T, r + dr)."""
    B: int
    C: int
    H: int
    T: int
    r: int
    dr: int
    esize: int
    rows: int           # rows a block
    row_blocks: int     # blocks a slot

    @property
    def n_spans(self) -> int:
        return _ceil(self.T, SPAN)

    @property
    def spans_a_group(self) -> int:
        return GROUP // SPAN

    @property
    def n_groups(self) -> int:
        return _ceil(self.T, GROUP)

    @property
    def threads(self) -> int:
        return 32 * self.rows

    @property
    def grid(self) -> Tuple[int, int]:
        return (self.row_blocks * self.B, self.n_groups)

    @property
    def merges(self) -> bool:
        """Whether the merge kernel runs (a row may cross groups)."""
        return self.n_groups > 1

    @property
    def work_floats(self) -> int:
        """fp32 words of the partials' workspace: (max, sum, weighted
        latent) a (query row, group)."""
        return (self.C * self.B * self.H * self.n_groups * (self.r + 2)
                if self.merges else 0)


def geometry(B: int, C: int, H: int, T: int, r: int, dr: int,
             esize: int) -> Geometry:
    """The launch for q_eff (C, B, H, r), caches (B, T, r) and (B, T, dr)
    of ``esize`` bytes an element."""
    rows = rows_a_block(H, C, B, _ceil(T, GROUP))
    return Geometry(B, C, H, T, r, dr, esize, rows, _ceil(H * C, rows))


def walk(rows: int, T: int) -> int:
    """Cache positions a row walks: its ``rows`` clamped to [0, T]."""
    return min(max(rows, 0), T)


def row_of(geo: Geometry, bx: int, i: int):
    """(c, b, h) of row i of block x ``bx``, in the kernel's arithmetic
    (None past the block's rows)."""
    rb, b = bx % geo.row_blocks, bx // geo.row_blocks
    qi = rb * geo.rows + i
    if i >= geo.rows or qi >= geo.H * geo.C:
        return None
    return qi // geo.H, b, qi % geo.H


def items(geo: Geometry, rows) -> Dict[Tuple[int, int, int], List[tuple]]:
    """Every (group, span, first position, positions) a launch computes,
    by query row (c, b, h), in the kernel's index arithmetic, then
    :data:`SELF`: block (x, y) walks group y's spans below its rows'
    longest walk, and a row takes those below its own; the row's self
    fold comes from the block of group 0 where its walk is one group at
    most, else from the merge after every group.  ``rows`` is (C, B)."""
    out: Dict[Tuple[int, int, int], list] = {}
    gx, gy = geo.grid
    k = geo.spans_a_group
    for bx in range(gx):
        block = [r for r in (row_of(geo, bx, i) for i in range(geo.rows))
                 if r is not None]
        walks = [walk(int(rows[c][b]), geo.T) for c, b, _ in block]
        longest = max(walks)
        for by in range(gy):
            for s in range(by * k, min(by * k + k, geo.n_spans)):
                if s * SPAN >= longest:
                    break
                for row, wk in zip(block, walks):
                    if s * SPAN < wk:
                        lo = s * SPAN
                        out.setdefault(row, []).append(
                            (by, s, lo, min(SPAN, wk - lo)))
        for row in block:
            out.setdefault(row, [])
    for row in out:
        out[row].sort()
        out[row].append(SELF)
    return out
