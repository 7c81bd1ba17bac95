"""The decomposition and launch geometry of ``csrc/latent_attention.cu``, on
the host.

A query row (one head of one column of one slot) reads the first ``walk``
rows of its slot's latent and rope caches, ``walk`` its ``rows`` clamped to
[0, T], then its column's own new row.  Its work is cut the same way
whatever runs with it, by constants of the kernel and (r, dr, dtype) alone:

- spans of :data:`SPAN` positions, span s covering [s * SPAN, (s + 1) *
  SPAN), and groups of :data:`GROUP` positions; a row takes the spans
  below its walk;
- a row of at most one group (walk <= :data:`GROUP`) writes its output from
  the block of group 0, the self row folded last; a longer row's group
  partials are folded in group order by the merge kernel, then its self
  row.

Which path a row takes is a function of its dtype alone (:func:`path`):

- ``"mma"`` (bf16): the positions of each span fall in :data:`TEAMS`
  chunks of :data:`CHUNK`; a row's chunks w of the group's spans are folded
  in span order into one online softmax (partial w: max, sum, weighted
  latent), the scores in :data:`K_STEP`-wide k-steps in order over [latent |
  rope] zero-padded (:func:`padded`), the weights rounded to bf16 and summed
  in position order; the group's partials are then folded in chunk order,
  the max first.  A block takes one group of :func:`tiles_a_block`
  sub-tiles of :data:`TILE` of a slot's H x C rows, and :data:`TEAMS` warps
  a sub-tile, warp w on chunk w of each span (a block of one sub-tile
  keeps the other warps to copy and fold); the rows of a block share each
  span's tile in shared memory;
- ``"fma"`` (fp32): one warp a row walks its spans on CUDA cores, a score
  split over :data:`LANES_A_POSITION` lanes, and folds them into its online
  softmax in span order, a span's positions in order.  A block serves
  :func:`rows_a_block` rows of one slot.

Which block, sub-tile or warp runs which row is the launch's business and
never changes a row's bits.  The grid is (``row_blocks`` x B,
``n_groups``), sized from the cache's T and never from ``rows``: a block of
a group past its rows' walks exits at once, so the launch is one node of a
CUDA graph with no host read.  The launch's ``rows_a_block`` argument is
the fp32 path's :func:`rows_a_block` whatever the dtype (the bf16 path
sizes its tiles itself, as :func:`tiles_a_block` does), so an earlier build
that took it for every dtype is launched as it launched itself.

:func:`items` lists a launch's work by row in the order the row folds it
(fma: (group, span, first position, positions); mma: (group, chunk, span,
first position, positions)), and the self row last, in the kernel's index
arithmetic, which the CPU tests hold to the index space (every visible
position of every row exactly once, the self row last) and to the rule
that a row's work does not depend on B, C, H, T or its place in a
sub-tile.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

#: positions a span
SPAN = 64
#: positions a block walks (a group of spans)
GROUP = 256
#: fp32: lanes that score one position together
LANES_A_POSITION = 8
#: fp32: query rows a block at most (one warp each)
MAX_ROWS = 8
#: the fewest blocks a launch keeps before a block takes fewer rows (the
#: H100's 132 SMs)
MIN_BLOCKS = 132
#: fp32: stages of the cp.async ring
STAGES = 2
#: bytes of one latent copy; the rope's are 4 where dr is not a whole
#: number of 16-byte vectors
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
#: bf16: query rows a sub-tile (an mma's M)
TILE = 16
#: bf16: sub-tiles a block at most
MAX_TILES = 2
#: bf16: positions of a span a warp takes (the product's k-step of P)
CHUNK = 16
#: bf16: warps a sub-tile, one a chunk of each span
TEAMS = SPAN // CHUNK
#: bf16: the k-step of the products
K_STEP = 16
#: bf16: elements padding a shared row (16 bytes)
PAD = 8
#: bf16: floats padding a row of a warp's partial in shared memory
PART_PAD = 8
#: bf16: bytes before the tiles in shared memory (the span barriers)
BAR_BYTES = 128
#: a row's last item: its column's own new row
SELF = ("self",)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def padded(n: int) -> int:
    """bf16: r or dr padded to a power of two of at least :data:`K_STEP`
    elements in shared memory: whole k-steps, and a power-of-two count of
    copies a row."""
    p = K_STEP
    while p < n:
        p *= 2
    return p


def vec(esize: int) -> int:
    """Elements of one 16-byte copy."""
    return COPY_BYTES // esize


def path(r: int, dr: int, esize: int) -> str:
    """The path a launch takes, a function of (r, dr, dtype) alone:
    ``"mma"`` (tensor cores) for bf16, ``"fma"`` (CUDA cores) for fp32,
    whose 2e-4 tolerance TF32 would miss."""
    if not takes(r, dr, esize):
        raise ValueError(f"latent_attention takes no r={r}, dr={dr} in "
                         f"{esize}-byte elements")
    return "mma" if esize == 2 else "fma"


def takes(r: int, dr: int, esize: int) -> bool:
    """Whether the kernel takes a latent of r and a rope key of dr
    elements: r at most :data:`MAX_R` in whole 16-byte vectors, dr at most
    :data:`MAX_ROPE` in whole 4-byte words."""
    return (0 < r <= MAX_R and r % vec(esize) == 0 and 0 < dr <= MAX_ROPE
            and (dr * esize) % ROPE_COPY_BYTES == 0)


def rows_a_block(H: int, C: int, B: int, n_groups: int) -> int:
    """fp32: query rows a block, of a slot's H x C rows: up to
    :data:`MAX_ROWS`, halved while the launch would have fewer than
    :data:`MIN_BLOCKS` blocks, down to one."""
    rows = min(MAX_ROWS, H * C)
    while rows > 1 and _ceil(H * C, rows) * B * n_groups < MIN_BLOCKS:
        rows //= 2
    return rows


def tiles_a_block(H: int, C: int, B: int, n_groups: int) -> int:
    """bf16: sub-tiles of :data:`TILE` rows a block: up to
    :data:`MAX_TILES`, halved while the launch would have fewer than
    :data:`MIN_BLOCKS` blocks or the slot's rows fill fewer tiles."""
    tiles = MAX_TILES
    while tiles > 1 and (_ceil(H * C, TILE * tiles) * B * n_groups
                         < MIN_BLOCKS or H * C <= TILE * (tiles // 2)):
        tiles //= 2
    return tiles


def smem_bytes(r: int, dr: int, esize: int, tiles: int = MAX_TILES) -> int:
    """Dynamic shared memory of a block.  fp32: the ring's latent and rope
    tiles.  bf16: the barriers, then the block's query rows and the group's
    cache rows as [latent | rope] rows (:func:`padded`, then :data:`PAD`),
    or, once the products are done, the (sub-tile, warp) partials over
    them: fp32 weighted latent (rows :data:`PART_PAD` floats longer), max
    and sum."""
    if path(r, dr, esize) == "fma":
        return STAGES * SPAN * (r + dr) * esize
    ld = padded(r) + padded(dr) + PAD
    tiles_b = (TILE * tiles + GROUP) * ld * 2
    parts_b = tiles * TEAMS * TILE * (padded(r) + PART_PAD + 2) * 4
    return BAR_BYTES + max(tiles_b, parts_b)


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
    rows: int           # fp32 rows a block: the launch's rows_a_block
    tiles: int          # bf16 sub-tiles a block

    @property
    def path(self) -> str:
        return path(self.r, self.dr, self.esize)

    @property
    def block_rows(self) -> int:
        """Query rows a block."""
        return TILE * self.tiles if self.path == "mma" else self.rows

    @property
    def row_blocks(self) -> int:
        """Blocks a slot (and a group)."""
        return _ceil(self.H * self.C, self.block_rows)

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
        return (32 * TEAMS * MAX_TILES if self.path == "mma"
                else 32 * self.rows)

    @property
    def smem(self) -> int:
        return smem_bytes(self.r, self.dr, self.esize, self.tiles)

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
    path(r, dr, esize)
    n_groups = _ceil(T, GROUP)
    return Geometry(B, C, H, T, r, dr, esize,
                    rows_a_block(H, C, B, n_groups),
                    tiles_a_block(H, C, B, n_groups))


def walk(rows: int, T: int) -> int:
    """Cache positions a row walks: its ``rows`` clamped to [0, T]."""
    return min(max(rows, 0), T)


def row_of(geo: Geometry, bx: int, i: int):
    """(c, b, h) of row i of block x ``bx`` (of sub-tile i // TILE on the
    mma path), in the kernel's arithmetic (None past the block's rows)."""
    rb, b = bx % geo.row_blocks, bx // geo.row_blocks
    qi = rb * geo.block_rows + i
    if i >= geo.block_rows or qi >= geo.H * geo.C:
        return None
    return qi // geo.H, b, qi % geo.H


def _block_items(geo: Geometry, block, walks, by: int, out) -> None:
    """Group ``by``'s items of one block.  fma: every row walks the spans
    below its walk, (group, span, first position, positions) each.  mma:
    warp (sub-tile, w) runs chunk w of each span below the block's longest
    walk that its sub-tile's longest walk reaches, and each of the
    sub-tile's rows takes the chunk's positions below its own walk:
    (group, w, span, first position, positions)."""
    k = geo.spans_a_group
    s_end = min(by * k + k, _ceil(max(walks), SPAN))
    if geo.path == "fma":
        for row, wk in zip(block, walks):
            for s in range(by * k, s_end):
                if s * SPAN < wk:
                    lo = s * SPAN
                    out.setdefault(row, []).append(
                        (by, s, lo, min(SPAN, wk - lo)))
        return
    for t in range(0, len(block), TILE):
        rows_, walks_ = block[t:t + TILE], walks[t:t + TILE]
        longest = max(walks_)
        for w in range(TEAMS):
            for s in range(by * k, s_end):
                lo = s * SPAN + w * CHUNK
                if lo >= longest:
                    break
                for row, wk in zip(rows_, walks_):
                    if lo < wk:
                        out.setdefault(row, []).append(
                            (by, w, s, lo, min(CHUNK, wk - lo)))


def items(geo: Geometry, rows) -> Dict[Tuple[int, int, int], List[tuple]]:
    """Every item a launch computes, by query row (c, b, h), in the
    kernel's index arithmetic and in the order a row folds them, then
    :data:`SELF`: block (x, y) takes group y's spans below its rows'
    longest walk, and a row the positions below its own (see
    :func:`_block_items` for the items of each path); the row's self fold
    comes from the block of group 0 where its walk is one group at most,
    else from the merge after every group.  ``rows`` is (C, B)."""
    out: Dict[Tuple[int, int, int], list] = {}
    gx, gy = geo.grid
    for bx in range(gx):
        block = [r for r in (row_of(geo, bx, i)
                             for i in range(geo.block_rows))
                 if r is not None]
        walks = [walk(int(rows[c][b]), geo.T) for c, b, _ in block]
        for by in range(gy):
            _block_items(geo, block, walks, by, out)
        for row in block:
            out.setdefault(row, [])
    for row in out:
        out[row].sort()
        out[row].append(SELF)
    return out
