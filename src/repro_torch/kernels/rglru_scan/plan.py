"""The launch geometry of ``csrc/rglru_scan.cu``'s reverse walk, on the host.

A block of the reverse walk holds ``tile`` neighbouring channels of one
batch row, one a lane, and ``chunks`` chunks of :data:`STEPS` logical steps
(s = T-1-t), one a thread: thread ``tid`` holds channel ``tid % tile`` of
chunk ``tid // tile``.  The block walks T in segments of ``chunks * STEPS``
steps; in the carry, thread ``tid`` holds chunk ``tid % chunks`` of channel
``tid // chunks``, so a channel's chunks are neighbouring lanes of one warp.
The grid is (``tiles``, B).

:func:`geometry` sizes the launch from B w, T and the residency the compiled
kernel gets: the widest tile of :data:`TILES` that gives each SM a block,
as many chunks as T needs (a power of two, at most a warp's lanes and
:data:`MAX_THREADS` threads), halved while the grid needs more than one
wave, down to a segment of :data:`MIN_SEGMENT` steps.  The kernel's launch
(``bwd_geometry``) computes the same ranges on the card, and
``rglru_scan_bwd_geometry`` reports them; this module is what the CPU tests
hold to the index space (every (b, t, channel) exactly once) and, at the
residency the launch bound guarantees (:func:`bound_resident`), to one
wave at recurrentgemma's training shape on an H100."""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np

#: logical steps a chunk (a thread)
STEPS = 8
#: threads a block at most (the kernel's launch bound)
MAX_THREADS = 512
#: chunks a segment at most: a channel's chunks fit one warp
MAX_CHUNKS = 32
#: the shortest segment the halving goes down to, in steps
MIN_SEGMENT = 64
#: channel tiles, widest first
TILES = (32, 16, 8)
#: the SMs of an H100
H100_SMS = 132


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class Geometry:
    """One launch: ``tile`` channels by ``chunks`` chunks a block, ``tiles``
    tiles a batch row, ``resident`` such blocks an SM on ``sms`` SMs."""
    B: int
    T: int
    w: int
    tile: int
    chunks: int
    tiles: int
    resident: int
    sms: int

    @property
    def threads(self) -> int:
        return self.tile * self.chunks

    @property
    def blocks(self) -> int:
        return self.tiles * self.B

    @property
    def segment(self) -> int:
        """Logical steps a segment."""
        return self.chunks * STEPS

    @property
    def segments(self) -> int:
        return _ceil(self.T, self.segment)

    @property
    def waves(self) -> int:
        return _ceil(self.blocks, self.sms * self.resident)


def geometry(B: int, T: int, w: int, sms: int,
             resident: Callable[[int], int]) -> Geometry:
    """The reverse walk's launch for (B, T, w) on ``sms`` SMs, where
    ``resident(threads)`` is how many blocks of that many threads fit an
    SM (the card's occupancy query, or :func:`bound_resident`)."""
    tile = TILES[0]
    for tile in TILES:
        if B * _ceil(w, tile) >= sms:
            break
    tiles = _ceil(w, tile)
    need = _ceil(T, STEPS)
    chunks = 1
    while chunks < need and chunks < MAX_CHUNKS and \
            tile * chunks < MAX_THREADS:
        chunks *= 2
    while tile * chunks < 32:
        chunks *= 2
    least = max(32 // tile, min(MIN_SEGMENT // STEPS, chunks))
    while True:
        r = resident(tile * chunks)
        if chunks <= least or tiles * B <= sms * r:
            break
        chunks //= 2
    return Geometry(B, T, w, tile, chunks, tiles, r, sms)


def bound_resident(threads: int) -> int:
    """Blocks of ``threads`` threads an SM that the kernel's launch bound
    guarantees: ``__launch_bounds__(MAX_THREADS)`` holds ptxas to the
    registers that let one block of :data:`MAX_THREADS` fit an SM, so
    ``MAX_THREADS // threads`` blocks of fewer threads fit too.  The card's
    occupancy query may report more; the launch uses that."""
    return MAX_THREADS // threads


def elements(geo: Geometry) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(b, t, channel) of every element the launch writes, one entry per
    (block, thread, segment, step) that passes the kernel's guards, in the
    kernel's index arithmetic."""
    tid = np.arange(geo.threads)
    lane_c, j = tid % geo.tile, tid // geo.tile
    x, b, seg, u, th = np.meshgrid(np.arange(geo.tiles), np.arange(geo.B),
                                   np.arange(geo.segments), np.arange(STEPS),
                                   np.arange(geo.threads), indexing="ij")
    c = x * geo.tile + lane_c[th]
    s = seg * geo.segment + j[th] * STEPS + u
    live = (c < geo.w) & (s < geo.T)
    return b[live], (geo.T - 1 - s)[live], c[live]


def carry_lanes(geo: Geometry) -> Tuple[np.ndarray, np.ndarray]:
    """(chunk, channel) each thread holds in the carry, by thread."""
    tid = np.arange(geo.threads)
    return tid % geo.chunks, tid // geo.chunks
