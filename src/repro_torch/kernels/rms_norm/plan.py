"""The launch geometry of ``csrc/rms_norm.cu``, on the host.

A row of d elements is read once, in vectors of :func:`vec` elements (16
bytes where d allows, else one element), vector j by thread j % t of the
row's t = :func:`threads_a_row` threads, each holding at most
:data:`TARGET_VECS` vectors (:data:`MAX_VECS` at 1024 threads) in
registers between the sum and the scale.  t is a function of (d, dtype)
alone, so a row's sum order (each thread's vectors in order, a butterfly
in each warp, the row's warps in order) never depends on how many rows run
with it.  A block holds :func:`rows_a_block` rows of
:data:`BLOCK_THREADS` threads (one when a row takes more)."""
from __future__ import annotations

#: vectors a thread, where the threads allow
TARGET_VECS = 2
#: vectors a thread at most
MAX_VECS = 8
#: bytes of one load
LOAD_BYTES = 16
#: threads a block when a row takes fewer
BLOCK_THREADS = 256
#: threads a row: powers of two from 32 to 1024
ROW_THREADS = (32, 64, 128, 256, 512, 1024)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def vec(d: int, esize: int) -> int:
    """Elements a load: 16 bytes when d is a multiple of them, else 1."""
    n = LOAD_BYTES // esize
    return n if d % n == 0 else 1


def threads_a_row(d: int, esize: int) -> int:
    """Threads a row: the fewest of :data:`ROW_THREADS` that give a thread
    at most :data:`TARGET_VECS` vectors, or 1024; raises where a thread
    would need more than :data:`MAX_VECS`."""
    nvec = d // vec(d, esize)
    t = next((t for t in ROW_THREADS if _ceil(nvec, t) <= TARGET_VECS),
             ROW_THREADS[-1])
    if _ceil(nvec, t) > MAX_VECS:
        raise ValueError(f"rms_norm kernel takes rows of at most "
                         f"{ROW_THREADS[-1] * MAX_VECS} vectors, got d={d}")
    return t


def rows_a_block(d: int, esize: int) -> int:
    """Rows a block: :data:`BLOCK_THREADS` threads' worth, at least one."""
    return max(1, BLOCK_THREADS // threads_a_row(d, esize))


def elements(d: int, esize: int):
    """The row elements each thread of a row reads, in its order: thread
    i takes vectors i, i + t, ... (t threads a row)."""
    n, t = vec(d, esize), threads_a_row(d, esize)
    return [[j * n + e for j in range(i, d // n, t) for e in range(n)]
            for i in range(t)]
