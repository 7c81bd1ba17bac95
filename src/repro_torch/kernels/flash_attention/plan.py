"""The tile schedule of ``csrc/flash_attention_bwd.cu``, on the host.

The backward kernels cut keys into tiles of :data:`KEY_TILE`.  dK and dV:
a work item is one (key tile, batch row, query head); blocks claim items in
the order :func:`items` gives, and an item walks, from the last to the
first, the query tiles of :func:`dkdv_tile` rows that see its keys
(:func:`walk`).  A GQA group's heads add their dK and dV in head order.
dQ: in fp32 the same pass adds each (query tile, key tile)'s share in the
order :func:`dq_order` gives, key tile ascending; in bf16 a pass of its
own walks, for each query tile of :data:`DQ_ROWS` rows, the key stages of
:func:`dq_stages`.  A counter per sum says how many shares have landed;
:func:`workspace` sizes the counters and the fp32 sums the wrapper
allocates, and the launch checks them.

The kernels compute the same ranges on the card; this module is what the
CPU tests hold to the attention mask (every tile pair that keeps an entry
is walked exactly once, and no other pair)."""
from __future__ import annotations

from typing import List, Tuple

#: keys a work item (and a tile of the dK/dV sums)
KEY_TILE = 64
#: query rows a block of the bf16 dQ pass
DQ_ROWS = 64


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def dkdv_tile(D: int, bf16: bool) -> int:
    """Query rows a stage of the dK/dV pass: bf16 64 (32 at D > 128, to
    keep dK and dV in registers); fp32 64, 32 or 16 as D grows to 64, 128
    or 256 (its K, V and two stages of Q and dO in shared memory)."""
    if bf16:
        return 32 if D > 128 else 64
    return 64 if D <= 64 else (32 if D <= 128 else 16)


def query_tile(D: int, bf16: bool) -> int:
    """Query rows a tile of the pass that writes dQ (fp32: the rows the
    prologue zeroes when no key tile sees them)."""
    return DQ_ROWS if bf16 else dkdv_tile(D, False)


def key_range(i: int, bq: int, Sq: int, Sk: int, causal: bool,
              window) -> Tuple[int, int]:
    """The keys [kb, ke) that some row of query tile ``i`` (``bq`` rows)
    sees (row r sees (r - window, r] causal, (r - window, Sk) not); (0, 0)
    when no row of it sees a key."""
    q0 = i * bq
    q_last = min(q0 + bq, Sq) - 1
    k_end = min(Sk, q_last + 1) if causal else Sk
    k_begin = max(0, q0 - window + 1) if window is not None else 0
    if q0 >= Sq or k_begin >= k_end:
        return 0, 0
    return k_begin, k_end


def key_tiles(i: int, bq: int, Sq: int, Sk: int, causal: bool,
              window) -> Tuple[int, int]:
    """The key tiles [tb, te) that some row of query tile ``i`` sees."""
    kb, ke = key_range(i, bq, Sq, Sk, causal, window)
    return kb // KEY_TILE, _ceil(ke, KEY_TILE)


def walk(kt: int, bq: int, Sq: int, Sk: int, causal: bool,
         window) -> List[int]:
    """The query tiles (of ``bq`` rows) key tile ``kt``'s items walk, in
    their order (the last first)."""
    tiles = []
    for i in range(_ceil(Sq, bq)):
        tb, te = key_tiles(i, bq, Sq, Sk, causal, window)
        if tb <= kt < te:
            tiles.append(i)
    return tiles[::-1]


def items(B: int, Hq: int, Sk: int) -> List[Tuple[int, int, int]]:
    """The work items (key tile, batch row, query head) in claim order: key
    tile first (a causal mask's heaviest first), then batch row, then head,
    so a group's heads are neighbours and every item an item waits on is
    claimed before it."""
    return [(kt, b, h) for kt in range(_ceil(Sk, KEY_TILE))
            for b in range(B) for h in range(Hq)]


def dq_order(i: int, bq: int, Sq: int, Sk: int, causal: bool,
             window) -> List[int]:
    """fp32: the key tiles whose shares of query tile ``i``'s dQ are
    added, in the order they are added (the rank of each is its place)."""
    return list(range(*key_tiles(i, bq, Sq, Sk, causal, window)))


def dq_stages(i: int, D: int, Sq: int, Sk: int, causal: bool,
              window) -> List[Tuple[int, int]]:
    """bf16: the key ranges [k0, k1) of the tiles the dQ pass walks for
    query tile ``i`` of :data:`DQ_ROWS` rows, in order: tiles of 64 keys
    (32 at D > 128) over the keys its rows see (none for a tile no key
    reaches, whose dQ the pass writes as zeros)."""
    width = 32 if D > 128 else KEY_TILE
    kb, ke = key_range(i, DQ_ROWS, Sq, Sk, causal, window)
    return [(t * width, min(Sk, (t + 1) * width))
            for t in range(kb // width, _ceil(ke, width))]


def workspace(B: int, Hq: int, Hkv: int, Sq: int, Sk: int, D: int, ld: int,
              bf16: bool) -> Tuple[int, int]:
    """(int32 counters, fp32 scratch floats) of one call: two work
    counters, one dK/dV counter a (batch, KV head, key tile) for each of
    the (up to two) dK/dV passes and, for fp32, one dQ counter a (batch,
    head, query tile); for bf16 with GQA the fp32 dK and dV sums
    (B, Hkv, Sk, ld) each.  fp32 sums in its outputs."""
    nk = _ceil(Sk, KEY_TILE)
    counters = 2 + 2 * B * Hkv * nk
    if not bf16:
        counters += B * Hq * _ceil(Sq, query_tile(D, False))
    scratch = 2 * B * Hkv * Sk * ld if bf16 and Hq > Hkv else 0
    return counters, scratch
