"""The yardstick of work: one H100's peaks, and the operations and bytes
that a step's products and attention need, counted from the
configuration's shapes and the harness's own record of which slots took
how many columns at which cache length.

Peaks (NVIDIA's data sheet for the H100 SXM, dense, at 700 W): 989e12
FLOP/s in bf16 on the tensor cores, 67e12 in float32 outside them, HBM at
3.35e12 B/s.  A call's bound is max(operations / peak at its dtype,
bytes / HBM bandwidth), each input byte counted once and each output byte
once.  Only the rows that carry a request's column are counted (the work
the traffic needs); a masked row the program also computes is not.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Tuple

from portbench.reference import family

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BW = 3.35e12
BYTES = {"bfloat16": 2, "float32": 4}

Cols = List[Tuple[int, int]]


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BW)


def products(cfg: Dict[str, Any]) -> List[Tuple[int, int, str]]:
    """(K, N, dtype) of each ``queue_matmul`` product of one layer of a
    step's body, as the configuration's family states them."""
    return family(cfg).products(cfg)


def matmul_bound(M: int, K: int, N: int, dtype: str) -> float:
    b = BYTES[dtype]
    return bound_s(2.0 * M * K * N, b * (K * N + M * K + M * N), dtype)


def queue_matmul_bound(cfg: Dict[str, Any], cols: Cols) -> float:
    """Seconds the step's ``queue_matmul`` calls need at least: every
    layer's products over the step's columns, and the head over one row a
    slot."""
    if not cols:
        return 0.0
    rows = sum(k for _, k in cols)
    body = sum(matmul_bound(rows, K, N, dt) for K, N, dt in products(cfg))
    head = matmul_bound(len(cols), cfg["d_model"], cfg["vocab"],
                        cfg["dtype"])
    return cfg["n_layers"] * body + head


def attended(cols: Cols) -> Iterable[Tuple[int, int]]:
    """(rows of the slot's cache read, query-row pairs) a slot: column j of
    a slot at length ``n`` attends positions [0, n + j]."""
    for n, k in cols:
        yield n + k, sum(n + j + 1 for j in range(k))


def decode_attention_bound(cfg: Dict[str, Any], cols: Cols) -> float:
    """Seconds the step's ``decode_attention`` calls need at least: each
    slot's K and V rows up to its last column read once, its queries read
    and outputs written once, and 4 hd operations a (query head, position)
    pair; one call a layer."""
    hd, H, Hkv = cfg["head_dim"], cfg["n_heads"], cfg["n_kv_heads"]
    b = BYTES[cfg["dtype"]]
    flops = nbytes = 0.0
    for (rows, pairs), (_, k) in zip(attended(cols), cols):
        flops += 4.0 * hd * H * pairs
        nbytes += b * (2 * rows * Hkv * hd + 2 * k * H * hd)
    return cfg["n_layers"] * bound_s(flops, nbytes, cfg["dtype"])


def model_flops(cfg: Dict[str, Any], cols: Cols) -> float:
    """The model's operations for a step's columns: each token's products
    and its attention over its context, and the head once a slot."""
    fam = family(cfg)
    tokens = sum(k for _, k in cols)
    pairs = sum(p for _, p in attended(cols))
    return (cfg["n_layers"] * (tokens * fam.token_flops(cfg)
                               + pairs * fam.pair_flops(cfg))
            + len(cols) * 2.0 * cfg["d_model"] * cfg["vocab"])
