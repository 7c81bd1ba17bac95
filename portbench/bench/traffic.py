"""The one traffic generator: a mix file's parameters and a seed in, the
requests of one run out.

A mix's kind (``bench/kinds/<kind>.py``) gives each request's due time;
this module gives its lengths and its prompt.  Lengths are the quantiles
of their distribution, handed out in blocks so that each block of
``block`` consecutive requests takes one length from each of ``block``
strata: any prefix of the stream then carries about the mix's mean work.
The order of the lengths and of the gaps between arrivals is drawn from
the mix's ``order_seed``, the same for every run: which requests share
chunk steps decides the work, so an order drawn from a run's seed would
change the work from seed to seed.  The prompts' token ids follow the
run's seed.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List

import numpy as np

from . import kinds

@dataclass
class Request:
    idx: int
    due: float               # seconds after the window opens
    prompt: List[int]
    max_new: int


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent generator per stream of one seed (any integer)."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def quantile_lengths(spec: Dict[str, Any], n: int) -> np.ndarray:
    """``n`` lengths at the mid-quantiles of ``spec``'s distribution:
    ``log_uniform`` between ``min`` and ``max`` (inclusive, rounded), or
    ``fixed`` at ``value``.  Sorted ascending."""
    if spec["dist"] == "fixed":
        return np.full(n, int(spec["value"]), np.int64)
    if spec["dist"] != "log_uniform":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    lo, hi = math.log(spec["min"]), math.log(spec["max"])
    u = (np.arange(n) + 0.5) / n
    return np.clip(np.rint(np.exp(lo + u * (hi - lo))), spec["min"],
                   spec["max"]).astype(np.int64)


def stratified_order(sorted_vals: np.ndarray, block: int,
                     rng: np.random.Generator) -> np.ndarray:
    """``sorted_vals`` reordered so that each block of ``block`` consecutive
    entries holds one value of each of ``block`` strata (contiguous runs of
    the sorted values), in random order within the block."""
    n = len(sorted_vals)
    block = max(1, min(block, n))
    per = -(-n // block)
    strata = [rng.permutation(sorted_vals[s * per:(s + 1) * per])
              for s in range(block)]
    out = []
    for j in range(per):
        row = [st[j] for st in strata if j < len(st)]
        out.extend(rng.permutation(np.array(row, np.int64)))
    return np.array(out, np.int64)


def poisson_gaps(n: int, rate: float, rng: np.random.Generator
                 ) -> np.ndarray:
    """``n`` gaps at the exponential's mid-quantiles, scaled so they sum to
    ``n / rate``, in the generator's order."""
    u = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-u)
    gaps *= n / rate / gaps.sum()
    return rng.permutation(gaps)


def make_requests(mix: Dict[str, Any], seed: int, seconds: float,
                  vocab: int, max_len: int) -> List[Request]:
    """The requests of one run of ``mix`` with ``seed``: the same seed gives
    the same requests.  Every prompt plus its output fits ``max_len``."""
    order = int(mix["order_seed"])
    due = kinds.load(mix["kind"]).due(mix, seconds, rng_for(order, 0))
    n = len(due)
    block = int(mix.get("block", 16))
    prompts = stratified_order(quantile_lengths(mix["prompt_tokens"], n),
                               block, rng_for(order, 1))
    outs = stratified_order(quantile_lengths(mix["output_tokens"], n),
                            block, rng_for(order, 2))
    if int((prompts + outs).max()) > max_len:
        raise ValueError(f"a request of the mix needs "
                         f"{int((prompts + outs).max())} positions; the "
                         f"cache holds {max_len}")
    ids = rng_for(seed, 3).integers(0, vocab, size=int(prompts.sum()))
    cuts = np.concatenate([[0], np.cumsum(prompts)])
    return [Request(i, float(due[i]), ids[cuts[i]:cuts[i + 1]].tolist(),
                    int(outs[i])) for i in range(n)]
