"""The one traffic generator: the same seed gives the same requests, every
seed the same sizes in the same order, bursts
and kinds as the mix file states them, and every request fits the
cache."""
import numpy as np
import pytest

from portbench.bench import kinds, manifest
from portbench.bench.traffic import (make_requests, poisson_gaps,
                                     quantile_lengths)

SEEDS = (0, 7, 2**31 + 12345, 2**33 + 1)


@pytest.mark.parametrize("cell", ["phi3-chat-poisson", "olmoe-decode-batch"])
def test_same_seed_same_requests(cell):
    c = manifest.load_cell(cell)
    srv, vocab = c.config["serving"], c.config["vocab"]
    a = make_requests(c.traffic, SEEDS[2], 30, vocab, srv["max_len"])
    b = make_requests(c.traffic, SEEDS[2], 30, vocab, srv["max_len"])
    assert [(r.due, r.prompt, r.max_new) for r in a] == \
        [(r.due, r.prompt, r.max_new) for r in b]


@pytest.mark.parametrize("cell", ["phi3-chat-poisson", "olmoe-decode-batch"])
def test_every_seed_same_sizes(cell):
    c = manifest.load_cell(cell)
    srv, vocab = c.config["serving"], c.config["vocab"]
    mix = c.traffic
    sizes = None
    for seed in SEEDS:
        reqs = make_requests(mix, seed, 30, vocab, srv["max_len"])
        got = (sorted(len(r.prompt) for r in reqs),
               sorted(r.max_new for r in reqs),
               np.round(sorted(np.diff([r.due for r in reqs])), 9).tolist())
        sizes = sizes or got
        assert got == sizes
        for r in reqs:
            assert len(r.prompt) + r.max_new <= srv["max_len"]
            assert mix["prompt_tokens"]["min"] <= len(r.prompt) <= \
                mix["prompt_tokens"]["max"]
            assert all(0 <= t < vocab for t in r.prompt[:64])
        if mix["kind"] == "poisson_open":
            assert reqs[0].due == 0 and reqs[-1].due < 30
            assert len(reqs) == int(mix["rate_per_s"] * 30)


def test_any_prefix_carries_the_mean():
    """Stratified blocks: each block of 16 takes one length from each of 16
    strata, so a window's first requests carry about the mix's work."""
    c = manifest.load_cell("olmoe-decode-batch")
    reqs = make_requests(c.traffic, 3, 30, 50304, 2304)
    mean = np.mean([r.max_new for r in reqs])
    for k in (32, 64):
        assert abs(np.mean([r.max_new for r in reqs[:k]]) / mean - 1) < 0.1


def test_lengths_and_gaps():
    spec = {"dist": "log_uniform", "min": 256, "max": 2048}
    q = quantile_lengths(spec, 1000)
    assert q.min() >= 256 and q.max() <= 2048
    assert abs(q.mean() - 1792 / np.log(8)) < 10
    gaps = poisson_gaps(100, 5.0, np.random.default_rng(0))
    assert abs(gaps.sum() - 100 / 5.0) < 1e-9
    with pytest.raises(ValueError):
        make_requests({"kind": "closed_batch", "pool": 4, "order_seed": 0,
                       "prompt_tokens": spec,
                       "output_tokens": {"dist": "fixed", "value": 200}},
                      0, 1, 100, 1000)


@pytest.mark.parametrize("cell", ["phi3-chat-poisson", "olmoe-decode-batch"])
def test_a_fixed_order_leaves_only_the_tokens_to_the_seed(cell):
    """Every seed gets the same lengths and arrivals in the same order (the
    mix's ``order_seed``), and its own prompts' token ids."""
    c = manifest.load_cell(cell)
    srv, vocab = c.config["serving"], c.config["vocab"]
    runs = [make_requests(c.traffic, s, 30, vocab, srv["max_len"])
            for s in SEEDS]
    shapes = {tuple((r.due, len(r.prompt), r.max_new) for r in reqs)
              for reqs in runs}
    assert len(shapes) == 1
    assert len({tuple(reqs[0].prompt) for reqs in runs}) == len(SEEDS)
    orders = {tuple(r.max_new for r in make_requests(
        dict(c.traffic, order_seed=s), 0, 30, vocab, srv["max_len"]))
        for s in SEEDS}
    assert len(orders) == len(SEEDS)


def test_bursts_share_a_due_time():
    mix = {"kind": "poisson_open", "rate_per_s": 4.0, "burst": 8,
           "order_seed": 0,
           "prompt_tokens": {"dist": "fixed", "value": 8},
           "output_tokens": {"dist": "fixed", "value": 4}}
    reqs = make_requests(mix, 5, 30, 100, 64)
    assert len(reqs) == 120
    starts = sorted({r.due for r in reqs})
    assert len(starts) == 15 and reqs[-1].due < 30
    for t in starts:
        assert sum(r.due == t for r in reqs) == 8
    single = make_requests(dict(mix, burst=1), 5, 30, 100, 64)
    assert len({r.due for r in single}) == 120


def test_kinds_are_found_by_name():
    for kind in ("poisson_open", "closed_batch"):
        mod = kinds.load(kind)
        assert all(callable(getattr(mod, f)) for f in
                   ("due", "drive", "failed"))
    with pytest.raises(ValueError):
        kinds.load("no_such_kind")
