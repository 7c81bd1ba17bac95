"""The tile schedule of the attention backward kernels
(``kernels/flash_attention/plan.py``, the ranges ``flash_attention_bwd.cu``
computes on the card) against the attention mask, on the CPU: the dK/dV
pass walks every (query tile, key tile) pair that keeps an entry exactly
once and no other pair; so does the dQ schedule (fp32: key tiles added in
ascending order, the same on every call; bf16: the dQ pass's key stages);
work items are claimed after every item they wait on; the workspace has a
counter for every ordered sum; and the query tiles whose dQ is written as
zeros (by the prologue in fp32, the dQ pass in bf16) are exactly those
whose rows see no key.  Cases: ``chip_smoke.py``'s
``BWD_CASES`` (read from the script), the card test's cases, and more
windows, ragged edges and head dims above 128."""
import ast
import math
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from _calibration_isolation import isolated_calibration  # noqa: F401

from repro_torch.kernels.flash_attention import plan
from repro_torch.kernels.flash_attention.ref import _mask

ROOT = Path(__file__).resolve().parents[1]


def _bwd_cases():
    """``BWD_CASES`` of chip_smoke.py, read without importing the script."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "BWD_CASES" for t in node.targets):
            return list(ast.literal_eval(node.value))
    raise AssertionError("chip_smoke.py has no BWD_CASES")


#: (B, Hq, Hkv, Sq, Sk, D, Dv, causal, window): tests/test_torch_cuda.py's
#: backward cases, then windows, ragged edges and D > 128 tiles
CASES = _bwd_cases() + [
    (2, 4, 2, 100, 100, 96, 96, True, None),
    (1, 4, 4, 70, 70, 80, 80, False, None),
    (1, 4, 1, 130, 130, 128, 128, True, 48),
    (1, 2, 1, 90, 90, 256, 256, True, 40),
    (1, 2, 2, 65, 65, 200, 200, False, 30),
    (2, 4, 4, 77, 77, 96, 64, True, None),
    (1, 2, 2, 33, 33, 36, 36, True, None),
    (1, 2, 1, 120, 40, 64, 64, False, 16),
    (1, 32, 2, 130, 130, 128, 128, True, None),
    (1, 4, 2, 96, 160, 64, 64, True, None),
    (1, 4, 4, 150, 70, 80, 80, False, None),
    (2, 4, 2, 150, 150, 256, 256, True, 50),
    (1, 4, 2, 130, 100, 96, 96, False, None),
    (1, 1, 1, 1, 1, 16, 16, True, None),
    (1, 2, 1, 300, 300, 192, 192, True, 100),
    (1, 2, 2, 200, 77, 64, 64, False, 30),
    (1, 2, 2, 129, 129, 144, 144, False, 7),
]
IDS = [",".join(map(str, c)) for c in CASES]


def _blocks(case, rows: int, cols: int) -> set:
    """The (query tile, key tile) pairs, ``rows`` x ``cols``, that keep at
    least one entry of the case's mask."""
    _, _, _, sq, sk, _, _, causal, window = case
    m = _mask(sq, sk, causal, window, 0, "cpu")
    return {(i, j) for i in range(math.ceil(sq / rows))
            for j in range(math.ceil(sk / cols))
            if bool(m[i * rows:(i + 1) * rows, j * cols:(j + 1) * cols].any())}


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_dkdv_walk_covers_each_kept_pair_once(case, bf16):
    _, _, _, sq, sk, d, _, causal, window = case
    bq = plan.dkdv_tile(d, bf16)
    pairs = []
    for kt in range(math.ceil(sk / plan.KEY_TILE)):
        tiles = plan.walk(kt, bq, sq, sk, causal, window)
        if tiles:   # the last first, and contiguous
            assert tiles == list(range(tiles[0], tiles[-1] - 1, -1))
        pairs += [(i, kt) for i in tiles]
    assert len(pairs) == len(set(pairs))
    assert set(pairs) == _blocks(case, bq, plan.KEY_TILE)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_fp32_dq_order_is_fixed_and_matches_the_walk(case):
    _, _, _, sq, sk, d, _, causal, window = case
    bq = plan.query_tile(d, False)
    assert bq == plan.dkdv_tile(d, False)    # dQ is summed in the same pass
    walked = {(i, kt) for kt in range(math.ceil(sk / plan.KEY_TILE))
              for i in plan.walk(kt, bq, sq, sk, causal, window)}
    added = set()
    for i in range(math.ceil(sq / bq)):
        order = plan.dq_order(i, bq, sq, sk, causal, window)
        assert order == plan.dq_order(i, bq, sq, sk, causal, window)
        # ascending, and a share's rank (the count it waits for, kt minus
        # the first tile) is its place in the order
        assert order == list(range(order[0], order[0] + len(order))) \
            if order else order == []
        added |= {(i, kt) for kt in order}
    assert added == walked


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bf16_dq_stages_cover_each_kept_pair_once(case):
    _, _, _, sq, sk, d, _, causal, window = case
    width = 32 if d > 128 else plan.KEY_TILE
    pairs = []
    for i in range(math.ceil(sq / plan.DQ_ROWS)):
        stages = plan.dq_stages(i, d, sq, sk, causal, window)
        assert [k0 for k0, _ in stages] == sorted(k0 for k0, _ in stages)
        assert all(k0 % width == 0 and k0 < k1 <= sk for k0, k1 in stages)
        pairs += [(i, k0 // width) for k0, _ in stages]
    assert len(pairs) == len(set(pairs))
    assert set(pairs) == _blocks(case, plan.DQ_ROWS, width)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_items_are_claimed_after_what_they_wait_on(case):
    b, hq, hkv, _, sk, _, _, _, _ = case
    items = plan.items(b, hq, sk)
    nk = math.ceil(sk / plan.KEY_TILE)
    assert sorted(items) == sorted({(kt, bb, h) for kt in range(nk)
                                    for bb in range(b) for h in range(hq)})
    place = {it: n for n, it in enumerate(items)}
    g = hq // hkv
    for kt, bb, h in items:
        if kt > 0:      # the share of dQ before this one
            assert place[(kt - 1, bb, h)] < place[(kt, bb, h)]
        if h % g > 0:   # the head of the group before this one
            assert place[(kt, bb, h - 1)] < place[(kt, bb, h)]
    # the heaviest key tiles of a causal mask first
    assert [kt for kt, _, _ in items] == sorted(kt for kt, _, _ in items)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_workspace_holds_every_ordered_sum(case, bf16):
    b, hq, hkv, sq, sk, d, _, _, _ = case
    ld = d + (-d) % 8 if bf16 else d
    counters, scratch = plan.workspace(b, hq, hkv, sq, sk, d, ld, bf16)
    nk = math.ceil(sk / plan.KEY_TILE)
    kv_sums = 2 * b * hkv * nk          # a dK/dV counter a pass and tile
    q_sums = 0 if bf16 else b * hq * math.ceil(sq / plan.query_tile(d, False))
    assert counters == 2 + kv_sums + q_sums
    # fp32 sums in its outputs; bf16 keeps fp32 dK and dV sums with GQA
    assert scratch == (2 * b * hkv * sk * ld if bf16 and hq > hkv else 0)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tiles_written_as_zeros_are_exactly_those_no_key_reaches(case,
                                                                  bf16):
    _, _, _, sq, sk, d, _, causal, window = case
    bq = plan.query_tile(d, bf16)
    m = _mask(sq, sk, causal, window, 0, "cpu")
    for i in range(math.ceil(sq / bq)):
        kb, ke = plan.key_range(i, bq, sq, sk, causal, window)
        rows = m[i * bq:(i + 1) * bq]
        assert (kb >= ke) == (not bool(rows.any()))
        if kb < ke:     # the keys its rows see, and no others
            seen = rows.any(0).nonzero().flatten()
            assert (int(seen.min()), int(seen.max()) + 1) == (kb, ke)
