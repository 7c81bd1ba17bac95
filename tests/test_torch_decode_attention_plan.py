"""The decomposition of the two row-wise kernels of the serve bodies, on the
CPU: ``decode_attention``'s split over the cache length
(``kernels/decode_attention/plan.py``, mirrored by
``csrc/decode_attention.cu``) and ``rms_norm``'s threads a row
(``kernels/rms_norm/plan.py``, mirrored by ``csrc/rms_norm.cu``).

* Every visible position of every query row falls in exactly one work item
  (span, warp), at lengths on and either side of a span's and a sub-span's
  edge, 0 (all T positions) and past T, whatever the launch.
* A row's work items are the same whatever B, C, G and T run with it.
* The shared memory of a block fits an H100 at every head dim the models
  use, in both dtypes; the grid stays inside CUDA's limits at a 4K context
  and at a 128K cache of 64 slots.
* The sources use the plans' constants.
* The split's arithmetic — partials per warp and span, merged in warp and
  then span order — emulated in plain PyTorch, agrees with the plain rows
  version and with the JAX ``decode_attention_ref`` within 2e-4 in fp32.
* ``rms_norm``'s threads a row are a function of d alone, read each element
  exactly once, and hold a row in at most ``MAX_VECS`` vectors a thread.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _calibration_isolation import isolated_calibration  # noqa: F401

import jax.numpy as jnp

from repro.models.attention import decode_attention_ref as jax_decode_ref
from repro_torch.kernels.decode_attention import plan
from repro_torch.kernels.decode_attention.ref import decode_attention_rows_ref
from repro_torch.kernels.rms_norm import plan as norm_plan

ROOT = Path(__file__).resolve().parents[1]
KERNELS = ROOT / "src" / "repro_torch" / "kernels"
SOURCE = KERNELS / "decode_attention" / "csrc" / "decode_attention.cu"
NORM_SOURCE = KERNELS / "rms_norm" / "csrc" / "rms_norm.cu"

#: the head dims of the served and reduced models
HEAD_DIMS = (8, 16, 64, 80, 96, 128, 192, 256)
ESIZES = (4, 2)

#: (B, C, Hq, Hkv, T, D, esize, the slots' first-column lengths): a decode
#: step, chunks, a GQA group of 16, D 256 and fp32 D 192 (32-position
#: spans), lengths at and either side of 16, 64 and 128, 0 and past T
SHAPES = [
    (4, 1, 32, 32, 256, 96, 2, (40, 17, 33, 8)),
    (4, 8, 4, 4, 256, 96, 2, (63, 0, 64, 200)),
    (3, 5, 32, 2, 300, 128, 2, (15, 16, 299)),
    (2, 3, 10, 1, 200, 256, 2, (127, 128)),
    (2, 4, 6, 3, 600, 192, 4, (31, 300)),
    (1, 16, 2, 2, 65, 16, 4, (0,)),
    (2, 2, 4, 2, 96, 8, 4, (95, 500)),
]


def _valid(C, B, T, lens):
    """(C, B) int lengths: slot b's column c sees lens[b] + c (a length 0
    stays 0 in column 0, and lengths may run past T)."""
    base = np.asarray(lens)[None]
    return base + np.arange(C)[:, None]


def _geo(B, C, Hq, Hkv, T, D, esize):
    return plan.geometry(B, C, Hq, Hkv, T, D, esize)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(
    map(str, s[:7])))
def test_every_visible_position_falls_in_exactly_one_work_item(shape):
    B, C, Hq, Hkv, T, D, esize, lens = shape
    geo = _geo(B, C, Hq, Hkv, T, D, esize)
    valid = _valid(C, B, T, lens)
    items = plan.items(geo, valid)
    span, sub = plan.span(D, esize), plan.sub_span(D, esize)
    assert set(items) == {(c, b, hq) for c in range(C) for b in range(B)
                          for hq in range(Hq)}
    for (c, b, hq), work in items.items():
        wk = plan.walk(int(valid[c][b]), T)
        seen = np.zeros(T, int)
        for s, w, lo, n in work:
            assert lo == s * span + w * sub and 0 <= n <= sub
            seen[lo:lo + n] += 1
        assert (seen[:wk] == 1).all() and (seen[wk:] == 0).all()
        # each span below the walk once, by the whole team, in span order
        spans = [s for s, w, _, _ in work]
        assert spans == sorted(spans)
        assert sorted(set(spans)) == list(range(-(-wk // span)))
        assert all(spans.count(s) == plan.WARPS for s in set(spans))


@pytest.mark.parametrize("walk_len", [1, 15, 16, 17, 63, 64, 65, 128, 250])
def test_a_rows_work_ignores_B_C_G_and_T(walk_len):
    """The same query row — its length, D and dtype fixed — placed among
    other slots, columns and GQA groups of other sizes, over caches of
    other lengths, gets the same (span, warp, positions) items."""
    seen = set()
    for B, C, Hq, Hkv, T in [(1, 1, 1, 1, 256), (4, 8, 32, 32, 256),
                             (3, 16, 32, 2, 4096), (2, 5, 96, 8, 300),
                             (64, 1, 10, 1, 260)]:
        valid = np.full((C, B), 7)
        c, b = C - 1, B - 1
        valid[c, b] = walk_len
        for D, esize in ((96, 2), (192, 4)):
            geo = _geo(B, C, Hq, Hkv, T, D, esize)
            items = plan.items(geo, valid)
            seen.add((D, esize, tuple(items[(c, b, Hq - 1)])))
    assert len(seen) == 2


@pytest.mark.parametrize("esize", ESIZES)
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_shared_memory_fits_an_h100(D, esize):
    assert plan.takes(D, esize)
    assert plan.smem_bytes(D, esize, plan.MAX_ROWS) <= plan.SMEM_LIMIT
    # a span's K and V tiles are whole 16-byte copies
    assert plan.span(D, esize) * D * esize % plan.COPY_BYTES == 0
    assert plan.span(D, esize) % (plan.WARPS * 32 // plan.LANES_A_POSITION
                                  ) == 0


@pytest.mark.parametrize("shape", [
    (4, 1, 32, 32, 4096, 96, 2),      # phi3 4k decode
    (4, 8, 32, 32, 4096, 96, 2),      # phi3 4k chunk
    (3, 1, 32, 2, 4096, 128, 2),      # glm4 4k decode
    (64, 16, 96, 8, 131072, 192, 2),  # 64 slots of a 128K cache, nemotron
    (64, 16, 32, 2, 131072, 128, 4),  # glm4's group of 16, fp32
    (4, 8, 32, 32, 256, 96, 2),       # the served engines' 256 rows
])
def test_the_grid_stays_inside_cudas_limits(shape):
    geo = _geo(*shape)
    gx, gy = geo.grid
    assert 1 <= gx <= plan.GRID_LIMITS[0] and 1 <= gy <= plan.GRID_LIMITS[1]
    assert gy * geo.spans_a_group >= geo.n_spans
    assert geo.spans_a_group * geo.span == plan.GROUP
    assert 1 <= geo.rows <= plan.MAX_ROWS
    assert geo.row_blocks * geo.rows >= geo.G * geo.C
    assert geo.threads <= 32 * plan.WARPS * plan.MAX_TEAMS
    # each thread folds at most four (row, dim) items
    assert geo.rows * geo.D <= 4 * geo.threads
    # a (query row, group) partial each, read by the merge
    assert geo.merges == (geo.T > plan.GROUP)
    assert geo.work_floats == (geo.C * geo.B * geo.Hq * geo.n_groups
                               * (geo.D + 2) if geo.merges else 0)


def test_the_grid_is_sized_from_T_not_from_valid():
    """The geometry takes the shapes only, never the lengths, so a launch
    over one cache keeps one geometry (a CUDA graph's node); a longer T
    adds groups; the served engines' 256-row caches are one group (no
    merge launch)."""
    import inspect
    assert "valid" not in inspect.signature(plan.geometry).parameters
    a = _geo(4, 8, 32, 32, 256, 96, 2)
    b = _geo(4, 8, 32, 32, 4096, 96, 2)
    assert (a.n_groups, b.n_groups) == (1, 16)
    assert not a.merges and b.merges
    assert b.n_spans == 4096 // plan.span(96, 2)


@pytest.mark.parametrize("shape,rows", [
    ((4, 1, 32, 32, 256, 96), 1),      # phi3's decode: one row a pair
    ((4, 8, 32, 32, 256, 96), 4),      # phi3's chunk: 256 blocks of 4
    ((4, 8, 32, 32, 4096, 96), 8),     # the same at 4K: 2048 blocks of 8
    ((3, 8, 32, 2, 128, 128), 2),      # glm4's chunk: 384 blocks of 2
    ((4, 1, 10, 1, 256, 256), 1),      # recurrentgemma's decode: 40 rows
    ((4, 8, 96, 8, 256, 192), 8),      # nemotron's chunk: 384 blocks
    ((3, 1, 32, 2, 4096, 128), 4),     # glm4 at 4K: 16 groups
    ((1, 1, 16, 1, 256, 64), 1),       # one pair of 16 rows: 16 blocks
])
def test_a_block_takes_fewer_rows_where_the_launch_would_be_small(shape,
                                                                   rows):
    """G x C rows a block up to MAX_ROWS, halved while the launch would
    have fewer than MIN_BLOCKS blocks, down to one (a launch choice: a
    row's work is the same either way)."""
    geo = _geo(*shape, 2)
    assert geo.rows == rows
    blocks = geo.grid[0] * geo.grid[1]
    assert blocks >= plan.MIN_BLOCKS or rows == 1
    if rows < min(plan.MAX_ROWS, geo.G * geo.C):
        wider = -(-geo.G * geo.C // (2 * rows)) * geo.B * geo.Hkv
        assert wider * geo.n_groups < plan.MIN_BLOCKS


def _constants(path):
    src = path.read_text()
    return src, {m[1]: int(m[2]) for m in re.finditer(
        r"constexpr int (k\w+) = (\d+)[;,]", src)} | {
        m[1]: int(m[2]) for m in re.finditer(r", (k\w+) = (\d+);", src)}


def test_the_attention_kernel_uses_the_plan_constants():
    src, const = _constants(SOURCE)
    assert const["kWarps"] == plan.WARPS
    assert const["kLanesAPosition"] == plan.LANES_A_POSITION
    assert const["kMaxSpan"] == plan.MAX_SPAN
    assert const["kSpanRowBytes"] == plan.SPAN_ROW_BYTES
    assert const["kGroup"] == plan.GROUP
    assert const["kMaxRows"] == plan.MAX_ROWS
    assert const["kMaxTeams"] == plan.MAX_TEAMS
    assert const["kStages"] == plan.STAGES
    assert const["kCopyBytes"] == plan.COPY_BYTES
    assert const["kMaxD"] == plan.MAX_D
    # plan.span's and plan.teams's rules, and plan.smem_bytes's terms
    assert "D * esize <= kSpanRowBytes ? kMaxSpan : kMaxSpan / 2" in src
    assert "rows < kMaxTeams ? rows : kMaxTeams" in src
    assert "kStages) * 2 * span_of(D, esize)" in src
    assert "rows) * kWarps * (D + 2)" in src
    assert "cp.async.wait_group" in src and "cp_async16" in src
    assert "__launch_bounds__(kMaxThreads," in src
    assert "32 * kWarps * kMaxTeams" in src


def test_the_norm_kernel_uses_the_plan_constants():
    src, const = _constants(NORM_SOURCE)
    assert const["kTargetVecs"] == norm_plan.TARGET_VECS
    assert const["kMaxVecs"] == norm_plan.MAX_VECS
    assert const["kLoadBytes"] == norm_plan.LOAD_BYTES
    assert const["kBlockThreads"] == norm_plan.BLOCK_THREADS
    assert const["kMinRowThreads"] == norm_plan.ROW_THREADS[0]
    assert const["kMaxRowThreads"] == norm_plan.ROW_THREADS[-1]
    assert "kTargetVecs) t *= 2" in src


# ---------------------------------------------------------------------------
# the split's arithmetic, emulated
# ---------------------------------------------------------------------------

def split_attention(q, k, v, valid):
    """The kernel's arithmetic in plain PyTorch, fp32: scores in the log2
    domain, each (row, span, warp)'s partial max, sum and weighted V over
    its sub-span; within a 256-position group the spans folded into a
    running partial in span order (each span's warps in warp order); a
    row's groups merged in group order (the max first).  q (C, B, Hq, D),
    caches (B, Hkv, T, D), valid (C, B)."""
    C, B, Hq, D = q.shape
    _, Hkv, T, _ = k.shape
    G = Hq // Hkv
    span = plan.span(D, q.element_size())
    sub = plan.sub_span(D, q.element_size())
    n_spans = -(-T // span)
    pad = n_spans * span - T
    kp = torch.nn.functional.pad(k.float(), (0, 0, 0, pad))
    vp = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))
    qg = q.float().reshape(C, B, Hkv, G, 1, D)
    scale = 1.0 / math.sqrt(D) * 1.4426950408889634
    s = (qg * kp[None, :, :, None]).sum(-1) * scale    # (C, B, Hkv, G, P)
    vis = torch.as_tensor(valid).clamp(max=T)
    walk = torch.where(vis > 0, vis, torch.full_like(vis, T))
    pos = torch.arange(n_spans * span)
    sel = pos < walk[..., None]                        # (C, B, P)
    # a visible position's score, the plain version's -1e30 for a row that
    # sees none, and -inf (no weight) past the row's walk
    s = torch.where((pos < vis[..., None])[:, :, None, None], s,
                    torch.tensor(-1e30))
    s = torch.where(sel[:, :, None, None], s, torch.tensor(-math.inf))
    shape = s.shape[:-1] + (n_spans, plan.WARPS, sub)
    s = s.reshape(shape)
    vt = vp.reshape(B, Hkv, n_spans, plan.WARPS, sub, D)
    m_w = s.amax(-1)                                   # (..., S, W)
    empty = torch.isinf(m_w)
    p = torch.exp2(s - torch.where(empty, 0.0, m_w)[..., None])
    p = torch.where(torch.isinf(s), 0.0, p)
    l_w = torch.zeros_like(m_w)
    for i in range(sub):                                # pass order
        l_w = l_w + p[..., i]
    acc_w = torch.zeros(shape[:-1] + (D,))
    for i in range(sub):                                # position order
        acc_w = acc_w + p[..., i, None] * vt[None, :, :, None, :, :, i]
    # within a group, each span's warp partials folded into the running
    # partial in span order, warp order within the span
    per = plan.GROUP // span
    n_groups = -(-n_spans // per)
    lead = m_w.shape[:-2]                               # (C, B, Hkv, G)
    M = torch.full(lead + (n_groups,), -math.inf)
    L = torch.zeros(lead + (n_groups,))
    A = torch.zeros(lead + (n_groups, D))
    for j in range(n_spans):
        g = j // per
        live = ~torch.isinf(m_w[..., j, 0])             # the row reaches j
        m = torch.maximum(M[..., g], m_w[..., j, :].amax(-1))
        m0 = torch.where(live, m, 0.0)
        fr = torch.exp2(M[..., g] - m0)
        ln, an = L[..., g] * fr, A[..., g, :] * fr[..., None]
        for w in range(plan.WARPS):                     # warp order
            f = torch.where(l_w[..., j, w] > 0,
                            torch.exp2(m_w[..., j, w] - m0), 0.0)
            ln = ln + l_w[..., j, w] * f
            an = an + acc_w[..., j, w, :] * f[..., None]
        M[..., g] = torch.where(live, m, M[..., g])
        L[..., g] = torch.where(live, ln, L[..., g])
        A[..., g, :] = torch.where(live[..., None], an, A[..., g, :])
    # a row's groups: the max first, then the sums in group order
    ng = -(-walk // plan.GROUP)                         # (C, B)
    live = (torch.arange(n_groups) < ng[..., None])[:, :, None, None]
    m = torch.where(live, M, -math.inf).amax(-1)
    f_g = torch.where(live, torch.exp2(M - m[..., None]), 0.0)
    l = torch.zeros_like(m)
    acc = torch.zeros(lead + (D,))
    for g in range(n_groups):                           # group order
        l = l + L[..., g] * f_g[..., g]
        acc = acc + A[..., g, :] * f_g[..., g, None]
    return (acc / l[..., None]).reshape(C, B, Hq, D)


#: (C, B, Hq, Hkv, T, D): GQA, over three spans and more, across groups;
#: fp32 D 96 and 192 take 32-position spans
SPLIT_SHAPES = [(3, 4, 4, 2, 600, 16), (2, 3, 6, 3, 300, 192),
                (4, 2, 2, 1, 129, 64), (2, 3, 4, 4, 520, 96)]


@pytest.mark.parametrize("shape", SPLIT_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_the_split_arithmetic_agrees_with_the_plain_rows_and_jax(shape):
    C, B, Hq, Hkv, T, D = shape
    rng = np.random.default_rng(sum(shape))
    q = rng.standard_normal((C, B, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, T, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, T, D)).astype(np.float32)
    # lengths that cross at least three spans, a row with valid 0, one
    # past T and one inside the first span
    first = np.array([T - 1, 0, 2 * T, 5][:B] if B > 2 else [T - 3, 0])
    valid = (first[None] + np.arange(C)[:, None]).astype(np.int32)
    assert (np.minimum(valid, T) > 2 * plan.span(D, 4)).any()
    assert (np.minimum(valid, T) > plan.GROUP).any() or T <= plan.GROUP
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    tvalid = torch.from_numpy(valid)
    got = split_attention(tq, tk, tv, tvalid)
    rows = decode_attention_rows_ref(tq, tk, tv, tvalid)
    torch.testing.assert_close(got, rows, rtol=0, atol=2e-4)
    for c in range(C):
        want = np.asarray(jax_decode_ref(jnp.asarray(q[c][:, :, None]),
                                         jnp.asarray(k), jnp.asarray(v),
                                         jnp.asarray(valid[c])))
        np.testing.assert_allclose(got[c].numpy(), want[:, :, 0], rtol=0,
                                   atol=2e-4)


# ---------------------------------------------------------------------------
# rms_norm's threads a row
# ---------------------------------------------------------------------------

NORM_DIMS = (1, 8, 64, 100, 1536, 2048, 2560, 3072, 4096, 5120, 18432,
             8190)


@pytest.mark.parametrize("esize", ESIZES)
@pytest.mark.parametrize("d", NORM_DIMS)
def test_the_norms_threads_a_row_read_each_element_once(d, esize):
    t = norm_plan.threads_a_row(d, esize)
    assert t in norm_plan.ROW_THREADS
    n = norm_plan.vec(d, esize)
    assert n in (1, norm_plan.LOAD_BYTES // esize)
    if d % (norm_plan.LOAD_BYTES // esize) == 0:
        assert n == norm_plan.LOAD_BYTES // esize   # 16-byte loads
    per = norm_plan.elements(d, esize)
    assert len(per) == t
    flat = sorted(e for thread in per for e in thread)
    assert flat == list(range(d))
    most = max(len(x) for x in per) // n
    assert most <= norm_plan.MAX_VECS
    # the fewest threads that keep a thread to TARGET_VECS vectors
    if t < norm_plan.ROW_THREADS[-1]:
        assert most <= norm_plan.TARGET_VECS
    if t > norm_plan.ROW_THREADS[0]:
        assert -(-(d // n) // (t // 2)) > norm_plan.TARGET_VECS
    rows = norm_plan.rows_a_block(d, esize)
    assert rows * t <= norm_plan.ROW_THREADS[-1]
    assert rows * t == max(t, norm_plan.BLOCK_THREADS)


def test_the_norms_threads_ignore_the_row_count():
    """The plan takes d and the dtype only: no row count reaches it, and
    the served widths get the same threads in a decode body and a chunk:
    two vectors a thread, three at nemotron's 18432 (1024 threads)."""
    import inspect
    for fn in (norm_plan.threads_a_row, norm_plan.rows_a_block,
               norm_plan.vec):
        assert list(inspect.signature(fn).parameters) == ["d", "esize"]
    assert norm_plan.threads_a_row(3072, 2) == 256
    assert norm_plan.threads_a_row(18432, 2) == 1024
    with pytest.raises(ValueError, match="at most"):
        norm_plan.threads_a_row(1024 * 8 * 8 + 8, 2)
