"""The decomposition of ``latent_attention``'s kernel, on the CPU
(``kernels/latent_attention/plan.py``, mirrored by
``csrc/latent_attention.cu``).

* Every visible cache position of every query row falls in exactly one work
  item (fp32: a span; bf16: a 16-position chunk of a span), in the order
  the row folds them, and the row's self row comes last, at walks on and
  either side of a chunk's, a span's and a group's edge, 0 (the self row
  alone) and past T, whatever the launch.
* A row's work items are the same whatever B, C, H and T run with it, and
  wherever it sits in a 16-row sub-tile, in both dtypes.
* The path is a function of (r, dr, dtype) alone; the bf16 path pads r and
  dr to powers of two.
* The shared memory of a block fits an H100 at the models' widths and the
  widest the kernel takes, in both dtypes and at one and two sub-tiles;
  the grid stays inside CUDA's limits at a 4K context and a 128K cache of
  64 slots, and is sized from T, never from the rows each query reads.
* The source uses the plan's constants.
* The kernel's arithmetic emulated in plain PyTorch agrees with the plain
  version: fp32 (scores in the log2 domain, an online softmax over each
  group's spans in order, the self row folded last, a longer row's groups
  merged in group order) within 2e-4; bf16 (each chunk of a span folded
  into its own online softmax over the spans in order, the weights rounded
  to bf16, the chunks' partials folded in chunk order, the max first)
  within 2e-2.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _calibration_isolation import isolated_calibration  # noqa: F401

from repro_torch.kernels.latent_attention import plan
from repro_torch.kernels.latent_attention.ref import latent_attention_ref

ROOT = Path(__file__).resolve().parents[1]
SOURCE = (ROOT / "src" / "repro_torch" / "kernels" / "latent_attention"
          / "csrc" / "latent_attention.cu")

#: (r, dr) of minicpm3 and of its reduced config
WIDTHS = ((256, 32), (16, 4))
ESIZES = (4, 2)

#: (B, C, H, T, r, dr, esize, the slots' first-column rows): minicpm3's
#: decode step and chunk, rows at and either side of 64 and 256, 0, past T,
#: a 600-row cache (three groups) and reduced minicpm3's widths
SHAPES = [
    (4, 1, 40, 256, 256, 32, 2, (40, 17, 0, 255)),
    (4, 8, 40, 256, 256, 32, 2, (63, 0, 64, 250)),
    (3, 5, 4, 600, 16, 4, 4, (255, 256, 590)),
    (2, 3, 6, 300, 256, 32, 4, (127, 900)),
    (1, 16, 2, 65, 16, 4, 2, (0,)),
    (3, 2, 20, 128, 256, 32, 2, (15, 16, 47)),
]


def _rows(C, B, lens):
    """(C, B) rows: slot b's column c reads lens[b] + c."""
    return np.asarray(lens)[None] + np.arange(C)[:, None]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(
    map(str, s[:7])))
def test_every_visible_position_falls_in_exactly_one_work_item(shape):
    B, C, H, T, r, dr, esize, lens = shape
    geo = plan.geometry(B, C, H, T, r, dr, esize)
    rows = _rows(C, B, lens)
    items = plan.items(geo, rows)
    assert set(items) == {(c, b, h) for c in range(C) for b in range(B)
                          for h in range(H)}
    for (c, b, h), work in items.items():
        wk = plan.walk(int(rows[c][b]), T)
        assert work[-1] == plan.SELF and plan.SELF not in work[:-1]
        seen = np.zeros(T, int)
        for item in work[:-1]:
            if geo.path == "fma":
                g, s, lo, n = item
                assert lo == s * plan.SPAN and 0 < n <= plan.SPAN
            else:
                g, w, s, lo, n = item
                assert lo == s * plan.SPAN + w * plan.CHUNK
                assert 0 < n <= plan.CHUNK
            assert g == s * plan.SPAN // plan.GROUP
            seen[lo:lo + n] += 1
        assert (seen[:wk] == 1).all() and (seen[wk:] == 0).all()
        if geo.path == "fma":
            spans = [s for _, s, _, _ in work[:-1]]
            assert spans == list(range(-(-wk // plan.SPAN)))
        else:
            # fold order: by group, then chunk, then span
            keys = [item[:3] for item in work[:-1]]
            assert keys == sorted(keys)


@pytest.mark.parametrize("walk_len", [0, 1, 63, 64, 65, 255, 256, 257, 700])
def test_a_rows_work_ignores_B_C_H_and_T(walk_len):
    """The same query row — its rows, r, dr and dtype fixed — placed among
    other slots, columns and heads, at other places of a 16-row sub-tile
    (first, inside, last, the first of the next), over caches of other
    lengths (each holding its walk), gets the same items: one list a
    path."""
    seen = set()
    for B, C, H, T in [(1, 1, 1, 800), (4, 8, 40, 1024), (3, 16, 4, 4096),
                       (64, 1, 40, 900), (2, 5, 6, 720), (8, 16, 40, 800)]:
        rows = np.full((C, B), 7)
        c, b = C - 1, B - 1
        rows[c, b] = walk_len
        for r, dr in WIDTHS:
            for esize in ESIZES:
                geo = plan.geometry(B, C, H, T, r, dr, esize)
                items = plan.items(geo, rows)
                for h in {0, H // 2, 15 % H, 16 % H, H - 1}:
                    seen.add((r, dr, geo.path, tuple(items[(c, b, h)])))
    assert len(seen) == len(WIDTHS) * len(ESIZES)
    by_path = {}
    for *_, p, work in seen:
        by_path.setdefault(p, set()).add(work)
    assert set(by_path) == {"fma", "mma"}
    assert all(len(works) == 1 for works in by_path.values())


@pytest.mark.parametrize("r,dr,esize,want", [
    (256, 32, 2, "mma"), (256, 32, 4, "fma"), (16, 4, 2, "mma"),
    (16, 4, 4, "fma"), (24, 6, 2, "mma"), (256, 64, 2, "mma")])
def test_the_path_is_a_function_of_r_dr_dtype(r, dr, esize, want):
    """bf16 takes the tensor cores and fp32 the CUDA cores, whatever the
    launch: geometry follows path(r, dr, esize) at every B, C, H and T."""
    assert plan.path(r, dr, esize) == want
    for shape in [(1, 1, 1, 16), (4, 8, 40, 4096), (64, 16, 40, 256)]:
        assert plan.geometry(*shape, r, dr, esize).path == want


def test_the_path_refuses_widths_the_kernel_cannot_copy():
    for r, dr, esize in [(plan.MAX_R + 8, 32, 2), (12, 4, 2), (16, 3, 2)]:
        with pytest.raises(ValueError, match="takes no"):
            plan.path(r, dr, esize)


@pytest.mark.parametrize("n,want", [(1, 16), (4, 16), (16, 16), (24, 32),
                                    (32, 32), (136, 256), (256, 256)])
def test_the_bf16_path_pads_to_a_power_of_two(n, want):
    assert plan.padded(n) == want


@pytest.mark.parametrize("esize", ESIZES)
@pytest.mark.parametrize("r,dr", WIDTHS + ((plan.MAX_R, plan.MAX_ROPE),))
def test_shared_memory_fits_an_h100(r, dr, esize):
    assert plan.takes(r, dr, esize)
    for tiles in range(1, plan.MAX_TILES + 1):
        assert plan.smem_bytes(r, dr, esize, tiles) <= plan.SMEM_LIMIT


def test_the_kernel_refuses_widths_it_cannot_copy():
    assert not plan.takes(plan.MAX_R + 8, 32, 2)
    assert not plan.takes(12, 4, 2)           # 24 bytes: not whole vectors
    assert not plan.takes(16, 3, 2)           # 6 bytes: not whole words
    assert not plan.takes(16, plan.MAX_ROPE + 2, 2)


@pytest.mark.parametrize("shape", [
    (4, 1, 40, 256, 256, 32, 2),       # minicpm3's decode step
    (4, 8, 40, 256, 256, 32, 2),       # its chunk
    (4, 1, 40, 4096, 256, 32, 2),      # a 4K context
    (64, 16, 40, 131072, 256, 32, 2),  # 64 slots of a 128K cache
    (64, 16, 40, 131072, 256, 32, 4),
])
def test_the_grid_stays_inside_cudas_limits(shape):
    geo = plan.geometry(*shape)
    gx, gy = geo.grid
    assert 1 <= gx <= plan.GRID_LIMITS[0] and 1 <= gy <= plan.GRID_LIMITS[1]
    assert gy * geo.spans_a_group >= geo.n_spans
    assert 1 <= geo.rows <= plan.MAX_ROWS
    assert 1 <= geo.tiles <= plan.MAX_TILES
    assert geo.row_blocks * geo.block_rows >= geo.H * geo.C
    assert geo.threads == (32 * plan.TEAMS * plan.MAX_TILES
                           if geo.path == "mma" else 32 * geo.rows) <= 1024
    assert geo.smem <= plan.SMEM_LIMIT
    assert geo.merges == (geo.T > plan.GROUP)
    assert geo.work_floats == (geo.C * geo.B * geo.H * geo.n_groups
                               * (geo.r + 2) if geo.merges else 0)


def test_the_grid_is_sized_from_T_not_from_rows():
    import inspect
    assert "rows" not in inspect.signature(plan.geometry).parameters
    a = plan.geometry(4, 8, 40, 256, 256, 32, 2)
    b = plan.geometry(4, 8, 40, 4096, 256, 32, 2)
    assert (a.n_groups, b.n_groups) == (1, 16)
    assert not a.merges and b.merges


@pytest.mark.parametrize("shape,rows", [
    ((4, 1, 40, 256), 1),       # minicpm3's decode step: 160 one-row blocks
    ((4, 8, 40, 256), 8),       # its chunk: 160 blocks of 8
    ((4, 1, 40, 4096), 8),      # decode at 4K: 16 groups
    ((1, 1, 4, 64), 1),         # reduced: 4 rows
])
def test_a_block_takes_fewer_rows_where_the_launch_would_be_small(shape,
                                                                   rows):
    geo = plan.geometry(*shape, 256, 32, 4)   # the fp32 path's rows
    assert geo.rows == rows
    assert geo.grid[0] * geo.grid[1] >= plan.MIN_BLOCKS or rows == 1


@pytest.mark.parametrize("shape,tiles", [
    ((4, 1, 40, 256), 1),       # minicpm3's decode step: 12 blocks of one
    ((4, 8, 40, 256), 1),       # its chunk: 80 blocks of one
    ((4, 1, 40, 4096), 1),      # decode at 4K: 2 x 4 x 16 < 132 blocks
    ((64, 8, 40, 256), 2),      # 64 slots' chunks: 640 blocks of two
    ((256, 1, 16, 256), 1),     # 16 rows a slot fill one sub-tile
])
def test_a_block_takes_two_sub_tiles_only_where_the_launch_stays_wide(
        shape, tiles):
    geo = plan.geometry(*shape, 256, 32, 2)
    assert geo.tiles == tiles
    assert geo.grid[0] * geo.grid[1] >= plan.MIN_BLOCKS or tiles == 1


def test_the_kernel_uses_the_plan_constants():
    src = SOURCE.read_text()
    const = {m[1]: int(m[2]) for m in re.finditer(
        r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kSpan"] == plan.SPAN
    assert const["kGroup"] == plan.GROUP
    assert const["kLanesAPosition"] == plan.LANES_A_POSITION
    assert const["kMaxRows"] == plan.MAX_ROWS
    assert const["kStages"] == plan.STAGES
    assert const["kCopyBytes"] == plan.COPY_BYTES
    assert const["kRopeCopyBytes"] == plan.ROPE_COPY_BYTES
    assert const["kMaxR"] == plan.MAX_R
    assert const["kMaxRope"] == plan.MAX_ROPE
    assert const["kMergeRows"] == plan.MERGE_ROWS
    assert const["kTile"] == plan.TILE
    assert const["kMaxTiles"] == plan.MAX_TILES
    assert const["kChunk"] == plan.CHUNK
    assert const["kMinBlocks"] == plan.MIN_BLOCKS
    assert const["kPad"] == plan.PAD
    assert const["kPartPad"] == plan.PART_PAD
    assert const["kBarBytes"] == plan.BAR_BYTES
    assert "constexpr int kWarpsATile = kSpan / kChunk;" in src
    # plan.smem_bytes's terms and plan.rows_a_block's launch
    assert "kStages) * kSpan * (r + dr) * esize" in src
    assert "32 * rows_a_block, smem" in src
    assert "cp.async.wait_group" in src and "cp_async16" in src
    # the bf16 path: plan.padded, plan.smem_bytes, plan.tiles_a_block and
    # the mma.sync products
    assert "int p = 16;\n  while (p < n) p *= 2;" in src
    assert "(rows + kGroup) * ld * sizeof(bf16)" in src
    assert "(padded(r) + kPartPad + 2) * sizeof(float)" in src
    assert "tiles /= 2;" in src
    assert "32 * kWarpsATile * kMaxTiles, smem" in src
    assert "mma_16816" in src and "ldmatrix_x4_trans" in src


# ---------------------------------------------------------------------------
# the kernel's arithmetic, emulated
# ---------------------------------------------------------------------------

def split_latent_attention(q_eff, q_rope, lat, rope, rows, self_lat,
                           self_rope, scale):
    """The kernel's arithmetic in plain PyTorch, fp32: scores in the log2
    domain, the latent and rope sums added; within a group the spans
    folded into an online softmax in span order; a row of one group then
    folds its self row, a longer row's groups are merged in group order
    (the max over the groups and the self row first), then its self
    row."""
    C, B, H, r = q_eff.shape
    T = lat.shape[1]
    n_spans = -(-T // plan.SPAN)
    pad = n_spans * plan.SPAN - T
    latp = torch.nn.functional.pad(lat.float(), (0, 0, 0, pad))
    ropep = torch.nn.functional.pad(rope.float(), (0, 0, 0, pad))
    q, qr = q_eff.float(), q_rope.float()
    own, own_r = self_lat.float(), self_rope.float()
    sl2 = scale * 1.4426950408889634
    s = ((q[:, :, :, None] * latp[None, :, None]).sum(-1)
         + (qr[:, :, :, None] * ropep[None, :, None]).sum(-1)) * sl2
    ss = ((q * own[:, :, None]).sum(-1)
          + (qr * own_r[:, :, None]).sum(-1)) * sl2      # (C, B, H)
    walk = torch.as_tensor(rows).clamp(0, T)            # (C, B)
    pos = torch.arange(n_spans * plan.SPAN)
    s = torch.where((pos < walk[..., None])[:, :, None], s,
                    torch.tensor(-math.inf))
    per = plan.GROUP // plan.SPAN
    n_groups = -(-n_spans // per)
    M = torch.full((C, B, H, n_groups), -math.inf)
    L = torch.zeros((C, B, H, n_groups))
    A = torch.zeros((C, B, H, n_groups, r))
    for j in range(n_spans):
        g = j // per
        sj = s[..., j * plan.SPAN:(j + 1) * plan.SPAN]
        live = (j * plan.SPAN < walk)[:, :, None]
        m = torch.maximum(M[..., g], sj.amax(-1))
        m0 = torch.where(live, m, 0.0)
        corr = torch.exp2(M[..., g] - m0)
        p = torch.exp2(sj - m0[..., None])
        vals = latp[:, j * plan.SPAN:(j + 1) * plan.SPAN]
        ln = L[..., g] * corr + p.sum(-1)
        an = A[..., g, :] * corr[..., None] + (
            p[..., None] * vals[None, :, None]).sum(-2)
        M[..., g] = torch.where(live, m, M[..., g])
        L[..., g] = torch.where(live, ln, L[..., g])
        A[..., g, :] = torch.where(live[..., None], an, A[..., g, :])
    # a row of one group: its self row folded into group 0
    m = torch.maximum(M[..., 0], ss)
    corr, ps = torch.exp2(M[..., 0] - m), torch.exp2(ss - m)
    one = ((A[..., 0, :] * corr[..., None] + ps[..., None] * own[:, :, None])
           / (L[..., 0] * corr + ps)[..., None])
    # a longer row: its groups in order, then the self row
    ng = -(-walk // plan.GROUP)
    live = (torch.arange(n_groups) < ng[..., None])[:, :, None]
    m = torch.maximum(torch.where(live, M, -math.inf).amax(-1), ss)
    f = torch.where(live, torch.exp2(M - m[..., None]), 0.0)
    ps = torch.exp2(ss - m)
    merged = (((A * f[..., None]).sum(-2) + ps[..., None] * own[:, :, None])
              / ((L * f).sum(-1) + ps)[..., None])
    return torch.where((walk <= plan.GROUP)[:, :, None, None], one, merged)


#: (C, B, H, T, r, dr): across spans and groups, reduced and full widths
SPLIT_SHAPES = [(3, 4, 4, 600, 16, 4), (2, 3, 6, 300, 256, 32),
                (4, 2, 2, 129, 16, 4)]


@pytest.mark.parametrize("shape", SPLIT_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_the_split_arithmetic_agrees_with_the_plain_version(shape):
    C, B, H, T, r, dr = shape
    rng = np.random.default_rng(sum(shape))
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    q, qr = f(C, B, H, r) * 0.3, f(C, B, H, dr)
    lat, rope, own, own_r = f(B, T, r), f(B, T, dr), f(C, B, r), f(C, B, dr)
    first = np.array([T - 1, 0, 2 * T, 70][:B])
    rows = torch.from_numpy((first[None] + np.arange(C)[:, None]).astype(
        np.int32)).clamp(max=T - 1)
    assert (rows > plan.GROUP).any() or T <= plan.GROUP
    scale = 1.0 / math.sqrt(12)
    got = split_latent_attention(q, qr, lat, rope, rows, own, own_r, scale)
    want = latent_attention_ref(q, qr, lat, rope, rows, own, own_r, scale)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-4)


def mma_latent_attention(q_eff, q_rope, lat, rope, rows, self_lat,
                         self_rope, scale):
    """The bf16 path's arithmetic in plain PyTorch, fp32 on bf16 inputs:
    scores in the log2 domain (the products' sums taken in fp32); a row's
    chunk w of each span of a group folded in span order into its own online
    softmax (the new max, the old sums scaled by exp2 of the old max less
    the new, the weights rounded to bf16 and summed); the group's chunk
    partials folded in chunk order, the max first; a row of one group then
    folds its self row, a longer row's groups are merged in group order
    (the max over the groups and the self row first), then its self row."""
    C, B, H, r = q_eff.shape
    T = lat.shape[1]
    n_groups = -(-T // plan.GROUP)
    pad = n_groups * plan.GROUP - T
    latp = torch.nn.functional.pad(lat.float(), (0, 0, 0, pad))
    ropep = torch.nn.functional.pad(rope.float(), (0, 0, 0, pad))
    q, qr = q_eff.float(), q_rope.float()
    own, own_r = self_lat.float(), self_rope.float()
    sl2 = scale * 1.4426950408889634
    s = ((q[:, :, :, None] * latp[None, :, None]).sum(-1)
         + (qr[:, :, :, None] * ropep[None, :, None]).sum(-1)) * sl2
    ss = ((q * own[:, :, None]).sum(-1)
          + (qr * own_r[:, :, None]).sum(-1)) * sl2      # (C, B, H)
    walk = torch.as_tensor(rows).clamp(0, T)            # (C, B)
    pos = torch.arange(n_groups * plan.GROUP)
    s = torch.where((pos < walk[..., None])[:, :, None], s,
                    torch.tensor(-math.inf))
    shape = (C, B, H, n_groups)
    M, L = torch.full(shape, -math.inf), torch.zeros(shape)
    A = torch.zeros(shape + (r,))
    spans = plan.GROUP // plan.SPAN
    for g in range(n_groups):
        Mw = torch.full((plan.TEAMS, C, B, H), -math.inf)
        Lw = torch.zeros((plan.TEAMS, C, B, H))
        Aw = torch.zeros((plan.TEAMS, C, B, H, r))
        for w in range(plan.TEAMS):
            for j in range(spans):
                lo = g * plan.GROUP + j * plan.SPAN + w * plan.CHUNK
                sj = s[..., lo:lo + plan.CHUNK]
                m = torch.maximum(Mw[w], sj.amax(-1))
                live = m > -math.inf
                m0 = torch.where(live, m, 0.0)
                corr = torch.where(live, torch.exp2(Mw[w] - m0), 1.0)
                p = torch.exp2(sj - m0[..., None]).bfloat16().float()
                p = torch.where(live[..., None], p, 0.0)
                Lw[w] = Lw[w] * corr + p.sum(-1)
                Aw[w] = Aw[w] * corr[..., None] + (
                    p[..., None] * latp[:, lo:lo + plan.CHUNK][None, :, None]
                ).sum(-2)
                Mw[w] = m
        seen = Lw != 0
        m = torch.where(seen, Mw, -math.inf).amax(0)
        f = torch.where(seen, torch.exp2(Mw - torch.where(
            m > -math.inf, m, 0.0)), 0.0)
        M[..., g], L[..., g] = m, (Lw * f).sum(0)
        A[..., g, :] = (Aw * f[..., None]).sum(0)
    # a row of one group: its self row folded into group 0
    m = torch.maximum(M[..., 0], ss)
    corr, ps = torch.exp2(M[..., 0] - m), torch.exp2(ss - m)
    one = ((A[..., 0, :] * corr[..., None] + ps[..., None] * own[:, :, None])
           / (L[..., 0] * corr + ps)[..., None])
    # a longer row: its groups in order, then the self row
    ng = -(-walk // plan.GROUP)
    live = (torch.arange(n_groups) < ng[..., None])[:, :, None]
    m = torch.maximum(torch.where(live, M, -math.inf).amax(-1), ss)
    f = torch.where(live, torch.exp2(M - m[..., None]), 0.0)
    ps = torch.exp2(ss - m)
    merged = (((A * f[..., None]).sum(-2) + ps[..., None] * own[:, :, None])
              / ((L * f).sum(-1) + ps)[..., None])
    return torch.where((walk <= plan.GROUP)[:, :, None, None], one, merged)


@pytest.mark.parametrize("shape", SPLIT_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_the_mma_arithmetic_agrees_with_the_plain_version(shape):
    """bf16 inputs (the path's), scores scaled up so each softmax rests on
    a few positions and a lost chunk would show."""
    C, B, H, T, r, dr = shape
    rng = np.random.default_rng(sum(shape) + 1)
    f = lambda *s, sc=1.0: torch.from_numpy(  # noqa: E731
        (sc * rng.standard_normal(s)).astype(np.float32)).bfloat16()
    q, qr = f(C, B, H, r, sc=4.0 / math.sqrt(r) * 3), f(C, B, H, dr)
    lat, rope, own, own_r = f(B, T, r), f(B, T, dr), f(C, B, r), f(C, B, dr)
    first = np.array([T - 1, 0, 2 * T, 70][:B])
    rows = torch.from_numpy((first[None] + np.arange(C)[:, None]).astype(
        np.int32)).clamp(max=T - 1)
    scale = 1.0 / math.sqrt(12)
    got = mma_latent_attention(q, qr, lat, rope, rows, own, own_r, scale)
    want = latent_attention_ref(q, qr, lat, rope, rows, own, own_r, scale)
    assert want.float().abs().max() > 0.5
    torch.testing.assert_close(got, want.float(), rtol=2e-2, atol=2e-2)
    # a chunk lost from every span misses it
    lost = mma_latent_attention(q, qr, lat, rope, rows.clamp(max=0), own,
                                own_r, scale)
    assert (lost - want.float()).abs().max() > 2e-2
