"""The queue_matmul wrapper's launch plan, which runs without a card: the
kernel each M takes, the shared memory a ring depth pair needs in each
kernel, the refusal of a pair that does not fit and its message, and the
thin kernel's K split, a function of (K, N) alone.  The kernels themselves
are held to these numbers on the card by tests/test_torch_cuda.py."""
import itertools

import pytest

torch = pytest.importorskip("torch")

from _calibration_isolation import isolated_calibration  # noqa: F401

from repro_torch.kernels import queue_matmul
from repro_torch.kernels.queue_matmul import ops

BF16, FP32 = torch.bfloat16, torch.float32
#: every (K, N) a served model's decode body multiplies in bf16
SERVED_KN = [(3072, 3072), (3072, 8192), (8192, 3072), (3072, 32064),
             (2048, 2048), (2048, 50304), (4096, 16384), (8192, 288),
             (256, 8192), (8192, 4096), (4096, 65024), (2560, 2560),
             (2560, 256), (2560, 7680), (7680, 2560), (2560, 256000)]


@pytest.mark.parametrize("m,dtype,kind", [
    (1, BF16, "thin"), (4, BF16, "thin"), (16, BF16, "thin"),
    (17, BF16, "wide"), (64, BF16, "wide"), (65, BF16, "wide"),
    (512, BF16, "wide"), (4, FP32, "fp32"), (512, FP32, "fp32")])
def test_the_regime_follows_m_and_dtype(m, dtype, kind):
    assert ops.regime(m, dtype) == kind


@pytest.mark.parametrize("m,dtype", [(4, BF16), (512, BF16), (4, FP32),
                                     (512, FP32)])
def test_every_depth_pair_up_to_8_fits(m, dtype):
    for dx, dw in itertools.product(range(1, 9), repeat=2):
        assert ops.smem_bytes(m, dx, dw, dtype) <= ops.MAX_SMEM
        assert ops._plan(m <= ops.THIN_MAX_M, 3072, 3072, dx, dw, dtype) >= 1


@pytest.mark.parametrize("m,dtype,dx,dw,want", [
    # wide: 1 KB of alignment, x 128 x 64 and w 64 x 256 bf16 a stage (16
    # and 32 KB), 16 bytes of full and empty barriers a stage; stages 32
    # deep (8 and 16 KB) where the 64-deep rings do not fit
    (512, BF16, 1, 1, 1024 + 16384 + 32768 + 32),
    (512, BF16, 4, 4, 1024 + 4 * 16384 + 4 * 32768 + 128),
    (512, BF16, 4, 5, 1024 + 4 * 16384 + 5 * 32768 + 144),
    (17, BF16, 8, 8, 1024 + 8 * 8192 + 8 * 16384 + 256),
    (17, BF16, 12, 8, 1024 + 12 * 8192 + 8 * 16384 + 320),
    # thin: barriers in one 128-byte line, 4 KB of x and 16 KB of w a
    # stage, at least the 20 KB of fp32 partials that reuse them
    (4, BF16, 1, 1, 128 + 4096 + 16384),
    (4, BF16, 4, 4, 128 + 4 * 4096 + 4 * 16384),
    (16, BF16, 2, 8, 128 + 2 * 4096 + 8 * 16384),
    # fp32, M <= 16: slots of x 16 rows x 32 k and w 32 k x 64 columns
    (4, FP32, 4, 4, 128 + 4 * 4 * (16 * 32 + 32 * 64)),
    (16, FP32, 16, 16, 256 + 4 * 16 * (16 * 32 + 32 * 64)),
    (1, FP32, 2, 8, 128 + 4 * (2 * 16 * 32 + 8 * 32 * 64)),
    # fp32, M > 16: slots of x 128 rows x 16 k and w 16 k x 128 columns
    # (the 128 x 64 tile fills half the w slot), the same bytes as 64 x 32
    # and 32 x 64
    (512, FP32, 4, 4, 128 + 4 * 4 * (128 * 16 + 16 * 128)),
    (17, FP32, 8, 8, 128 + 4 * 8 * (128 * 16 + 16 * 128)),
    (4096, FP32, 2, 5, 128 + 4 * (2 * 128 * 16 + 5 * 16 * 128)),
])
def test_shared_memory_of_a_depth_pair(m, dtype, dx, dw, want):
    assert ops.smem_bytes(m, dx, dw, dtype) == want


@pytest.mark.parametrize("m,dtype,dx,dw,need", [
    (512, BF16, 16, 16, 1024 + 16 * 8192 + 16 * 16384 + 512),
    (64, BF16, 13, 8, 1024 + 13 * 8192 + 8 * 16384 + 336),
    (4, BF16, 16, 16, 256 + 16 * 4096 + 16 * 16384),
    (16, BF16, 4, 14, 256 + 4 * 4096 + 14 * 16384),
    (512, FP32, 16, 16, 256 + 4 * 16 * (64 * 32 + 32 * 64)),
])
def test_a_pair_that_does_not_fit_is_refused_with_its_bytes(m, dtype, dx, dw,
                                                            need):
    assert need > ops.MAX_SMEM
    with pytest.raises(ValueError, match=f"need {need} bytes of shared "
                                         f"memory .* above the 232448"):
        ops._plan(m <= ops.THIN_MAX_M, 3072, 3072, dx, dw, dtype)


def test_deep_x_rings_fit_beside_shallow_w_rings():
    """The x rings are the small ones: 16 x stages beside 4 w stages fit
    in both bf16 kernels."""
    for thin in (True, False):
        assert ops._plan(thin, 3072, 3072, 16, 4, BF16) == \
            ops.split_k(3072, 3072, wide=not thin)


@pytest.mark.parametrize("dx,dw", [(0, 4), (4, 0), (17, 1), (1, 17)])
def test_depths_outside_1_to_16_are_refused(dx, dw):
    with pytest.raises(ValueError, match=r"ring depths must lie in \[1, 16\]"):
        ops._plan(True, 64, 64, dx, dw, BF16)


@pytest.mark.parametrize("k,n", SERVED_KN)
@pytest.mark.parametrize("wide", [False, True])
def test_the_split_depends_on_k_and_n_only(k, n, wide):
    """Every depth pair and every M of a regime gets the split of (K, N);
    fp32 takes none."""
    s = ops.split_k(k, n, wide=wide)
    for dx, dw in itertools.product((1, 2, 4, 8), repeat=2):
        assert ops._plan(not wide, k, n, dx, dw, BF16) == s
    assert ops._plan(not wide, k, n, 4, 4, FP32) == 1
    # a power of two up to one portable cluster; every part keeps at least
    # four 128-deep stages (thin) or 16 64-deep units (wide), and more
    # parts are taken only while the column tiles times the parts are
    # under the target
    bn, bk, target, stages = (256, 64, 20, 16) if wide else (64, 128, 160, 4)
    assert s in (1, 2, 4, 8)
    n_tiles, nk = -(-n // bn), -(-k // bk)
    if s > 1:
        assert nk >= stages * s and n_tiles * (s // 2) < target
    if s < 8:
        assert n_tiles * s >= target or nk < 2 * stages * s


@pytest.mark.parametrize("k,n,thin,wide", [
    (3072, 3072, 4, 2), (2048, 2048, 4, 2), (8192, 288, 8, 8),
    (2560, 256, 4, 2), (256, 8192, 1, 1), (3072, 32064, 1, 1),
    (2560, 256000, 1, 1), (7680, 2560, 4, 2), (3072, 8192, 2, 1),
    (2560, 7680, 2, 1), (8192, 4096, 4, 2), (2120, 200, 4, 2)])
def test_split_of_served_shapes(k, n, thin, wide):
    assert ops.split_k(k, n) == thin
    assert ops.split_k(k, n, wide=True) == wide


def test_the_cpu_path_plans_and_launches_nothing():
    """On the CPU every M and depth pair, even one the card would refuse,
    takes the plain version."""
    before = queue_matmul.launches
    for m in (4, 17, 512):
        x = torch.ones((m, 40), dtype=BF16)
        out = queue_matmul(x, torch.ones((40, 24), dtype=BF16), depth=16)
        assert out.shape == (m, 24) and bool((out == 40).all())
    assert queue_matmul.launches == before


@pytest.mark.parametrize("m", [1, 4, 16, 17, 32, 64, 512])
def test_a_product_run_row_by_row_takes_the_thin_kernel(m):
    """``slab`` runs a bf16 product of any M on the thin kernel (its row
    bits depend on neither M nor the row's place); fp32 stays on its
    one block."""
    assert ops.regime(m, BF16, rowwise=True) == "thin"
    assert ops.regime(m, FP32, rowwise=True) == "fp32"
    assert ops._plan(True, 3072, 3072, 4, 4, BF16) == ops.split_k(3072, 3072)


@pytest.mark.parametrize("depths,tiles", [
    # (M = 1, 16, 17, 32, 33, 64, 200): up to four 16-row tiles a block
    ((1, 1), (1, 1, 2, 2, 4, 4, 4)),
    ((4, 4), (1, 1, 2, 2, 4, 4, 4)),
    ((2, 8), (1, 1, 2, 2, 4, 4, 4)),
    # four tiles' x rings do not fit beside these: two
    ((8, 8), (1, 1, 2, 2, 2, 2, 2)),
    ((16, 4), (1, 1, 2, 2, 2, 2, 2)),
    ((12, 8), (1, 1, 2, 2, 2, 2, 2)),
    # not even one tile fits: refused before any launch
    ((16, 16), (0, 0, 0, 0, 0, 0, 0))])
def test_thin_tiles_a_block(depths, tiles):
    assert tuple(ops.thin_tiles(m, *depths)
                 for m in (1, 16, 17, 32, 33, 64, 200)) == tiles


@pytest.mark.parametrize("m,dx,dw,want", [
    # barriers in one 128-byte line; x 4 KB a tile and w 16 KB a stage,
    # at least the fp32 partials of 4 warps' one tile and the block's tiles
    (4, 4, 4, 128 + 4 * 4096 + 4 * 16384),
    (32, 4, 4, 128 + 4 * 2 * 4096 + 4 * 16384),
    (64, 4, 4, 128 + 4 * 4 * 4096 + 4 * 16384),
    (64, 8, 8, 128 + 8 * 2 * 4096 + 8 * 16384),
    (64, 1, 1, 128 + 4 * (4 + 4) * 16 * 64)])
def test_shared_memory_of_a_product_run_row_by_row(m, dx, dw, want):
    assert ops.smem_bytes(m, dx, dw, BF16, rowwise=True) == want
    assert ops.smem_bytes(m, dx, dw, BF16, rowwise=True) <= ops.MAX_SMEM
