"""The fp32 attention forward's tiles on the host (``ops.fp32_geometry``,
the layout ``csrc/flash_attention.cu`` compiles for each head-dim class),
without a card: the query rows a block and the keys a tile for every head
dim the kernel takes, and the shared memory a block needs, which must fit
the 227 KB a block may use (and two blocks an SM up to D = 128).  The
kernel is held to these numbers on the card by tests/test_torch_cuda.py."""
import pytest

torch = pytest.importorskip("torch")

from _calibration_isolation import isolated_calibration  # noqa: F401

from repro_torch.kernels.flash_attention import ops

#: an H100 SM's shared memory for blocks (228 KB) and the 1 KB the
#: runtime keeps for each block
SM_SMEM, PER_BLOCK = 233472, 1024


def test_every_head_dim_from_16_to_256_fits_a_block():
    for d in range(16, ops.MAX_HEAD_DIM + 1):
        bq, bk, nbytes = ops.fp32_geometry(d)
        assert nbytes <= ops.MAX_SMEM, d
        assert bq % 16 == 0 and bk % 16 == 0
        # the class a head dim takes: the narrowest of 64, 128 and 256
        want = (64, 64) if d <= 64 else ((64, 32) if d <= 128 else (32, 32))
        assert (bq, bk) == want, d


@pytest.mark.parametrize("d,bq,bk,nbytes", [
    # 128 bytes of barriers; Q bq x (w + 4), two stages of K and V
    # bk x (w + 4), P bq x (bk + 16) floats, w the class's head dim
    (16, 64, 64, 128 + 4 * (64 * 68 + 4 * 64 * 68 + 64 * 80)),
    (64, 64, 64, 128 + 4 * (64 * 68 + 4 * 64 * 68 + 64 * 80)),
    (65, 64, 32, 128 + 4 * (64 * 132 + 4 * 32 * 132 + 64 * 48)),
    (80, 64, 32, 128 + 4 * (64 * 132 + 4 * 32 * 132 + 64 * 48)),
    (96, 64, 32, 128 + 4 * (64 * 132 + 4 * 32 * 132 + 64 * 48)),
    (128, 64, 32, 128 + 4 * (64 * 132 + 4 * 32 * 132 + 64 * 48)),
    (129, 32, 32, 128 + 4 * (32 * 260 + 4 * 32 * 260 + 32 * 48)),
    (200, 32, 32, 128 + 4 * (32 * 260 + 4 * 32 * 260 + 32 * 48)),
    (256, 32, 32, 128 + 4 * (32 * 260 + 4 * 32 * 260 + 32 * 48)),
])
def test_tiles_and_bytes_of_a_head_dim(d, bq, bk, nbytes):
    assert ops.fp32_geometry(d) == (bq, bk, nbytes)


@pytest.mark.parametrize("d,blocks", [(16, 2), (64, 2), (96, 2), (128, 2),
                                      (192, 1), (256, 1)])
def test_blocks_an_sm_holds(d, blocks):
    """Two blocks share an SM up to D = 128; one above."""
    need = ops.fp32_geometry(d)[2] + PER_BLOCK
    assert blocks * need <= SM_SMEM < (blocks + 1) * need


@pytest.mark.parametrize("d", [0, 257])
def test_head_dims_outside_the_kernel_are_refused(d):
    with pytest.raises(ValueError, match="head dim"):
        ops.fp32_geometry(d)
