"""The layout functions of the redesigned kernels 4 and 5 (pure Python).

`fused_layout` and `mma_layout` (mpctsid_tpu_torch/qp/kernels.py) decide,
from (B, n, m), a block's shared-memory limit and the number of
multiprocessors, which path a launch takes and with what geometry; the CUDA
launchers recompute the sizes and refuse a mismatch.  These tests hold the
decisions at the shapes the port runs, on the H100's limits (232,448 bytes of
shared memory per block, 132 multiprocessors).  No kernel runs here.
"""

import pytest

from mpctsid_tpu_torch.qp import kernels as tk

SMEM, N_SM = 232448, 132
WBC, TEST, MPC = (30, 50), (24, 40), (192, 320)


def _pad16(v):
    return (v + 15) // 16 * 16


# ------------------------------------------------------------------ kernel 5

@pytest.mark.parametrize("n,m", [WBC, TEST], ids=["wbc", "test"])
@pytest.mark.parametrize("B", [1, 37, 64, 4096])
def test_mma_small_shapes_take_the_warp_path(n, m, B):
    lay = tk.mma_layout(n, m, B, SMEM, N_SM)
    assert lay.path == "warp" and lay.cluster == 0 and lay.resident == 0
    # K^-1, K, A; 4 + 9 vectors and parts of vectors of n, 7 + 2 of m
    slot = (2 * n + m) * lay.ld + 13 * _pad16(n) + 9 * _pad16(m)
    # the slot fits at least four times; g is what fits, capped, and no more
    # than spreads B over the multiprocessors
    assert SMEM // (4 * slot) >= tk.MIN_WARP_SLOTS
    assert 1 <= lay.g <= min(tk.MAX_MMA_SLOTS, SMEM // (4 * slot))
    assert lay.g <= max(1, -(-B // N_SM))
    assert lay.smem_floats == lay.g * slot and 4 * lay.smem_floats <= SMEM
    assert lay.threads == 32 * lay.g
    # a valid grid: every scenario has a warp, the last block may be partial
    blocks = -(-B // lay.g)
    assert (blocks - 1) * lay.g < B <= blocks * lay.g
    assert lay.geometry == (lay.g, 0, lay.threads, lay.ld, 0, lay.smem_floats)


def test_mma_warp_path_fills_the_block_at_full_width():
    lay = tk.mma_layout(*WBC, 4096, SMEM, N_SM)
    assert (lay.g, lay.ld) == (tk.MAX_MMA_SLOTS, 32)
    # twelve scenarios share a multiprocessor, in three blocks
    assert SMEM // (4 * lay.smem_floats) == 3
    # B = 37 at four warps per block would end in a partial block
    assert tk.mma_layout(*WBC, 37 * N_SM, SMEM, N_SM).g == 4


@pytest.mark.parametrize("n", [1, 7, 16, 24, 30, 31, 33, 100, 192, 400])
def test_mma_row_stride_is_a_multiple_of_four(n):
    """Rows 'as given' are read in 16-byte pieces: the stride keeps every row
    16-byte aligned and wastes under four floats."""
    lay = tk.mma_layout(n, 2 * n, 8, SMEM, N_SM)
    assert lay.ld % 4 == 0 and n <= lay.ld < n + 4


@pytest.mark.parametrize("B", [1, 8, 4096])
def test_mma_mpc_shape_takes_the_least_cluster_that_holds_it(B):
    """Three blocks hold K^-1, K and A of the MPC shape; two do not.  (The
    fewer blocks share a scenario, the faster: PERF.md.)"""
    lay = tk.mma_layout(*MPC, B, SMEM, N_SM)
    assert (lay.path, lay.cluster, lay.g) == ("cluster", 3, 0)
    assert (lay.rows_n, lay.rows_m, lay.ld) == (64, 112, 192)
    assert lay.resident == tk.RES_KINV | tk.RES_A | tk.RES_K
    # slices of K^-1, K and A; the vectors and their parts; the partial
    # sums; the exchange buffer and its four 8-byte barriers
    mats = (2 * 64 + 112) * 192
    vecs = (14 * 192 + 9 * 112 + tk.MMA_KSPLIT * 192 + 3 * 192
            + tk.MMA_BARRIER_FLOATS)
    assert lay.smem_floats == mats + vecs
    assert 4 * lay.smem_floats < 232448
    assert lay.threads == 384
    # two blocks would not hold their slices
    assert 4 * ((2 * 96 + 160) * 192) > SMEM
    # the grid is B clusters of C blocks
    assert (B * lay.cluster) % lay.cluster == 0


@pytest.mark.parametrize("n,m,cluster", [
    (100, 170, 1), (128, 208, 2), (150, 250, 2), (192, 320, 3),
    (224, 352, 4), (256, 400, 6)])
def test_mma_cluster_size_is_the_least_that_fits(n, m, cluster):
    lay = tk.mma_layout(n, m, 8, SMEM, N_SM)
    assert (lay.path, lay.cluster) == ("cluster", cluster)
    assert lay.resident == 7 and 4 * lay.smem_floats <= SMEM
    if cluster > 1:
        # one block fewer does not hold everything
        c, np_ = cluster - 1, _pad16(n)
        rows_n = -(-(np_ // 16) // c) * 16
        rows_m = -(-(_pad16(m) // 16) // c) * 16
        floats = ((2 * rows_n + rows_m) * lay.ld + 14 * np_ + 9 * rows_m
                  + tk.MMA_KSPLIT * max(np_, rows_m) + c * np_
                  + tk.MMA_BARRIER_FLOATS)
        assert 4 * floats > SMEM


@pytest.mark.parametrize("n,m", [(150, 250), (30, 50), (192, 320), (17, 33),
                                 (100, 170), (400, 700)])
@pytest.mark.parametrize("cluster", [1, 2, 3, 4, 6, 8])
def test_cluster_slices_cover_every_row_exactly_once(n, m, cluster):
    """Whole 16-row tiles per block, the last slices ragged or empty."""
    for total in (n, m):
        rows_per = -(-(_pad16(total) // 16) // cluster) * 16
        slices = tk.row_slices(total, rows_per, cluster)
        assert len(slices) == cluster and rows_per % 16 == 0
        covered = [r for a, b in slices for r in range(a, b)]
        assert covered == list(range(total))
        assert all(0 <= b - a <= rows_per and (a % 16 == 0 or a == b == total)
                   for a, b in slices)


def test_mma_ragged_shape_slices_are_the_layouts():
    lay = tk.mma_layout(150, 250, 8, SMEM, N_SM)
    assert (lay.cluster, lay.rows_n, lay.rows_m) == (2, 80, 128)
    assert tk.row_slices(150, lay.rows_n, 2) == [(0, 80), (80, 150)]
    assert tk.row_slices(250, lay.rows_m, 2) == [(0, 128), (128, 250)]


def test_mma_streams_what_a_cluster_of_eight_cannot_hold():
    lay = tk.mma_layout(400, 700, 2, SMEM, N_SM)
    assert (lay.path, lay.cluster) == ("cluster", 8)
    assert lay.resident == tk.RES_KINV          # greedily by reads: K^-1 first
    assert 4 * lay.smem_floats <= SMEM
    with pytest.raises(ValueError, match="shared memory"):
        tk.mma_layout(4000, 9000, 2, SMEM, N_SM)


# ------------------------------------------------------------------ kernel 4

@pytest.mark.parametrize("n,m", [WBC, TEST, (32, 50)],
                         ids=["wbc", "test", "n32"])
@pytest.mark.parametrize("B", [1, 37, 64, 4096])
def test_fused_small_shapes_take_the_warp_path(n, m, B):
    lay = tk.fused_layout(n, m, B, SMEM, N_SM)
    assert lay.path == "warp" and lay.threads == 0
    assert lay.ld == n | 1 and lay.ld % 2 == 1
    # the factorization's scratch (n rows of 32 floats; K^-1 in the end), P,
    # A and K with the odd stride, 7 n + 10 m vector entries; whole 16 bytes
    floats = n * max(lay.ld, 32) + (2 * n + m) * lay.ld + 7 * n + 10 * m
    assert lay.slot_floats == -(-floats // 4) * 4
    fit = SMEM // (4 * lay.slot_floats)
    assert fit >= tk.MIN_WARP_SLOTS
    assert 1 <= lay.g <= min(tk.MAX_FUSED_SLOTS, fit)
    assert lay.g <= max(1, -(-B // N_SM))
    blocks = -(-B // lay.g)
    assert (blocks - 1) * lay.g < B <= blocks * lay.g


def test_fused_warp_path_at_full_width():
    lay = tk.fused_layout(*WBC, 4096, SMEM, N_SM)
    assert (lay.g, lay.ld, lay.slot_floats) == (11, 31, 5080)
    assert 4096 % lay.g != 0        # the main path ends in a partial block
    assert tk.fused_layout(*TEST, 4096, SMEM, N_SM).g == tk.MAX_FUSED_SLOTS


@pytest.mark.parametrize("n,m", [(33, 55), MPC, (64, 96)])
def test_fused_larger_shapes_take_the_block_path(n, m):
    lay = tk.fused_layout(n, m, 8, SMEM, N_SM)
    assert lay == tk.FusedLayout("block", tk._pick_threads(n), 0, 0, 0)


def test_fused_block_path_when_too_few_slots_fit():
    # n <= 32 but a tall A: fewer than four scenarios per block
    assert tk.fused_layout(32, 600, 8, SMEM, N_SM).path == "block"
    # and on a device with little shared memory
    assert tk.fused_layout(*WBC, 4096, 48 * 1024, N_SM).path == "block"
