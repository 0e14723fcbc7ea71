"""The layout functions of the redesigned kernels 1-5 (pure Python).

`m2_layout`, `vpu_layout`, `packed_layout`, `fused_layout` and `mma_layout`
(mpctsid_tpu_torch/qp/kernels.py) decide,
from (B, n, m), a block's shared-memory limit and the number of
multiprocessors (kernel 1: from n, m and the shared-memory limit alone),
which path a launch takes and with what geometry; the CUDA
launchers recompute the sizes and refuse a mismatch.  These tests hold the
decisions at the shapes the port runs, on the H100's limits (232,448 bytes of
shared memory per block, 132 multiprocessors).  No kernel runs here.
Kernel 3's slot sizes come from the kernel's own count
(qp/csrc/packed_slot.h), built here with the host compiler as its library
exports it on the card.
"""

import pytest

from mpctsid_tpu_torch.qp import kernels as tk

from _torch_port_util import build_packed_slot_floats

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


# ------------------------------------------------------------------ kernel 1

def _round4(v):
    return (v + 3) // 4 * 4


def _m2_floats(n, m, cluster, m2):
    """Floats of one block of kernel 1 at a cluster size with M2 in
    "regs" or "smem" and A in shared memory; None where the register
    variant does not fit the block's threads."""
    rows_n, rows_m, threads, vec = tk.m2_block(n, m, cluster)
    np_ = _round4(n)
    ld = np_ if np_ % 8 == 4 else np_ + 4
    if m2 == "regs":
        if (np_ // 4) * -(-rows_n // tk.M2_REG_ROWS) > threads:
            return None
        return vec + rows_m * ld
    return vec + (rows_n + rows_m) * ld


@pytest.mark.parametrize("n,m,cluster,resident", [
    (24, 40, 1, tk.RES_M2_REGS | tk.RES_M2_A),
    (30, 50, 1, tk.RES_M2_REGS | tk.RES_M2_A),
    (100, 170, 1, tk.RES_M2_REGS | tk.RES_M2_A),
    (128, 208, 1, tk.RES_M2_REGS | tk.RES_M2_A),
    (192, 320, 2, tk.RES_M2_REGS | tk.RES_M2_A),
    (256, 120, 2, tk.RES_M2 | tk.RES_M2_A),
    (256, 256, 3, tk.RES_M2 | tk.RES_M2_A),
    (256, 400, 3, tk.RES_M2_REGS | tk.RES_M2_A),
    (400, 700, 7, tk.RES_M2_REGS | tk.RES_M2_A)])
def test_m2_cluster_size_is_the_least_that_holds_m2_and_a(n, m, cluster,
                                                          resident):
    lay = tk.m2_layout(n, m, SMEM)
    assert (lay.cluster, lay.resident) == (cluster, resident)
    assert 4 * lay.smem_floats <= SMEM
    # one block fewer holds neither M2 in registers nor in shared memory
    if cluster > 1:
        for m2 in ("regs", "smem"):
            floats = _m2_floats(n, m, cluster - 1, m2)
            assert floats is None or 4 * floats > SMEM
    # M2 in registers wherever they hold each thread's part at this size
    assert (lay.resident & tk.RES_M2_REGS != 0) == (
        _m2_floats(n, m, cluster, "regs") is not None)


def test_m2_mpc_shape_takes_clusters_of_two():
    """M2 (147,456 B) and A (245,760 B) do not fit one block's 232,448 B;
    two blocks hold 96 rows of M2 in registers and 160 rows of A each."""
    lay = tk.m2_layout(*MPC, SMEM)
    assert lay == tk.M2Layout(2, 384, 196, tk.RES_M2_REGS | tk.RES_M2_A,
                              lay.smem_floats, 96, 160)
    # the barriers, x, q, x_t, rhs (+ 12), seven m-vectors, the partial sums
    # (4 per thread), the two exchange buffers; A's slice at stride 196
    vec = 4 + 3 * 192 + 96 + 12 + 7 * 160 + 4 * 384 + 2 * (96 + 192)
    assert lay.smem_floats == vec + 160 * 196
    assert 4 * lay.smem_floats <= SMEM
    # 48 groups of four columns x 8 chunks of 12 rows of M2: one per thread
    assert 48 * 8 == lay.threads
    assert lay.geometry == (2, 384, 196, lay.resident, lay.smem_floats)
    # M2 and A of one scenario do not fit one block
    assert 4 * (192 + 320) * 192 > SMEM


@pytest.mark.parametrize("smem", [232448, 166912, 101376, 65536])
def test_m2_cluster_grows_as_shared_memory_shrinks(smem):
    """On a card with less shared memory per block the MPC shape takes
    the least cluster that holds its slices there, never more than needed,
    and the block always fits."""
    lay = tk.m2_layout(*MPC, smem)
    assert 4 * lay.smem_floats <= smem
    assert lay.resident & tk.RES_M2_A
    fits = [c for c in range(1, tk.MAX_CLUSTER + 1)
            if any(f is not None and 4 * f <= smem
                   for f in (_m2_floats(*MPC, c, "regs"),
                             _m2_floats(*MPC, c, "smem")))]
    assert lay.cluster == fits[0]
    assert lay.cluster >= tk.m2_layout(*MPC, SMEM).cluster


@pytest.mark.parametrize("n,m", [MPC, TEST, WBC, (100, 170), (128, 208),
                                 (256, 400), (401, 700)])
def test_m2_registers_take_one_part_of_m2_per_thread(n, m):
    """Where M2's slice sits in registers the block has one part of it (12
    rows of four columns) per thread, rounded up to a warp, at least 64
    threads: no thread idles in the M2 product, none is there only for A."""
    lay = tk.m2_layout(n, m, SMEM)
    assert lay.resident & tk.RES_M2_REGS
    parts = (_round4(n) // 4) * -(-lay.rows_n // tk.M2_REG_ROWS)
    assert parts <= lay.threads
    assert lay.threads == max(64, -(-parts // 32) * 32)


@pytest.mark.parametrize("n", [1, 7, 24, 30, 31, 100, 192, 401])
def test_m2_row_stride_is_four_mod_eight(n):
    """A x_t reads 16-byte pieces of eight rows per quarter warp: a stride
    of 4 mod 8 floats puts them on different banks."""
    lay = tk.m2_layout(n, 2 * n, SMEM)
    assert lay.ld % 8 == 4 and _round4(n) <= lay.ld < _round4(n) + 8


@pytest.mark.parametrize("n,m", [MPC, TEST, WBC, (150, 250), (256, 400),
                                 (401, 701), (500, 900), (1000, 2000)])
def test_m2_row_slices_cover_every_row_once(n, m):
    """Every row of M2 and of A belongs to exactly one block of the
    cluster; slices start at multiples of four rows; and the reduce-scatter
    of A' w sends each group of four columns to the one block that owns
    those rows of M2, with as many bytes as that block expects."""
    lay = tk.m2_layout(n, m, SMEM)
    C = lay.cluster
    for total, rows_per in ((n, lay.rows_n), (m, lay.rows_m)):
        assert rows_per % 4 == 0
        slices = tk.row_slices(total, rows_per, C)
        covered = [r for a, b in slices for r in range(a, b)]
        assert covered == list(range(total))
        assert all(a % 4 == 0 or a == b == total for a, b in slices)
    np_ = _round4(n)
    received = [0] * C
    for j in range(0, np_, 4):
        owner = j // lay.rows_n
        assert owner < C
        received[owner] += 4
    for r, (a, b) in enumerate(tk.row_slices(n, lay.rows_n, C)):
        assert received[r] == _round4(b - a)     # admm_m2.cu: bytes1 / C


def test_m2_streams_what_a_cluster_of_eight_cannot_hold():
    # M2's slice in shared memory (too many rows per thread for registers),
    # A streamed; then both streamed
    lay = tk.m2_layout(500, 900, SMEM)
    assert (lay.cluster, lay.resident) == (8, tk.RES_M2)
    assert 4 * lay.smem_floats <= SMEM
    lay = tk.m2_layout(1000, 2000, SMEM)
    assert (lay.cluster, lay.resident) == (8, 0)
    with pytest.raises(ValueError, match="shared memory"):
        tk.m2_layout(40000, 80000, SMEM)


@pytest.mark.parametrize("n,m", [MPC, TEST, WBC, (256, 120), (500, 900)])
def test_m2_block_size_and_vector_floats(n, m):
    lay = tk.m2_layout(n, m, SMEM)
    assert lay.threads % 32 == 0 and 64 <= lay.threads <= tk.MAX_M2_THREADS
    rows_n, rows_m, threads, vec = tk.m2_block(n, m, lay.cluster)
    assert (rows_n, rows_m, threads) == (lay.rows_n, lay.rows_m, lay.threads)
    part = max(4 * threads, _round4(n), rows_m)
    assert vec == (4 + 3 * _round4(n) + rows_n + tk.M2_REG_ROWS + 7 * rows_m
                   + part + lay.cluster * (rows_n + _round4(n)))
    mats = (lay.rows_m * lay.ld if lay.resident & tk.RES_M2_A else 0) + (
        lay.rows_n * lay.ld if lay.resident & tk.RES_M2 else 0)
    assert lay.smem_floats == vec + mats


# ------------------------------------------------------------------ kernel 2

@pytest.mark.parametrize("n", [1, 7, 24, 30, 32])
@pytest.mark.parametrize("B", [1, 37, 531, 4096])
def test_vpu_small_n_takes_the_warp_path(n, B):
    m = 50
    lay = tk.vpu_layout(n, m, B, SMEM, N_SM)
    assert lay.path == "warp" and lay.ld == tk.VPU_LD
    assert lay.ld % 8 == 4 and lay.ld >= 32
    # A (round4(m) rows), rhs, x_a, r, x_t (32 each), 7 m-vectors
    slot = 52 * lay.ld + 4 * 32 + 7 * 52
    assert lay.slot_floats == slot
    fit = SMEM // (4 * slot)
    assert fit >= tk.MIN_WARP_SLOTS
    assert 1 <= lay.g <= min(tk.MAX_VPU_SLOTS, fit)
    assert lay.g <= max(1, -(-B // N_SM))
    assert lay.threads == 32 * lay.g
    blocks = -(-B // lay.g)
    assert (blocks - 1) * lay.g < B <= blocks * lay.g
    assert lay.geometry == (lay.g, lay.threads, lay.ld, slot)


def test_vpu_warp_path_at_full_width():
    lay = tk.vpu_layout(*WBC, 4096, SMEM, N_SM)
    assert (lay.g, lay.slot_floats) == (tk.MAX_VPU_SLOTS, 2364)
    # B = 531 spreads over the multiprocessors in blocks of four, the last
    # one partial
    lay = tk.vpu_layout(*WBC, 531, SMEM, N_SM)
    assert lay.g == 4 and 531 % lay.g != 0


@pytest.mark.parametrize("n,m", [(33, 55), MPC, (64, 96)])
def test_vpu_larger_n_takes_the_block_path(n, m):
    lay = tk.vpu_layout(n, m, 8, SMEM, N_SM)
    assert lay == tk.VpuLayout("block", 0, tk._pick_threads(n), 0, 0)
    assert lay.geometry == (0, tk._pick_threads(n), 0, 0)


def test_vpu_block_path_when_too_few_slots_fit():
    # n <= 32 but a tall A: fewer than four scenarios per block
    assert tk.vpu_layout(30, 600, 8, SMEM, N_SM).path == "block"
    # and on a device with little shared memory
    assert tk.vpu_layout(*WBC, 4096, 32 * 1024, N_SM).path == "block"


# ------------------------------------------------------------------ kernel 3

@pytest.fixture(scope="module")
def slot_floats(tmp_path_factory):
    """packed_slot::slot_floats of qp/csrc/packed_slot.h, the count that
    admm_packed.cu exports as `admm_packed_slot_floats`, built with g++."""
    return build_packed_slot_floats(tmp_path_factory.mktemp("packed_slot"))


REGS, SHARED = tk.PACKED_PATHS["registers"], tk.PACKED_PATHS["shared"]


@pytest.mark.parametrize("n,m", [WBC, TEST, (32, 50), (7, 12), (1, 3)],
                         ids=["wbc", "test", "n32", "small", "n1"])
@pytest.mark.parametrize("B", [1, 37, 531, 4096])
def test_packed_small_n_takes_the_register_path(n, m, B, slot_floats):
    lay = tk.packed_layout(n, m, B, SMEM, N_SM, slot_floats)
    assert lay.path == "registers" and lay.ld == tk.PACKED_REG_LD == 36
    assert lay.ld % 8 == 4
    # A's region: A at stride 36 or, while they pass through, K^-1 and K
    # at the odd stride n | 1, whichever is larger; then rhs, x_a, r, x_t
    # (32 each) and 7 m-vectors: the kernel's own count
    mp = _round4(m)
    stage = 2 * _round4(n * (n | 1))
    assert lay.slot_floats == max(mp * 36, stage) + 4 * 32 + 7 * mp
    assert lay.slot_floats == slot_floats(REGS, n, m)
    assert lay.slot_floats % 4 == 0         # 16-byte aligned slots
    fit = SMEM // (4 * lay.slot_floats)
    assert 1 <= lay.g <= min(tk.MAX_PACKED_REG_SLOTS, fit)
    assert lay.g <= max(1, -(-B // N_SM))
    assert lay.threads == 32 * lay.g
    blocks = -(-B // lay.g)
    assert (blocks - 1) * lay.g < B <= blocks * lay.g
    assert lay.geometry == (REGS, lay.g, 36, lay.slot_floats)


def test_packed_register_slot_at_the_wbc_shape_is_kernel_2s(slot_floats):
    """Kernels 2 and 3 run the same loop on the same slot: at n = 30,
    m = 50 the two staged matrices (2 x 30 rows of 31 floats) fit in A's 52
    rows of 36, so the slot is kernel 2's to the float."""
    lay = tk.packed_layout(*WBC, 4096, SMEM, N_SM, slot_floats)
    vlay = tk.vpu_layout(*WBC, 4096, SMEM, N_SM)
    assert lay.slot_floats == vlay.slot_floats == 2364
    assert (lay.path, lay.g) == ("registers", tk.MAX_PACKED_REG_SLOTS)
    # where A is short, the staging area sets the region (n = 32, m = 4)
    assert slot_floats(REGS, 32, 4) == 2 * 1056 + 4 * 32 + 7 * 4


@pytest.mark.parametrize("n,m", [(33, 55), (40, 60), (48, 30)])
def test_packed_larger_n_takes_the_shared_path(n, m, slot_floats):
    lay = tk.packed_layout(n, m, 8, SMEM, N_SM, slot_floats)
    assert lay.path == "shared" and lay.ld == n | 1
    assert slot_floats(REGS, n, m) == -1       # no register path past 32
    # K^-1, K, A at the odd stride, 5 n + 7 m vector entries
    assert lay.slot_floats == (2 * n + m) * (n | 1) + 5 * n + 7 * m
    assert lay.slot_floats == slot_floats(SHARED, n, m)
    assert 1 <= lay.g <= tk.MAX_PACKED_SHARED_SLOTS
    assert lay.geometry == (SHARED, lay.g, n | 1, lay.slot_floats)


def test_packed_n33_edge(slot_floats):
    lay = tk.packed_layout(33, 55, 8, SMEM, N_SM, slot_floats)
    assert (lay.path, lay.ld, lay.slot_floats, lay.g) == (
        "shared", 33, 4543, 1)      # B = 8 over 132 multiprocessors


def test_packed_mpc_shape_is_refused_with_the_reason(slot_floats):
    with pytest.raises(ValueError, match="shared memory") as e:
        tk.packed_layout(*MPC, 8, SMEM, N_SM, slot_floats)
    need = 4 * slot_floats(SHARED, *MPC)
    assert str(need) in str(e.value) and need > SMEM
    assert "admm_iterate_vpu" in str(e.value)


# --------------------------------------------------------------- Ruiz kernel

@pytest.mark.parametrize("B,cluster", [(1, 4), (37, 4), (4096, 2)])
def test_ruiz_mpc_shape_holds_p_in_shared_memory(B, cluster):
    """The MPC's n = 192, m = 320: a thread-block cluster per scenario,
    each block 4 row groups on its slice of the columns with that slice of
    P in shared memory beside the scales, the exchange's arrays and four
    nonzeros of A kept per group and column.  At B = 4096 two blocks of 96
    columns (73,728 bytes of P, 103,712 bytes in all): two blocks a
    multiprocessor; a small batch spreads a scenario over more."""
    lay = tk.ruiz_layout(*MPC, B, SMEM, N_SM)
    w = 192 // cluster
    assert lay.path == "cluster" and lay.cluster == cluster
    assert lay.p_in_smem and lay.slots == 4 and lay.width == w
    assert lay.blocks == B * cluster
    assert lay.threads == 4 * -(-w // 32) * 32
    assert lay.smem_floats == 72 + 192 * w + 3 * 192 + 2 * 320 \
        + cluster * 320 + 22 * w + 4 * w * 9
    if B == 4096:
        assert lay.smem_floats == 25928
        # two blocks' shared memory (and their 1 KB each) in a
        # multiprocessor's 228 KB
        assert 2 * (4 * lay.smem_floats + 1024) <= 233472
    assert lay.geometry == (1, cluster, 1, 4)


@pytest.mark.parametrize("n,m,threads", [(33, 55, 128), (192, 320, 384),
                                         (45, 70, 128), (256, 100, 384),
                                         (400, 700, 384), (120, 60, 256)])
def test_ruiz_threads_are_four_row_groups_of_a_column_each(n, m, threads):
    """The cluster path (n > 32): 4 row groups of W threads, a thread a
    column of the block's slice, W a multiple of 32 and at most 96 (wider
    slices in sweeps of 96 columns: two blocks of at most 384 threads a
    multiprocessor)."""
    lay = tk.ruiz_layout(n, m, 4096, SMEM, N_SM)
    assert lay.path == "cluster"
    assert lay.threads == threads == 4 * min(-(-lay.width // 32) * 32, 96)
    assert lay.width == tk.ruiz_slice_width(n, lay.cluster)
    assert lay.width % 4 == 0 and lay.width * lay.cluster >= n


def test_ruiz_streams_p_where_it_does_not_fit():
    # n = 400: two blocks' slices of P (320 KB) do not fit, four blocks'
    # do; n = 680: not even eight blocks' (88 columns, 239 KB): P is read
    # from device memory on the batch's cluster of 2, with the lists
    lay = tk.ruiz_layout(400, 100, 4096, SMEM, N_SM)
    assert lay.p_in_smem and lay.cluster == 4
    assert 4 * tk.ruiz_smem_floats(400, 100, 2, True, 0) > SMEM
    lay = tk.ruiz_layout(680, 100, 4096, SMEM, N_SM)
    assert not lay.p_in_smem and lay.cluster == 2 and lay.slots == 4
    assert 4 * tk.ruiz_smem_floats(680, 100, 8, True, 0) > SMEM
    assert lay.smem_floats == tk.ruiz_smem_floats(680, 100, 2, False, 4)


def test_ruiz_wbc_shape_keeps_the_lists():
    """The WBC's n = 30, m = 50 takes the warp path: a warp per scenario,
    four a block, each lane holding its column of P and of A in registers
    (no shared memory, no lists); the same width with more than 64 rows of
    A goes to the cluster path, which keeps the lists."""
    lay = tk.ruiz_layout(*WBC, 4096, SMEM, N_SM)
    assert lay == tk.RuizLayout("warp", 1024, 128, 1, 4, 32, False, 0, 0)
    assert lay.geometry == (0, 4, 0, 0)
    lay = tk.ruiz_layout(30, 80, 4096, SMEM, N_SM)
    assert lay.path == "cluster" and lay.slots == tk.RUIZ_SLOTS


@pytest.mark.parametrize("B,warps", [(1, 1), (37, 1), (256, 2), (4096, 4)])
def test_ruiz_warp_path_spreads_a_small_batch(B, warps):
    lay = tk.ruiz_layout(*WBC, B, SMEM, N_SM)
    assert (lay.path, lay.warps, lay.threads) == ("warp", warps, 32 * warps)
    assert lay.blocks == -(-B // warps)


@pytest.mark.parametrize("n,m,path", [(32, 64, "warp"), (33, 64, "cluster"),
                                      (32, 65, "cluster"), (1, 1, "warp")])
def test_ruiz_path_edge(n, m, path):
    assert tk.ruiz_layout(n, m, 4096, SMEM, N_SM).path == path


@pytest.mark.parametrize("B,cluster", [(1, 4), (16, 4), (33, 4), (65, 4),
                                       (66, 2), (4096, 2)])
def test_ruiz_cluster_size_follows_the_batch(B, cluster):
    """Twice as many blocks a scenario while B of them leave the card's 132
    multiprocessors idle, up to 4 (clusters of 8 measured slower at B = 1);
    at n = 33 at most 2 (every block some columns)."""
    assert tk.ruiz_layout(*MPC, B, SMEM, N_SM).cluster == cluster
    assert tk.ruiz_layout(33, 55, B, SMEM, N_SM).cluster == min(cluster, 2)


def test_ruiz_refuses_what_does_not_fit_even_without_p():
    with pytest.raises(ValueError, match="shared memory"):
        tk.ruiz_layout(2000, 20000, 1, SMEM, N_SM)
