"""The redesigned solve-tail kernels on the CPU: `kkt_blocks` as a stream
of tiles of P into K and `unscale` as a warp a scenario (the WBC shape)
or a block whose warps stream rows of P (the MPC shape), built with g++
from qp/csrc/solve_tail.h (`_torch_port_util.build_solve_tail_harness`:
a tile's setup units and then its pieces one after another, a warp's 32
lanes one after another in each phase, a block's units likewise, each in
order and reversed, from NaN-filled shared memory, with the launchers'
geometry checks) and driven by the wrappers' packing (`qp/tail.py`).

Bits.  K and rho_vec equal `tail.kkt_in_order` (the kernel's sums
written out as elementwise PyTorch ops, each rounding once) bit for bit,
for every tile size and piece width; the epilogue's six outputs equal
`tail.unscale_in_order` bit for bit on both paths (index-order row sums
on the warp path, 32 partials summed in order on the block path).  The
block path is also held to the plain version (`_unscaled_solution`)
within the tolerances of tests/test_torch_solve_tail_kernels.py (z and
prim 1e-5 / 1e-13 of max(1, |A x|), dual of its largest term), with ok
the plain version's.
"""

import numpy as np
import pytest
import torch

from mpctsid_tpu_torch.qp import admm as tadmm
from mpctsid_tpu_torch.qp import tail

from _torch_port_util import build_solve_tail_harness, stacked
from test_torch_solve_tail_kernels import (BLOCKS, DTYPES, H100_OPTIN,
                                           H100_SMS, TOL, mpc_qp,
                                           scaled_state, scenario_rel,
                                           unscale_scales)

N_MPC, M_MPC = 192, 320


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    return build_solve_tail_harness(tmp_path_factory.mktemp("tail_redesign"))


def equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and bool(
        torch.equal(a, b) or torch.equal(a.isnan(), b.isnan())
        and torch.equal(a[~a.isnan()], b[~b.isnan()]))


# ----------------------------------------------------------- kkt_blocks

def kkt_geometries(P, A):
    """The layout's (16-byte pieces), a value a piece, and smaller tiles
    (96 threads) whose edges fall elsewhere in the rows."""
    B, n = P.shape[:2]
    m = A.shape[1]
    lay = tail.kkt_layout(B, n, m, BLOCKS, H100_OPTIN, P.dtype)
    one = tail.kkt_layout(B, n, m, BLOCKS, H100_OPTIN, P.dtype,
                          aligned=False)
    tiles = -(-n * n // (96 * tail.LAYOUT["kkt_pieces"] * lay.lanes))
    return [lay.geometry, one.geometry, (96, B * tiles, lay.lanes)]


@pytest.mark.parametrize("eq_rows", [False, True])
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("dtype", DTYPES)
def test_kkt_blocks_bit_for_bit_in_order(harness, dtype, B, eq_rows):
    (Ps, _, As, *_), eqf, rho_s, _ = scaled_state(
        mpc_qp(20 + B, B, dtype), 20 + B)
    if eq_rows:
        eqf = eqf.clone()
        eqf[:, ::7] = 1.0
    want_K, want_rho = tail.kkt_in_order(Ps, As, eqf, rho_s, 1e-6, 1e3,
                                         BLOCKS)
    _, plain_rho = tadmm._dense_kkt(Ps, As, eqf, rho_s, 1e-6, 1e3)
    assert torch.equal(want_rho, plain_rho)
    geoms = kkt_geometries(Ps, As)
    assert geoms[0][2] == 16 // Ps.element_size() and geoms[1][2] == 1
    for geometry in geoms:
        for fn in (harness.kkt, harness.kkt_reversed):
            rc, (K, rho_vec) = tail.run_kkt(fn, Ps, As, eqf, rho_s, 1e-6,
                                            1e3, BLOCKS, geometry)
            assert rc == 0, geometry
            assert torch.equal(K, want_K), geometry
            assert torch.equal(rho_vec, want_rho), geometry
            assert not K.isnan().any()


def test_kkt_in_order_is_the_plain_k_within_rounding():
    """The written-out order against the dense product (the plain
    version): off the blocks P's values, inside within 1e-6 of each
    scenario's largest |K| (float32)."""
    (Ps, _, As, *_), eqf, rho_s, _ = scaled_state(mpc_qp(30, 2), 30)
    K, _ = tail.kkt_in_order(Ps, As, eqf, rho_s, 1e-6, 1e3, BLOCKS)
    Kp, _ = tadmm._dense_kkt(Ps, As, eqf, rho_s, 1e-6, 1e3)
    scale = Kp.abs().reshape(2, -1).amax(dim=1).double()
    assert scenario_rel(K, Kp, scale) <= 1e-6
    inside = torch.block_diag(*[torch.ones(3, 3)] * 64).bool()
    assert torch.equal(K[:, ~inside], Ps[:, ~inside])


def test_kkt_shared_a_and_scenario_stride(harness):
    """A stride-0 A (one row for every scenario) and a P whose scenarios
    lie at a stride that is not a whole number of 16-byte pieces: the
    wrapper's layout takes a value a piece there."""
    (Ps, _, As, *_), eqf, rho_s, _ = scaled_state(mpc_qp(31, 3), 31)
    A0 = As[:1].expand(3, -1, -1)
    flat = torch.full((3 * N_MPC * N_MPC + 3,), float("nan"))
    P = flat[1:1 + 3 * N_MPC * N_MPC].view(3, N_MPC, N_MPC)
    P.copy_(Ps)
    want = tail.kkt_in_order(P, A0, eqf, rho_s, 1e-6, 1e3, BLOCKS)
    lay = tail.kkt_layout(3, N_MPC, M_MPC, BLOCKS, H100_OPTIN,
                          aligned=P.data_ptr() % 16 == 0)
    assert lay.lanes == 1
    rc, got = tail.run_kkt(harness.kkt, P, A0, eqf, rho_s, 1e-6, 1e3,
                           BLOCKS, lay.geometry)
    assert rc == 0 and all(torch.equal(a, b) for a, b in zip(got, want))


def test_kkt_refused_geometries(harness):
    (Ps, _, As, *_), eqf, rho_s, _ = scaled_state(mpc_qp(32, 2), 32)
    good = tail.kkt_layout(2, N_MPC, M_MPC, BLOCKS, H100_OPTIN).geometry
    for bad in [(good[0], good[1] + 1, good[2]),     # not B x the tiles
                (good[0], good[1] // 2, good[2]),
                (good[0], good[1], 3),               # 3 does not divide n
                (good[0] * 2, good[1], good[2])]:    # tiles of another size
        rc, _ = tail.run_kkt(harness.kkt, Ps, As, eqf, rho_s, 1e-6, 1e3,
                             BLOCKS, bad)
        assert rc != 0, bad


# -------------------------------------------------------------- unscale

def small_block_qp(seed, B, n, m, dtype):
    """A random QP whose A is block diagonal in 5 x 3 blocks."""
    r = np.random.default_rng(seed)
    P, q, A, l, u = (torch.tensor(a, dtype=dtype)
                     for a in stacked(range(seed, seed + B), n=n, m=m))
    mask = torch.block_diag(*[torch.ones(5, 3)] * (n // 3)).to(dtype)
    A = A * mask
    A[:, 0, 0] = float(r.uniform(0.5, 1.0))
    return [P, q, A, l, u]


def warp_cases(dtype):
    """(label, qp, xs, ys, D, E, c, a_blocks, status_tol) at shapes within
    `warp_dim`: the WBC's dense 30 x 50 and a declared block-diagonal 24 x
    40."""
    qp = [torch.tensor(a, dtype=dtype) for a in stacked(range(5), n=30, m=50)]
    (_, _, _, _, _, D, E, c), _, _, (xs, _, ys) = scaled_state(qp, 10)
    yield "wbc, dense", qp, xs, ys, D, E, c, None, 0.5
    qp = small_block_qp(40, 4, 24, 40, dtype)
    (_, _, _, _, _, D, E, c), _, _, (xs, _, ys) = scaled_state(qp, 41)
    yield "24 x 40, blocks", qp, xs, ys, D, E, c, BLOCKS, 0.5


@pytest.mark.parametrize("slots", [1, 2])
@pytest.mark.parametrize("warps", [1, 3, 8])
@pytest.mark.parametrize("dtype", DTYPES)
def test_unscale_warp_path_bit_for_bit_in_order(harness, dtype, warps,
                                                slots):
    """One slot (the lanes stage the rows at an odd stride) and two (the
    rows copied in whole at stride n, as the card's bulk copies; the
    warps walking the scenarios: one block)."""
    for label, qp, xs, ys, D, E, c, blocks, tol in warp_cases(dtype):
        B = xs.shape[0]
        want = tail.unscale_in_order(*qp, xs, ys, D, E, c, tol, blocks)
        geometry = (32 * warps, -(-B // warps) if slots == 1 else 1, slots)
        for fn in (harness.unscale, harness.unscale_reversed):
            rc, got = tail.run_unscale(fn, *qp, xs, ys, D, E, c, tol, blocks,
                                       geometry)
            assert rc == 0, label
            for name, g, w in zip("x y z prim dual ok".split(), got, want):
                assert equal(g, w), (label, name)
        s = tadmm._unscaled_solution(*qp, xs, ys, D, E, c, tol)
        assert torch.equal(got[0], s.x) and torch.equal(got[1], s.y)
        assert torch.equal(got[5], s.ok), label


def test_unscale_warp_path_non_finite(harness):
    """A non-finite x: ok False on that scenario, the maxima NaN-propagating
    as the written-out order's; the other scenarios' bits unchanged."""
    label, qp, xs, ys, D, E, c, blocks, tol = next(warp_cases(torch.float32))
    B = xs.shape[0]
    bad = xs.clone()
    bad[1, 4] = float("nan")
    bad[3, 0] = float("inf")
    geometry = tail.tail_layout(30, 50, B, H100_OPTIN, H100_SMS,
                                True).geometry
    assert geometry[2] == 2
    _, got = tail.run_unscale(harness.unscale, *qp, bad, ys, D, E, c, tol,
                              blocks, geometry)
    want = tail.unscale_in_order(*qp, bad, ys, D, E, c, tol, blocks)
    for g, w in zip(got, want):
        assert equal(g, w)
    assert not bool(got[5][1]) and not bool(got[5][3])
    _, clean = tail.run_unscale(harness.unscale, *qp, xs, ys, D, E, c, tol,
                                blocks, geometry)
    keep = [0, 2, 4]
    assert all(torch.equal(a[keep], b[keep]) for a, b in zip(got, clean))


def offset_copy(t):
    """`t` copied to a buffer one element past a 16-byte boundary."""
    flat = torch.full((t.numel() + 1,), float("nan"), dtype=t.dtype)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("dtype", DTYPES)
def test_unscale_warp_path_unaligned_rows(harness, dtype):
    """P and A whose rows are not 16-byte aligned: the layout takes one
    slot, the warp stages them a value a piece, with the same bits; two
    slots are refused."""
    label, qp, xs, ys, D, E, c, blocks, tol = next(warp_cases(dtype))
    B = xs.shape[0]
    moved = [offset_copy(qp[0]), qp[1], offset_copy(qp[2]), *qp[3:]]
    assert moved[0].data_ptr() % 16 and moved[2].data_ptr() % 16
    want = tail.unscale_in_order(*qp, xs, ys, D, E, c, tol, blocks)
    assert not tail.bulk_rows(moved[0], 30 * 30)
    lay = tail.tail_layout(30, 50, B, H100_OPTIN, H100_SMS, True, dtype,
                           aligned=False)
    assert lay.lanes == 1
    for fn in (harness.unscale, harness.unscale_reversed):
        rc, got = tail.run_unscale(fn, *moved, xs, ys, D, E, c, tol, blocks,
                                   lay.geometry)
        assert rc == 0
        assert all(equal(g, w) for g, w in zip(got, want))
    rc, _ = tail.run_unscale(harness.unscale, *moved, xs, ys, D, E, c, tol,
                             blocks, (64, 1, 2))
    assert rc != 0


def block_cases(dtype):
    """The MPC's QPs with their blocks declared (n = 192: every load of a
    row group unrolled) and dense, a block-diagonal 96 x 160 and the WBC's
    30 x 50 (n not 192: the rows' loads of one j together)."""
    qp = mpc_qp(9, 3, dtype)
    (_, _, _, _, _, D, E, c), _, _, (xs, _, ys) = scaled_state(qp, 9)
    yield "mpc, blocks", qp, xs, ys, D, E, c, BLOCKS, 0.05
    yield "mpc, dense", qp, xs, ys, D, E, c, None, 0.05
    qp = small_block_qp(50, 2, 96, 160, dtype)
    (_, _, _, _, _, D, E, c), _, _, (xs, _, ys) = scaled_state(qp, 51)
    yield "96 x 160, blocks", qp, xs, ys, D, E, c, BLOCKS, 0.5
    qp = [torch.tensor(a, dtype=dtype) for a in stacked(range(3), n=30, m=50)]
    (_, _, _, _, _, D, E, c), _, _, (xs, _, ys) = scaled_state(qp, 52)
    yield "wbc, dense", qp, xs, ys, D, E, c, None, 0.5


@pytest.mark.parametrize("threads", [128, 512])
@pytest.mark.parametrize("dtype", DTYPES)
def test_unscale_block_path_every_layout(harness, dtype, threads):
    for label, qp, xs, ys, D, E, c, blocks, tol in block_cases(dtype):
        B = xs.shape[0]
        want = tail.unscale_in_order(*qp, xs, ys, D, E, c, tol, blocks,
                                     lanes=32)
        for fn in (harness.unscale, harness.unscale_reversed):
            rc, got = tail.run_unscale(fn, *qp, xs, ys, D, E, c, tol, blocks,
                                       (threads, B, 32))
            assert rc == 0, label
            for name, g, w in zip("x y z prim dual ok".split(), got, want):
                assert equal(g, w), (label, name)
        s = tadmm._unscaled_solution(*qp, xs, ys, D, E, c, tol)
        x, y, z, prim, dual, ok = got
        assert torch.equal(x, s.x) and torch.equal(y, s.y), label
        z_scale, d_scale = unscale_scales(qp, s.x, s.y)
        assert scenario_rel(z, s.z, z_scale) <= TOL[dtype], label
        assert float(((prim.double() - s.prim_res.double()).abs()
                      / z_scale).max()) <= TOL[dtype], label
        assert float(((dual.double() - s.dual_res.double()).abs()
                      / d_scale).max()) <= TOL[dtype], label
        assert torch.equal(ok, s.ok), label


@pytest.mark.parametrize("dtype", DTYPES)
def test_unscale_block_path_unaligned_rows(harness, dtype):
    """The MPC's P at a 16-byte boundary and one element past it: the same
    bits, as the written-out order (the block path reads P's rows at any
    alignment)."""
    label, qp, xs, ys, D, E, c, blocks, tol = next(block_cases(dtype))
    B = xs.shape[0]
    moved = [offset_copy(qp[0]), *qp[1:]]
    want = tail.unscale_in_order(*qp, xs, ys, D, E, c, tol, blocks, lanes=32)
    for P_qp in (qp, moved):
        for fn in (harness.unscale, harness.unscale_reversed):
            rc, got = tail.run_unscale(fn, *P_qp, xs, ys, D, E, c, tol,
                                       blocks, (512, B, 32))
            assert rc == 0
            assert all(equal(g, w) for g, w in zip(got, want))


def test_unscale_refused_geometries(harness):
    label, qp, xs, ys, D, E, c, blocks, tol = next(block_cases(torch.float32))
    B = xs.shape[0]
    for bad in [(256, B, 1),          # the warp path at n = 192
                (256, B + 1, 32),     # not a block a scenario
                (256, B, 8)]:         # lanes neither 1 nor 32
        rc, _ = tail.run_unscale(harness.unscale, *qp, xs, ys, D, E, c, tol,
                                 blocks, bad)
        assert rc != 0, bad
    label, qp, xs, ys, D, E, c, blocks, tol = next(warp_cases(torch.float32))
    B = xs.shape[0]
    for bad in [(32 * 17, 1, 1), (64, B, 1),   # 17 warps; blocks not B / 2
                (64, B, 2), (48, 1, 2)]:       # more blocks than warps need;
                                               # not whole warps
        rc, _ = tail.run_unscale(harness.unscale, *qp, xs, ys, D, E, c, tol,
                                 blocks, bad)
        assert rc != 0, bad


# -------------------------------------------------------------- layouts

@pytest.mark.parametrize("B", [1, 256, 4096])
def test_layouts_on_h100(B):
    kkt = tail.kkt_layout(B, N_MPC, M_MPC, BLOCKS, H100_OPTIN)
    tile = tail.KKT_THREADS * tail.LAYOUT["kkt_pieces"] * 4
    assert kkt.path == "tiles" and kkt.lanes == 4
    assert kkt.geometry == (tail.KKT_THREADS, B * 9, 4) and tile * 9 == \
        N_MPC * N_MPC
    assert kkt.smem_bytes == tail.kkt_smem_bytes(N_MPC, 3, tile, True, 4) \
        == 16 + 4 * (tile + tail.kkt_smem_values(N_MPC, 3, tile))
    assert kkt.smem_bytes <= H100_OPTIN
    one = tail.kkt_layout(B, N_MPC, M_MPC, BLOCKS, H100_OPTIN, aligned=False)
    assert one.lanes == 1 and one.blocks == B * 36
    assert one.smem_bytes == 4 * tail.kkt_smem_values(N_MPC, 3, tile // 4)
    f64 = tail.kkt_layout(B, N_MPC, M_MPC, BLOCKS, H100_OPTIN, torch.float64)
    assert f64.lanes == 2 and f64.blocks == B * 18
    with pytest.raises(ValueError):
        tail.kkt_layout(B, N_MPC, M_MPC, BLOCKS, kkt.smem_bytes - 4)
    # the WBC shape: the warp path, warps spread over the multiprocessors;
    # two slots, at most a block a multiprocessor, where the rows are
    # aligned
    wbc = tail.tail_layout(30, 50, B, H100_OPTIN, H100_SMS, dense=True)
    slot = tail.unscale_smem_bytes(30, 50, True, 1, 2, 4)
    warps = min(tail.LAYOUT["max_warps"], H100_OPTIN // slot,
                -(-B // H100_SMS))
    assert H100_OPTIN // slot == 11
    assert wbc.path == "warp" and wbc.lanes == 2
    assert wbc.geometry == (32 * warps, min(-(-B // warps), H100_SMS), 2)
    assert wbc.smem_bytes == tail.unscale_smem_bytes(30, 50, True, warps, 2,
                                                     4)
    assert wbc.smem_bytes <= H100_OPTIN
    one = tail.tail_layout(30, 50, B, H100_OPTIN, H100_SMS, dense=True,
                           aligned=False)
    slot1 = tail.unscale_smem_bytes(30, 50, True, 1, 1, 4)
    w1 = min(tail.LAYOUT["max_warps"], H100_OPTIN // slot1, -(-B // H100_SMS))
    assert one.geometry == (32 * w1, -(-B // w1), 1)
    assert one.smem_bytes == w1 * slot1
    squeezed = tail.tail_layout(30, 50, B, 2 * slot, H100_SMS, dense=True)
    assert squeezed.threads == 32 * min(2, warps)
    with pytest.raises(ValueError):
        tail.tail_layout(30, 50, B, slot - 16, H100_SMS, dense=True)
    # the MPC shape: a block a scenario
    mpc = tail.tail_layout(N_MPC, M_MPC, B, H100_OPTIN, H100_SMS,
                           dense=False)
    threads = 256 if B >= 4 * H100_SMS else 512
    assert mpc.path == "block" and mpc.geometry == (threads, B, 32)
    assert mpc.smem_bytes == tail.unscale_smem_bytes(N_MPC, M_MPC, False,
                                                     0, 1, 4)
    assert mpc.smem_bytes <= H100_OPTIN
    assert tail.tail_layout(N_MPC, M_MPC, B, H100_OPTIN, H100_SMS, False,
                            aligned=False) == mpc
    dense = tail.tail_layout(N_MPC, M_MPC, B, H100_OPTIN, H100_SMS, True,
                             torch.float64)
    assert dense.smem_bytes == tail.unscale_smem_bytes(N_MPC, M_MPC, True,
                                                       0, 1, 8)
    with pytest.raises(ValueError):
        tail.tail_layout(N_MPC, M_MPC, B, mpc.smem_bytes - 4, H100_SMS,
                         dense=False)
    # adapt_rho takes the warp path's geometry (its own shared memory) and
    # a block of 512 threads a scenario at every B
    assert tail.adapt_layout(N_MPC, M_MPC, B, H100_OPTIN, H100_SMS,
                             False).geometry == (tail.TAIL_THREADS, B, 32)
    assert tail.adapt_layout(30, 50, B, H100_OPTIN, H100_SMS, True
                             ).geometry == wbc.geometry
