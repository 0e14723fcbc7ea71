"""The redesigned `adapt_rho` on the CPU: the epilogue's two layouts with
sums in double, built with g++ from qp/csrc/solve_tail.h
(`_torch_port_util.build_solve_tail_harness`: a warp's 32 lanes one after
another in each phase, a block's units likewise, each in order and
reversed, from NaN-filled shared memory, with the launcher's geometry
checks) and driven by the wrapper's packing (`qp/tail.py::run_adapt`).

Bits.  rho equals `tail.adapt_in_order` (the kernel's sums written out as
elementwise float64 PyTorch ops, each rounding once) bit for bit on both
paths: the warp path (a lane a row of P and of A over j in index order, a
column of A' y over k; one slot staged by the lanes, two slots copied in
whole) and the block path (32 partials of each row over j = l, l + 32,
..., summed in order; 128 and 512 threads, n = 192 with every load of a
row group unrolled and other n).  These are the first design's orders,
so rho keeps its bits; `adapt_in_order` is also held to the plain version
(`qp/admm.py::_adapt_rho`) in float64 within 1e-13 (relative).  A
non-finite iterate gives NaN for its scenario and leaves the others'.
"""

import pytest
import torch

from mpctsid_tpu_torch.qp import admm as tadmm
from mpctsid_tpu_torch.qp import tail

from _torch_port_util import build_solve_tail_harness, stacked
from test_torch_solve_tail_kernels import (BLOCKS, DTYPES, H100_OPTIN,
                                           H100_SMS, mpc_qp, scaled_state)
from test_torch_solve_tail_redesign import offset_copy, small_block_qp

N_MPC, M_MPC = 192, 320


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    return build_solve_tail_harness(tmp_path_factory.mktemp("adapt"))


def equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and bool(
        torch.equal(a.isnan(), b.isnan())
        and torch.equal(a[~a.isnan()], b[~b.isnan()]))


def adapt_args(qp, seed):
    """(P, q, A, x, z, y, rho_s) of the scaled problem of `qp` and an
    iterate 20 plain iterations reach."""
    (Ps, qs, As, *_), _, rho_s, (x, z, y) = scaled_state(qp, seed)
    return Ps, qs, As, x, z, y, rho_s


def warp_cases(dtype, B):
    """(label, args, a_blocks) within `warp_dim`: the WBC's dense 30 x 50
    and a declared block-diagonal 24 x 40."""
    qp = [torch.tensor(a, dtype=dtype)
          for a in stacked(range(B), n=30, m=50)]
    yield "wbc, dense", adapt_args(qp, 10 + B), None
    yield "24 x 40, blocks", adapt_args(
        small_block_qp(40 + B, B, 24, 40, dtype), 41), BLOCKS


def block_cases(dtype, B):
    """The MPC's QPs with their blocks declared (n = 192) and dense, a
    block-diagonal 96 x 160 and the WBC's 30 x 50 (n not 192)."""
    args = adapt_args(mpc_qp(9 + B, B, dtype), 9)
    yield "mpc, blocks", args, BLOCKS
    yield "mpc, dense", args, None
    yield "96 x 160, blocks", adapt_args(
        small_block_qp(50 + B, B, 96, 160, dtype), 51), BLOCKS
    qp = [torch.tensor(a, dtype=dtype) for a in stacked(range(B), n=30, m=50)]
    yield "wbc, dense", adapt_args(qp, 52), None


@pytest.mark.parametrize("slots", [1, 2])
@pytest.mark.parametrize("warps", [1, 3, 8])
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("dtype", DTYPES)
def test_warp_path_bit_for_bit_in_order(harness, dtype, B, warps, slots):
    for label, args, blocks in warp_cases(dtype, B):
        want = tail.adapt_in_order(*args, blocks, lanes=slots)
        geometry = (32 * warps, -(-B // warps) if slots == 1 else 1, slots)
        for fn in (harness.adapt, harness.adapt_reversed):
            rc, rho = tail.run_adapt(fn, *args, blocks, geometry)
            assert rc == 0, label
            assert equal(rho, want), label


@pytest.mark.parametrize("threads", [128, 512])
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("dtype", DTYPES)
def test_block_path_bit_for_bit_in_order(harness, dtype, B, threads):
    for label, args, blocks in block_cases(dtype, B):
        want = tail.adapt_in_order(*args, blocks, lanes=32)
        for fn in (harness.adapt, harness.adapt_reversed):
            rc, rho = tail.run_adapt(fn, *args, blocks, (threads, B, 32))
            assert rc == 0, label
            assert equal(rho, want), label


@pytest.mark.parametrize("dtype", DTYPES)
def test_in_order_is_the_plain_version_within_rounding(dtype):
    """Both orders against the plain chain run in float64 on the same
    inputs: float64 within 1e-13, float32 within 1e-6 (a float32 rounding
    of rho is 6e-8), relative."""
    for label, args, blocks in block_cases(dtype, 3):
        w64 = tadmm._adapt_rho(*(t.double() for t in args))
        for lanes in (1, 32):
            got = tail.adapt_in_order(*args, blocks, lanes=lanes)
            rel = float(((got.double() - w64).abs() / w64.abs()).max())
            assert rel <= (1e-13 if dtype == torch.float64 else 1e-6), label


@pytest.mark.parametrize("geometry", [(64, 2, 1), (64, 1, 2), (128, 3, 32)])
def test_non_finite_iterate(harness, geometry):
    """NaN and inf in x, and NaN in z: NaN for those scenarios (as the
    plain version's maxima give it), on every path; the others' bits
    unchanged."""
    label, args, blocks = next(warp_cases(torch.float32, 3))
    P, q, A, x, z, y, rho_s = args
    x = x.clone()
    x[1, 4] = float("nan")
    z = z.clone()
    z[2, 0] = float("nan")
    bad = (P, q, A, x, z, y, rho_s)
    _, rho = tail.run_adapt(harness.adapt, *bad, blocks, geometry)
    want = tail.adapt_in_order(*bad, blocks, lanes=geometry[2])
    plain = tadmm._adapt_rho(*bad)
    assert equal(rho, want)
    assert bool(rho[1:].isnan().all()) and bool(plain[1:].isnan().all())
    _, clean = tail.run_adapt(harness.adapt, *args, blocks, geometry)
    assert torch.equal(rho[0], clean[0]) and not bool(clean.isnan().any())


@pytest.mark.parametrize("dtype", DTYPES)
def test_unaligned_rows(harness, dtype):
    """P and A one element past a 16-byte boundary: the layout takes one
    slot (the lanes stage the rows) with the same bits; two slots are
    refused; the block path reads any alignment."""
    label, args, blocks = next(warp_cases(dtype, 4))
    P, q, A, x, z, y, rho_s = args
    moved = (offset_copy(P), q, offset_copy(A), x, z, y, rho_s)
    assert not tail.bulk_rows(moved[0], 30 * 30)
    lay = tail.adapt_layout(30, 50, 4, H100_OPTIN, H100_SMS, True, dtype,
                            aligned=False)
    assert lay.path == "warp" and lay.lanes == 1
    want = tail.adapt_in_order(*args, blocks)
    for fn in (harness.adapt, harness.adapt_reversed):
        rc, rho = tail.run_adapt(fn, *moved, blocks, lay.geometry)
        assert rc == 0 and equal(rho, want)
    rc, _ = tail.run_adapt(harness.adapt, *moved, blocks, (64, 1, 2))
    assert rc != 0
    label, args, blocks = next(block_cases(dtype, 2))
    P = args[0]
    want = tail.adapt_in_order(*args, blocks, lanes=32)
    rc, rho = tail.run_adapt(harness.adapt, offset_copy(P), *args[1:],
                             blocks, (512, 2, 32))
    assert rc == 0 and equal(rho, want)


def test_refused_geometries(harness):
    label, args, blocks = next(block_cases(torch.float32, 3))
    for bad in [(256, 3, 1),          # the warp path at n = 192
                (256, 4, 32),         # not a block a scenario
                (256, 3, 8)]:         # lanes neither 1, 2 nor 32
        rc, _ = tail.run_adapt(harness.adapt, *args, blocks, bad)
        assert rc != 0, bad
    label, args, blocks = next(warp_cases(torch.float32, 3))
    for bad in [(32 * 17, 1, 1), (64, 3, 1),   # 17 warps; blocks not B / 2
                (64, 3, 2), (48, 1, 2)]:       # more blocks than warps need;
                                               # not whole warps
        rc, _ = tail.run_adapt(harness.adapt, *args, blocks, bad)
        assert rc != 0, bad


@pytest.mark.parametrize("B", [1, 256, 4096])
def test_adapt_layout_on_h100(B):
    """The WBC shape: the warp path, two slots where aligned (at most a
    block a multiprocessor), one slot else; the MPC shape: the block path,
    512 threads at every B; shared memory within the limit and a ValueError
    past it."""
    for dtype, size in ((torch.float32, 4), (torch.float64, 8)):
        wbc = tail.adapt_layout(30, 50, B, H100_OPTIN, H100_SMS, True, dtype)
        slot = tail.adapt_smem_bytes(30, 50, True, 1, 2, size)
        warps = min(tail.LAYOUT["max_warps"], H100_OPTIN // slot,
                    -(-B // H100_SMS))
        assert wbc == tail.TailLayout(
            "warp", 32 * warps, min(-(-B // warps), H100_SMS),
            warps * slot, 2)
        assert wbc.smem_bytes <= H100_OPTIN
        one = tail.adapt_layout(30, 50, B, H100_OPTIN, H100_SMS, True, dtype,
                                aligned=False)
        slot1 = tail.adapt_smem_bytes(30, 50, True, 1, 1, size)
        w1 = min(tail.LAYOUT["max_warps"], H100_OPTIN // slot1,
                 -(-B // H100_SMS))
        assert one.geometry == (32 * w1, -(-B // w1), 1)
        with pytest.raises(ValueError):
            tail.adapt_layout(30, 50, B, slot - 16, H100_SMS, True, dtype)
        mpc = tail.adapt_layout(N_MPC, M_MPC, B, H100_OPTIN, H100_SMS, False,
                                dtype)
        assert mpc == tail.TailLayout(
            "block", 512, B,
            tail.adapt_smem_bytes(N_MPC, M_MPC, False, 0, 1, size), 32)
        assert mpc.smem_bytes <= H100_OPTIN
        with pytest.raises(ValueError):
            tail.adapt_layout(N_MPC, M_MPC, B, mpc.smem_bytes - 8, H100_SMS,
                              False, dtype)
    # the slot's doubles (x, y) start 8-byte aligned after the rows
    assert tail.adapt_smem_bytes(31, 50, True, 1, 1, 4) % 16 == 0


@pytest.fixture(scope="module")
def first_design(tmp_path_factory):
    from _torch_port_util import build_first_design_harness

    return build_first_design_harness(tmp_path_factory.mktemp("first"),
                                      "adapt_rho")


@pytest.mark.parametrize("dtype", DTYPES)
def test_rho_is_the_first_designs(harness, first_design, dtype):
    """The first design (its solve_tail.h, kept in
    scripts/probe_kernel_designs.py) built on the host beside the new one:
    its unit a row (lanes 1) against the warp path, its 32 units a row
    against the block path, rho bit for bit."""
    for label, args, blocks in warp_cases(dtype, 5):
        _, want = tail.run_adapt(first_design, *args, blocks, (128, 5, 1))
        for geometry in ((64, 3, 1), (96, 1, 2)):
            _, rho = tail.run_adapt(harness.adapt, *args, blocks, geometry)
            assert equal(rho, want), (label, geometry)
    for label, args, blocks in block_cases(dtype, 3):
        _, want = tail.run_adapt(first_design, *args, blocks, (512, 3, 32))
        _, rho = tail.run_adapt(harness.adapt, *args, blocks, (256, 3, 32))
        assert equal(rho, want), label
