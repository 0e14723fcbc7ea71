"""The pipelined MPC QP build on the CPU: mpc/csrc/mpc_build.h built with
g++ (`_torch_port_util.build_mpc_build_harness`) and driven by the
wrapper's packing (`mpc.srb.run_mpc_build`) in three schedules of the same
units, each from NaN-filled shared memory: the card's pipeline in one
thread (the producer's step j, then the consumers' row block j), the first
design's phase order (the whole recursion, then every row block), and the
pipeline with the row blocks delayed at random (each only after the step
that publishes its W_j, the units of each phase in order or reversed at
random).

Bits.  Every schedule gives the same P, q, l and u bit for bit: no unit
reads what another writes in its phase, and no row block reads what a
later step of the recursion overwrites (S, T and g change every step; a row
block that read them, or a W_i not yet published, would part or show NaN).
The layout: shared memory in values and mbarrier bytes as the header
counts it, the blocks a multiprocessor on an H100's limits, the refusal
edges in N.
"""

import pytest
import torch

from mpctsid_tpu_torch.model.solo12 import SOLO12
from mpctsid_tpu_torch.mpc import kernels as mk
from mpctsid_tpu_torch.mpc import srb as tsrb

from _torch_port_util import build_mpc_build_harness
from test_torch_mpc_build_kernel import (CFG, DTYPES, H100_OPTIN,
                                         H100_SMEM_PER_SM, as_tensors,
                                         scenarios)

N = CFG.mpc.horizon


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    return build_mpc_build_harness(tmp_path_factory.mktemp("mpc_redesign"))


def build(fn, t, mass):
    rc, out = tsrb.run_mpc_build(fn, SOLO12, CFG.mpc, *t, mass)
    assert rc == 0
    return out


def same(a, b):
    return all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("with_mass", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", [1, 5, 37])
def test_pipeline_bit_for_bit_the_phase_order(harness, B, dtype, with_mass):
    """(a) The pipeline (units in order and reversed) against the first
    design's phase order over the same units (in order and reversed): P,
    q, l and u bit for bit, P written whole and exactly symmetric."""
    t, mass = as_tensors(scenarios(100 + B, B), dtype, with_mass)
    want = build(harness.phases, t, mass)
    assert not any(bool(w.isnan().any()) for w in want)
    assert torch.equal(want[0], want[0].transpose(1, 2))
    for fn in (harness.launch, harness.launch_reversed,
               harness.phases_reversed):
        assert same(build(fn, t, mass), want)


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("dtype", DTYPES)
def test_row_blocks_delayed_after_their_step(harness, dtype, seed):
    """(d) Row blocks run late and out of order, each only after the step
    that publishes its W_j, while the recursion goes on overwriting S, T
    and g: the same bits as the pipeline in order."""
    t, mass = as_tensors(scenarios(200 + seed, 7), dtype, seed % 2 == 0)
    want = build(harness.launch, t, mass)
    harness.shuffle_seed(seed)
    assert same(build(harness.shuffled, t, mass), want)


def test_a_row_block_before_its_step_would_show(harness):
    """What the schedules rely on: the buffers a row block reads hold NaN
    until the recursion's step has written them, so row block N-1 run
    before its step leaves NaN in its rows and columns of P (and only
    there), where the pipeline leaves every value finite."""
    t, mass = as_tensors(scenarios(300, 2), torch.float32, False)
    good = build(harness.launch, t, mass)
    assert all(bool(torch.isfinite(o).all()) for o in good)
    P = build(harness.early, t, mass)[0]
    rows = slice(12 * (N - 1), 12 * N)
    assert bool(P[:, rows].isnan().any())
    assert torch.equal(P[:, :12 * (N - 1)], good[0][:, :12 * (N - 1)])


@pytest.mark.parametrize("B", [1, 37, 4096])
def test_layout_on_the_h100(harness, B):
    """(c) Shared memory as the header counts it (values after N 8-byte
    mbarriers, rounded to 16), the blocks a multiprocessor by shared
    memory, threads and the launch bounds (4 in float32, 2 in float64), and
    fewer where a device offers less shared memory."""
    for n in (1, 2, 15, 16, 17, 24, 36):
        assert harness.smem_values(n) == mk.smem_values(n)
        assert harness.barrier_bytes(n) == mk.barrier_bytes(n) == \
            (8 * n + 15) // 16 * 16
    for dtype, size, per_sm in ((torch.float32, 4, 4),
                                (torch.float64, 8, 2)):
        lay = mk.mpc_build_layout(B, N, dtype, H100_OPTIN, H100_SMEM_PER_SM)
        smem = 128 + size * 14076
        assert lay == mk.MpcBuildLayout(B, mk.LAYOUT["threads"], smem,
                                        per_sm)
        assert mk.smem_bytes(N, dtype) == smem <= H100_OPTIN
        assert per_sm * (smem + 1024) <= H100_SMEM_PER_SM
        # a device with half the shared memory a multiprocessor
        half = mk.mpc_build_layout(B, N, dtype, H100_OPTIN,
                                   H100_SMEM_PER_SM // 2)
        assert half.blocks_per_sm == max(1, per_sm // 2)
    # float32 at N = 16: 4 blocks of 384 threads fit by shared memory,
    # the launch bounds keep registers from capping them lower
    assert mk.LAYOUT["min_blocks_f32"] * mk.LAYOUT["threads"] <= 2048


@pytest.mark.parametrize("dtype, edge", [(torch.float32, 36),
                                         (torch.float64, 24)])
def test_layout_refusal_edges(dtype, edge):
    assert mk.mpc_build_layout(1, edge, dtype, H100_OPTIN).smem_bytes <= \
        H100_OPTIN
    with pytest.raises(ValueError):
        mk.mpc_build_layout(1, edge + 1, dtype, H100_OPTIN)
    with pytest.raises(ValueError):
        mk.mpc_build_layout(1, N, dtype, mk.smem_bytes(N, dtype) - 1)


@pytest.fixture(scope="module")
def first_design(tmp_path_factory):
    from _torch_port_util import build_first_design_harness

    return build_first_design_harness(tmp_path_factory.mktemp("first"),
                                      "mpc_build")


@pytest.mark.parametrize("with_mass", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_pipeline_is_the_first_designs(harness, first_design, dtype,
                                       with_mass):
    """The first design (its mpc_build.h, kept in
    scripts/probe_kernel_designs.py) built on the host beside the new one,
    both without contraction: P, q, l and u bit for bit."""
    t, mass = as_tensors(scenarios(400, 9), dtype, with_mass)
    assert same(build(harness.launch, t, mass), build(first_design, t, mass))
