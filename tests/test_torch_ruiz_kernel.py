"""The Ruiz kernel's arithmetic on the CPU: qp/csrc/ruiz.h built with g++
(`_torch_port_util.build_ruiz_harness`: the warp path's 32 lanes one after
another in each phase, the cluster path's ranks in turn with the exchange
delivered between stages, in NaN-filled memory, with the launcher's C
signature less the stream) and driven by the wrapper's own packing
(`qp.kernels.run_ruiz`), held against the plain version
(qp/admm.py::ruiz_equilibrate) and the JAX function, with the MPC's
stride-0 constraint matrix and with dense ones.

Tolerances.  Every maximum and product is the plain version's; the host twin
takes 1 / sqrtf for rsqrt, as PyTorch on the CPU does; only the mean column
norm is summed in another order (the kernel's tree against PyTorch's).  So
the header is held to the plain version within 1e-6 relative (measured:
equal bits), and to the JAX function within the budgets of
tests/test_torch_admm.py::test_ruiz_scales_match_jax (scales 1e-5 relative,
matrices 1e-5 of their largest entry).  The paths, cluster sizes, the lists
of A's nonzeros and P's place give the same bits by design (maxima on bit
patterns in any order, one fixed sum tree): those are held bit for bit.
"""

import numpy as np
import pytest
import torch

import jax

from mpctsid_tpu.qp import admm as jadmm
from mpctsid_tpu_torch.config import EngineConfig
from mpctsid_tpu_torch.mpc.srb import _constraint_matrix
from mpctsid_tpu_torch.qp import admm as tadmm
from mpctsid_tpu_torch.qp import kernels

from _torch_port_util import build_ruiz_harness, jj, npy, stacked

INF = 1e20
NAMES = ("Pb", "qb", "Ab", "lb", "ub", "D", "E", "c")


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    return build_ruiz_harness(tmp_path_factory.mktemp("ruiz"))


def mpc_like(seed, B, N=4):
    """QPs of the MPC's structure: SPD P with the swing feet's 1e6 ridge,
    q, the pyramid constant broadcast to every scenario (stride 0), bounds
    with the infinite convention."""
    r = np.random.default_rng(seed)
    n, m = 12 * N, 20 * N
    Q = r.normal(size=(B, n, n))
    P = Q @ Q.transpose(0, 2, 1) / n + np.eye(n)
    swing = r.uniform(size=(B, n)) < 0.3
    P[:, np.arange(n), np.arange(n)] += 1e6 * swing
    A = torch.tensor(_constraint_matrix(N, EngineConfig().mpc.mu),
                     dtype=torch.float32).expand(B, m, n)
    l = np.where(r.uniform(size=(B, m)) < 0.5, -INF, 0.0)
    u = np.where(r.uniform(size=(B, m)) < 0.5, INF, r.uniform(5, 25, (B, m)))
    f = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    return [f(P), f(r.normal(size=(B, n)) * 10.0), A, f(l), f(u)]


def dense(seed, B, n, m, eq=True):
    return [torch.tensor(a) for a in stacked(range(seed, seed + B), n=n, m=m,
                                              eq=eq)]


def rel(got, want):
    """Largest |got - want| over the largest |want| (finite entries; the
    infinite bounds must be equal)."""
    inf = want.abs() >= 1e19
    assert torch.equal(got[inf], want[inf])
    if bool((~inf).any()):
        return float((got - want)[~inf].abs().max()
                     / want[~inf].abs().max().clamp_min(1e-30))
    return 0.0


WARP, CLUSTER = 0, 1


def header(harness, qp, iters=8, geometry=None):
    """The host build on `qp`; `geometry` the launcher's (path, size,
    p_in_smem, slots), by default the cluster path on one block with P in
    shared memory and the lists of A's nonzeros."""
    geometry = geometry or (CLUSTER, 1, 1, kernels.RUIZ_SLOTS)
    rc, out = kernels.run_ruiz(harness.launch, *qp, iters, geometry)
    assert rc == 0
    return out


def same_bits(got, want):
    return all(torch.equal(torch.isnan(g), torch.isnan(w))
               and torch.equal(g[~torch.isnan(g)], w[~torch.isnan(w)])
               for g, w in zip(got, want))


CASES = {"mpc-like, stride-0 A": lambda: mpc_like(0, 5),
         "wbc shape, dense A": lambda: dense(10, 4, 30, 50),
         "n=45 m=70 (a partial warp)": lambda: dense(20, 3, 45, 70),
         "n=300 m=90 (two column sweeps)": lambda: dense(30, 2, 300, 90,
                                                         eq=False)}
# (cluster size, P in shared memory, slots) of the cluster path
CLUSTER_GEOMETRIES = [(1, True, 4), (1, False, 4), (1, True, 0),
                      (1, True, 1), (2, True, 4), (4, False, 0),
                      (8, True, 1)]


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("cluster,p_in_smem,slots", CLUSTER_GEOMETRIES)
def test_header_against_plain(harness, case, cluster, p_in_smem, slots):
    """The cluster path on 1-8 blocks; P's columns in shared memory or read
    each pass; A's nonzeros kept (4 or 1 a group and column: the MPC's
    pyramid fits 4, not 1, and a dense A neither) or A read whole every
    round: the plain version's values."""
    qp = CASES[case]()
    got = header(harness, qp, geometry=(CLUSTER, cluster, int(p_in_smem),
                                        slots))
    want = tadmm.ruiz_equilibrate(*qp, 8)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert g.is_contiguous(), name
        assert rel(g, w) <= 1e-6, name
    # the scales elementwise
    for g, w in zip(got[5:], want[5:]):
        assert float(((g - w).abs() / w.abs()).max()) <= 1e-6


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("cluster", [2, 4, 8])
def test_cluster_sizes_give_the_bits_of_one_block(harness, case, cluster):
    """A cluster of 2, 4 or 8 blocks, each on its slice of the columns with
    the exchange between stages, against one block: the same bits (each
    block forms E and c from all blocks' row maxima and column norms, the
    sum in one tree of n)."""
    qp = CASES[case]()
    for p_in_smem, slots in ((1, 4), (0, 0)):
        one = header(harness, qp, geometry=(CLUSTER, 1, p_in_smem, slots))
        got = header(harness, qp, geometry=(CLUSTER, cluster, p_in_smem,
                                            slots))
        assert same_bits(got, one)


@pytest.mark.parametrize("n,m", [(24, 40), (30, 50), (32, 64), (32, 20)])
def test_warp_path_gives_the_bits_of_the_cluster_path(harness, n, m):
    """The warp path (a lane a column, rows by shuffles, a row's maximum one
    reduction) at n = 24, 30 and 32: the cluster path's bits, and the plain
    version's values."""
    qp = dense(100 + n, 3, n, m)
    got = header(harness, qp, geometry=(WARP, 1, 0, 0))
    assert same_bits(got, header(harness, qp))
    want = tadmm.ruiz_equilibrate(*qp, 8)
    assert all(rel(g, w) <= 1e-6 for g, w in zip(got, want))


def test_warp_path_refuses_what_it_cannot_hold(harness):
    """n = 33 or m = 65 do not fit a warp's registers: the host launcher
    returns an error (the card's does too), and `ruiz_layout` sends them to
    the cluster path."""
    for n, m in ((33, 40), (30, 65)):
        qp = dense(110, 2, n, m)
        rc, _ = kernels.run_ruiz(harness.launch, *qp, 8, (WARP, 1, 0, 0))
        assert rc != 0
        lay = kernels.ruiz_layout(n, m, 4096, 232448, 132)
        assert lay.path == "cluster"
        got = header(harness, qp, geometry=lay.geometry)
        want = tadmm.ruiz_equilibrate(*qp, 8)
        assert all(rel(g, w) <= 1e-6 for g, w in zip(got, want))


@pytest.mark.parametrize("n", [32, 33])
def test_path_edge(harness, n):
    """n = 32 is the warp path's last width, n = 33 the cluster path's
    first (on 2 blocks of 20 and 13 columns at a large batch): each gives
    the plain version's values and the other path's bits."""
    qp = dense(120 + n, 3, n, 50)
    lay = kernels.ruiz_layout(n, 50, 4096, 232448, 132)
    assert lay.path == ("warp" if n == 32 else "cluster")
    got = header(harness, qp, geometry=lay.geometry)
    other = ((CLUSTER, 2, 1, 4) if n == 32 else (CLUSTER, 1, 0, 0))
    assert same_bits(got, header(harness, qp, geometry=other))
    want = tadmm.ruiz_equilibrate(*qp, 8)
    assert all(rel(g, w) <= 1e-6 for g, w in zip(got, want))


@pytest.mark.parametrize("n", [1, 7, 30, 32, 33, 64, 100, 192, 256, 300,
                               1000, 1100])
def test_sum_tree_is_unchanged_across_threads(harness, n):
    """The one sum: `tree_sum` (what every path and every block of a
    cluster forms, skipping the warps that hold no value) against the first
    design's block sum over T threads, for every T that holds a value a
    thread (T >= n): the same bits, whatever T; and over the first design's
    own T where a thread holds several (n > 1024)."""
    r = np.random.default_rng(n)
    v = (r.uniform(size=n) * 10.0 ** r.integers(-6, 6, n)).astype(np.float32)
    want = harness.tree_sum(v, n)
    own = 4 * min(-(-n // 32) * 32, 256)
    Ts = sorted({own} | {T for T in (32, 64, 128, 256, 384, 512, 768, 1024)
                         if T >= n})
    for T in Ts:
        got = harness.block_sum(v, n, T)
        assert np.float32(got).tobytes() == np.float32(want).tobytes(), T
    if n <= 1024:
        # one value a thread: the warps' sums in order
        sums = [np.float32(0.0)]
        for w in range(0, n, 32):
            lane = v[w:w + 32].copy()
            lane = np.concatenate([lane, np.zeros(32 - len(lane),
                                                  np.float32)])
            for off in (16, 8, 4, 2, 1):
                lane[:off] = lane[:off] + lane[off:2 * off]
            sums.append(np.float32(sums[-1] + lane[0]))
        assert sums[-1].tobytes() == np.float32(want).tobytes()


@pytest.mark.parametrize("geometry", [(CLUSTER, 1, 1, 4),
                                      (CLUSTER, 4, 1, 4)])
@pytest.mark.parametrize("iters", [0, 1, 3])
def test_header_round_counts(harness, iters, geometry):
    qp = mpc_like(1, 3)
    got = header(harness, qp, iters=iters, geometry=geometry)
    want = tadmm.ruiz_equilibrate(*qp, iters)
    assert all(rel(g, w) <= 1e-6 for g, w in zip(got, want))
    if iters == 0:
        assert torch.equal(got[5], torch.ones_like(got[5]))
        assert torch.equal(got[7], torch.ones_like(got[7]))


@pytest.mark.parametrize("iters", [0, 1, 3])
def test_warp_path_round_counts(harness, iters):
    qp = dense(130, 3, 30, 50)
    got = header(harness, qp, iters=iters, geometry=(WARP, 1, 0, 0))
    want = tadmm.ruiz_equilibrate(*qp, iters)
    assert all(rel(g, w) <= 1e-6 for g, w in zip(got, want))
    assert same_bits(got, header(harness, qp, iters=iters))


@pytest.mark.parametrize("path", ["warp", "cluster"])
@pytest.mark.parametrize("eq", [True, False])
def test_header_against_jax(harness, eq, path):
    qp = dense(40, 4, 24, 40, eq=eq)
    got = header(harness, qp, geometry=(WARP, 1, 0, 0) if path == "warp"
                 else (CLUSTER, 2, 1, 4))
    want = jax.vmap(jadmm.ruiz_equilibrate)(*[jj(npy(a)) for a in qp])
    for name, g, w in zip(NAMES, got, want):
        w = npy(w)
        if name in ("D", "E", "c"):
            np.testing.assert_allclose(npy(g), w, rtol=1e-5, err_msg=name)
        else:
            fin = np.abs(w) < 1e19
            np.testing.assert_array_equal(npy(g)[~fin], w[~fin])
            assert np.abs(npy(g)[fin] - w[fin]).max() <= \
                1e-5 * np.abs(w[fin]).max(), name


@pytest.mark.parametrize("cluster", [1, 2])
def test_header_against_jax_stride0_a(harness, cluster):
    qp = mpc_like(2, 4)
    got = header(harness, qp, geometry=(CLUSTER, cluster, 1, 4))
    want = jax.vmap(jadmm.ruiz_equilibrate)(*[jj(npy(a.contiguous()))
                                              for a in qp])
    for name, g, w in zip(NAMES, got, want):
        w = npy(w)
        fin = np.abs(w) < 1e19
        assert np.abs(npy(g)[fin] - w[fin]).max() <= \
            1e-5 * np.abs(w[fin]).max(), name


@pytest.mark.parametrize("geometry", [(CLUSTER, 1, 1, 4), (CLUSTER, 2, 1, 4),
                                      (CLUSTER, 4, 0, 0), (WARP, 1, 0, 0)])
def test_nan_stays_in_its_scenario(harness, geometry):
    """A NaN in one scenario's P gives that scenario the plain version's
    NaN pattern and leaves the others bit for bit as without it."""
    qp = dense(50, 3, 20, 30)
    bad = [t.clone() for t in qp]
    bad[0][1, 2, 3] = float("nan")
    got = header(harness, bad, geometry=geometry)
    clean = header(harness, qp, geometry=geometry)
    want = tadmm.ruiz_equilibrate(*bad, 8)
    for g, w, c in zip(got, want, clean):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        assert torch.equal(g[[0, 2]], c[[0, 2]])


def test_layout_and_shared_memory_count(harness):
    """The header's counts (threads, slice width, shared memory) against the
    wrapper's layout and its copy of the count, every cluster size."""
    for n, m in ((30, 50), (192, 320), (45, 70), (300, 90), (1000, 2000),
                 (33, 55)):
        for B in (1, 37, 4096):
            lay = kernels.ruiz_layout(n, m, B, 10**9, 132)
            if lay.path == "cluster":
                assert harness.threads(n, lay.cluster) == lay.threads
                assert harness.slice_width(n, lay.cluster) == lay.width
                assert harness.smem_floats(n, m, lay.cluster,
                                           int(lay.p_in_smem), lay.slots) \
                    == lay.smem_floats
        for C in (1, 2, 3, 4, 8):
            assert harness.slice_width(n, C) == kernels.ruiz_slice_width(n, C)
            for p in (True, False):
                for slots in (0, 1, 4):
                    assert harness.smem_floats(n, m, C, int(p), slots) == \
                        kernels.ruiz_smem_floats(n, m, C, p, slots)


def test_kept_nonzeros_equal_reading_a_whole(harness):
    """The stride-0 pyramid (at most 2 nonzeros a group and column) read
    from the kept lists after the first round and Ab written from them, a
    dense A (too many) read whole: each bit for bit as with no list at all,
    also with a NaN and an infinity in A (kept as nonzeros), a -0.0 in A
    (Ab then read from A: its sign) and a NaN in P (a NaN scale: Ab's zeros
    in its column NaN, as the plain version's 0 * NaN)."""
    mpc = mpc_like(5, 3)
    a = mpc[2].contiguous().clone()
    a[1, 7, 4] = float("nan")
    a[2, 9, 10] = float("inf")
    z = mpc[2].contiguous().clone()
    z[0, 3, 5] = -0.0
    nanp = [t.clone() for t in mpc]
    nanp[0][1, 2, 2] = float("nan")
    for qp in (mpc, dense(80, 3, 30, 50), mpc[:2] + [a] + mpc[3:],
               mpc[:2] + [z] + mpc[3:], nanp):
        for cluster in (1, 2, 4):
            kept = header(harness, qp, geometry=(CLUSTER, cluster, 1, 4))
            whole = header(harness, qp, geometry=(CLUSTER, cluster, 1, 0))
            assert same_bits(kept, whole)
    assert bool(torch.isnan(header(harness, nanp)[2][1]).any())
    # the -0.0 keeps its sign in Ab
    got = header(harness, mpc[:2] + [z] + mpc[3:])
    assert torch.signbit(got[2][0, 3, 5]) and got[2][0, 3, 5] == 0


def test_cpu_wrapper_is_the_plain_version():
    for qp in (mpc_like(3, 2), dense(60, 2, 30, 50)):
        got = kernels.ruiz_equilibrate(*qp, 8)
        want = tadmm.ruiz_equilibrate(*qp, 8)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    # on the CPU any dtype passes through to the plain version
    q64 = [t.double() for t in dense(61, 2, 10, 12)]
    assert kernels.ruiz_equilibrate(*q64, 8)[0].dtype == torch.float64


def test_argument_checks(harness):
    qp = dense(70, 2, 10, 12)
    g = (CLUSTER, 1, 1, 4)
    with pytest.raises(TypeError):
        kernels.run_ruiz(harness.launch, qp[0].double(), *qp[1:], 8, g)
    with pytest.raises(ValueError):
        kernels.run_ruiz(harness.launch, qp[0], qp[1], qp[2][:, :, :9],
                         *qp[3:], 8, g)
    with pytest.raises(ValueError):
        kernels.run_ruiz(harness.launch, qp[0], qp[1], qp[2], qp[3][:, :5],
                         qp[4], 8, g)
    with pytest.raises(ValueError):
        kernels.run_ruiz(harness.launch, *qp, -1, g)


@pytest.mark.parametrize("backend", ["m2", "vpu", "packed", "mma", "torch"])
def test_scaled_solve_routes_ruiz(backend, monkeypatch):
    """The kernel backends take Ruiz through the kernel's wrapper (on the
    CPU its plain version, bit for bit), the plain backend the plain chain;
    the stride-0 A reaches the wrapper uncopied."""
    calls = []

    def counted(P, q, A, l, u, iters):
        calls.append(A.stride(0))
        return kernels.ruiz_equilibrate(P, q, A, l, u, iters)

    monkeypatch.setattr(tadmm, "ruiz_equilibrate_kernel", counted)
    qp = mpc_like(4, 3)
    sol = tadmm.admm_solve(*qp, iters=20, adapt_rounds=2, backend=backend)
    ref = tadmm.admm_solve(*qp, iters=20, adapt_rounds=2, backend="torch")
    assert calls == ([] if backend == "torch" else [0])
    if backend == "torch":
        assert torch.equal(sol.x, ref.x)
    assert bool(torch.isfinite(sol.x).all())
