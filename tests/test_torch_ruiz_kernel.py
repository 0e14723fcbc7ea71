"""The Ruiz kernel's arithmetic on the CPU: qp/csrc/ruiz.h built with g++
(`_torch_port_util.build_ruiz_harness`: each scenario's units run one after
another in a NaN-filled shared memory, with the launcher's C signature less
the stream) and driven by the wrapper's own packing (`qp.kernels.run_ruiz`),
held against the plain version (qp/admm.py::ruiz_equilibrate) and the JAX
function, with the MPC's stride-0 constraint matrix and with dense ones.

Tolerances.  Every maximum and product is the plain version's; the host twin
takes 1 / sqrtf for rsqrt, as PyTorch on the CPU does; only the mean column
norm is summed in another order (the kernel's tree against PyTorch's).  So
the header is held to the plain version within 1e-6 relative (measured:
equal bits), and to the JAX function within the budgets of
tests/test_torch_admm.py::test_ruiz_scales_match_jax (scales 1e-5 relative,
matrices 1e-5 of their largest entry).
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


def header(harness, qp, iters=8, p_in_smem=True, slots=kernels.RUIZ_SLOTS):
    rc, out = kernels.run_ruiz(harness.launch, *qp, iters, p_in_smem, slots)
    assert rc == 0
    return out


CASES = {"mpc-like, stride-0 A": lambda: mpc_like(0, 5),
         "wbc shape, dense A": lambda: dense(10, 4, 30, 50),
         "n=45 m=70 (a partial warp)": lambda: dense(20, 3, 45, 70),
         "n=300 m=90 (two column sweeps)": lambda: dense(30, 2, 300, 90,
                                                         eq=False)}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("p_in_smem,slots", [(True, 4), (False, 4),
                                             (True, 0), (True, 1)])
def test_header_against_plain(harness, case, p_in_smem, slots):
    """P in shared memory or read each pass; A's nonzeros kept (4 or 1 a
    group and column: the MPC's pyramid fits 4, not 1, and a dense A
    neither) or A read whole every round: the same bits."""
    qp = CASES[case]()
    got = header(harness, qp, p_in_smem=p_in_smem, slots=slots)
    want = tadmm.ruiz_equilibrate(*qp, 8)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert g.is_contiguous(), name
        assert rel(g, w) <= 1e-6, name
    # the scales elementwise
    for g, w in zip(got[5:], want[5:]):
        assert float(((g - w).abs() / w.abs()).max()) <= 1e-6


@pytest.mark.parametrize("iters", [0, 1, 3])
def test_header_round_counts(harness, iters):
    qp = mpc_like(1, 3)
    got = header(harness, qp, iters=iters)
    want = tadmm.ruiz_equilibrate(*qp, iters)
    assert all(rel(g, w) <= 1e-6 for g, w in zip(got, want))
    if iters == 0:
        assert torch.equal(got[5], torch.ones_like(got[5]))
        assert torch.equal(got[7], torch.ones_like(got[7]))


@pytest.mark.parametrize("eq", [True, False])
def test_header_against_jax(harness, eq):
    qp = dense(40, 4, 24, 40, eq=eq)
    got = header(harness, qp)
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


def test_header_against_jax_stride0_a(harness):
    qp = mpc_like(2, 4)
    got = header(harness, qp)
    want = jax.vmap(jadmm.ruiz_equilibrate)(*[jj(npy(a.contiguous()))
                                              for a in qp])
    for name, g, w in zip(NAMES, got, want):
        w = npy(w)
        fin = np.abs(w) < 1e19
        assert np.abs(npy(g)[fin] - w[fin]).max() <= \
            1e-5 * np.abs(w[fin]).max(), name


def test_nan_stays_in_its_scenario(harness):
    """A NaN in one scenario's P gives that scenario the plain version's
    NaN pattern and leaves the others bit for bit as without it."""
    qp = dense(50, 3, 20, 30)
    bad = [t.clone() for t in qp]
    bad[0][1, 2, 3] = float("nan")
    got, clean = header(harness, bad), header(harness, qp)
    want = tadmm.ruiz_equilibrate(*bad, 8)
    for g, w, c in zip(got, want, clean):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        assert torch.equal(g[[0, 2]], c[[0, 2]])


def test_layout_and_shared_memory_count(harness):
    for n, m in ((30, 50), (192, 320), (45, 70), (300, 90), (1000, 2000)):
        assert harness.threads(n) == kernels.ruiz_layout(n, m, 1,
                                                         10**9).threads
        for p in (True, False):
            for slots in (0, 1, 4):
                assert harness.smem_floats(n, m, int(p), slots) == \
                    kernels.ruiz_smem_floats(n, m, p, slots)


def test_kept_nonzeros_equal_reading_a_whole(harness):
    """The stride-0 pyramid (at most 2 nonzeros a group and column) read
    from the kept lists after the first round, a dense A (too many) read
    whole: each bit for bit as with no list at all, also with a NaN and an
    infinity in A (kept as nonzeros)."""
    mpc = mpc_like(5, 3)
    a = mpc[2].contiguous().clone()
    a[1, 7, 4] = float("nan")
    a[2, 9, 10] = float("inf")
    for qp in (mpc, dense(80, 3, 30, 50), mpc[:2] + [a] + mpc[3:]):
        kept = header(harness, qp, slots=4)
        whole = header(harness, qp, slots=0)
        for g, w in zip(kept, whole):
            assert torch.equal(torch.isnan(g), torch.isnan(w))
            assert torch.equal(g[~torch.isnan(g)], w[~torch.isnan(w)])


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
    with pytest.raises(TypeError):
        kernels.run_ruiz(harness.launch, qp[0].double(), *qp[1:], 8, True, 4)
    with pytest.raises(ValueError):
        kernels.run_ruiz(harness.launch, qp[0], qp[1], qp[2][:, :, :9],
                         *qp[3:], 8, True, 4)
    with pytest.raises(ValueError):
        kernels.run_ruiz(harness.launch, qp[0], qp[1], qp[2], qp[3][:, :5],
                         qp[4], 8, True, 4)
    with pytest.raises(ValueError):
        kernels.run_ruiz(harness.launch, *qp, -1, True, 4)


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
