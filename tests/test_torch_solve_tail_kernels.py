"""The solve-tail kernels' arithmetic on the CPU: qp/csrc/solve_tail.h
built with g++ (`_torch_port_util.build_solve_tail_harness`: kkt_blocks'
entries one after another over the batch, adapt_rho's and unscale's units
one after another per phase of each scenario from NaN-filled shared memory,
in order and reversed, with the launchers' C signature less the stream)
and driven by the wrappers' own packing (`qp/tail.py::run_kkt`,
`run_adapt`, `run_unscale`), held against the plain versions in
qp/admm.py (`_dense_kkt`, `_adapt_rho`, `_unscaled_solution`); the
declaration `a_blocks` (`mpc/srb.py::MPC_A_BLOCKS`) against the MPC's A;
`admm_solve(backend="m2", a_blocks=MPC_A_BLOCKS)` against the JAX
package's `admm_solve(backend="pallas_m2")` in interpret mode on the JAX
`build_mpc_qp`'s QPs.

Tolerances.  rho_vec, x and y are the plain versions' bits (the same
rounded ops in the same order), K's entries outside the declared blocks
are P's bits, the units' order moves no bit.  The dot products run in
index order where the plain versions call a BLAS: K within 1e-6 (float32)
/ 1e-14 (float64) of each scenario's largest |K| (measured on a CPU:
2.9e-8 / 5.4e-17); rho_s in float32 as close to a float64 run of the
plain version as the plain float32 chain (factor 2, plus 1e-6 relative;
the dual residual cancels as the iterate converges, and the header sums
in double: measured 5e-8 from float64 against the plain chain's 3.1e-5 on
the WBC-sized QPs, 2.5e-8 against 3.3e-7 on the MPC's) and within 1e-4
relative of it, in float64 within 1e-13 relative (1e-15); z, prim within
1e-5 / 1e-13 of each scenario's largest |A x| (at least 1), dual within
1e-5 / 1e-13 of its largest term (|P x|, |q|, |A' y|: the ridge's 1e6
makes them large), ok the plain version's.
"""

import numpy as np
import pytest
import torch

import jax

from mpctsid_tpu.config import EngineConfig as JEngineConfig
from mpctsid_tpu.model.solo12 import SOLO12 as J_SOLO12
from mpctsid_tpu.mpc import srb as jsrb
from mpctsid_tpu.qp import admm as jadmm
from mpctsid_tpu_torch.config import EngineConfig
from mpctsid_tpu_torch.model.gaits import GAIT_IDS, gait_tables
from mpctsid_tpu_torch.model.solo12 import SOLO12
from mpctsid_tpu_torch.mpc import srb as tsrb
from mpctsid_tpu_torch.qp import admm as tadmm
from mpctsid_tpu_torch.qp import tail

from _torch_port_util import (build_solve_tail_harness, jj, npy, stacked,
                              tt)

CFG = EngineConfig()
JCFG = JEngineConfig()
N = CFG.mpc.horizon
DTYPES = [torch.float32, torch.float64]
K_TOL = {torch.float32: 1e-6, torch.float64: 1e-14}
TOL = {torch.float32: 1e-5, torch.float64: 1e-13}
BLOCKS = tsrb.MPC_A_BLOCKS
# an H100's limits: shared memory a block may opt in to, multiprocessors
H100_OPTIN, H100_SMS = 232448, 132


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    return build_solve_tail_harness(tmp_path_factory.mktemp("solve_tail"))


def mpc_inputs(seed, B):
    """numpy float32 (x0, x_ref, feet, contacts): the four gaits in turn at
    random phases, any yaw, the commanded-velocity rollout as reference."""
    r = np.random.default_rng(seed)
    x0 = np.zeros((B, 12), np.float32)
    x0[:, 2] = SOLO12.h_ref + r.normal(size=B) * 0.01
    x0[:, 3:5] = r.normal(size=(B, 2)) * 0.05
    x0[:, 5] = r.uniform(-np.pi, np.pi, B)
    x0[:, 6:8] = r.normal(size=(B, 2)) * 0.2
    vc = np.stack([r.uniform(-0.5, 0.5, B), r.uniform(-0.2, 0.2, B),
                   r.uniform(-0.5, 0.5, B)], 1).astype(np.float32)
    x_ref = npy(tsrb.reference_rollout(SOLO12, CFG.mpc, tt(x0), tt(vc)))
    tables = gait_tables()
    gids = [GAIT_IDS[g] for g in ("trot", "walk", "bound", "pace")]
    phase = r.integers(0, 16, size=B)
    cont = np.stack([tables[gids[b % 4]][(phase[b] + np.arange(N)) % 16]
                     for b in range(B)]).astype(np.float32)
    feet = (SOLO12.shoulder_offsets[None, None]
            + r.normal(size=(B, N, 4, 3)) * 0.03)
    feet[..., 2] = 0.0
    feet[..., 0:2] += x0[:, None, None, 0:2]
    return x0, x_ref, feet.astype(np.float32), cont


def mpc_qp(seed, B, dtype=torch.float32):
    """(P, q, A, l, u) of B MPC problems in `dtype` (A the stride-0
    constant)."""
    args = [torch.tensor(a, dtype=dtype) for a in mpc_inputs(seed, B)]
    return tsrb.build_mpc_qp(SOLO12, CFG.mpc, *args)


def scaled_state(qp, seed):
    """The scaled problem of `qp` (Ruiz), its eqf, and an iterate (x, z, y)
    that 20 plain iterations from zero reach, plus a per-scenario rho."""
    P, q, A, l, u = qp
    B = P.shape[0]
    eqf = ((u - l) < 1e-9).to(P.dtype)
    Ps, qs, As, ls, us, D, E, c = tadmm.ruiz_equilibrate(P, q, A, l, u)
    r = np.random.default_rng(seed)
    rho_s = torch.tensor(10.0 ** r.uniform(-2, 1, B), dtype=P.dtype)
    z0 = torch.minimum(torch.maximum(As.new_zeros(l.shape), ls), us)
    x, z, y = tadmm._run_block(Ps, qs, As, ls, us, eqf, rho_s,
                               Ps.new_zeros(q.shape), z0,
                               Ps.new_zeros(l.shape), 20, 1e-6, 1.6, 1e3,
                               "torch", "blockinv")
    return (Ps, qs, As, ls, us, D, E, c), eqf, rho_s, (x, z, y)


def kkt_geometry(P, A, dtype=None):
    """kkt_blocks' geometry at P's shape on an H100 (`kkt_layout`)."""
    return tail.kkt_layout(P.shape[0], P.shape[1], A.shape[1], BLOCKS,
                           H100_OPTIN, dtype or P.dtype).geometry


def scenario_rel(got, want, scale):
    """Largest |got - want| of each scenario over its `scale` (B,)."""
    d = (got.double() - want.double()).abs().reshape(got.shape[0], -1)
    return float((d.amax(dim=1) / scale).max())


# ------------------------------------------------------------ the declaration

def test_mpc_constraint_matrix_is_block_diagonal_as_declared():
    """The constant the build kernel's wrapper hands back and the plain
    version's A: every entry outside the declared 5 x 3 blocks is zero, and
    the blocks tile A; Ruiz's scaled A keeps exactly those zeros."""
    r, c = BLOCKS
    A_np = tsrb._constraint_matrix(N, CFG.mpc.mu)
    m, n = A_np.shape
    assert tail.check_blocks(n, m, BLOCKS) == (r, c)
    inside = np.zeros((m, n), bool)
    for k in range(m // r):
        inside[k * r:(k + 1) * r, k * c:(k + 1) * c] = True
    assert not A_np[~inside].any()
    qp = mpc_qp(0, 3)
    A = npy(qp[2])
    assert A.shape == (3, m, n) and qp[2].stride(0) == 0
    assert not A[:, ~inside].any()
    Ab = npy(tadmm.ruiz_equilibrate(*qp)[2])
    assert not Ab[:, ~inside].any() and (Ab[:, inside] != 0).any()


def test_wrong_declarations_raise():
    qp = mpc_qp(1, 2)
    for bad in [(4, 3), (5, 4), (0, 3), (10, 3), (5, 0)]:
        with pytest.raises(ValueError):
            tail.check_blocks(192, 320, bad)
        with pytest.raises(ValueError):
            tadmm.admm_solve(*qp, iters=2, backend="m2", a_blocks=bad)
    Ps, _, As, *_ = tadmm.ruiz_equilibrate(*qp)
    with pytest.raises(ValueError):
        tail.kkt_blocks(Ps, As, torch.zeros(2, 320), torch.ones(2), 1e-6,
                        1e3, (4, 3))
    # kkt_blocks has no dense path: the plain version is that
    with pytest.raises(ValueError):
        tail.run_kkt(None, Ps, As, torch.zeros(2, 320), torch.ones(2), 1e-6,
                     1e3, None, (256, 1, 1))
    assert tail.check_blocks(192, 320, None) == (0, 0)


# ----------------------------------------------------------- kkt_blocks

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", [1, 3])
def test_kkt_blocks_matches_plain(harness, dtype, B):
    (Ps, _, As, *_), eqf, rho_s, _ = scaled_state(mpc_qp(B, B, dtype), B)
    rc, (K, rho_vec) = tail.run_kkt(harness.kkt, Ps, As, eqf, rho_s, 1e-6,
                                    1e3, BLOCKS, kkt_geometry(Ps, As))
    assert rc == 0
    Kp, rho_p = tadmm._dense_kkt(Ps, As, eqf, rho_s, 1e-6, 1e3)
    assert torch.equal(rho_vec, rho_p)
    scale = Kp.abs().reshape(B, -1).amax(dim=1).double()
    assert scenario_rel(K, Kp, scale) <= K_TOL[dtype]
    r, c = BLOCKS
    inside = torch.zeros(192, 192, dtype=torch.bool)
    for k in range(192 // c):
        inside[k * c:(k + 1) * c, k * c:(k + 1) * c] = True
    assert torch.equal(K[:, ~inside], Ps[:, ~inside])
    assert torch.equal(Kp[:, ~inside], Ps[:, ~inside])
    _, (K_rev, rho_rev) = tail.run_kkt(harness.kkt_reversed, Ps, As, eqf,
                                       rho_s, 1e-6, 1e3, BLOCKS,
                                       kkt_geometry(Ps, As))
    assert torch.equal(K_rev, K) and torch.equal(rho_rev, rho_vec)


def test_kkt_blocks_with_equality_rows(harness):
    """eqf's boost (rho_eq_scale) on some rows, a shared stride-0 A."""
    (Ps, _, As, *_), eqf, rho_s, _ = scaled_state(mpc_qp(5, 2), 5)
    eqf = eqf.clone()
    eqf[:, ::7] = 1.0
    A0 = As[:1].expand(2, -1, -1)
    rc, (K, rho_vec) = tail.run_kkt(harness.kkt, Ps, A0, eqf, rho_s, 1e-6,
                                    1e3, BLOCKS, kkt_geometry(Ps, A0))
    Kp, rho_p = tadmm._dense_kkt(Ps, A0, eqf, rho_s, 1e-6, 1e3)
    assert rc == 0 and torch.equal(rho_vec, rho_p)
    scale = Kp.abs().reshape(2, -1).amax(dim=1).double()
    assert scenario_rel(K, Kp, scale) <= K_TOL[torch.float32]


# ------------------------------------------------------------ adapt_rho

def adapt_cases(dtype):
    """(label, P, q, A, x, z, y, rho_s, a_blocks): the MPC's scaled problem
    with its blocks declared and dense, the WBC-sized random QPs dense."""
    (Ps, qs, As, *_), _, rho_s, (x, z, y) = scaled_state(
        mpc_qp(7, 3, dtype), 7)
    yield "mpc, blocks", Ps, qs, As, x, z, y, rho_s, BLOCKS
    yield "mpc, dense", Ps, qs, As, x, z, y, rho_s, None
    P, q, A, l, u = [torch.tensor(a, dtype=dtype)
                     for a in stacked(range(4), n=30, m=50)]
    (Ps, qs, As, ls, us, *_), eqf, rho_s, (x, z, y) = scaled_state(
        (P, q, A, l, u), 8)
    yield "wbc-sized, dense", Ps, qs, As, x, z, y, rho_s, None


@pytest.mark.parametrize("lanes", [1, 32])
@pytest.mark.parametrize("dtype", DTYPES)
def test_adapt_rho_matches_plain(harness, dtype, lanes):
    """lanes 1: the warp path (a lane a row of P; the shapes within
    `warp_dim`), two scenarios a block; lanes 32: the block path, a row of
    P over a warp's 32 lanes, at every shape."""
    for label, P, q, A, x, z, y, rho_s, blocks in adapt_cases(dtype):
        B, n = q.shape
        m = A.shape[1]
        if lanes == 1 and max(n, m) > tail.LAYOUT["warp_dim"]:
            continue
        geometry = (64, -(-B // 2), 1) if lanes == 1 else (256, B, lanes)
        rc, rho = tail.run_adapt(harness.adapt, P, q, A, x, z, y, rho_s,
                                 blocks, geometry)
        assert rc == 0, label
        want = tadmm._adapt_rho(P, q, A, x, z, y, rho_s)
        w64 = tadmm._adapt_rho(*(t.double() for t in (P, q, A, x, z, y,
                                                       rho_s)))

        def rel(a, b):
            return float(((a.double() - b).abs() / b.abs()).max())

        if dtype == torch.float64:
            assert rel(rho, want) <= TOL[dtype], label
        else:
            # rd's numerator cancels near convergence: the plain float32
            # chain lies up to 3e-5 from float64 on the WBC-sized case
            assert rel(rho, w64) <= 2.0 * rel(want, w64) + 1e-6, label
            assert rel(rho, want.double()) <= 1e-4, label
        _, rev = tail.run_adapt(harness.adapt_reversed, P, q, A, x, z, y,
                                rho_s, blocks, geometry)
        assert torch.equal(rev, rho), label
        assert rho.shape == (B,) and bool(((rho >= 1e-3 * (1 - 1e-6))
                                           & (rho <= 1e3 * (1 + 1e-6))).all())


def test_adapt_rho_nan_propagates(harness):
    """A scenario whose iterate is not finite gets NaN, as the plain
    version's maxima give it, and leaves the others' bits."""
    _, P, q, A, x, z, y, rho_s, blocks = next(adapt_cases(torch.float32))
    x = x.clone()
    x[1, 5] = float("nan")
    _, rho = tail.run_adapt(harness.adapt, P, q, A, x, z, y, rho_s, blocks,
                            (256, 3, 32))
    want = tadmm._adapt_rho(P, q, A, x, z, y, rho_s)
    assert torch.isnan(rho[1]) and torch.isnan(want[1])
    _, clean = tail.run_adapt(harness.adapt, P, q, A, x.nan_to_num(0.0), z,
                              y, rho_s, blocks, (256, 3, 32))
    assert torch.equal(rho[[0, 2]], clean[[0, 2]])


# ------------------------------------------------------------- unscale

def unscale_cases(dtype):
    qp = mpc_qp(9, 3, dtype)
    (_, _, _, _, _, D, E, c), _, _, (xs, _, ys) = scaled_state(qp, 9)
    yield "mpc, blocks", qp, xs, ys, D, E, c, BLOCKS, 0.05
    yield "mpc, dense", qp, xs, ys, D, E, c, None, 0.05
    qp = [torch.tensor(a, dtype=dtype) for a in stacked(range(5), n=30, m=50)]
    (_, _, _, _, _, D, E, c), _, _, (xs, _, ys) = scaled_state(qp, 10)
    yield "wbc-sized, dense", qp, xs, ys, D, E, c, None, 0.5


def unscale_scales(qp, x, y):
    """Per scenario: max(1, |A x|) for z and prim; the largest of |P x|,
    |q|, |A' y| for dual."""
    P, q, A = (t.double() for t in qp[:3])
    x, y = x.double(), y.double()
    Ax = torch.einsum("bmn,bn->bm", A.expand(P.shape[0], -1, -1), x)
    Px = torch.einsum("bij,bj->bi", P, x)
    Aty = torch.einsum("bmn,bm->bn", A.expand(P.shape[0], -1, -1), y)
    z_scale = torch.clamp_min(Ax.abs().amax(dim=1), 1.0)
    d_scale = torch.stack([Px.abs().amax(dim=1), q.abs().amax(dim=1),
                           Aty.abs().amax(dim=1)]).amax(dim=0)
    return z_scale, d_scale


@pytest.mark.parametrize("lanes", [1, 32])
@pytest.mark.parametrize("dtype", DTYPES)
def test_unscale_matches_plain(harness, dtype, lanes):
    """lanes 1: the warp path (a lane a row; the shapes within
    `warp_dim`), two scenarios a block; lanes 32: the block path, a row
    of P over a warp's 32 lanes, at every shape."""
    for label, qp, xs, ys, D, E, c, blocks, tol in unscale_cases(dtype):
        B, n = xs.shape
        if lanes == 1 and max(n, ys.shape[1]) > tail.LAYOUT["warp_dim"]:
            continue
        geometry = (64, -(-B // 2), 1) if lanes == 1 else (256, B, lanes)
        rc, got = tail.run_unscale(harness.unscale, *qp, xs, ys, D, E, c,
                                   tol, blocks, geometry)
        assert rc == 0, label
        s = tadmm._unscaled_solution(*qp, xs, ys, D, E, c, tol)
        x, y, z, prim, dual, ok = got
        assert torch.equal(x, s.x) and torch.equal(y, s.y), label
        z_scale, d_scale = unscale_scales(qp, s.x, s.y)
        assert scenario_rel(z, s.z, z_scale) <= TOL[dtype], label
        assert float(((prim.double() - s.prim_res.double()).abs()
                      / z_scale).max()) <= TOL[dtype], label
        assert float(((dual.double() - s.dual_res.double()).abs()
                      / d_scale).max()) <= TOL[dtype], label
        assert ok.dtype == torch.bool and torch.equal(ok, s.ok), label
        _, rev = tail.run_unscale(harness.unscale_reversed, *qp, xs, ys, D,
                                  E, c, tol, blocks, geometry)
        assert all(torch.equal(a, b) for a, b in zip(rev, got)), label


def test_unscale_ok_flags(harness):
    """ok is False for a non-finite x and for prim at or over status_tol;
    prim is 0 for an interior point."""
    label, qp, xs, ys, D, E, c, blocks, _ = next(unscale_cases(torch.float32))
    xs = xs.clone()
    xs[0, 3] = float("inf")
    _, got = tail.run_unscale(harness.unscale, *qp, xs, ys, D, E, c, 0.05,
                              blocks, (256, 3, 32))
    s = tadmm._unscaled_solution(*qp, xs, ys, D, E, c, 0.05)
    assert not bool(got[5][0]) and torch.equal(got[5], s.ok)
    tol = float(s.prim_res[1])
    _, at = tail.run_unscale(harness.unscale, *qp, xs, ys, D, E, c, tol,
                             blocks, (256, 3, 32))
    assert not bool(at[5][1])


# ---------------------------------------------------------------- layouts

def test_layouts_and_counts(harness):
    assert [harness.layout(i) for i in range(len(tail.LAYOUT))] == list(
        tail.LAYOUT.values())
    assert harness.layout(len(tail.LAYOUT)) == -1
    for n, m in ((192, 320), (30, 50), (24, 40), (1000, 2000)):
        for dense in (0, 1):
            for warps in (0, 1, 3, 8):
                for slots, size in ((1, 4), (2, 4), (1, 8), (2, 8)):
                    assert harness.unscale_smem_bytes(
                        n, m, dense, warps, slots, size) == \
                        tail.unscale_smem_bytes(n, m, bool(dense), warps,
                                                slots, size)
                    assert harness.adapt_smem_bytes(
                        n, m, dense, warps, slots, size) == \
                        tail.adapt_smem_bytes(n, m, bool(dense), warps,
                                              slots, size)
    for n, c in ((192, 3), (30, 3), (3, 3), (96, 2)):
        for tile in (1024, 4096, 2048, 37):
            for bulk, size in ((0, 4), (1, 4), (1, 8)):
                assert harness.kkt_smem_bytes(n, c, tile, bulk, size) == \
                    tail.kkt_smem_bytes(n, c, tile, bool(bulk), size)
    mpc = tail.adapt_layout(192, 320, 4096, H100_OPTIN, H100_SMS,
                            dense=False)
    assert mpc.geometry == (tail.TAIL_THREADS, 4096, 32)
    assert mpc.smem_bytes == tail.adapt_smem_bytes(192, 320, False, 0, 1, 4)
    assert tail.adapt_layout(192, 320, 1, H100_OPTIN, H100_SMS, dense=True
                             ).smem_bytes > mpc.smem_bytes
    wbc = tail.adapt_layout(30, 50, 1, H100_OPTIN, H100_SMS, dense=True)
    assert wbc.geometry == (32, 1, 2)
    assert wbc.smem_bytes == tail.adapt_smem_bytes(30, 50, True, 1, 2, 4)
    with pytest.raises(ValueError):
        tail.adapt_layout(2000, 2000, 1, H100_OPTIN, H100_SMS, dense=True)
    with pytest.raises(ValueError):
        tail.tail_layout(2000, 2000, 1, H100_OPTIN, H100_SMS, dense=True)
    with pytest.raises(ValueError):
        tail.kkt_layout(1, 192, 320, None, H100_OPTIN)


# --------------------------------------------- the wrappers and admm_solve

def test_cpu_wrappers_are_the_plain_versions():
    qp = mpc_qp(11, 2)
    (Ps, qs, As, ls, us, D, E, c), eqf, rho_s, (x, z, y) = scaled_state(
        qp, 11)
    counts = (tail.kkt_blocks.launches, tail.adapt_rho.launches,
              tail.unscale.launches)
    got = tail.kkt_blocks(Ps, As, eqf, rho_s, 1e-6, 1e3, BLOCKS)
    want = tadmm._dense_kkt(Ps, As, eqf, rho_s, 1e-6, 1e3)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(tail.adapt_rho(Ps, qs, As, x, z, y, rho_s, BLOCKS),
                       tadmm._adapt_rho(Ps, qs, As, x, z, y, rho_s))
    got = tail.unscale(*qp, x, y, D, E, c, 0.05, BLOCKS)
    s = tadmm._unscaled_solution(*qp, x, y, D, E, c, 0.05)
    assert all(torch.equal(a, b) for a, b in zip(
        got, (s.x, s.y, s.z, s.prim_res, s.dual_res, s.ok)))
    assert counts == (tail.kkt_blocks.launches, tail.adapt_rho.launches,
                      tail.unscale.launches)


@pytest.mark.parametrize("backend", ["torch", "m2", "vpu"])
def test_admm_solve_with_blocks_keeps_its_bits_on_the_cpu(backend):
    """The declaration changes nothing on the CPU: every backend gives the
    bits it gives without it."""
    qp = mpc_qp(12, 2)
    kw = dict(iters=20, adapt_rounds=2, rho=0.1, backend=backend)
    a = tadmm.admm_solve(*qp, a_blocks=BLOCKS, **kw)
    b = tadmm.admm_solve(*qp, **kw)
    for f in ("x", "y", "z", "prim_res", "dual_res", "ok"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_admm_solve_m2_with_blocks_matches_jax_pallas_m2():
    """MPC QPs from the JAX `build_mpc_qp` (two gaits' scenarios): the
    port's `admm_solve(backend="m2", a_blocks=MPC_A_BLOCKS)` on the CPU
    against the JAX `admm_solve(backend="pallas_m2")` in interpret mode, the
    cascade's budget (60 iterations in 2 rounds), warm-started from zero;
    the budgets of tests/test_torch_mpc.py:137-138 (x 1e-3 N, y 1e-2)."""
    x0, x_ref, feet, cont = mpc_inputs(13, 2)
    qp_j = jax.vmap(lambda a, b, c, d: jsrb.build_mpc_qp(
        J_SOLO12, JCFG.mpc, a, b, c, d))(jj(x0), jj(x_ref), jj(feet),
                                         jj(cont))
    kw = dict(iters=60, adapt_rounds=2, rho=0.1)
    s_j = jax.vmap(lambda P, q, A, l, u: jadmm.admm_solve(
        P, q, A, l, u, backend="pallas_m2", backend_interpret=True, **kw))(
            *qp_j)
    qp_t = [torch.tensor(npy(t)) for t in qp_j]
    s_t = tadmm.admm_solve(*qp_t, backend="m2", a_blocks=BLOCKS, **kw)
    np.testing.assert_allclose(npy(s_t.x), npy(s_j.x), atol=1e-3)
    np.testing.assert_allclose(npy(s_t.y), npy(s_j.y), atol=1e-2)
    assert npy(s_t.ok).tolist() == npy(s_j.ok).tolist()
