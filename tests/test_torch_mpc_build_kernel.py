"""The MPC QP build kernel's arithmetic on the CPU: mpc/csrc/mpc_build.h
built with g++ (`_torch_port_util.build_mpc_build_harness`: each scenario's
block run unit after unit in each phase, in order and reversed, in
NaN-filled shared memory, the producer's step j before the consumers' row
block j, with the kernel's C signature less the stream)
and driven by the wrapper's own packing (`mpc.srb.run_mpc_build`), held
against the plain version (`build_mpc_qp_reference`) and, through the
solve, against the JAX package's `build_mpc_qp`.

Tolerances.  The header computes the plain version's function over the
horizon's structure (backward recursions for S_j and g_j, P's blocks as
Su_{j,i}' S_j B_j), so its sums run in another order than the plain
version's dense Su' diag(Q) Su: P's off-diagonal entries within 1e-5 (float32)
/ 1e-12 (float64) of the scenario's largest |P| off the ridge, the diagonal
within 1e-5 / 1e-12 of each entry, q within 1e-5 / 1e-12 of the scenario's
largest |q| (measured on a CPU: 6.4e-7, 7.7e-7, 3.9e-7 in float32; 1.2e-15
in float64).  l and u are the plain version's bit for bit, P is exactly
symmetric, and the units' order does not move a bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpctsid_tpu.config import EngineConfig as JEngineConfig
from mpctsid_tpu.model.solo12 import SOLO12 as J_SOLO12
from mpctsid_tpu.mpc import srb as jsrb
from mpctsid_tpu.qp import admm as jadmm
from mpctsid_tpu_torch.config import EngineConfig
from mpctsid_tpu_torch.model.gaits import GAIT_IDS, gait_tables
from mpctsid_tpu_torch.model.solo12 import SOLO12
from mpctsid_tpu_torch.mpc import kernels as mk
from mpctsid_tpu_torch.mpc import srb as tsrb
from mpctsid_tpu_torch.plan.gait import contacts_at, contacts_horizon
from mpctsid_tpu_torch.qp import admm as tadmm

from _torch_port_util import build_mpc_build_harness, jj, npy

JCFG = JEngineConfig()
CFG = EngineConfig()
N = CFG.mpc.horizon
GAITS4 = [GAIT_IDS[g] for g in ("trot", "walk", "bound", "pace")]
DTYPES = [torch.float32, torch.float64]
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
# an H100's limits: shared memory a block may opt in to, a multiprocessor's
H100_OPTIN, H100_SMEM_PER_SM = 232448, 233472


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    return build_mpc_build_harness(tmp_path_factory.mktemp("mpc_build"))


def scenarios(seed, B):
    """numpy float64 (x0, x_ref, feet, contacts, mass): the four gaits in
    turn at random phases, states around the standing height with any yaw
    and position, the commanded-velocity rollout as the reference, feet
    near the shoulders, masses with payloads of up to 1 kg."""
    r = np.random.default_rng(seed)
    x0 = np.zeros((B, 12))
    x0[:, 0:2] = r.normal(size=(B, 2))
    x0[:, 2] = SOLO12.h_ref + r.normal(size=B) * 0.01
    x0[:, 3:5] = r.normal(size=(B, 2)) * 0.05
    x0[:, 5] = r.uniform(-np.pi, np.pi, B)
    x0[:, 6:12] = r.normal(size=(B, 6)) * 0.2
    vc = np.stack([r.uniform(-0.5, 0.5, B), r.uniform(-0.2, 0.2, B),
                   r.uniform(-0.5, 0.5, B)], 1)
    tables = gait_tables()
    phase = r.integers(0, 16, size=B)
    cont = np.stack([tables[GAITS4[b % 4]][(phase[b] + np.arange(N)) % 16]
                     for b in range(B)])
    feet = (SOLO12.shoulder_offsets[None, None]
            + r.normal(size=(B, N, 4, 3)) * 0.03)
    feet[..., 2] = r.normal(size=(B, N, 4)) * 0.005
    feet[..., 0:2] += x0[:, None, None, 0:2]
    x_ref = tsrb.reference_rollout_reference(
        SOLO12, CFG.mpc, torch.tensor(x0), torch.tensor(vc)).numpy()
    mass = SOLO12.total_mass + r.uniform(0.0, 1.0, B)
    return x0, x_ref, feet, cont, mass


def as_tensors(sc, dtype, with_mass):
    t = [torch.tensor(a, dtype=dtype) for a in sc[:4]]
    return t, (torch.tensor(sc[4], dtype=dtype) if with_mass else None)


def qp_errors(got, want, cont):
    """(P off-diagonal, P diagonal, q): the largest errors, each relative as
    the module's docstring says."""
    P, q = got[0].double(), got[1].double()
    Pw, qw = want[0].double(), want[1].double()
    eye = torch.eye(P.shape[-1], dtype=torch.bool)
    pinned = torch.tensor(np.repeat(cont.reshape(cont.shape[0], -1) < 0.5, 3,
                                    axis=1))
    d, dw = P.diagonal(dim1=1, dim2=2), Pw.diagonal(dim1=1, dim2=2)
    scale = torch.maximum(
        Pw.masked_fill(eye, 0.0).abs().amax((1, 2)),
        dw.masked_fill(pinned, 0.0).abs().amax(1))
    off = (P - Pw).masked_fill(eye, 0.0).abs().amax((1, 2)) / scale
    diag = ((d - dw).abs() / dw.abs()).amax(1)
    qe = (q - qw).abs().amax(1) / qw.abs().amax(1)
    return float(off.max()), float(diag.max()), float(qe.max())


def test_layout_counts_match_the_header(harness):
    assert [harness.layout(i) for i in range(len(mk.LAYOUT))] == \
        list(mk.LAYOUT.values())
    assert harness.layout(len(mk.LAYOUT)) == -1
    for n in range(1, 21):
        assert harness.smem_values(n) == mk.smem_values(n)
        assert harness.barrier_bytes(n) == mk.barrier_bytes(n)
    # 14,076 values at the horizon of 16: rows 0:6 of Su's 136 blocks,
    # rows 6:12 of the 16 B_i, 16 W_j, S, S A, the M_k, d, g and diag(Q);
    # 128 bytes of mbarriers before them
    assert mk.smem_values(16) == 14076 and mk.barrier_bytes(16) == 128


@pytest.mark.parametrize("B", [1, 37, 4096])
def test_mpc_build_layout_on_the_h100(B):
    f32 = mk.mpc_build_layout(B, 16, torch.float32, H100_OPTIN,
                              H100_SMEM_PER_SM)
    f64 = mk.mpc_build_layout(B, 16, torch.float64, H100_OPTIN,
                              H100_SMEM_PER_SM)
    assert f32 == mk.MpcBuildLayout(B, 384, 128 + 4 * 14076, 4)
    assert f64 == mk.MpcBuildLayout(B, 384, 128 + 8 * 14076, 2)


def test_mpc_build_layout_refuses_what_does_not_fit():
    # float64 fits up to N = 24 (223,200 bytes), float32 up to N = 36
    assert mk.mpc_build_layout(1, 24, torch.float64, H100_OPTIN).smem_bytes \
        == 192 + 8 * mk.smem_values(24) <= H100_OPTIN
    assert mk.mpc_build_layout(1, 36, torch.float32, H100_OPTIN).smem_bytes \
        <= H100_OPTIN
    with pytest.raises(ValueError):
        mk.mpc_build_layout(1, 25, torch.float64, H100_OPTIN)
    with pytest.raises(ValueError):
        mk.mpc_build_layout(1, 37, torch.float32, H100_OPTIN)
    with pytest.raises(ValueError):
        mk.mpc_build_layout(0, 16, torch.float32, H100_OPTIN)


@pytest.mark.parametrize("with_mass", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", [1, 5, 37])
def test_header_against_plain(harness, B, dtype, with_mass):
    sc = scenarios(10 + B, B)
    t, mass = as_tensors(sc, dtype, with_mass)
    rc, got = tsrb.run_mpc_build(harness.launch, SOLO12, CFG.mpc, *t, mass)
    rc2, again = tsrb.run_mpc_build(harness.launch_reversed, SOLO12,
                                    CFG.mpc, *t, mass)
    want = tsrb.build_mpc_qp_reference(SOLO12, CFG.mpc, *t, total_mass=mass)
    assert rc == rc2 == 0
    n, m = 12 * N, 20 * N
    assert [tuple(g.shape) for g in got] == [(B, n, n), (B, n), (B, m),
                                             (B, m)]
    assert all(g.dtype == dtype for g in got)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    assert torch.equal(got[0], got[0].transpose(1, 2))
    assert torch.equal(got[2], want[3]) and torch.equal(got[3], want[4])
    errs = qp_errors(got, want, sc[3])
    assert max(errs) < TOL[dtype], errs


@pytest.mark.parametrize("with_mass", [False, True])
def test_float32_header_as_close_to_float64_as_the_plain_chain(harness,
                                                               with_mass):
    """The float32 kernel no farther from the float64 plain version than
    twice the float32 plain version is (P off the diagonal, P's diagonal
    and q, each by its largest absolute error)."""
    sc = scenarios(20, 37)
    t32, m32 = as_tensors(sc, torch.float32, with_mass)
    t64, m64 = as_tensors(sc, torch.float64, with_mass)
    _, got = tsrb.run_mpc_build(harness.launch, SOLO12, CFG.mpc, *t32, m32)
    plain = tsrb.build_mpc_qp_reference(SOLO12, CFG.mpc, *t32,
                                        total_mass=m32)
    ref = tsrb.build_mpc_qp_reference(SOLO12, CFG.mpc, *t64, total_mass=m64)
    eye = torch.eye(12 * N, dtype=torch.bool)

    def err(a):
        dP = a[0].double() - ref[0]
        return (float(dP.masked_fill(eye, 0.0).abs().max()),
                float(dP.diagonal(dim1=1, dim2=2).abs().max()),
                float((a[1].double() - ref[1]).abs().max()))

    for k, p in zip(err(got), err(plain)):
        assert k <= 2.0 * p, (err(got), err(plain))


@pytest.mark.parametrize("with_mass", [False, True])
def test_header_qps_solve_as_the_jax_package_does(harness, with_mass):
    """The kernel's float32 QPs solved by the port's admm_solve (200
    iterations in one round from zeros) against the JAX package's
    build_mpc_qp (vmapped) and the same solve: the budgets of
    tests/test_torch_mpc.py::test_solve_mpc_batch_matches_jax, 1e-3 on x
    (the forces, N) and 1e-2 on y."""
    x0, x_ref, feet, cont, mass = [np.asarray(a, np.float32)
                                   for a in scenarios(30, 3)]
    t, m = as_tensors((x0, x_ref, feet, cont, mass), torch.float32,
                      with_mass)
    _, (P, q, l, u) = tsrb.run_mpc_build(harness.launch, SOLO12, CFG.mpc, *t,
                                         m)
    A = tsrb.build_mpc_qp_reference(SOLO12, CFG.mpc, *t, total_mass=m)[2]
    sol = tadmm.admm_solve(P, q, A, l, u, x0=torch.zeros(3, 12 * N),
                           y0=torch.zeros(3, 20 * N), iters=200)

    def one(a, b, c, d, e):
        qp = jsrb.build_mpc_qp(J_SOLO12, JCFG.mpc, a, b, c, d,
                               total_mass=e if with_mass else None)
        return jadmm.admm_solve(*qp, x0=jnp.zeros(12 * N),
                                y0=jnp.zeros(20 * N), iters=200)

    want = jax.vmap(one)(jj(x0), jj(x_ref), jj(feet), jj(cont), jj(mass))
    np.testing.assert_allclose(npy(sol.x), npy(want.x), atol=1e-3)
    np.testing.assert_allclose(npy(sol.y), npy(want.y), atol=1e-2)
    assert npy(sol.ok).tolist() == npy(want.ok).tolist() == [True] * 3


def test_rows_of_a_packed_buffer_and_mixed_dtypes(harness):
    """x0 as a slice of the host path's packed snapshot and a reference
    row shared by every scenario give what contiguous copies give, bit for
    bit; contacts and mass of another dtype than x0's are taken as the
    plain version takes them (l and u in the contacts' dtype)."""
    x0, x_ref, feet, cont, mass = scenarios(40, 4)
    t, m = as_tensors((x0, x_ref, feet, cont, mass), torch.float32, True)
    snap = torch.cat([t[0], torch.zeros(4, 16)], dim=1)[:, 0:12]
    assert not snap.is_contiguous()
    _, a = tsrb.run_mpc_build(harness.launch, SOLO12, CFG.mpc, snap, *t[1:],
                              m)
    _, b = tsrb.run_mpc_build(harness.launch, SOLO12, CFG.mpc, *t, m)
    assert all(torch.equal(g, w) for g, w in zip(a, b))
    shared = [x[:1] for x in t[1:]]
    _, c = tsrb.run_mpc_build(harness.launch, SOLO12, CFG.mpc, t[0], *shared)
    _, e = tsrb.run_mpc_build(harness.launch, SOLO12, CFG.mpc, t[0],
                              *[x.expand(4, *x.shape[1:]).contiguous()
                                for x in shared])
    assert all(torch.equal(g, w) for g, w in zip(c, e))
    t64 = [x.double() for x in t]
    _, f = tsrb.run_mpc_build(harness.launch, SOLO12, CFG.mpc, *t64[:3],
                              t[3], m)
    want = tsrb.build_mpc_qp_reference(SOLO12, CFG.mpc, *t64[:3], t[3],
                                       total_mass=m)
    assert f[0].dtype == torch.float64 and f[2].dtype == torch.float32
    assert torch.equal(f[2], want[3]) and torch.equal(f[3], want[4])
    assert max(qp_errors(f, want, cont)) < TOL[torch.float64]


def test_cpu_wrapper_is_the_plain_version():
    for with_mass in (False, True):
        t, m = as_tensors(scenarios(50, 3), torch.float32, with_mass)
        got = tsrb.build_mpc_qp(SOLO12, CFG.mpc, *t, total_mass=m)
        want = tsrb.build_mpc_qp_reference(SOLO12, CFG.mpc, *t,
                                           total_mass=m)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert got[2].stride(0) == 0


def test_argument_checks(harness):
    t, m = as_tensors(scenarios(60, 2), torch.float32, True)
    with pytest.raises(TypeError):
        tsrb.build_mpc_qp(SOLO12, CFG.mpc, t[0].half(), *t[1:])
    with pytest.raises(TypeError):
        tsrb.run_mpc_build(harness.launch, SOLO12, CFG.mpc, t[0],
                           t[1].double(), *t[2:])
    with pytest.raises(TypeError):
        tsrb.run_mpc_build(harness.launch, SOLO12, CFG.mpc, *t[:3],
                           t[3].long())
    with pytest.raises(ValueError):
        tsrb.run_mpc_build(harness.launch, SOLO12, CFG.mpc, t[0],
                           t[1][:, :8], *t[2:])
    with pytest.raises(ValueError):
        tsrb.run_mpc_build(harness.launch, SOLO12, CFG.mpc, *t,
                           torch.stack([m, m], dim=1))


@pytest.mark.parametrize("dtype", DTYPES)
def test_contacts_horizon_is_the_stacked_contacts_at(dtype):
    """The form that bench.py::_mpc_qp_batch and
    scripts/profile_torch_cascade.py call (one contacts_horizon) against
    the 16 stacked contacts_at it replaces, every gait and phases over
    three periods."""
    r = np.random.default_rng(70)
    gid = torch.tensor(r.integers(0, len(GAIT_IDS), 64), dtype=torch.int32)
    phase = torch.tensor(r.integers(0, 48, 64), dtype=torch.int32)
    want = torch.stack([contacts_at(gid, phase + k, dtype)
                        for k in range(N)], dim=1)
    got = contacts_horizon(gid, phase, N, dtype)
    assert got.dtype == dtype and torch.equal(got, want)
