"""Port parity: mpc/srb.py (batched PyTorch) vs the JAX functions.

QP matrices to atol 1e-5, the budget tests/test_mpc_jax.py gives the JAX
QP assembly against the oracle; the ridge-pinned diagonal entries (1e6) are
compared relatively (one f32 ulp there is 0.06).
"""

import numpy as np
import pytest
import torch

import jax

from mpctsid_tpu.config import EngineConfig as JEngineConfig
from mpctsid_tpu.model.solo12 import SOLO12 as J_SOLO12
from mpctsid_tpu.mpc import srb as jsrb
from mpctsid_tpu_torch.config import EngineConfig
from mpctsid_tpu_torch.model.gaits import GAIT_IDS, gait_tables
from mpctsid_tpu_torch.model.solo12 import SOLO12
from mpctsid_tpu_torch.mpc import srb as tsrb
from mpctsid_tpu_torch.qp import admm as tadmm

from _torch_port_util import jj, npy, tt

JCFG = JEngineConfig()
CFG = EngineConfig()
B = 4
N = CFG.mpc.horizon


def scenarios(seed):
    """x0, v_cmd, x_ref, feet, contacts for B scenarios with mixed gaits."""
    r = np.random.default_rng(seed)
    x0 = np.zeros((B, 12))
    x0[:, 2] = SOLO12.h_ref + r.normal(size=B) * 0.01
    x0[:, 6:8] = r.normal(size=(B, 2)) * 0.2
    x0[:, 3:5] = r.normal(size=(B, 2)) * 0.05
    x0[:, 5] = r.normal(size=B) * 0.3
    vc = np.stack([r.uniform(-0.5, 0.5, B), r.uniform(-0.2, 0.2, B),
                   r.uniform(-0.5, 0.5, B)], 1)
    tables = gait_tables()
    gids = [GAIT_IDS[g] for g in ("trot", "walk", "bound", "pace")]
    phase = r.integers(0, 16, size=B)
    cont = np.stack([tables[g][(p + np.arange(N)) % 16]
                     for g, p in zip(gids, phase)])
    feet = (SOLO12.shoulder_offsets[None, None]
            + r.normal(size=(B, N, 4, 3)) * 0.03)
    feet[..., 2] = 0.0
    feet[..., 0:2] += x0[:, None, None, 0:2]
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return f(x0), f(vc), f(feet), f(cont)


def test_rot_z():
    yaw = np.linspace(-3, 3, 7).astype(np.float32)
    np.testing.assert_allclose(npy(tsrb.rot_z(tt(yaw))),
                               npy(jax.vmap(jsrb.rot_z)(jj(yaw))), atol=1e-6)


def test_reference_rollout():
    x0, vc, _, _ = scenarios(0)
    want = jax.vmap(lambda x, v: jsrb.reference_rollout(
        J_SOLO12, JCFG.mpc, x, v))(jj(x0), jj(vc))
    got = tsrb.reference_rollout(SOLO12, CFG.mpc, tt(x0), tt(vc))
    assert got.shape == (B, N, 12)
    np.testing.assert_allclose(npy(got), npy(want), atol=1e-6)


@pytest.mark.parametrize("with_mass", [False, True])
def test_srb_discrete(with_mass):
    x0, vc, feet, _ = scenarios(1)
    mass = np.asarray(SOLO12.total_mass + np.arange(B) * 0.1, np.float32)
    if with_mass:
        want = jax.vmap(lambda y, f, p, m: jsrb.srb_discrete(
            J_SOLO12, JCFG.mpc, y, f, p, total_mass=m))(
                jj(x0[:, 5]), jj(feet[:, 0]), jj(x0[:, 0:3]), jj(mass))
        got = tsrb.srb_discrete(SOLO12, CFG.mpc, tt(x0[:, 5]),
                                tt(feet[:, 0]), tt(x0[:, 0:3]),
                                total_mass=tt(mass))
    else:
        want = jax.vmap(lambda y, f, p: jsrb.srb_discrete(
            J_SOLO12, JCFG.mpc, y, f, p))(
                jj(x0[:, 5]), jj(feet[:, 0]), jj(x0[:, 0:3]))
        got = tsrb.srb_discrete(SOLO12, CFG.mpc, tt(x0[:, 5]),
                                tt(feet[:, 0]), tt(x0[:, 0:3]))
    for name, g, w in zip("ABc", got, want):
        # B holds dt * I^-1 [r]x with I^-1 ~ 1e2: a few 1e-6 of rounding
        np.testing.assert_allclose(npy(g), npy(w), atol=5e-6, err_msg=name)


@pytest.mark.parametrize("with_mass", [False, True])
def test_build_mpc_qp(with_mass):
    x0, vc, feet, cont = scenarios(2)
    xref = npy(tsrb.reference_rollout(SOLO12, CFG.mpc, tt(x0), tt(vc)))
    mass = np.asarray(SOLO12.total_mass + np.arange(B) * 0.1, np.float32)
    if with_mass:
        want = jax.vmap(lambda a, b, c, d, m: jsrb.build_mpc_qp(
            J_SOLO12, JCFG.mpc, a, b, c, d, total_mass=m))(
                jj(x0), jj(xref), jj(feet), jj(cont), jj(mass))
        got = tsrb.build_mpc_qp(SOLO12, CFG.mpc, tt(x0), tt(xref), tt(feet),
                                tt(cont), total_mass=tt(mass))
    else:
        want = jax.vmap(lambda a, b, c, d: jsrb.build_mpc_qp(
            J_SOLO12, JCFG.mpc, a, b, c, d))(
                jj(x0), jj(xref), jj(feet), jj(cont))
        got = tsrb.build_mpc_qp(SOLO12, CFG.mpc, tt(x0), tt(xref), tt(feet),
                                tt(cont))
    P, q, A, l, u = [npy(t) for t in got]
    Pj, qj, Aj, lj, uj = [npy(t) for t in want]
    assert P.shape == (B, 192, 192) and A.shape == (B, 320, 192)
    np.testing.assert_allclose(q, qj, atol=1e-5)
    np.testing.assert_array_equal(A, Aj)
    np.testing.assert_array_equal(l, lj)
    np.testing.assert_array_equal(u, uj)
    off = ~np.eye(192, dtype=bool)
    assert np.abs((P - Pj)[:, off]).max() < 1e-5
    dP, dPj = np.diagonal(P, axis1=1, axis2=2), np.diagonal(Pj, axis1=1, axis2=2)
    pinned = np.repeat(cont.reshape(B, -1) < 0.5, 3, axis=1)
    assert np.all(dP[pinned] > 1e5)
    np.testing.assert_allclose(dP[pinned], dPj[pinned], rtol=2e-7)
    np.testing.assert_allclose(dP[~pinned], dPj[~pinned], atol=1e-5)


def test_solve_mpc_batch_matches_jax():
    """B = 3 mixed-gait scenarios, 200 iterations in one round from zero warm
    starts (the JAX function's defaults), then warm-started from its own
    solution.  Two float32 reduction orders through 200 iterations of
    a fixed-point method: the JAX package's budget between two of its
    backends, 1e-3 on x (the forces, N) and 1e-2 on y."""
    x0, vc, feet, cont = [a[:3] for a in scenarios(3)]
    xref = npy(tsrb.reference_rollout(SOLO12, CFG.mpc, tt(x0), tt(vc)))
    f_j, s_j = jsrb.solve_mpc_batch(J_SOLO12, JCFG.mpc, jj(x0), jj(xref),
                                    jj(feet), jj(cont))
    f_t, s_t = tsrb.solve_mpc_batch(SOLO12, CFG.mpc, tt(x0), tt(xref),
                                    tt(feet), tt(cont))
    assert tuple(f_t.shape) == (3, N, 4, 3) and tuple(s_t.ok.shape) == (3,)
    np.testing.assert_allclose(npy(f_t), npy(f_j), atol=1e-3)
    np.testing.assert_allclose(npy(s_t.y), npy(s_j.y), atol=1e-2)
    assert npy(s_t.ok).tolist() == npy(s_j.ok).tolist() == [True] * 3
    # swing feet carry no force (the ridge pins them to ~1e-6 N)
    assert np.abs(npy(f_t)[cont < 0.5]).max() < 1e-3
    # zero warm starts are the default; a solve warm-started from its own
    # solution stays there (a fixed point of the iteration, to float32
    # rounding of the scaled warm start)
    args = (SOLO12, CFG.mpc, tt(x0), tt(xref), tt(feet), tt(cont))
    f_0, _ = tsrb.solve_mpc_batch(*args, warm_x=torch.zeros(3, 12 * N),
                                  warm_y=torch.zeros(3, 20 * N))
    assert torch.equal(f_0, f_t)
    f_w, _ = tsrb.solve_mpc_batch(*args, warm_x=s_t.x, warm_y=s_t.y)
    np.testing.assert_allclose(npy(f_w), npy(f_t), atol=1e-3)


def oracle_scenario(seed):
    """tests/test_mpc_jax.py's scenario: a trot MPC problem planned by the
    float64 oracle (GaitScheduler, plan_footsteps_horizon, the oracle's
    reference rollout) from a perturbed state and a random command."""
    from mpctsid_tpu.model.gaits import TROT
    from mpctsid_tpu.oracle.mpc import reference_rollout as o_rollout
    from mpctsid_tpu.oracle.planner import (GaitScheduler,
                                            plan_footsteps_horizon)

    r = np.random.default_rng(seed)
    x0 = np.zeros(12)
    x0[2] = J_SOLO12.h_ref + r.normal() * 0.01
    x0[6:8] = r.normal(size=2) * 0.2
    x0[3:5] = r.normal(size=2) * 0.05
    vc = np.array([r.uniform(-0.5, 0.5), r.uniform(-0.2, 0.2),
                   r.uniform(-0.5, 0.5)])
    g = GaitScheduler(TROT, phase=int(r.integers(0, 16)))
    feet0 = J_SOLO12.shoulder_offsets.copy()
    feet0[:, 2] = 0.0
    fsteps, _ = plan_footsteps_horizon(J_SOLO12, JCFG.mpc, JCFG.cascade, g,
                                       x0, vc, feet0)
    return x0, o_rollout(J_SOLO12, JCFG.mpc, x0, vc), fsteps, g.horizon(16)


def test_polished_mpc_tier_under_1e4_of_the_oracle():
    """BASELINE.json:5, as tests/test_mpc_jax.py holds the JAX package: the
    polished tier (100 iterations in 4 rounds, polish_kkt=True) within 1e-4
    of the float64 oracle's solution, here on four scenarios at once (the
    per-scenario polish and acceptance run batched).  Measured on the CPU:
    4e-5 - 6e-5, where float32 and float64 solves of the port differ by
    1.4e-5 at most: the rest is the oracle's bound-pinned swing rows against
    the port's ridge."""
    from mpctsid_tpu.oracle.mpc import solve_mpc as o_solve

    seeds = range(4)
    scen = [oracle_scenario(s) for s in seeds]
    stack = [tt(np.stack([sc[i] for sc in scen])) for i in range(4)]
    P, q, A, l, u = tsrb.build_mpc_qp(SOLO12, CFG.mpc, *stack)
    sol = tadmm.admm_solve(P, q, A, l, u, iters=100, adapt_rounds=4, rho=0.1,
                           polish_kkt=True)
    assert sol.ok.all()
    for b, sc in enumerate(scen):
        _, res_o = o_solve(J_SOLO12, JCFG.mpc, JCFG.solver, *sc)
        assert np.abs(npy(sol.x[b]) - res_o.x).max() < 1e-4, b
