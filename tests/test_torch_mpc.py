"""Port parity: mpc/srb.py (batched PyTorch) vs the JAX functions.

QP matrices to atol 1e-5, the budget tests/test_mpc_jax.py gives the JAX
QP assembly against the oracle; the ridge-pinned diagonal entries (1e6) are
compared relatively (one f32 ulp there is 0.06).
"""

import numpy as np
import pytest

import jax

from mpctsid_tpu.config import EngineConfig as JEngineConfig
from mpctsid_tpu.model.solo12 import SOLO12 as J_SOLO12
from mpctsid_tpu.mpc import srb as jsrb
from mpctsid_tpu_torch.config import EngineConfig
from mpctsid_tpu_torch.model.gaits import GAIT_IDS, gait_tables
from mpctsid_tpu_torch.model.solo12 import SOLO12
from mpctsid_tpu_torch.mpc import srb as tsrb

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


def test_solve_mpc_batch_raises_by_name():
    with pytest.raises(NotImplementedError, match="solve_mpc_batch"):
        tsrb.solve_mpc_batch()
