"""The port's `model/tree.py::to_mjcf` and its float64 dyn/ against MuJoCo,
as tests/test_oracle_dynamics_mujoco.py holds the oracle: the same MJCF
string as the JAX package's, then the mass matrix, bias forces, foot
positions, Jacobians and drifts of the batched torch recursions (float64)
against MuJoCo's, over the same seeds.

MuJoCo's free joint: qpos quaternion wxyz, qvel = [v_world, w_local, qdot];
ours: quaternion xyzw, v = [v_local, w_local, qdot].  With
T = blockdiag(R_base, I3, I12): M = T' M_mj T, h = T' h_mj + T' M_mj Tdot v
(Tdot v = [R (w x v_local); 0; 0]), J = J_mj T.
"""

import numpy as np
import pytest
import torch

from mpctsid_tpu.model.solo12 import SOLO12 as J_SOLO12
from mpctsid_tpu.model.tree import to_mjcf as j_to_mjcf
from mpctsid_tpu_torch import dyn
from mpctsid_tpu_torch.model.solo12 import SOLO12
from mpctsid_tpu_torch.model.tree import build_tree, to_mjcf

mujoco = pytest.importorskip("mujoco")

TREE = build_tree(SOLO12)
SEEDS = range(5)


@pytest.fixture(scope="module")
def mj():
    model = mujoco.MjModel.from_xml_string(to_mjcf(SOLO12))
    return model, mujoco.MjData(model)


def random_state(seed):
    """tests/test_oracle_dynamics_mujoco.py's states: any position, any
    orientation, joints in +-1.5 rad, velocities ~2."""
    rng = np.random.default_rng(seed)
    q = np.zeros(19)
    q[0:3] = rng.normal(size=3)
    quat = rng.normal(size=4)
    q[3:7] = quat / np.linalg.norm(quat)
    q[7:] = rng.uniform(-1.5, 1.5, size=12)
    v = rng.normal(size=18) * 2.0
    return q, v


def set_state(mj, q, v):
    model, data = mj
    R0 = dyn.quat_to_rot(torch.tensor(q[None, 3:7]))[0].numpy()
    data.qpos[0:3] = q[0:3]
    data.qpos[3:7] = [q[6], q[3], q[4], q[5]]
    data.qpos[7:] = q[7:]
    data.qvel[0:3] = R0 @ v[0:3]
    data.qvel[3:6] = v[3:6]
    data.qvel[6:] = v[6:]
    mujoco.mj_forward(model, data)
    T = np.eye(18)
    T[0:3, 0:3] = R0
    return T, R0


def t64(a):
    return torch.tensor(np.asarray(a, np.float64)[None])


def test_to_mjcf_equals_the_jax_packages():
    xml = to_mjcf(SOLO12)
    assert xml == j_to_mjcf(J_SOLO12)
    assert xml.count("<joint") == 12 and xml.count("<freejoint") == 1
    assert xml.count("<site") == 4


def test_total_mass_matches_mujoco(mj):
    model, _ = mj
    assert abs(SOLO12.total_mass
               - model.body_subtreemass[model.body("base").id]) < 1e-9


@pytest.mark.parametrize("seed", SEEDS)
def test_mass_matrix_and_bias_forces(mj, seed):
    """Measured over the five seeds: 2.2e-15 (mass matrix) and 1.4e-14
    (bias forces); held to the oracle's budgets, 1e-10 and 1e-9."""
    model, data = mj
    q, v = random_state(seed)
    T, R0 = set_state(mj, q, v)
    M_mj = np.zeros((18, 18))
    mujoco.mj_fullM(model, data, M_mj)
    M = dyn.crba(TREE, t64(q))[0].numpy()
    np.testing.assert_allclose(M, T.T @ M_mj @ T, rtol=0, atol=1e-10)
    tdot_v = np.zeros(18)
    tdot_v[0:3] = R0 @ np.cross(v[3:6], v[0:3])
    h_want = T.T @ data.qfrc_bias + T.T @ M_mj @ tdot_v
    h = dyn.rnea(TREE, t64(q), t64(v), torch.zeros(1, 18,
                                                   dtype=torch.float64))[0]
    np.testing.assert_allclose(h.numpy(), h_want, rtol=0, atol=1e-9)


@pytest.mark.parametrize("seed", SEEDS)
def test_foot_positions_and_jacobians(mj, seed):
    """Measured 4.4e-16 (feet, m) and 4.4e-16 (Jacobians); held to the
    oracle's 1e-10."""
    model, data = mj
    q, v = random_state(seed)
    T, _ = set_state(mj, q, v)
    feet = dyn.foot_positions(TREE, t64(q))[0].numpy()
    J = dyn.foot_jacobians(TREE, t64(q))[0].numpy()
    for leg in range(4):
        sid = model.site(f"foot_{leg}").id
        np.testing.assert_allclose(feet[leg], data.site_xpos[sid], rtol=0,
                                   atol=1e-10)
        jacp = np.zeros((3, 18))
        mujoco.mj_jacSite(model, data, jacp, None, sid)
        np.testing.assert_allclose(J[leg], jacp @ T, rtol=0, atol=1e-10)


@pytest.mark.parametrize("seed", range(3))
def test_foot_drifts_against_mujoco_jacobian_rates(mj, seed):
    """Jdot v from MuJoCo's Jacobians at q -+ eps v (central difference of
    J_mj(q(t)) T(q(t)) v), against the port's closed-form drift; the
    oracle's own test uses the same difference of its Jacobians (rtol 1e-4,
    atol 1e-5)."""
    model, data = mj
    q, v = random_state(seed)
    eps = 1e-6
    drift = dyn.foot_drifts(TREE, t64(q), t64(v))[0].numpy()
    jv = {}
    for sign in (1.0, -1.0):
        qs = dyn.integrate_q(t64(q), t64(v), sign * eps)[0].numpy()
        T, _ = set_state(mj, qs, v)
        jv[sign] = []
        for leg in range(4):
            jacp = np.zeros((3, 18))
            mujoco.mj_jacSite(model, data, jacp, None,
                              model.site(f"foot_{leg}").id)
            jv[sign].append(jacp @ T @ v)
    fd = (np.asarray(jv[1.0]) - np.asarray(jv[-1.0])) / (2 * eps)
    np.testing.assert_allclose(drift, fd, rtol=1e-4, atol=1e-5)
