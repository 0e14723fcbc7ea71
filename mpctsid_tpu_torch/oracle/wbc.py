"""Oracle whole-body controller: TSID-style inverse-dynamics QP (numpy, float64).

Replaces the reference's TSID task formulation + eiquadprog active-set solve
(SURVEY.md §2.1 "TSID WBC formulation" / "WBC QP solver"; BASELINE.json:5
"task-space accelerations, contact forces, torque bounds").  Matches TSID
*solutions*, not iterates: the QP below is strictly convex, solved here by the
same oracle ADMM + polish, so its minimizer is solver-independent
(SURVEY.md §7.3 "Active-set semantics without branches").

Decision variable x = [qdd(18); f(12)] in R^30.

Cost (weighted least-squares tasks):
  * swing-foot tracking   w_foot * || J_i qdd + drift_i - a_des_i ||^2   (per swing foot)
  * force tracking        w_force * || f - f_mpc ||^2
  * posture               w_post * || qdd_joints - a_post ||^2
  * base pose             w_base * || qdd_base - a_base ||^2

Constraints (rows fixed-shape; stance/swing only toggles bounds):
  * 6  base dynamics equalities   M_u qdd - (Jc' f)_u = -h_u
  * 12 torque bounds              M_a qdd - (Jc' f)_a + h_a in [-tau_max, tau_max]
  * 20 friction pyramid / fz bounds on f (5 per foot; swing foot pinned to 0)
  * 12 stance contact equalities  J_i qdd = -drift_i - kd_c * v_foot_i
                                  (relaxed to free rows for swing feet)
After the solve:  tau = M_a qdd + h_a - (Jc' f)_a.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mpctsid_tpu_torch.config import WbcConfig
from mpctsid_tpu_torch.model.tree import NV, KinematicTree
from mpctsid_tpu_torch.oracle import dynamics as dyn
from mpctsid_tpu_torch.oracle.mpc import INF, pyramid_block
from mpctsid_tpu_torch.oracle.qp import solve_qp

NQDD = NV          # 18
NF = 12
NXW = NQDD + NF    # 30
KD_CONTACT = 20.0  # stance-foot drift damping


@dataclasses.dataclass
class WbcRefs:
    """Per-tick task references."""

    contacts: np.ndarray       # (4,) {0,1}
    f_mpc: np.ndarray          # (4,3) MPC force plan (world)
    foot_pos_ref: np.ndarray   # (4,3) swing-foot position refs (world)
    foot_vel_ref: np.ndarray   # (4,3)
    foot_acc_ref: np.ndarray   # (4,3)
    q_posture: np.ndarray      # (12,) joint posture target
    base_rpy_ref: np.ndarray   # (2,) roll/pitch targets (usually 0)
    h_ref: float               # base height target


def solve_wbc(
    tree: KinematicTree,
    cfg: WbcConfig,
    q: np.ndarray,    # (19,)
    v: np.ndarray,    # (18,)
    refs: WbcRefs,
    solver_kwargs: dict | None = None,
):
    """Returns (tau(12,), qdd(18,), f(4,3), qp_result)."""
    st = dyn.DynState(tree, q)
    M = dyn.crba(tree, st)
    h = dyn.rnea(tree, st, v, np.zeros(NV))
    feet = st.foot_positions()
    J = np.stack([dyn.foot_jacobian(tree, st, i) for i in range(4)])     # (4,3,18)
    drift = np.stack([dyn.foot_drift(tree, st, v, i) for i in range(4)]) # (4,3)
    foot_vel = np.einsum("fij,j->fi", J, v)

    # Jc' stacked: (18,12) mapping forces to generalized torques
    JcT = np.concatenate([J[i].T for i in range(4)], axis=1)

    # ---- cost -------------------------------------------------------------
    H = np.zeros((NXW, NXW))
    g = np.zeros(NXW)

    def add_task(A_t, b_t, w):
        nonlocal H, g
        H += w * (A_t.T @ A_t)
        g += -w * (A_t.T @ b_t)

    R0 = st.R_w[0]
    rpy = _rot_to_rpy(R0)
    for i in range(4):
        swing = refs.contacts[i] < 0.5
        if swing:
            a_des = (refs.foot_acc_ref[i]
                     + cfg.kp_foot * (refs.foot_pos_ref[i] - feet[i])
                     + cfg.kd_foot * (refs.foot_vel_ref[i] - foot_vel[i]))
            A_t = np.zeros((3, NXW))
            A_t[:, :NV] = J[i]
            add_task(A_t, a_des - drift[i], cfg.w_foot)

    A_f = np.zeros((NF, NXW))
    A_f[:, NV:] = np.eye(NF)
    add_task(A_f, refs.f_mpc.reshape(-1), cfg.w_force)

    A_p = np.zeros((12, NXW))
    A_p[:, 6:NV] = np.eye(12)
    a_post = cfg.kp_posture * (refs.q_posture - q[7:]) - cfg.kd_posture * v[6:]
    add_task(A_p, a_post, cfg.w_posture)

    # base task on HEIGHT + ROLL + PITCH only: x, y and yaw accelerations belong
    # to the MPC force plan — tracking zero there would fight the commanded push.
    A_b = np.zeros((3, NXW))
    A_b[0, 2] = 1.0   # qdd_z (local)
    A_b[1, 3] = 1.0   # roll
    A_b[2, 4] = 1.0   # pitch
    a_base = np.array([
        cfg.kp_base * (refs.h_ref - q[2]) - cfg.kd_base * v[2],
        cfg.kp_base * (refs.base_rpy_ref[0] - rpy[0]) - cfg.kd_base * v[3],
        cfg.kp_base * (refs.base_rpy_ref[1] - rpy[1]) - cfg.kd_base * v[4],
    ])
    add_task(A_b, a_base, cfg.w_base)

    H += 1e-6 * np.eye(NXW)  # strict convexity

    # ---- constraints ------------------------------------------------------
    m_rows = 6 + 12 + 20 + 12
    A = np.zeros((m_rows, NXW))
    l = np.zeros(m_rows)
    u = np.zeros(m_rows)

    # base dynamics equalities
    A[0:6, :NV] = M[0:6]
    A[0:6, NV:] = -JcT[0:6]
    l[0:6] = u[0:6] = -h[0:6]

    # torque bounds
    A[6:18, :NV] = M[6:]
    A[6:18, NV:] = -JcT[6:]
    l[6:18] = -cfg.tau_max - h[6:]
    u[6:18] = cfg.tau_max - h[6:]

    # friction pyramid per foot
    C = pyramid_block(cfg.mu)
    for i in range(4):
        r0 = 18 + 5 * i
        A[r0:r0 + 5, NV + 3 * i: NV + 3 * i + 3] = C
        if refs.contacts[i] > 0.5:
            l[r0:r0 + 5] = [-INF, 0.0, -INF, 0.0, cfg.fz_min]
            u[r0:r0 + 5] = [0.0, INF, 0.0, INF, cfg.fz_max]
        else:
            l[r0:r0 + 5] = [-INF, 0.0, -INF, 0.0, 0.0]
            u[r0:r0 + 5] = [0.0, INF, 0.0, INF, 0.0]

    # stance contact equalities (free rows for swing feet)
    for i in range(4):
        r0 = 38 + 3 * i
        if refs.contacts[i] > 0.5:
            A[r0:r0 + 3, :NV] = J[i]
            l[r0:r0 + 3] = u[r0:r0 + 3] = -drift[i] - KD_CONTACT * foot_vel[i]
        else:
            A[r0:r0 + 3, NV + 3 * i: NV + 3 * i + 3] = np.eye(3)
            l[r0:r0 + 3] = -INF
            u[r0:r0 + 3] = INF

    res = solve_qp(H, g, A, l, u, **(solver_kwargs or {}))
    qdd = res.x[:NV]
    f = res.x[NV:].reshape(4, 3)
    tau = M[6:] @ qdd + h[6:] - JcT[6:] @ res.x[NV:]
    return tau, qdd, f, res


def _rot_to_rpy(R: np.ndarray) -> np.ndarray:
    """ZYX euler (roll, pitch, yaw) from rotation matrix."""
    pitch = -np.arcsin(np.clip(R[2, 0], -1.0, 1.0))
    roll = np.arctan2(R[2, 1], R[2, 2])
    yaw = np.arctan2(R[1, 0], R[0, 0])
    return np.array([roll, pitch, yaw])
