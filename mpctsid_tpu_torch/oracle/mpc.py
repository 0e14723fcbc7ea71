"""Oracle centroidal MPC: SRB model, condensation, QP assembly (numpy, float64).

Implements the convex centroidal-dynamics MPC of the reference (BASELINE.json:5:
"12-state SRB model, per-footstep contact schedule, friction-cone and force-bound
constraints"; horizon 16, dt 20 ms per BASELINE.json:7; family algorithm per
SURVEY.md §2.1 "Centroidal MPC — QP builder" and §3.3).

State   x = [p(3), rpy(3), v(3), omega_world(3)]  in R^12, world frame.
Input   u_k = [f_FL, f_FR, f_HL, f_HR]            in R^12, world-frame forces.

Continuous dynamics, yaw-linearized at the reference yaw psi_k with world-frame
SRB inertia I_w = Rz(psi_k) I_b Rz(psi_k)':

    p'   = v
    rpy' = Rz(psi_k)' omega
    v'   = (1/m) sum_i f_i - g e_z
    w'   = I_w^{-1} sum_i [r_ki - p_ref_k]x f_i

Euler-discretized at dt, then condensed: X = Sx x0 + Su U + Sc over the horizon,
giving a dense strictly-convex QP in U in R^{12N} with block-diagonal (5 rows per
foot per step) friction-pyramid/force-bound constraints.  The contact schedule
zeroes swing-foot forces through l = u = 0 on the fz row (rows 1-4 then pin
fx = fy = 0).  This condensed form is the same QP as the reference's sparse
OSQP formulation after eliminating the dynamics equalities — identical minimizer.
"""

from __future__ import annotations

import numpy as np

from mpctsid_tpu_torch.config import MpcConfig, SolverConfig
from mpctsid_tpu_torch.model.solo12 import Solo12Model
from mpctsid_tpu_torch.oracle.qp import QPResult, solve_qp

INF = 1e20  # OSQP-style "infinity"; kept finite so f32 ports behave identically

NX = 12
NU = 12
N_FEET = 4
ROWS_PER_FOOT = 5


def rot_z(yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def skew(r: np.ndarray) -> np.ndarray:
    return np.array([
        [0.0, -r[2], r[1]],
        [r[2], 0.0, -r[0]],
        [-r[1], r[0], 0.0],
    ])


def srb_discrete(
    model: Solo12Model,
    cfg: MpcConfig,
    yaw: float,
    feet: np.ndarray,      # (4,3) world foot positions at this step
    p_ref: np.ndarray,     # (3,) reference COM position at this step
):
    """One-step Euler-discretized (A_k, B_k, c_k)."""
    dt = cfg.dt
    Rz = rot_z(yaw)
    I_w = Rz @ model.srb_inertia @ Rz.T
    I_w_inv = np.linalg.inv(I_w)

    A = np.eye(NX)
    A[0:3, 6:9] = dt * np.eye(3)
    A[3:6, 9:12] = dt * Rz.T

    B = np.zeros((NX, NU))
    for i in range(N_FEET):
        r = feet[i] - p_ref
        B[6:9, 3 * i:3 * i + 3] = dt / model.total_mass * np.eye(3)
        B[9:12, 3 * i:3 * i + 3] = dt * (I_w_inv @ skew(r))

    c = np.zeros(NX)
    c[8] = -dt * model.g
    return A, B, c


def condense(A_list, B_list, c_list):
    """Stack x_{k+1} = A_k x_k + B_k u_k + c_k into X = Sx x0 + Su U + Sc.

    X = [x_1 .. x_N], U = [u_0 .. u_{N-1}]."""
    N = len(A_list)
    Sx = np.zeros((N * NX, NX))
    Su = np.zeros((N * NX, N * NU))
    Sc = np.zeros(N * NX)
    for k in range(N):
        rows = slice(k * NX, (k + 1) * NX)
        if k == 0:
            Sx[rows] = A_list[0]
            Sc[rows] = c_list[0]
        else:
            prev = slice((k - 1) * NX, k * NX)
            Sx[rows] = A_list[k] @ Sx[prev]
            Sc[rows] = A_list[k] @ Sc[prev] + c_list[k]
            Su[rows] = A_list[k] @ Su[prev]
        Su[rows, k * NU:(k + 1) * NU] = B_list[k]
    return Sx, Su, Sc


def pyramid_block(mu: float) -> np.ndarray:
    """(5,3) friction-pyramid + normal-bound rows for one force [fx, fy, fz]."""
    return np.array([
        [1.0, 0.0, -mu],
        [1.0, 0.0, mu],
        [0.0, 1.0, -mu],
        [0.0, 1.0, mu],
        [0.0, 0.0, 1.0],
    ])


def build_mpc_qp(
    model: Solo12Model,
    cfg: MpcConfig,
    x0: np.ndarray,          # (12,)
    x_ref: np.ndarray,       # (N,12) reference states x_1..x_N
    feet: np.ndarray,        # (N,4,3) world foot positions per step
    contacts: np.ndarray,    # (N,4) in {0,1}
):
    """Returns (P, q, A, l, u) for the condensed MPC QP over U in R^{12N}."""
    N = cfg.horizon
    A_list, B_list, c_list = [], [], []
    for k in range(N):
        yaw_k = x_ref[k, 5]
        Ak, Bk, ck = srb_discrete(model, cfg, yaw_k, feet[k], x_ref[k, 0:3])
        A_list.append(Ak)
        B_list.append(Bk)
        c_list.append(ck)
    Sx, Su, Sc = condense(A_list, B_list, c_list)

    q_diag = np.tile(cfg.q_diag, N)
    H = Su.T @ (q_diag[:, None] * Su) + cfg.w_force * np.eye(N * NU)
    drift = Sx @ x0 + Sc - x_ref.reshape(-1)
    g = Su.T @ (q_diag * drift)

    C = pyramid_block(cfg.mu)
    m = N * N_FEET * ROWS_PER_FOOT
    A_c = np.zeros((m, N * NU))
    l = np.zeros(m)
    u = np.zeros(m)
    for k in range(N):
        for i in range(N_FEET):
            r0 = (k * N_FEET + i) * ROWS_PER_FOOT
            c0 = k * NU + 3 * i
            A_c[r0:r0 + ROWS_PER_FOOT, c0:c0 + 3] = C
            in_contact = contacts[k, i] > 0.5
            l[r0:r0 + 5] = [-INF, 0.0, -INF, 0.0,
                            cfg.fz_min if in_contact else 0.0]
            u[r0:r0 + 5] = [0.0, INF, 0.0, INF,
                            cfg.fz_max if in_contact else 0.0]
    return H, g, A_c, l, u


def solve_mpc(
    model: Solo12Model,
    cfg: MpcConfig,
    solver: SolverConfig,
    x0: np.ndarray,
    x_ref: np.ndarray,
    feet: np.ndarray,
    contacts: np.ndarray,
    warm_x: np.ndarray | None = None,
    warm_y: np.ndarray | None = None,
) -> tuple[np.ndarray, QPResult]:
    """Solve the condensed MPC QP; returns forces (N,4,3) and the raw QP result."""
    P, q, A, l, u = build_mpc_qp(model, cfg, x0, x_ref, feet, contacts)
    res = solve_qp(P, q, A, l, u,
                   rho=solver.rho, sigma=solver.sigma, alpha=solver.alpha,
                   eps_abs=solver.eps_abs, eps_rel=solver.eps_rel,
                   max_iters=solver.max_iters_oracle, polish=solver.polish,
                   x0=warm_x, y0=warm_y)
    forces = res.x.reshape(cfg.horizon, N_FEET, 3)
    return forces, res


def reference_rollout(
    model: Solo12Model,
    cfg: MpcConfig,
    x0: np.ndarray,
    v_cmd: np.ndarray,  # (3,) [vx, vy, wz] in the base (yaw) frame
) -> np.ndarray:
    """(N,12) reference states x_1..x_N by integrating the commanded velocity
    (SURVEY.md §2.1 "Reference-trajectory rollout")."""
    N = cfg.horizon
    x_ref = np.zeros((N, NX))
    p = x0[0:3].copy()
    yaw = x0[5]
    for k in range(N):
        v_world = rot_z(yaw) @ np.array([v_cmd[0], v_cmd[1], 0.0])
        p = p + cfg.dt * v_world
        yaw = yaw + cfg.dt * v_cmd[2]
        x_ref[k, 0:2] = p[0:2]
        x_ref[k, 2] = model.h_ref
        x_ref[k, 5] = yaw
        x_ref[k, 6:9] = v_world
        x_ref[k, 11] = v_cmd[2]
    return x_ref
