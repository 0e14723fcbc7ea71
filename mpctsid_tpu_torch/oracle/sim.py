"""Oracle plant: whole-body simulation with penalty ground contacts (numpy).

Replaces the reference's PyBullet plant (SURVEY.md §2.1 "Simulator") for oracle
closed-loop rollouts: torque-controlled forward dynamics of the full 18-DoF model
using this repo's own CRBA/RNEA (validated vs MuJoCo), with a Kelvin-Voigt normal
spring-damper and an anchored tangential spring (true sticking friction with
Coulomb-cone sliding and anchor dragging) at the four foot points, semi-implicit
Euler at 1 kHz with substeps.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mpctsid_tpu_torch.model.tree import NV, KinematicTree
from mpctsid_tpu_torch.oracle import dynamics as dyn


@dataclasses.dataclass
class ContactParams:
    kp_n: float = 8000.0   # normal spring
    kd_n: float = 100.0    # normal damper
    kp_t: float = 2000.0   # tangential anchor spring
    kd_t: float = 30.0     # tangential damper
    mu: float = 0.7


@dataclasses.dataclass
class SimState:
    q: np.ndarray                  # (19,)
    v: np.ndarray                  # (18,)
    anchor: np.ndarray             # (4,2) tangential anchors
    in_contact: np.ndarray         # (4,) bool

    @staticmethod
    def init(q: np.ndarray, v: np.ndarray | None = None) -> "SimState":
        return SimState(q=q.copy(),
                        v=np.zeros(NV) if v is None else v.copy(),
                        anchor=np.zeros((4, 2)),
                        in_contact=np.zeros(4, dtype=bool))


def contact_forces(tree: KinematicTree, st: dyn.DynState, v: np.ndarray,
                   anchor: np.ndarray, in_contact: np.ndarray,
                   params: ContactParams):
    """Returns (forces (4,3) world, new_anchor, new_in_contact)."""
    feet = st.foot_positions()
    f = np.zeros((4, 3))
    anchor = anchor.copy()
    in_contact = in_contact.copy()
    for i in range(4):
        z = feet[i, 2]
        if z >= 0.0:
            in_contact[i] = False
            continue
        vel = dyn.foot_velocity(tree, st, v, i)
        if not in_contact[i]:
            in_contact[i] = True
            anchor[i] = feet[i, 0:2]
        fz = -params.kp_n * z - params.kd_n * vel[2]
        fz = max(fz, 0.0)
        ft = -params.kp_t * (feet[i, 0:2] - anchor[i]) - params.kd_t * vel[0:2]
        limit = params.mu * fz
        ft_norm = np.linalg.norm(ft)
        if ft_norm > limit:
            if ft_norm > 1e-12:
                ft *= limit / ft_norm
            # drag the anchor so the spring force sits on the cone (sliding)
            if params.kp_t > 0.0 and limit > 0.0:
                anchor[i] = feet[i, 0:2] + (ft + params.kd_t * vel[0:2]) / params.kp_t
            else:
                anchor[i] = feet[i, 0:2]
        f[i] = [ft[0], ft[1], fz]
    return f, anchor, in_contact


def step(tree: KinematicTree, state: SimState, tau: np.ndarray,
         dt: float = 0.001, substeps: int = 2,
         params: ContactParams | None = None) -> tuple[SimState, np.ndarray]:
    """Advance the plant by dt under joint torques tau (12,).

    Contact damping is integrated IMPLICITLY — (M + h J' D J) v+ = M v + h (tau
    - bias + J' f_elastic) — because the explicit damper is unstable against the
    tiny foot-segment inertia at any practical kd (kd*h/m_eff > 2).  The Coulomb
    cone / unilateral clamp is then applied to the resulting forces and the
    velocity is recomputed with the clamped forces (bounded, so explicit is safe).

    Returns (new_state, ground_forces(4,3) from the last substep)."""
    params = params or ContactParams()
    q, v = state.q.copy(), state.v.copy()
    anchor, in_c = state.anchor.copy(), state.in_contact.copy()
    h_dt = dt / substeps
    D = np.diag([params.kd_t, params.kd_t, params.kd_n])
    f_ground = np.zeros((4, 3))
    for _ in range(substeps):
        st = dyn.DynState(tree, q)
        M = dyn.crba(tree, st)
        bias = dyn.rnea(tree, st, v, np.zeros(NV))
        feet = st.foot_positions()
        tau_gen = np.zeros(NV)
        tau_gen[6:] = tau

        Js = []
        f_el = np.zeros((4, 3))
        active = []
        for i in range(4):
            if feet[i, 2] >= 0.0:
                in_c[i] = False
                Js.append(None)
                continue
            if not in_c[i]:
                in_c[i] = True
                anchor[i] = feet[i, 0:2]
            J = dyn.foot_jacobian(tree, st, i)
            Js.append(J)
            active.append(i)
            f_el[i, 0:2] = -params.kp_t * (feet[i, 0:2] - anchor[i])
            f_el[i, 2] = -params.kp_n * feet[i, 2]

        M_eff = M.copy()
        rhs = M @ v + h_dt * (tau_gen - bias)
        for i in active:
            M_eff += h_dt * (Js[i].T @ D @ Js[i])
            rhs += h_dt * (Js[i].T @ f_el[i])
        v_new = np.linalg.solve(M_eff, rhs)

        # clamp forces to the friction cone / unilateral condition
        f_ground = np.zeros((4, 3))
        clamped_any = False
        for i in active:
            f_i = f_el[i] - D @ (Js[i] @ v_new)
            fz = max(f_i[2], 0.0)
            ft = f_i[0:2]
            limit = params.mu * fz
            ft_norm = np.linalg.norm(ft)
            if ft_norm > limit:
                ft = ft * (limit / ft_norm) if ft_norm > 1e-12 else ft * 0.0
                # drag the anchor so the spring sits on the cone (sliding)
                anchor[i] = feet[i, 0:2] + (
                    ft + params.kd_t * (Js[i] @ v_new)[0:2]) / params.kp_t
                clamped_any = True
            if f_i[2] < 0.0:
                clamped_any = True
            f_ground[i] = [ft[0], ft[1], fz]
        if clamped_any:
            # recompute with clamped (bounded) forces, explicit
            rhs = M @ v + h_dt * (tau_gen - bias)
            for i in active:
                rhs += h_dt * (Js[i].T @ f_ground[i])
            v_new = np.linalg.solve(M, rhs)

        v = v_new
        q = dyn.integrate_q(q, v, h_dt)
    return SimState(q=q, v=v, anchor=anchor, in_contact=in_c), f_ground


def imu_readings(tree: KinematicTree, state: SimState,
                 qdd: np.ndarray | None = None) -> tuple[np.ndarray, np.ndarray]:
    """(gyro(3,) local, accel(3,) local specific force incl. gravity)."""
    st = dyn.DynState(tree, state.q)
    R0 = st.R_w[0]
    gyro = state.v[3:6]
    a_world = np.zeros(3) if qdd is None else R0 @ qdd[0:3]
    accel = R0.T @ (a_world + np.array([0.0, 0.0, dyn.GRAV]))
    return gyro, accel
