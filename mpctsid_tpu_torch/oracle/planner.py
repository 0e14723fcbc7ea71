"""Oracle planners: gait scheduler, Raibert footstep planner, swing trajectories.

Numpy float64 reference for SURVEY.md §2.1 rows "Gait scheduler", "Footstep planner"
and "Swing-foot trajectory generator":
  * gait scheduler — periodic contact table rolled one step per MPC period;
  * footstep planner — next touchdown = yaw-rotated shoulder position
    + (T_stance/2) v + k (v - v_ref) + centrifugal term 0.5 sqrt(h/g) (v x w_ref);
  * swing trajectories — quintic xy / sextic z polynomials with ~5 cm apex and
    zero touchdown velocity and acceleration.
"""

from __future__ import annotations

import numpy as np

from mpctsid_tpu_torch.config import CascadeConfig, MpcConfig
from mpctsid_tpu_torch.model.gaits import GAIT_PERIOD, GaitDef
from mpctsid_tpu_torch.model.solo12 import Solo12Model
from mpctsid_tpu_torch.oracle.mpc import rot_z


class GaitScheduler:
    """Phase counter over a periodic contact table (SURVEY.md §2.1)."""

    def __init__(self, gait: GaitDef, phase: int = 0):
        self.gait = gait
        self.phase = phase % GAIT_PERIOD

    def roll(self):
        self.phase = (self.phase + 1) % GAIT_PERIOD

    def contacts(self) -> np.ndarray:
        return self.gait.contacts_at(self.phase)

    def horizon(self, n: int) -> np.ndarray:
        return self.gait.horizon(self.phase, n)

    def stance_duration_s(self, leg: int, mpc_dt: float) -> float:
        return self.gait.stance_duration(leg) * mpc_dt

    def swing_progress(self, leg: int, frac: float = 0.5) -> tuple[float, float]:
        """(s, T_swing): normalized progress in the current swing phase and its
        duration in MPC steps.  s = 0 at lift-off, 1 at touchdown; (0, 0) if the
        leg is in stance.  frac in [0,1) is sub-step progress within the current
        MPC step (the 1 kHz WBC evaluates swing refs between gait rolls)."""
        col = self.gait.table[:, leg]
        if col[self.phase % GAIT_PERIOD] > 0.5:
            return 0.0, 0.0
        # walk back to lift-off, forward to touchdown
        back = 0
        while col[(self.phase - back - 1) % GAIT_PERIOD] < 0.5 and back < GAIT_PERIOD:
            back += 1
        fwd = 0
        while col[(self.phase + fwd + 1) % GAIT_PERIOD] < 0.5 and fwd < GAIT_PERIOD:
            fwd += 1
        dur = back + fwd + 1
        return (back + frac) / dur, float(dur)


def raibert_touchdown(
    model: Solo12Model,
    cascade: CascadeConfig,
    leg: int,
    p_com: np.ndarray,     # (3,) COM position at touchdown time
    yaw: float,
    v: np.ndarray,         # (3,) measured base velocity, world
    v_ref_world: np.ndarray,   # (3,) commanded velocity, world
    wz_ref: float,
    t_stance: float,
) -> np.ndarray:
    """World-frame (3,) touchdown target for one leg (z = 0, flat ground)."""
    shoulder = p_com + rot_z(yaw) @ model.shoulder_offsets[leg]
    p = shoulder[:2].copy()
    p += cascade.t_stance_factor * t_stance * v[:2]
    p += cascade.k_raibert * (v[:2] - v_ref_world[:2])
    # centrifugal term 0.5*sqrt(h/g) * (v x w), w = [0, 0, wz]
    h = max(p_com[2], 1e-3)
    p += 0.5 * np.sqrt(h / model.g) * np.array([v[1] * wz_ref, -v[0] * wz_ref])
    return np.array([p[0], p[1], 0.0])


def plan_footsteps_horizon(
    model: Solo12Model,
    mpc: MpcConfig,
    cascade: CascadeConfig,
    gait: GaitScheduler,
    x: np.ndarray,             # (12,) current SRB state
    v_cmd: np.ndarray,         # (3,) [vx, vy, wz] command in yaw frame
    current_feet: np.ndarray,  # (4,3) current world foot positions
) -> tuple[np.ndarray, np.ndarray]:
    """Per-step world foot positions over the MPC horizon.

    Returns (feet (N,4,3), next_touchdown (4,3)).  A foot in stance holds its
    position; at each swing->stance transition inside the horizon the touchdown
    is recomputed with the Raibert heuristic at the projected future COM/yaw
    (SURVEY.md §3.2/§3.3 fsteps construction)."""
    N = mpc.horizon
    contacts = gait.horizon(N + 1)
    p0, yaw0 = x[0:3], x[5]
    v = x[6:9]
    feet = np.zeros((N, 4, 3))
    work = current_feet.copy()
    work[:, 2] = 0.0
    next_td = np.full((4, 3), np.nan)
    prev = gait.contacts()
    for k in range(N):
        yaw_k = yaw0 + v_cmd[2] * mpc.dt * k
        v_ref_world = rot_z(yaw_k) @ np.array([v_cmd[0], v_cmd[1], 0.0])
        p_k = p0 + v * mpc.dt * k
        for i in range(4):
            if contacts[k, i] > 0.5 and prev[i] < 0.5:
                t_stance = gait.stance_duration_s(i, mpc.dt)
                work[i] = raibert_touchdown(
                    model, cascade, i, np.array([p_k[0], p_k[1], model.h_ref]),
                    yaw_k, v, v_ref_world, v_cmd[2], t_stance)
                if np.isnan(next_td[i, 0]):
                    next_td[i] = work[i]
            feet[k, i] = work[i]
        prev = contacts[k]
    # feet that never touch down in the horizon keep their current position
    for i in range(4):
        if np.isnan(next_td[i, 0]):
            next_td[i] = work[i]
    return feet, next_td


def swing_xy_coeffs(p0: float, p1: float):
    """Quintic s in [0,1] from p0 to p1, zero vel/acc at both ends.
    Returns polynomial coefficients [c0..c5], evaluated as sum c_j s^j."""
    d = p1 - p0
    return np.array([p0, 0.0, 0.0, 10.0 * d, -15.0 * d, 6.0 * d])


def swing_z_coeffs(h_apex: float):
    """Sextic s in [0,1] with z(0)=z(1)=0, z'(0)=z'(1)=0, z''(0)=z''(1)=0,
    z(1/2)=h_apex.  Closed form: z = 64 h s^3 (1-s)^3."""
    h = 64.0 * h_apex
    # 64 h s^3 (1-s)^3 = h (64 s^3 - 192 s^4 + 192 s^5 - 64 s^6)
    return np.array([0.0, 0.0, 0.0, h, -3.0 * h, 3.0 * h, -h])


def eval_poly(coeffs: np.ndarray, s: float, ds_dt: float):
    """(pos, vel, acc) of a polynomial in s at s, with s-rate ds_dt = 1/T."""
    powers = s ** np.arange(len(coeffs))
    pos = float(coeffs @ powers)
    dcoef = coeffs[1:] * np.arange(1, len(coeffs))
    vel = float(dcoef @ powers[:-1]) * ds_dt
    ddcoef = dcoef[1:] * np.arange(1, len(dcoef))
    acc = float(ddcoef @ powers[:-2]) * ds_dt * ds_dt
    return pos, vel, acc


def swing_foot_ref(
    p_liftoff: np.ndarray,   # (3,) world position at lift-off (z ~ 0)
    p_touchdown: np.ndarray, # (3,) world touchdown target
    s: float,                # normalized phase in [0,1]
    T: float,                # swing duration in seconds
    h_apex: float,
):
    """(pos, vel, acc) each (3,) for a swing foot at phase s."""
    ds = 1.0 / max(T, 1e-6)
    pos = np.zeros(3)
    vel = np.zeros(3)
    acc = np.zeros(3)
    for ax in range(2):
        c = swing_xy_coeffs(p_liftoff[ax], p_touchdown[ax])
        pos[ax], vel[ax], acc[ax] = eval_poly(c, s, ds)
    cz = swing_z_coeffs(h_apex)
    pz, vz, az = eval_poly(cz, s, ds)
    pos[2], vel[2], acc[2] = pz, vz, az
    return pos, vel, acc
