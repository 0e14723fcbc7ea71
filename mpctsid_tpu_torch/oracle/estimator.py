"""Oracle state estimator: complementary filter (numpy).

Reference mechanism per SURVEY.md §2.1 "State estimator" / §3.5: IMU attitude
complementary filter + leg-odometry base velocity from stance-foot kinematics,
low-pass fused.  Inputs are gyro/accelerometer readings and joint encoders
(positions + velocities) plus the stance contact flags from the gait scheduler.
Outputs the (q, v) estimate consumed by the controller.
"""

from __future__ import annotations

import numpy as np

from mpctsid_tpu_torch.model.tree import KinematicTree
from mpctsid_tpu_torch.oracle import dynamics as dyn


class ComplementaryEstimator:
    def __init__(self, tree: KinematicTree, q0: np.ndarray, dt: float = 0.001,
                 alpha_tilt: float = 0.02, alpha_vel: float = 0.97,
                 alpha_z: float = 0.05):
        self.tree = tree
        self.dt = dt
        self.alpha_tilt = alpha_tilt   # accelerometer correction gain
        self.alpha_vel = alpha_vel     # leg-odometry low-pass (higher = trust odometry less)
        self.alpha_z = alpha_z         # stance-kinematics height blend per tick
        self.q = q0.copy()
        self.v = np.zeros(18)

    def update(self, gyro: np.ndarray, accel: np.ndarray,
               q_joints: np.ndarray, qd_joints: np.ndarray,
               contacts: np.ndarray,
               base_pos_hint: np.ndarray | None = None) -> tuple[np.ndarray, np.ndarray]:
        """One 1 kHz update; returns the current (q(19,), v(18,)) estimate.

        Base HEIGHT is always estimated from stance-leg kinematics (the
        reference derives height the same way, SURVEY.md §3.5).  base_pos_hint,
        when provided (sim ground truth or mocap), overrides only the drifting
        integrated x-y — the reference similarly relies on PyBullet/mocap for
        absolute planar position in sim (SURVEY.md §2.1 [K-MED])."""
        dt = self.dt
        # joints come straight from the encoders
        self.q[7:] = q_joints
        # --- attitude: integrate gyro, tilt-correct toward accelerometer gravity
        self.q = dyn.integrate_q(
            self.q, np.concatenate([np.zeros(3), gyro, np.zeros(12)]), dt)
        R0 = dyn.quat_to_rot(self.q[3:7])
        a_norm = np.linalg.norm(accel)
        if a_norm > 1e-6:
            g_meas = R0 @ (accel / a_norm)          # measured up-direction, world
            tilt_err = np.cross(g_meas, np.array([0.0, 0.0, 1.0]))
            corr_local = self.alpha_tilt * (R0.T @ tilt_err)
            self.q = dyn.integrate_q(
                self.q, np.concatenate([np.zeros(3), corr_local, np.zeros(12)]), 1.0)
            R0 = dyn.quat_to_rot(self.q[3:7])

        # --- base velocity: leg odometry from stance feet
        st = dyn.DynState(self.tree, self.q)
        v_full = np.concatenate([np.zeros(3), gyro, qd_joints])
        v_odo = np.zeros(3)
        n_st = 0
        for i in range(4):
            if contacts[i] > 0.5:
                J = dyn.foot_jacobian(self.tree, st, i)
                # 0 = J_lin v_lin + rest  =>  v_lin_local = -R0' (J[:,3:] @ [w; qd])
                resid = J[:, 3:] @ v_full[3:]
                v_odo += -R0.T @ resid
                n_st += 1
        v_lin_prev = self.v[0:3]
        if n_st > 0:
            v_odo /= n_st
            # low-pass fuse: IMU acceleration integration + odometry correction
            a_local = accel - R0.T @ np.array([0.0, 0.0, dyn.GRAV])
            v_pred = v_lin_prev + dt * (a_local - np.cross(gyro, v_lin_prev))
            v_lin = self.alpha_vel * v_pred + (1.0 - self.alpha_vel) * v_odo
        else:
            a_local = accel - R0.T @ np.array([0.0, 0.0, dyn.GRAV])
            v_lin = v_lin_prev + dt * (a_local - np.cross(gyro, v_lin_prev))

        self.v = np.concatenate([v_lin, gyro, qd_joints])
        # --- base x-y: integrate (or take hint)
        if base_pos_hint is not None:
            self.q[0:2] = base_pos_hint[0:2]
        else:
            self.q[0:2] = self.q[0:2] + dt * (R0 @ v_lin)[0:2]
        # --- base z: stance-leg kinematics blended with the velocity integral
        # ((foot_z - base_z) is independent of the current base-z estimate)
        z_int = self.q[2] + dt * (R0 @ v_lin)[2]
        if n_st > 0:
            feet_w = dyn.DynState(self.tree, self.q).foot_positions()
            z_kin = self.q[2] - float(
                (feet_w[:, 2] * contacts).sum() / n_st)
            self.q[2] = (1.0 - self.alpha_z) * z_int + self.alpha_z * z_kin
        else:
            self.q[2] = z_int
        return self.q.copy(), self.v.copy()
