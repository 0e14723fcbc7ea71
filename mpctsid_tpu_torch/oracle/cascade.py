"""Oracle closed-loop cascade: 1 kHz WBC / 50 Hz MPC controller (numpy).

The reference Controller.compute() sequencing (SURVEY.md §3.2): estimate ->
(every 20 ticks: roll gait, plan footsteps, rollout x_ref, launch MPC) ->
swing-foot refs -> WBC -> safety clamp.  The reference runs the MPC in a second
process and the WBC consumes the last COMPLETED plan ("one-solve-stale",
SURVEY.md §2.2); here that timing semantic is reproduced deterministically: the
plan used during MPC period p was solved from the state at period p-1, and the
WBC reads the force column whose prediction window covers the current period
(column 1 of the stale plan).  The first period uses a gravity-compensation
fallback plan.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mpctsid_tpu_torch.config import EngineConfig
from mpctsid_tpu_torch.model.gaits import GAITS
from mpctsid_tpu_torch.model.solo12 import Solo12Model
from mpctsid_tpu_torch.model.tree import build_tree
from mpctsid_tpu_torch.oracle import dynamics as dyn
from mpctsid_tpu_torch.oracle.mpc import reference_rollout, rot_z, solve_mpc
from mpctsid_tpu_torch.oracle.planner import (GaitScheduler, plan_footsteps_horizon,
                                        swing_foot_ref)
from mpctsid_tpu_torch.oracle.wbc import WbcRefs, solve_wbc


def srb_state_from_full(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Project the full (q, v) onto the 12-dim SRB state [p, rpy, v_w, w_w]."""
    R0 = dyn.quat_to_rot(q[3:7])
    rpy = _rpy(R0)
    return np.concatenate([q[0:3], rpy, R0 @ v[0:3], R0 @ v[3:6]])


def _rpy(R):
    return np.array([
        np.arctan2(R[2, 1], R[2, 2]),
        -np.arcsin(np.clip(R[2, 0], -1.0, 1.0)),
        np.arctan2(R[1, 0], R[0, 0]),
    ])


@dataclasses.dataclass
class TickLog:
    tau: np.ndarray
    x_srb: np.ndarray
    f_plan: np.ndarray
    contacts: np.ndarray
    mpc_iters: int


@dataclasses.dataclass
class ActuatorCommand:
    """Joint-impedance command: the reference sends feedforward torque plus
    low-gain joint PD around setpoints integrated from the WBC accelerations
    (family-typical masterboard interface, SURVEY.md §2.1 "Real-robot interface")."""

    tau_ff: np.ndarray   # (12,)
    q_des: np.ndarray    # (12,)
    qd_des: np.ndarray   # (12,)
    kp: float = 6.0
    kd: float = 0.3

    def torque(self, q_joints: np.ndarray, qd_joints: np.ndarray,
               tau_max: float = 2.7) -> np.ndarray:
        tau = (self.tau_ff + self.kp * (self.q_des - q_joints)
               + self.kd * (self.qd_des - qd_joints))
        return np.clip(tau, -tau_max, tau_max)


class OracleController:
    """Stateful reference controller (the JAX cascade is its functional twin)."""

    def __init__(self, model: Solo12Model, cfg: EngineConfig,
                 q0: np.ndarray, perfect_state: bool = True):
        self.model = model
        self.cfg = cfg
        self.tree = build_tree(model)
        self.gait = GaitScheduler(GAITS[cfg.gait])
        self.tick = 0
        self.perfect_state = perfect_state
        st = dyn.DynState(self.tree, q0)
        feet = st.foot_positions()
        feet[:, 2] = 0.0
        self.feet_ref = feet.copy()       # current stance positions
        self.liftoff = feet.copy()        # positions at last lift-off
        self.touchdown = feet.copy()      # planned touchdown targets
        self.f_plan = None                # (N,4,3) stale MPC plan
        self.mpc_warm = (None, None)
        self.mpc_iters = 0
        self.prev_contacts = self.gait.contacts()
        self.v_int = np.zeros(3)   # velocity-error integral (engine twin)

    def compute(self, q: np.ndarray, v: np.ndarray) -> tuple[np.ndarray, TickLog]:
        cfg = self.cfg
        model = self.model
        mpc_every = cfg.cascade.mpc_every
        x_srb = srb_state_from_full(q, v)
        v_cmd = np.asarray(cfg.v_ref)

        if self.tick % mpc_every == 0:
            if self.tick > 0:
                self.gait.roll()
            contacts = self.gait.contacts()
            # offset-free velocity integrator (cascade/engine.py twin):
            # body-frame velocity error integrated once per period, biasing
            # the command fed to the planner + reference rollout
            cy, sy = np.cos(x_srb[5]), np.sin(x_srb[5])
            v_meas = np.array([cy * x_srb[6] + sy * x_srb[7],
                               -sy * x_srb[6] + cy * x_srb[7],
                               x_srb[11]])
            t_period = cfg.cascade.mpc_every * cfg.cascade.wbc_dt
            self.v_int = np.clip(
                self.v_int + cfg.cascade.ki_vint * t_period
                * (v_cmd - v_meas),
                -cfg.cascade.v_int_max, cfg.cascade.v_int_max)
            v_cmd = v_cmd + self.v_int
            # swing/stance transitions: record lift-off, fix touchdown targets
            st = dyn.DynState(self.tree, q)
            feet_now = st.foot_positions()
            fsteps, next_td = plan_footsteps_horizon(
                model, cfg.mpc, cfg.cascade, self.gait, x_srb, v_cmd, feet_now)
            for i in range(4):
                if contacts[i] < 0.5 and self.prev_contacts[i] > 0.5:
                    self.liftoff[i] = feet_now[i]
                if contacts[i] > 0.5 and self.prev_contacts[i] < 0.5:
                    self.feet_ref[i] = feet_now[i] * np.array([1.0, 1.0, 0.0])
                if contacts[i] < 0.5:
                    self.touchdown[i] = next_td[i]
            self.prev_contacts = contacts

            # launch MPC from current state; one-solve-stale handoff
            x_ref = reference_rollout(model, cfg.mpc, x_srb, v_cmd)
            forces, res = solve_mpc(
                model, cfg.mpc, cfg.solver, x_srb, x_ref, fsteps,
                self.gait.horizon(cfg.mpc.horizon),
                warm_x=self.mpc_warm[0], warm_y=self.mpc_warm[1])
            self.mpc_warm = (res.x, res.y)
            self.mpc_iters = res.iters
            self.pending_plan = forces
            if self.f_plan is None:
                # first period: gravity-compensation fallback
                fb = np.zeros((cfg.mpc.horizon, 4, 3))
                n_st = max(contacts.sum(), 1.0)
                for i in range(4):
                    if contacts[i] > 0.5:
                        fb[:, i, 2] = model.total_mass * model.g / n_st
                self.f_plan = fb
            else:
                self.f_plan = self.stale_plan
            self.stale_plan = self.pending_plan

        contacts = self.gait.contacts()
        # WBC reads the stale plan's column covering the current period
        f_mpc = self.f_plan[1] if self.f_plan.shape[0] > 1 else self.f_plan[0]
        # zero forces for feet the CURRENT schedule says are swinging
        f_mpc = f_mpc * contacts[:, None]

        # swing-foot references at sub-tick resolution
        frac = (self.tick % mpc_every) / mpc_every
        foot_pos = np.zeros((4, 3))
        foot_vel = np.zeros((4, 3))
        foot_acc = np.zeros((4, 3))
        for i in range(4):
            if contacts[i] < 0.5:
                s, dur = self.gait.swing_progress(i, frac)
                T = dur * cfg.mpc.dt
                foot_pos[i], foot_vel[i], foot_acc[i] = swing_foot_ref(
                    self.liftoff[i], self.touchdown[i], s, T,
                    cfg.cascade.swing_height)

        refs = WbcRefs(
            contacts=contacts,
            f_mpc=f_mpc,
            foot_pos_ref=foot_pos,
            foot_vel_ref=foot_vel,
            foot_acc_ref=foot_acc,
            q_posture=model.q_stand,
            base_rpy_ref=np.zeros(2),
            h_ref=model.h_ref,
        )
        tau, qdd, f, res = solve_wbc(self.tree, cfg.wbc, q, v, refs)
        tau = np.clip(tau, -cfg.wbc.tau_max, cfg.wbc.tau_max)
        # integrate WBC joint accelerations into impedance setpoints
        dt = cfg.cascade.wbc_dt
        qd_des = v[6:] + qdd[6:] * dt
        q_des = q[7:] + v[6:] * dt + 0.5 * qdd[6:] * dt * dt
        cmd = ActuatorCommand(tau_ff=tau, q_des=q_des, qd_des=qd_des)
        self.tick += 1
        return cmd, TickLog(tau=tau, x_srb=x_srb, f_plan=f_mpc,
                            contacts=contacts, mpc_iters=self.mpc_iters)
