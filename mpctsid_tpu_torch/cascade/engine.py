"""The full MPC + TSID cascade over a batch of scenarios (counterpart of the
JAX package's cascade/engine.py, batch written out).

Structure: a 1 kHz WBC loop with a 50 Hz MPC, the WBC consuming the last
COMPLETED plan.  The cascade is a Python loop over MPC periods with an inner
Python loop over the `mpc_every` WBC ticks; the one-solve-stale handoff is a
carried tensor: the plan solved in period p is consumed in period p+1 (its
column 1 covers p+1's prediction window); period 0 uses a gravity-
compensation fallback.

Every state tensor carries a leading scenario axis, including the
per-scenario gait id, gait phase, velocity command, plant friction and
payload.  All switching (contacts, MPC/WBC failure fallbacks) is masked
arithmetic with per-scenario masks; nothing in the tick loop reads a tensor
on the host, and the metrics stay on the device until the caller fetches
them.

With `use_estimator=True` the controller consumes the complementary-filter
estimate (est/filter.py), fed by the plant's IMU and encoders every tick,
instead of the plant's true state; the actuator law and the plant keep the
truth.
"""

from __future__ import annotations

import dataclasses

import torch

from mpctsid_tpu_torch import dyn
from mpctsid_tpu_torch.config import EngineConfig
from mpctsid_tpu_torch.env.plant import ContactParams, PlantState, plant_step
from mpctsid_tpu_torch.est.filter import estimator_update, imu_from_plant
from mpctsid_tpu_torch.model.solo12 import Solo12Model
from mpctsid_tpu_torch.model.tree import KinematicTree, build_tree
from mpctsid_tpu_torch.mpc.srb import build_mpc_qp, reference_rollout
from mpctsid_tpu_torch.plan.footsteps import plan_footsteps_horizon
from mpctsid_tpu_torch.plan.gait import (contacts_at, contacts_horizon,
                                         swing_tables)
from mpctsid_tpu_torch.plan.swing import swing_foot_ref
from mpctsid_tpu_torch.qp.admm import admm_solve
from mpctsid_tpu_torch.utils import (device_constant, enforce_f32_matmuls,
                                     resolve_device)
from mpctsid_tpu_torch.wbc.tsid import WbcRefs, solve_wbc

N_MPC_VARS = 192
N_MPC_ROWS = 320
N_WBC_VARS = 30
N_WBC_ROWS = 50


@dataclasses.dataclass
class ControllerState:
    phase: torch.Tensor          # (B,) int32: gait phase (MPC periods)
    liftoff: torch.Tensor        # (B, 4, 3)
    touchdown: torch.Tensor      # (B, 4, 3)
    prev_contacts: torch.Tensor  # (B, 4)
    f_plan: torch.Tensor         # (B, N, 4, 3) stale plan consumed this period
    mpc_warm_x: torch.Tensor     # (B, 192)
    mpc_warm_y: torch.Tensor     # (B, 320)
    wbc_warm_x: torch.Tensor     # (B, 30)
    wbc_warm_y: torch.Tensor     # (B, 50)
    v_int: torch.Tensor          # (B, 3) velocity-error integral [vx, vy, wz]


def _to_device(state, device):
    """A dataclass of tensors (or None) moved to `device`."""
    if state is None:
        return None
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name).to(device)
        for f in dataclasses.fields(state)})


def srb_state(q, v):
    """Project full (q, v) onto the 12-dim SRB state [p, rpy, v_w, w_w]."""
    R0 = dyn.quat_to_rot(q[:, 3:7])
    rpy = dyn.rot_to_rpy(R0)
    v_w = torch.bmm(R0, v[:, 0:3, None])[:, :, 0]
    w_w = torch.bmm(R0, v[:, 3:6, None])[:, :, 0]
    return torch.cat([q[:, 0:3], rpy, v_w, w_w], dim=-1)


def init_controller(model: Solo12Model, cfg: EngineConfig, tree, q0,
                    gait_id, payload=None, device="cuda",
                    dtype=torch.float32) -> ControllerState:
    """Controller state at configurations q0 (B, 19) for gaits gait_id (B,).

    q0, gait_id and payload ((B,) kg, optional) may be numpy arrays or
    tensors; the state is built on `device`."""
    dev = resolve_device(device)
    q0 = torch.as_tensor(q0, dtype=dtype).to(dev)
    if q0.dim() != 2:
        raise ValueError(f"q0 must be (B, 19), got {tuple(q0.shape)}")
    B = q0.shape[0]
    gait_id = torch.as_tensor(gait_id).to(dev)
    feet = dyn.foot_positions(tree, q0) * device_constant(
        "xy_mask", lambda: [1.0, 1.0, 0.0], dev, dtype)
    phase0 = torch.zeros((B,), dtype=torch.int32, device=dev)
    contacts0 = contacts_at(gait_id, phase0, dtype)
    n_st = torch.clamp_min(contacts0.sum(dim=-1), 1.0)
    mass = q0.new_full((B,), model.total_mass)
    if payload is not None:
        mass = mass + torch.as_tensor(payload, dtype=dtype).to(dev)
    fb = q0.new_zeros((B, cfg.mpc.horizon, 4, 3))
    fb[..., 2] = (mass * model.g / n_st)[:, None, None] * contacts0[:, None, :]
    return ControllerState(
        phase=phase0,
        liftoff=feet, touchdown=feet.clone(), prev_contacts=contacts0,
        f_plan=fb,
        mpc_warm_x=q0.new_zeros((B, N_MPC_VARS)),
        mpc_warm_y=q0.new_zeros((B, N_MPC_ROWS)),
        wbc_warm_x=q0.new_zeros((B, N_WBC_VARS)),
        wbc_warm_y=q0.new_zeros((B, N_WBC_ROWS)),
        v_int=q0.new_zeros((B, 3)),
    )


@dataclasses.dataclass(frozen=True)
class CascadeConfigured:
    """Static bundle: model + config + kinematic tree."""

    model: Solo12Model
    cfg: EngineConfig

    def __post_init__(self):
        object.__setattr__(self, "_tree", build_tree(self.model))

    @property
    def tree(self) -> KinematicTree:
        return self._tree


def cascade_period(cc: CascadeConfigured, ctl: ControllerState,
                   plant: PlantState, gait_id, v_cmd,
                   contact_params: ContactParams,
                   est=None, use_estimator: bool = False,
                   est_mocap: bool = False,
                   mpc_iters: int = None, mpc_rounds: int = None,
                   wbc_iters: int = None, wbc_rounds: int = None,
                   mpc_backend: str = None, wbc_backend: str = None,
                   payload=None, payload_known: bool = True):
    """One 20 ms MPC period: plan + MPC solve + mpc_every WBC/plant ticks.

    gait_id (B,) int, v_cmd (B, 3).  Runs where the state tensors lie.

    With use_estimator=True, the controller consumes the estimate `est`
    (an `EstimatorState`, see est/filter.py) updated every tick from the
    plant's IMU and encoders, instead of ground truth.  By default the
    estimator is HINT-FREE: base x-y comes from integrating the fused
    velocity and drifts as leg odometry does.  est_mocap=True feeds the
    plant's true base position as an external-position hint.

    payload: optional (B,) tensor (kg): a point mass rigidly attached at the
    base origin, per scenario.  The plant always carries it.  payload_known
    controls whether the CONTROLLER models it too (SRB total mass + WBC mass
    matrix/gravity bias); False exercises unmodeled-load robustness.

    Returns (new_ctl, new_plant, est, metrics); metrics values are (B, ...)
    tensors on the device."""
    if use_estimator and est is None:
        raise ValueError("cascade_period(use_estimator=True) needs est, an "
                         "EstimatorState (est.filter.estimator_init)")
    model, cfg, tree = cc.model, cc.cfg, cc.tree
    # backend and budgets default from the config tree; explicit kwargs
    # (benches, A/B scripts, parity tests) override
    if mpc_backend is None:
        mpc_backend = cfg.solver.mpc_backend
    if wbc_backend is None:
        wbc_backend = cfg.solver.wbc_backend
    if mpc_iters is None:
        mpc_iters = cfg.solver.mpc_iters
    if mpc_rounds is None:
        mpc_rounds = cfg.solver.mpc_adapt_rounds
    if wbc_iters is None:
        wbc_iters = cfg.solver.wbc_iters
    if wbc_rounds is None:
        wbc_rounds = cfg.solver.wbc_adapt_rounds
    dtype = plant.q.dtype
    dev = plant.q.device
    B = plant.q.shape[0]
    # payload spatial inertia: the plant truth always carries it; the
    # controller's dynamics see it only when payload_known
    plant_extra = None if payload is None else dyn.point_mass_spatial(
        payload.to(dtype))
    ctl_extra = plant_extra if payload_known else None
    ctl_mass = (None if (payload is None or not payload_known)
                else model.total_mass + payload.to(dtype))
    phase = ctl.phase
    contacts = contacts_at(gait_id, phase, dtype)                # (B, 4)

    q_ctl = est.q if use_estimator else plant.q
    v_ctl = est.v if use_estimator else plant.v
    feet_now = dyn.foot_positions(tree, q_ctl)
    x_srb = srb_state(q_ctl, v_ctl)

    # lift-off bookkeeping at stance->swing transitions
    swing = contacts < 0.5
    to_swing = swing & (ctl.prev_contacts > 0.5)
    liftoff = torch.where(to_swing[..., None], feet_now, ctl.liftoff)

    # Offset-free velocity tracking (config.py CascadeConfig.ki_vint):
    # integrate the body-frame velocity error once per period and bias the
    # command fed to the planner + reference rollout; the clamp bounds windup.
    cy, sy = torch.cos(x_srb[:, 5]), torch.sin(x_srb[:, 5])
    v_meas = torch.stack([cy * x_srb[:, 6] + sy * x_srb[:, 7],
                          -sy * x_srb[:, 6] + cy * x_srb[:, 7],
                          x_srb[:, 11]], dim=-1)
    t_period = cfg.cascade.mpc_every * cfg.cascade.wbc_dt
    v_int = torch.clamp(
        ctl.v_int + cfg.cascade.ki_vint * t_period * (v_cmd - v_meas),
        -cfg.cascade.v_int_max, cfg.cascade.v_int_max).to(dtype)
    v_used = v_cmd + v_int

    # footstep plan + touchdown targets for swinging feet
    fsteps, next_td = plan_footsteps_horizon(
        model, cfg.mpc, cfg.cascade, gait_id, phase, x_srb, v_used, feet_now)
    touchdown = torch.where(swing[..., None], next_td, ctl.touchdown)

    # MPC solve from the current state (one-solve-stale: consumed NEXT period)
    x_ref = reference_rollout(model, cfg.mpc, x_srb, v_used)
    cont_h = contacts_horizon(gait_id, phase, cfg.mpc.horizon, dtype)
    P, q_lin, A, l, u = build_mpc_qp(model, cfg.mpc, x_srb, x_ref, fsteps,
                                     cont_h, total_mass=ctl_mass)
    # MPC backend: "auto_mpc" resolves to the hand-written M2 iteration
    # kernel on a CUDA device (valid because this QP is inequality-only; see
    # qp/admm.py) and to the plain loop on the CPU.
    mpc_sol = admm_solve(P, q_lin, A, l, u,
                         x0=ctl.mpc_warm_x, y0=ctl.mpc_warm_y,
                         iters=mpc_iters, adapt_rounds=mpc_rounds, rho=0.1,
                         backend=mpc_backend)
    del P, q_lin, A, l, u
    # Infeasible/diverged-QP policy: on a bad solve, carry the LAST FEASIBLE
    # plan forward one period (shift columns, hold the tail) instead of
    # adopting garbage, and keep the previous warm start.  mpc_ok is per
    # scenario, so one diverged scenario never touches another's rollout.
    mpc_ok = mpc_sol.ok                                          # (B,)
    plan_solved = mpc_sol.x.reshape(B, cfg.mpc.horizon, 4, 3)
    plan_fallback = torch.cat([ctl.f_plan[:, 1:], ctl.f_plan[:, -1:]], dim=1)
    new_plan = torch.where(mpc_ok[:, None, None, None], plan_solved,
                           plan_fallback)
    mpc_warm_x = torch.where(mpc_ok[:, None], mpc_sol.x, ctl.mpc_warm_x)
    mpc_warm_y = torch.where(mpc_ok[:, None], mpc_sol.y, ctl.mpc_warm_y)

    # WBC consumes the stale plan's column covering the current period
    f_used = ctl.f_plan[:, 1] * contacts[..., None]

    back, _, dur, _ = swing_tables(gait_id, phase, dtype)
    T_swing = dur * cfg.mpc.dt
    mpc_every = cfg.cascade.mpc_every
    wbc_dt = cfg.cascade.wbc_dt
    tau_max = cfg.wbc.tau_max

    q_stand = device_constant(("q_stand", model), lambda: model.q_stand,
                              dev, dtype).expand(B, 12)
    rpy_ref = plant.q.new_zeros((B, 2))
    h_ref = plant.q.new_full((B,), model.h_ref)
    dur_pos = dur > 0
    dur_safe = torch.clamp_min(dur, 1.0)

    wx, wy = ctl.wbc_warm_x, ctl.wbc_warm_y
    tau_sq_sum = plant.q.new_zeros((B,))
    fz_sum = plant.q.new_zeros((B,))
    wbc_ok_sum = plant.q.new_zeros((B,))
    for t in range(mpc_every):
        if use_estimator:
            gyro, accel = imu_from_plant(tree, plant.q, plant.v)
            est = estimator_update(
                tree, est, gyro, accel, plant.q[:, 7:], plant.v[:, 6:],
                contacts, dt=wbc_dt,
                base_pos_hint=plant.q[:, 0:3] if est_mocap else None)
            q_t, v_t = est.q, est.v
        else:
            q_t, v_t = plant.q, plant.v
        frac = t / mpc_every
        s = torch.where(dur_pos, (back + frac) / dur_safe,
                        torch.zeros_like(dur))
        pos, vel, acc = swing_foot_ref(liftoff, touchdown, s, T_swing,
                                       cfg.cascade.swing_height)
        refs = WbcRefs(
            contacts=contacts, f_mpc=f_used,
            foot_pos_ref=pos, foot_vel_ref=vel, foot_acc_ref=acc,
            q_posture=q_stand, base_rpy_ref=rpy_ref, h_ref=h_ref)
        tau_ff, qdd, _, wbc_sol = solve_wbc(
            tree, cfg.wbc, q_t, v_t, refs,
            iters=wbc_iters, adapt_rounds=wbc_rounds,
            warm_x=wx, warm_y=wy, backend=wbc_backend,
            extra_base_inertia=ctl_extra)
        # WBC failure containment: a non-finite/diverged tick falls back to
        # pure joint impedance toward the standing posture and keeps the
        # previous warm start.
        wbc_ok = wbc_sol.ok[:, None]                             # (B, 1)
        zero12 = torch.zeros_like(tau_ff)
        tau_ff = torch.where(wbc_ok, torch.clamp(tau_ff, -tau_max, tau_max),
                             zero12)
        qdd_j = torch.where(wbc_ok, qdd[:, 6:], zero12)
        # joint-impedance actuator
        qd_des = torch.where(wbc_ok, v_t[:, 6:] + qdd_j * wbc_dt, zero12)
        q_des = torch.where(
            wbc_ok,
            q_t[:, 7:] + v_t[:, 6:] * wbc_dt + 0.5 * qdd_j * wbc_dt**2,
            q_stand)
        tau = torch.clamp(tau_ff + 6.0 * (q_des - plant.q[:, 7:])
                          + 0.3 * (qd_des - plant.v[:, 6:]),
                          -tau_max, tau_max)
        plant, f_ground = plant_step(tree, plant, tau, dt=wbc_dt,
                                     params=contact_params,
                                     extra_base_inertia=plant_extra)
        wx = torch.where(wbc_ok, wbc_sol.x, wx)
        wy = torch.where(wbc_ok, wbc_sol.y, wy)
        tau_sq_sum = tau_sq_sum + (tau * tau).sum(dim=-1)
        fz_sum = fz_sum + f_ground[..., 2].sum(dim=-1)
        wbc_ok_sum = wbc_ok_sum + wbc_sol.ok.to(dtype)

    new_ctl = ControllerState(
        phase=phase + 1,
        liftoff=liftoff, touchdown=touchdown, prev_contacts=contacts,
        f_plan=new_plan,
        mpc_warm_x=mpc_warm_x, mpc_warm_y=mpc_warm_y,
        wbc_warm_x=wx, wbc_warm_y=wy, v_int=v_int)
    metrics = {
        "x_srb": x_srb,
        "tau_rms": torch.sqrt(tau_sq_sum / (mpc_every * 12)),
        "fz_sum": fz_sum / mpc_every,
        "mpc_prim_res": mpc_sol.prim_res,
        # dual (stationarity) residual |Px + q + A'y|_inf: strictly-interior
        # solutions have prim 0 regardless of solution quality
        "mpc_dual_res": mpc_sol.dual_res,
        # per-scenario solve-status vector
        "mpc_ok": mpc_ok,
        "wbc_ok_frac": wbc_ok_sum / mpc_every,
    }
    if use_estimator:
        # odometry-frame drift of the hint-free estimator against plant
        # truth (stays 0 with est_mocap)
        metrics["est_xy_err"] = torch.linalg.vector_norm(
            est.q[:, 0:2] - plant.q[:, 0:2], dim=-1)
    return new_ctl, plant, est, metrics


def cascade_rollout(cc: CascadeConfigured, ctl: ControllerState,
                    plant: PlantState, gait_id, v_cmd,
                    contact_params: ContactParams, n_periods: int,
                    est=None, use_estimator: bool = False,
                    payload=None, device="cuda", **solver_kw):
    """Roll n_periods MPC periods (n_periods * mpc_every WBC ticks) for a
    batch of scenarios on `device`.

    gait_id (B,) int; v_cmd (B, 3) or an (B, n_periods, 3) profile; payload:
    optional (B,) base point mass (kg); est: the estimator's state when
    use_estimator is set.  The states are moved to `device` (default the
    card; raises if CUDA is asked for and absent).

    Returns (ctl, plant, metrics); each metric is stacked over periods on
    axis 1, (B, n_periods, ...), and stays on the device."""
    enforce_f32_matmuls()
    dev = resolve_device(device)
    ctl = _to_device(ctl, dev)
    plant = _to_device(plant, dev)
    est = _to_device(est, dev)
    contact_params = _to_device(contact_params, dev)
    gait_id = torch.as_tensor(gait_id).to(dev)
    v_cmd = torch.as_tensor(v_cmd, dtype=plant.q.dtype).to(dev)
    if payload is not None:
        payload = torch.as_tensor(payload, dtype=plant.q.dtype).to(dev)
    if v_cmd.dim() == 2:
        v_seq = v_cmd[:, None, :].expand(-1, n_periods, -1)
    else:
        v_seq = v_cmd
    if v_seq.shape[1] != n_periods:
        raise ValueError(f"v_cmd profile has {v_seq.shape[1]} periods, "
                         f"n_periods is {n_periods}")

    per_period = []
    for k in range(n_periods):
        ctl, plant, est, metrics = cascade_period(
            cc, ctl, plant, gait_id, v_seq[:, k], contact_params,
            est=est, use_estimator=use_estimator, payload=payload,
            **solver_kw)
        per_period.append(metrics)
    stacked = {name: torch.stack([m[name] for m in per_period], dim=1)
               for name in per_period[0]}
    return ctl, plant, stacked
