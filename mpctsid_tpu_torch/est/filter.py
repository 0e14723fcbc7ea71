"""Complementary-filter state estimator over a batch of scenarios
(counterpart of the JAX package's est/filter.py, batch written out): IMU
attitude complementary filter + stance-leg-odometry base velocity, low-pass
fused.

A pure function over an explicit EstimatorState: `estimator_update` returns a
new state and never writes into the one it was given.  Inputs are the plant's
sensor model: gyro / accel (`imu_from_plant`), joint encoders, and the gait's
contact flags.  Every switch (no stance foot, a vanishing accelerometer
reading) is a per-scenario mask.

On CUDA tensors `estimator_update`, and `estimator_tick` (the IMU model and
the update together, the cascade's tick), are one launch each of the
hand-written kernel `est_step` (dyn/csrc/est_step.cu over est_step.h: a
block of scenarios, the attitude chain on one warp and the legs in the base
frame on four beside it, a lane a scenario), or an exception; on CPU
tensors their plain versions, `estimator_update_reference` and
`estimator_tick_reference`.
"""

from __future__ import annotations

import dataclasses

import torch

from mpctsid_tpu_torch import dyn
from mpctsid_tpu_torch.dyn.rigid_body import _mv, _T
from mpctsid_tpu_torch.model.tree import KinematicTree
from mpctsid_tpu_torch.utils import device_constant, resolve_device

GRAV = 9.81

__all__ = ["GRAV", "EstimatorState", "estimator_init", "estimator_update",
           "estimator_update_reference", "estimator_tick",
           "estimator_tick_reference", "imu_from_plant", "run_est_update",
           "run_est_step"]


@dataclasses.dataclass
class EstimatorState:
    q: torch.Tensor   # (B, 19) current estimate
    v: torch.Tensor   # (B, 18)


def estimator_init(q0, device="cuda", dtype=torch.float32) -> EstimatorState:
    """Estimate at rest at configurations q0 (B, 19), numpy or tensor, placed
    on `device`."""
    dev = resolve_device(device)
    q0 = torch.as_tensor(q0, dtype=dtype).to(dev)
    if q0.dim() != 2:
        raise ValueError(f"q0 must be (B, 19), got {tuple(q0.shape)}")
    return EstimatorState(q=q0.clone(), v=q0.new_zeros((q0.shape[0], 18)))


def estimator_update(tree: KinematicTree, st: EstimatorState,
                     gyro, accel, q_joints, qd_joints, contacts,
                     dt: float = 0.001,
                     alpha_tilt: float = 0.02,
                     alpha_vel: float = 0.97,
                     alpha_z: float = 0.05,
                     base_pos_hint=None) -> EstimatorState:
    """One 1 kHz update for a batch: gyro, accel (B, 3), q_joints, qd_joints
    (B, 12), contacts (B, 4).

    Base HEIGHT is always estimated from stance-leg kinematics (feet on the
    ground => base z = -mean stance-foot z relative to the base), blended at
    alpha_z per tick with the velocity integral.  base_pos_hint (B, 3), when
    given (sim ground truth / mocap analog), overrides only the drifting
    integrated x-y.

    CUDA tensors: one launch of the hand-written kernel `est_update`
    (dyn/csrc/est_step.cu; float32 or float64), or an exception.  CPU
    tensors: the plain version, `estimator_update_reference`."""
    from mpctsid_tpu_torch.dyn import kernels

    kernels.check_batch(st.q, st.v)
    if st.q.device.type == "cpu":
        return estimator_update_reference(
            tree, st, gyro, accel, q_joints, qd_joints, contacts, dt=dt,
            alpha_tilt=alpha_tilt, alpha_vel=alpha_vel, alpha_z=alpha_z,
            base_pos_hint=base_pos_hint)
    q, v = kernels.launch("est_step", run_est_update, st.q.device, tree, st,
                          gyro, accel, q_joints, qd_joints, contacts, dt,
                          alpha_tilt, alpha_vel, alpha_z, base_pos_hint,
                          entry="est_update")
    estimator_update.launches += 1
    return EstimatorState(q=q, v=v)


estimator_update.launches = 0


def estimator_tick(tree: KinematicTree, st: EstimatorState, q_plant, v_plant,
                   contacts, dt: float = 0.001, alpha_tilt: float = 0.02,
                   alpha_vel: float = 0.97, alpha_z: float = 0.05,
                   base_pos_hint=None) -> EstimatorState:
    """The cascade's estimator tick for a batch: the plant's IMU model
    (`imu_from_plant` at qdd = None) and one `estimator_update` on it, the
    joint encoders read off the plant's q_plant (B, 19) and v_plant
    (B, 18); contacts (B, 4); base_pos_hint (B, 3) as estimator_update's.

    CUDA tensors: one launch of the hand-written kernel `est_step`
    (dyn/csrc/est_step.cu: a lane a scenario in each of five warps; float32
    or float64), or an exception.  CPU tensors: the plain version, `estimator_tick_reference`."""
    from mpctsid_tpu_torch.dyn import kernels

    kernels.check_batch(st.q, st.v)
    if st.q.device.type == "cpu":
        return estimator_tick_reference(
            tree, st, q_plant, v_plant, contacts, dt=dt,
            alpha_tilt=alpha_tilt, alpha_vel=alpha_vel, alpha_z=alpha_z,
            base_pos_hint=base_pos_hint)
    q, v = kernels.launch("est_step", run_est_step, st.q.device, tree, st,
                          q_plant, v_plant, contacts, dt, alpha_tilt,
                          alpha_vel, alpha_z, base_pos_hint)
    estimator_tick.launches += 1
    return EstimatorState(q=q, v=v)


estimator_tick.launches = 0


def estimator_tick_reference(tree: KinematicTree, st: EstimatorState,
                             q_plant, v_plant, contacts, dt: float = 0.001,
                             alpha_tilt: float = 0.02,
                             alpha_vel: float = 0.97, alpha_z: float = 0.05,
                             base_pos_hint=None) -> EstimatorState:
    """Plain version of `estimator_tick` (any device and dtype)."""
    gyro, accel = imu_from_plant(tree, q_plant, v_plant)
    return estimator_update_reference(
        tree, st, gyro, accel, q_plant[:, 7:], v_plant[:, 6:], contacts,
        dt=dt, alpha_tilt=alpha_tilt, alpha_vel=alpha_vel, alpha_z=alpha_z,
        base_pos_hint=base_pos_hint)


def _est_operands(st: EstimatorState, gyro, accel, q_joints, qd_joints,
                  contacts, dt, alpha_tilt, alpha_vel, alpha_z,
                  base_pos_hint, q_plant=None):
    """(inputs, outputs, parameters) of the estimator kernels in
    est_step.h's order, the outputs allocated here: the tick's q_plant in
    place of accel (None), a bool or other-dtype contacts row cast to the
    estimate's dtype."""
    from mpctsid_tpu_torch.dyn import kernels

    q = st.q
    B = kernels.check_batch(st.q, st.v)
    if contacts.dtype != q.dtype:
        contacts = contacts.to(q.dtype)
    none = (None, 0)
    ins = [kernels.rows("est.q", st.q, B, (19,), q),
           kernels.rows("est.v", st.v, B, (18,), q),
           kernels.rows("gyro", gyro, B, (3,), q),
           none if accel is None else kernels.rows("accel", accel, B, (3,),
                                                   q),
           kernels.rows("q_joints", q_joints, B, (12,), q),
           kernels.rows("qd_joints", qd_joints, B, (12,), q),
           kernels.rows("contacts", contacts, B, (4,), q),
           none if base_pos_hint is None else kernels.rows(
               "base_pos_hint", base_pos_hint, B, (3,), q),
           none if q_plant is None else kernels.rows("q_plant", q_plant, B,
                                                     (19,), q)]
    outs = (q.new_empty((B, 19)), q.new_empty((B, 18)))
    # the tilt gain rounded through float32 in both dtypes: the plain
    # version's torch.where(a_norm > 1e-6, alpha_tilt, 0.0) of two Python
    # numbers is float32, torch's default dtype, before its .to(dtype)
    gain = float(torch.tensor(alpha_tilt, dtype=torch.float32))
    par = [dt, gain, alpha_vel, 1.0 - alpha_vel, alpha_z, 1.0 - alpha_z,
           0.0 if base_pos_hint is None else 1.0]
    return ins, outs, par


def run_est_update(launch_fn, tree, st: EstimatorState, gyro, accel,
                   q_joints, qd_joints, contacts, dt, alpha_tilt, alpha_vel,
                   alpha_z, base_pos_hint):
    """(rc, (q, v)): the `est_update` kernel's operands packed for
    `launch_fn` (dyn/kernels.py's signature less the stream), its outputs
    allocated here."""
    from mpctsid_tpu_torch.dyn import kernels

    ins, outs, par = _est_operands(st, gyro, accel, q_joints, qd_joints,
                                   contacts, dt, alpha_tilt, alpha_vel,
                                   alpha_z, base_pos_hint)
    return kernels.call(launch_fn, tree, st.q, ins, outs, par), outs


def run_est_step(launch_fn, tree, st: EstimatorState, q_plant, v_plant,
                 contacts, dt, alpha_tilt, alpha_vel, alpha_z,
                 base_pos_hint):
    """(rc, (q, v)): the `est_step` kernel's operands packed for
    `launch_fn`: gyro, the joints' positions and rates as rows of the
    plant's q and v (their strides), accel not given (the kernel's IMU
    model reads q_plant)."""
    from mpctsid_tpu_torch.dyn import kernels

    B = kernels.check_batch(q_plant, v_plant)
    if B != st.q.shape[0]:
        raise ValueError(f"the plant's batch {B} is not the estimate's "
                         f"{st.q.shape[0]}")
    ins, outs, par = _est_operands(st, v_plant[:, 3:6], None, q_plant[:, 7:],
                                   v_plant[:, 6:], contacts, dt, alpha_tilt,
                                   alpha_vel, alpha_z, base_pos_hint,
                                   q_plant=q_plant)
    return kernels.call(launch_fn, tree, st.q, ins, outs, par), outs


def estimator_update_reference(tree: KinematicTree, st: EstimatorState,
                               gyro, accel, q_joints, qd_joints, contacts,
                               dt: float = 0.001,
                               alpha_tilt: float = 0.02,
                               alpha_vel: float = 0.97,
                               alpha_z: float = 0.05,
                               base_pos_hint=None) -> EstimatorState:
    """Plain version of `estimator_update` (any device and dtype)."""
    B = st.q.shape[0]
    dev, dtype = st.q.device, st.q.dtype
    zeros3 = st.q.new_zeros((B, 3))
    zeros12 = st.q.new_zeros((B, 12))
    q = torch.cat([st.q[:, :7], q_joints], dim=-1)
    # attitude: integrate gyro
    q = dyn.integrate_q(q, torch.cat([zeros3, gyro, zeros12], dim=-1), dt)
    R0 = dyn.quat_to_rot(q[:, 3:7])
    # tilt correction toward the accelerometer's gravity direction
    e_z = device_constant("est_e_z", lambda: [0.0, 0.0, 1.0], dev, dtype)
    a_norm = torch.linalg.vector_norm(accel, dim=-1, keepdim=True)   # (B, 1)
    g_meas = _mv(R0, accel / torch.clamp_min(a_norm, 1e-6))
    tilt_err = torch.linalg.cross(g_meas, e_z.expand(B, 3), dim=-1)
    gain = torch.where(a_norm > 1e-6, alpha_tilt, 0.0).to(dtype)
    corr = gain * _mv(_T(R0), tilt_err)
    q = dyn.integrate_q(q, torch.cat([zeros3, corr, zeros12], dim=-1), 1.0)
    R0 = dyn.quat_to_rot(q[:, 3:7])

    # leg odometry: stance feet imply base linear velocity
    J = dyn.foot_jacobians(tree, q)                  # (B, 4, 3, 18)
    v_rest = torch.cat([gyro, qd_joints], dim=-1)    # (B, 15)
    resid = torch.matmul(J[:, :, :, 3:], v_rest[:, None, :, None])[..., 0]
    v_odo_each = -torch.matmul(resid, R0)            # R0' resid_f, local frame
    c_sum = contacts.sum(dim=-1, keepdim=True)       # (B, 1)
    n_st = torch.clamp_min(c_sum, 1e-6)
    v_odo = (v_odo_each * contacts[:, :, None]).sum(dim=1) / n_st

    a_local = accel - GRAV * R0[:, 2, :]             # accel - R0' [0, 0, g]
    v_lin_prev = st.v[:, 0:3]
    v_pred = v_lin_prev + dt * (
        a_local - torch.linalg.cross(gyro, v_lin_prev, dim=-1))
    has_stance = c_sum > 0.5                         # (B, 1)
    v_lin = torch.where(has_stance,
                        alpha_vel * v_pred + (1.0 - alpha_vel) * v_odo,
                        v_pred)

    v = torch.cat([v_lin, gyro, qd_joints], dim=-1)
    v_world = _mv(R0, v_lin)
    xy = (base_pos_hint[:, 0:2] if base_pos_hint is not None
          else q[:, 0:2] + dt * v_world[:, 0:2])
    # kinematic height: feet_w uses the current estimate's base position, but
    # (foot_z - base_z) is independent of it, so no circularity
    feet_w = dyn.foot_positions(tree, q)
    z_kin = q[:, 2:3] - (feet_w[:, :, 2] * contacts).sum(
        dim=-1, keepdim=True) / n_st
    z_int = q[:, 2:3] + dt * v_world[:, 2:3]
    z = torch.where(has_stance, (1.0 - alpha_z) * z_int + alpha_z * z_kin,
                    z_int)
    q = torch.cat([xy, z, q[:, 3:]], dim=-1)
    return EstimatorState(q=q, v=v)


def imu_from_plant(tree: KinematicTree, q, v, qdd=None):
    """Sensor model: (gyro (B, 3), accel (B, 3)), both in the body frame."""
    R0 = dyn.quat_to_rot(q[:, 3:7])
    gyro = v[:, 3:6]
    if qdd is None:
        accel = GRAV * R0[:, 2, :]                   # R0' [0, 0, g]
    else:
        a_world = _mv(R0, qdd[:, 0:3])
        a_world = torch.cat([a_world[:, 0:2], a_world[:, 2:3] + GRAV], dim=-1)
        accel = _mv(_T(R0), a_world)
    return gyro, accel
