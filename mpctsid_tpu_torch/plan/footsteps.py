"""Raibert footstep planner (counterpart of the JAX package's
plan/footsteps.py, batch written out).

Touchdown target = yaw-rotated shoulder position at projected touchdown time
+ (T_stance/2) v + k (v - v_ref) + centrifugal 0.5 sqrt(h/g) (v x w).  A
foot's working position is replaced by a fresh Raibert target exactly at
swing->stance transitions inside the horizon.

`plan_footsteps_horizon` is, on CUDA tensors, one launch of the hand-written
kernel `plan_footsteps` (plan/csrc/planner.cu: a thread per scenario and
foot; plan/kernels.py); on CPU tensors it runs its plain version,
`plan_footsteps_horizon_reference`: the per-horizon-step Python loop of
masked batched ops (about 911 kernels a call on the card).
"""

from __future__ import annotations

import numpy as np
import torch

from mpctsid_tpu_torch.config import CascadeConfig, MpcConfig
from mpctsid_tpu_torch.model.solo12 import Solo12Model
from mpctsid_tpu_torch.mpc.srb import rot_z
from mpctsid_tpu_torch.plan import kernels
from mpctsid_tpu_torch.plan.gait import contacts_horizon, swing_tables
from mpctsid_tpu_torch.utils import device_constant


def raibert_touchdown(model: Solo12Model, cascade: CascadeConfig,
                      p_com, yaw, v, v_ref_world, wz_ref, t_stance):
    """(B, 4, 3) world touchdown targets for all four legs at once.

    p_com (B, 3), yaw (B,), v (B, 3) measured world velocity, v_ref_world
    (B, 3), wz_ref (B,), t_stance (B, 4)."""
    sh = device_constant(("shoulder_offsets", model),
                         lambda: model.shoulder_offsets,
                         p_com.device, p_com.dtype)              # (4, 3)
    shoulder = p_com[:, None] + torch.einsum("bij,fj->bfi", rot_z(yaw), sh)
    p = shoulder[..., 0:2]
    p = p + cascade.t_stance_factor * t_stance[..., None] * v[:, None, 0:2]
    p = p + cascade.k_raibert * (v[:, 0:2] - v_ref_world[:, 0:2])[:, None]
    h = torch.clamp_min(p_com[:, 2], 1e-3)
    cf = 0.5 * torch.sqrt(h / model.g)
    p = p + (cf[:, None] * torch.stack([v[:, 1] * wz_ref,
                                        -v[:, 0] * wz_ref], dim=-1))[:, None]
    return torch.cat([p, torch.zeros_like(p[..., :1])], dim=-1)


def plan_footsteps_horizon(model: Solo12Model, mpc: MpcConfig,
                           cascade: CascadeConfig,
                           gait_id, phase, x, v_cmd, current_feet):
    """(feet (B, N, 4, 3), next_touchdown (B, 4, 3)).

    gait_id, phase (B,) ints; x (B, 12) SRB state; v_cmd (B, 3);
    current_feet (B, 4, 3) world foot positions.

    CUDA tensors: one launch of the kernel `plan_footsteps` (float32 or
    float64), or an exception.  CPU tensors: the plain version,
    `plan_footsteps_horizon_reference`."""
    kernels.require_dtype("x", x)
    if x.device.type == "cpu":
        return plan_footsteps_horizon_reference(
            model, mpc, cascade, gait_id, phase, x, v_cmd, current_feet)
    out = kernels.launch("footsteps", run_footsteps, x.device, model, mpc,
                         cascade, gait_id, phase, x, v_cmd, current_feet)
    plan_footsteps_horizon.launches += 1
    return out


plan_footsteps_horizon.launches = 0


def _int_rows(name: str, t, B: int, like):
    """(int32 rows, stride) of a (B,) or (1,) integer tensor."""
    if not isinstance(t, torch.Tensor) or t.dtype.is_floating_point or \
            t.dtype == torch.bool:
        raise TypeError(f"{name} must be an integer tensor, got "
                        f"{getattr(t, 'dtype', type(t))}")
    return kernels.rows(name, t.to(torch.int32), B, (1,), like, torch.int32)


def run_footsteps(launch_fn, model: Solo12Model, mpc: MpcConfig,
                  cascade: CascadeConfig, gait_id, phase, x, v_cmd,
                  current_feet):
    """(rc, (feet, next_td)): the footstep kernel's operands packed for
    `launch_fn` (plan/kernels.py's signature less the stream: the CUDA
    library's, or the CPU tests' host build of planner.h), its outputs
    allocated here.  Gait ids must lie in [0, 5): the kernel reads its
    table without a check."""
    B = x.shape[0]
    N = mpc.horizon
    ins = [_int_rows("gait_id", gait_id, B, x),
           _int_rows("phase", phase, B, x),
           kernels.rows("x", x, B, (12,), x),
           kernels.rows("v_cmd", v_cmd, B, (3,), x),
           kernels.rows("current_feet", current_feet, B, (4, 3), x)]
    feet = x.new_empty((B, N, 4, 3))
    td = x.new_empty((B, 4, 3))
    par = [mpc.dt, model.h_ref, model.g, cascade.t_stance_factor,
           cascade.k_raibert, *kernels.rotation_forms(x.dtype, B),
           *np.asarray(model.shoulder_offsets).ravel()]
    rc = kernels.call(launch_fn, x.dtype, B, N, kernels.gait_tables(x.device),
                      ins, [feet, td], par)
    return rc, (feet, td)


def plan_footsteps_horizon_reference(model: Solo12Model, mpc: MpcConfig,
                                     cascade: CascadeConfig, gait_id, phase,
                                     x, v_cmd, current_feet):
    """Plain version of `plan_footsteps_horizon` (any device and dtype)."""
    N = mpc.horizon
    dtype = x.dtype
    B = x.shape[0]
    cont = contacts_horizon(gait_id, phase, N + 1, dtype)        # (B, N+1, 4)
    _, _, _, stance_steps = swing_tables(gait_id, phase, dtype)
    t_stance = stance_steps * mpc.dt

    p0, yaw0, v = x[:, 0:3], x[:, 5], x[:, 6:9]
    xy_mask = device_constant("xy_mask", lambda: [1.0, 1.0, 0.0],
                              x.device, dtype)
    work = current_feet * xy_mask
    next_td = work
    found = torch.zeros((B, 4), dtype=torch.bool, device=x.device)
    h_ref = x.new_full((B,), model.h_ref)
    zero = torch.zeros_like(v_cmd[:, 2])
    feet = []
    prev = cont[:, 0]
    for k in range(N):
        yaw_k = yaw0 + v_cmd[:, 2] * mpc.dt * k
        v_body = torch.stack([v_cmd[:, 0], v_cmd[:, 1], zero], dim=-1)
        v_ref_world = torch.bmm(rot_z(yaw_k), v_body[:, :, None])[:, :, 0]
        p_k = torch.stack([p0[:, 0] + v[:, 0] * mpc.dt * k,
                           p0[:, 1] + v[:, 1] * mpc.dt * k,
                           h_ref], dim=-1)
        td = raibert_touchdown(model, cascade, p_k, yaw_k, v,
                               v_ref_world, v_cmd[:, 2], t_stance)
        trans = (cont[:, k] > 0.5) & (prev < 0.5)  # swing -> stance at step k
        work = torch.where(trans[..., None], td, work)
        next_td = torch.where((trans & ~found)[..., None], td, next_td)
        found = found | trans
        feet.append(work)
        prev = cont[:, k]
    return torch.stack(feet, dim=1), next_td
