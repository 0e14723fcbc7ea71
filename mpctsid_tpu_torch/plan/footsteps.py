"""Raibert footstep planner (counterpart of the JAX package's
plan/footsteps.py, batch written out).

Touchdown target = yaw-rotated shoulder position at projected touchdown time
+ (T_stance/2) v + k (v - v_ref) + centrifugal 0.5 sqrt(h/g) (v x w).  The
per-horizon-step working-position update is a Python loop of masked batched
ops: a foot's position is replaced by a fresh Raibert target exactly at
swing->stance transitions inside the horizon.
"""

from __future__ import annotations

import torch

from mpctsid_tpu_torch.config import CascadeConfig, MpcConfig
from mpctsid_tpu_torch.model.solo12 import Solo12Model
from mpctsid_tpu_torch.mpc.srb import rot_z
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
    current_feet (B, 4, 3) world foot positions."""
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
