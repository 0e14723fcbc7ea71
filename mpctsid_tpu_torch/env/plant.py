"""Batched plant: whole-body dynamics + penalty ground contacts (counterpart
of the JAX package's env/plant.py, batch written out).

Implicit-damping contact integration:

    (M + h J' D J) v+ = M v + h (tau_gen - bias + J' f_elastic)

then Coulomb-cone / unilateral clamping with anchor dragging, recomputing the
velocity explicitly with the (bounded) clamped forces where clamping
occurred.  All contact switching is masked arithmetic, per scenario: the
`any_cl` switch reduces over a scenario's own feet only.  Per-scenario
friction / contact parameters are data, enabling mu/load perturbation
batches.
"""

from __future__ import annotations

import dataclasses

import torch

from mpctsid_tpu_torch import dyn
from mpctsid_tpu_torch.model.tree import NV, KinematicTree
from mpctsid_tpu_torch.qp.blockinv import spd_inverse
from mpctsid_tpu_torch.utils import resolve_device


@dataclasses.dataclass
class ContactParams:
    kp_n: torch.Tensor    # (B,) normal spring
    kd_n: torch.Tensor    # (B,) normal damper
    kp_t: torch.Tensor    # (B,) tangential anchor spring
    kd_t: torch.Tensor    # (B,) tangential damper
    mu: torch.Tensor      # (B,) friction coefficient

    @staticmethod
    def default(batch: int = 1, device="cuda",
                dtype=torch.float32) -> "ContactParams":
        dev = resolve_device(device)
        f = lambda val: torch.full((batch,), val, dtype=dtype, device=dev)  # noqa: E731
        return ContactParams(kp_n=f(8000.0), kd_n=f(100.0),
                             kp_t=f(2000.0), kd_t=f(30.0), mu=f(0.7))


@dataclasses.dataclass
class PlantState:
    q: torch.Tensor           # (B, 19)
    v: torch.Tensor           # (B, 18)
    anchor: torch.Tensor      # (B, 4, 2)
    in_contact: torch.Tensor  # (B, 4) float {0, 1}

    @staticmethod
    def init(q, v=None, device="cuda", dtype=torch.float32) -> "PlantState":
        """State at rest (or at v) for configurations q (B, 19), numpy or
        tensor, placed on `device`."""
        dev = resolve_device(device)
        q = torch.as_tensor(q, dtype=dtype).to(dev)
        B = q.shape[0]
        v = (q.new_zeros((B, NV)) if v is None
             else torch.as_tensor(v, dtype=dtype).to(dev))
        return PlantState(q=q, v=v, anchor=q.new_zeros((B, 4, 2)),
                          in_contact=q.new_zeros((B, 4)))


def _substep(tree: KinematicTree, st: PlantState, tau, h_dt, p: ContactParams,
             extra_base_inertia=None):
    q, v = st.q, st.v
    B = q.shape[0]
    M = dyn.crba(tree, q, extra_base_inertia=extra_base_inertia)
    bias = dyn.rnea(tree, q, v, q.new_zeros((B, NV)),
                    extra_base_inertia=extra_base_inertia)
    feet = dyn.foot_positions(tree, q)      # (B, 4, 3)
    J = dyn.foot_jacobians(tree, q)         # (B, 4, 3, 18)
    Jm = J.reshape(B, 12, NV)

    below = feet[..., 2] < 0.0
    new_contact = below & (st.in_contact < 0.5)
    anchor = torch.where(new_contact[..., None], feet[..., 0:2], st.anchor)
    in_c = below.to(q.dtype)

    kp_t = p.kp_t[:, None, None]
    kd_t = p.kd_t[:, None, None]
    # elastic forces (world): anchored tangential spring + normal spring
    f_el = torch.cat([
        -kp_t * (feet[..., 0:2] - anchor),
        (-p.kp_n[:, None] * feet[..., 2])[..., None],
    ], dim=-1) * in_c[..., None]

    d_vec = torch.stack([p.kd_t, p.kd_t, p.kd_n], dim=-1)   # diag of D, (B, 3)
    tau_gen = torch.cat([q.new_zeros((B, 6)), tau], dim=-1)

    # implicit damping: M_eff = M + h * sum_active J' D J
    Jw = (J * (d_vec[:, None, :, None] * in_c[:, :, None, None])
          ).reshape(B, 12, NV)
    JDJ = torch.bmm(Jm.transpose(1, 2), Jw)
    M_eff = M + h_dt * JDJ
    Mv = torch.bmm(M, v[:, :, None])[:, :, 0]

    def gen_force(f):
        """J' f for foot forces f (B, 4, 3)."""
        return torch.bmm(f.reshape(B, 1, 12), Jm)[:, 0]

    rhs = Mv + h_dt * (tau_gen - bias + gen_force(f_el))
    # M and M_eff are SPD with cond ~ 1e2: the blocked Schur inverse
    # (qp/blockinv.py) is exact to ~cond * eps_f32 here
    M_inv = spd_inverse(M)
    v_imp = torch.bmm(spd_inverse(M_eff), rhs[:, :, None])[:, :, 0]

    # contact forces at the implicit velocity, then clamp
    foot_vel = torch.bmm(Jm, v_imp[:, :, None]).reshape(B, 4, 3)
    f_raw = f_el - d_vec[:, None, :] * foot_vel * in_c[..., None]
    fz = torch.clamp_min(f_raw[..., 2], 0.0)
    ft = f_raw[..., 0:2]
    limit = p.mu[:, None] * fz
    ft_norm = torch.linalg.vector_norm(ft, dim=-1)
    scale = torch.where(ft_norm > limit,
                        limit / torch.clamp_min(ft_norm, 1e-12),
                        torch.ones_like(limit))
    ft_cl = ft * scale[..., None]
    clamped = (ft_norm > limit) | (f_raw[..., 2] < 0.0)
    # drag anchors for sliding feet so the spring sits on the cone
    slid = (ft_norm > limit) & (in_c > 0.5)
    anchor = torch.where(
        slid[..., None],
        feet[..., 0:2] + (ft_cl + kd_t * foot_vel[..., 0:2]) / kp_t,
        anchor)
    f_cl = torch.cat([ft_cl, fz[..., None]], dim=-1) * in_c[..., None]

    # explicit recomputation with clamped (bounded) forces where clamping hit
    rhs_cl = Mv + h_dt * (tau_gen - bias + gen_force(f_cl))
    v_exp = torch.bmm(M_inv, rhs_cl[:, :, None])[:, :, 0]
    any_cl = (clamped & (in_c > 0.5)).any(dim=-1, keepdim=True)   # (B, 1)
    v_new = torch.where(any_cl, v_exp, v_imp)

    q_new = dyn.integrate_q(q, v_new, h_dt)
    return PlantState(q=q_new, v=v_new, anchor=anchor, in_contact=in_c), f_cl


def plant_step(tree: KinematicTree, st: PlantState, tau,
               dt: float = 0.001, substeps: int = 2,
               params: ContactParams | None = None,
               extra_base_inertia=None):
    """One 1 kHz plant step under joint torques tau (B, 12).

    extra_base_inertia: optional (B, 6, 6) base spatial-inertia addend: the
    TRUE payload carried by the plant in load-perturbation batches.

    Returns (new_state, ground_forces (B, 4, 3) from the last substep)."""
    if params is None:
        params = ContactParams.default(st.q.shape[0], device=st.q.device,
                                       dtype=st.q.dtype)
    h_dt = dt / substeps
    f = st.q.new_zeros((st.q.shape[0], 4, 3))
    for _ in range(substeps):
        st, f = _substep(tree, st, tau, h_dt, params,
                         extra_base_inertia=extra_base_inertia)
    return st, f
