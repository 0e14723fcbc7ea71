"""Whole-body controller: TSID-style inverse-dynamics QP (counterpart of the
JAX package's wbc/tsid.py, batch written out).

Fully masked stance/swing switching: contact flags are DATA, not control
flow, so one tick serves every scenario of the batch.

Decision variable x = [qdd(18); f(12)] in R^30.  Two deliberate choices:
  * swing-foot forces are pinned by a 1e6 ridge instead of l = u = 0 rows:
    the degenerate tight pair (both mu sides active at mu*fz = 0) stalls the
    fixed-iteration ADMM.  The ridge keeps every constraint row regular;
    cond(H) ~ 1e7 is handled by the Jacobi pre-scaling inside
    qp/blockinv.py spd_inverse_chol.
  * the swing-foot tracking task is weight-masked (w_foot * (1 - contact))
    instead of being added/removed, keeping H's sparsity pattern static.

The QP has equality rows (base dynamics, stance contacts), which puts it
outside the M2 kernel's validity domain: `solve_wbc` takes every backend of
qp/admm.py that keeps the explicit refinement residual and refuses the M2
ones.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpctsid_tpu_torch import dyn
from mpctsid_tpu_torch.config import WbcConfig
from mpctsid_tpu_torch.model.tree import NV, KinematicTree
from mpctsid_tpu_torch.qp.admm import INF, admm_solve
from mpctsid_tpu_torch.utils import device_constant

NF = 12
NXW = NV + NF       # 30
KD_CONTACT = 20.0   # stance-foot drift damping
W_PIN = 1e6         # swing-force Hessian ridge (see module docstring)


@dataclasses.dataclass
class WbcRefs:
    contacts: torch.Tensor       # (B, 4)
    f_mpc: torch.Tensor          # (B, 4, 3)
    foot_pos_ref: torch.Tensor   # (B, 4, 3)
    foot_vel_ref: torch.Tensor   # (B, 4, 3)
    foot_acc_ref: torch.Tensor   # (B, 4, 3)
    q_posture: torch.Tensor      # (B, 12)
    base_rpy_ref: torch.Tensor   # (B, 2)
    h_ref: torch.Tensor          # (B,)


def _pyramid_rows(mu: float) -> np.ndarray:
    """(20, 30) friction-pyramid rows over the force block of x."""
    Cpyr = np.array([[1.0, 0.0, -mu], [1.0, 0.0, mu],
                     [0.0, 1.0, -mu], [0.0, 1.0, mu],
                     [0.0, 0.0, 1.0]])
    A_pyr = np.zeros((20, NXW))
    for i in range(4):
        A_pyr[5 * i:5 * i + 5, NV + 3 * i:NV + 3 * i + 3] = Cpyr
    return A_pyr


def build_wbc_qp(tree: KinematicTree, cfg: WbcConfig, q, v, refs: WbcRefs,
                 extra_base_inertia=None):
    """Returns (H, g, A, l, u, M, h_bias, JcT), each with a leading B axis.

    q (B, 19), v (B, 18).  extra_base_inertia: optional (B, 6, 6) base
    spatial-inertia addend (the WBC side of a payload perturbation)."""
    dtype = q.dtype
    dev = q.device
    B = q.shape[0]
    M = dyn.crba(tree, q, extra_base_inertia=extra_base_inertia)
    h = dyn.rnea(tree, q, v, q.new_zeros((B, NV)),
                 extra_base_inertia=extra_base_inertia)
    kin = dyn.fk(tree, q)
    feet = kin.p_foot
    J = dyn.foot_jacobians(tree, q)            # (B, 4, 3, 18)
    drift = dyn.foot_drifts(tree, q, v)        # (B, 4, 3)
    Jm = J.reshape(B, 12, NV)
    foot_vel = torch.bmm(Jm, v[:, :, None]).reshape(B, 4, 3)
    JcT = Jm.transpose(1, 2)                   # (B, 18, 12)

    rpy = dyn.rot_to_rpy(kin.R0)
    c = refs.contacts

    # ---- cost ------------------------------------------------------------
    H = q.new_zeros((B, NXW, NXW))
    g = q.new_zeros((B, NXW))

    # swing-foot tracking, weight-masked by (1 - contact); the task rows
    # J_i qdd = a_des_i - drift_i only touch the qdd block of x
    a_des = (refs.foot_acc_ref
             + cfg.kp_foot * (refs.foot_pos_ref - feet)
             + cfg.kd_foot * (refs.foot_vel_ref - foot_vel))   # (B, 4, 3)
    w_leg = cfg.w_foot * (1.0 - c)                             # (B, 4)
    b_t = (a_des - drift).reshape(B, 12)
    w_rows = w_leg.repeat_interleave(3, dim=-1)                # (B, 12)
    H[:, :NV, :NV] = torch.bmm(JcT, w_rows[:, :, None] * Jm)
    g[:, :NV] = -torch.bmm(JcT, (w_rows * b_t)[:, :, None])[:, :, 0]

    H_diag = H.diagonal(dim1=-2, dim2=-1)      # a view: writes land in H

    # force tracking
    H_diag[:, NV:] += cfg.w_force
    g[:, NV:] += -cfg.w_force * refs.f_mpc.reshape(B, NF)

    # posture
    a_post = (cfg.kp_posture * (refs.q_posture - q[:, 7:])
              - cfg.kd_posture * v[:, 6:])
    H_diag[:, 6:NV] += cfg.w_posture
    g[:, 6:NV] += -cfg.w_posture * a_post

    # base height + roll + pitch task (generalized coordinates 2, 3, 4)
    a_base = torch.stack([
        cfg.kp_base * (refs.h_ref - q[:, 2]) - cfg.kd_base * v[:, 2],
        cfg.kp_base * (refs.base_rpy_ref[:, 0] - rpy[:, 0])
        - cfg.kd_base * v[:, 3],
        cfg.kp_base * (refs.base_rpy_ref[:, 1] - rpy[:, 1])
        - cfg.kd_base * v[:, 4],
    ], dim=-1)
    H_diag[:, 2:5] += cfg.w_base
    g[:, 2:5] += -cfg.w_base * a_base

    # strict convexity + swing-force ridge
    H_diag[:, :NV] += 1e-6
    H_diag[:, NV:] += 1e-6 + W_PIN * (1.0 - c).repeat_interleave(3, dim=-1)

    # ---- constraints (50 rows) ------------------------------------------
    # base dynamics equalities (6)
    A_dyn = torch.cat([M[:, 0:6], -JcT[:, 0:6]], dim=2)
    l_dyn = u_dyn = -h[:, 0:6]
    # torque bounds (12)
    A_tau = torch.cat([M[:, 6:], -JcT[:, 6:]], dim=2)
    l_tau = -cfg.tau_max - h[:, 6:]
    u_tau = cfg.tau_max - h[:, 6:]
    # friction pyramid (20): stance-active, swing-free (the ridge above pins
    # swing forces to ~0, so degenerate tight bound pairs never enter the
    # ADMM projection)
    A_pyr = device_constant(("wbc_A_pyr", cfg.mu),
                            lambda: _pyramid_rows(cfg.mu), dev, dtype)
    A_pyr = A_pyr.expand(B, -1, -1)
    l_row = device_constant(
        ("wbc_l_pyr", cfg.fz_min),
        lambda: np.tile([-INF, 0.0, -INF, 0.0, cfg.fz_min], 4), dev, dtype)
    u_row = device_constant(
        ("wbc_u_pyr", cfg.fz_max),
        lambda: np.tile([0.0, INF, 0.0, INF, cfg.fz_max], 4), dev, dtype)
    srep = (c > 0.5).repeat_interleave(5, dim=-1)              # (B, 20)
    l_pyr = torch.where(srep, l_row, -INF)
    u_pyr = torch.where(srep, u_row, INF)
    # stance contact equalities (12): J qdd = -drift - kd v_foot; swing free
    crep = c.repeat_interleave(3, dim=-1)                      # (B, 12)
    A_con = torch.cat([Jm * crep[:, :, None],
                       q.new_zeros((B, 12, NF))], dim=2)
    b_con = (-drift - KD_CONTACT * foot_vel).reshape(B, 12)
    l_con = torch.where(crep > 0.5, b_con, -INF)
    u_con = torch.where(crep > 0.5, b_con, INF)

    A_c = torch.cat([A_dyn, A_tau, A_pyr, A_con], dim=1)
    l_c = torch.cat([l_dyn, l_tau, l_pyr, l_con], dim=1)
    u_c = torch.cat([u_dyn, u_tau, u_pyr, u_con], dim=1)
    return H, g, A_c, l_c, u_c, M, h, JcT


# backends of qp/admm.py that fold the refinement into M2: outside the WBC
# QP's domain (see solve_wbc)
_M2_BACKENDS = ("m2", "pallas_m2", "auto_mpc")


def solve_wbc(tree: KinematicTree, cfg: WbcConfig, q, v, refs: WbcRefs,
              iters: int = 60, adapt_rounds: int = 3,
              warm_x=None, warm_y=None, backend: str = "torch",
              polish: bool = False, extra_base_inertia=None):
    """One WBC tick: returns (tau (B, 12), qdd (B, 18), f (B, 4, 3),
    QPSolution).

    backend: any backend of `admm_solve` that is valid with equality rows:
    "torch" (plain), "vpu", "packed", "mma", "fused", "auto", or their JAX
    spellings ("xla", "pallas_vpu", "pallas_packed", "pallas")."""
    if backend in _M2_BACKENDS:
        raise ValueError(
            f"solve_wbc backend {backend!r}: the WBC QP has equality rows "
            "(base dynamics, stance contacts), outside the M2 kernel's "
            "domain: their 1e3 rho boost pushes cond(K) to ~1e4, where the "
            "folded map M2 loses the accuracy the explicit residual keeps; "
            "use 'torch', 'vpu', 'packed', 'mma', 'fused' or 'auto'")
    H, g, A, l, u, M, h, JcT = build_wbc_qp(
        tree, cfg, q, v, refs, extra_base_inertia=extra_base_inertia)
    # status_tol 0.5: a cold-started fixed-iteration WBC solve legitimately
    # sits at prim ~0.2 on the acceleration-scale constraint rows (m/s^2);
    # the failure policy should only trip on divergence/non-finite solves
    sol = admm_solve(H, g, A, l, u, x0=warm_x, y0=warm_y,
                     iters=iters, adapt_rounds=adapt_rounds, rho=0.1,
                     status_tol=0.5, backend=backend, polish_kkt=polish)
    qdd = sol.x[:, :NV]
    f = sol.x[:, NV:]
    tau = (torch.bmm(M[:, 6:], qdd[:, :, None])[:, :, 0] + h[:, 6:]
           - torch.bmm(JcT[:, 6:], f[:, :, None])[:, :, 0])
    return tau, qdd, f.reshape(-1, 4, 3), sol
