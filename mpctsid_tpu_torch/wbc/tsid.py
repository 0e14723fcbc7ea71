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

`solve_wbc_contract` is the tier held to the float64 oracle.  It drops the
ridge and zeroes the swing forces' columns of A instead: those forces then
leave every constraint, their cost 0.5 w_force f^2 (the MPC plan is zero on
a swing foot) puts their optimum at exactly 0, and the QP's optimum is the
oracle's (which pins them by l = u = 0 bounds).  The ridge alone moves the
optimal torques by up to 1e-3 Nm on a bound tick.

On CUDA tensors the QP build (the dynamics, the foot kinematics and every
cost and constraint row) is one launch of a hand-written kernel
(`wbc_build`, dyn/csrc/wbc_build.cu over the rigid-body core rbd.h); its
plain version (`build_wbc_qp_reference`) runs on CPU tensors.

The QP has equality rows (base dynamics, stance contacts), which puts it
outside the M2 kernel's validity domain: `solve_wbc` takes every backend of
qp/admm.py that keeps the explicit refinement residual and refuses the M2
ones.

The solve on the card.  The default backend ("xla", alias "torch": the plain
chain of qp/admm.py) is, for a float32, unpolished solve on CUDA tensors, ONE
launch of a hand-written kernel (`qp/kernels.py::admm_solve_plain_warp`
through `qp/admm.py::admm_solve_warp`: a warp per scenario with the plain
chain's norm-only Ruiz, K and K^-1 in registers, the register loop of
kernels 2 and 3), then the unscaling and residuals of
`_unscaled_solution`; the chain itself is that kernel's plain version and
runs on CPU tensors.  The route is taken in `_solve_tick` on what the caller
asks for, not on what fails: the polished tier (`polish=True`) and the
float64 tiers (`solve_wbc_contract`, config.WBC_PARITY_SOLVER's solves in
float64) ask for the plain chain by their arguments and get it; a float32,
unpolished CUDA solve always takes the kernel, or raises.  The kernel
backends ("vpu", "packed", "mma") invert K on the SPD-inverse kernel
(`qp/kernels.py::chol_inverse`), three launches a tick; "fused" is kernel 4.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpctsid_tpu_torch import dyn
from mpctsid_tpu_torch.config import WbcConfig
from mpctsid_tpu_torch.dyn import kernels as rbd
from mpctsid_tpu_torch.model.tree import NV, KinematicTree
from mpctsid_tpu_torch.qp.admm import (INF, _resolve_backend, admm_solve,
                                       admm_solve_warp)
from mpctsid_tpu_torch.utils import device_constant

NF = 12
NXW = NV + NF       # 30
NCW = 50            # constraint rows
KD_CONTACT = 20.0   # stance-foot drift damping
W_PIN = 1e6         # swing-force Hessian ridge (see module docstring)
WBC_EPS = 1e-6      # strict-convexity diagonal
# The budget of `solve_wbc_contract`: float64 QPs, swing forces pinned
# exactly, 1200 iterations in 3 rounds and the KKT polish.  WBC_PARITY_SOLVER's
# 150 iterations with the ridge (the JAX package's float64 tier) stay within
# 2.6e-5 Nm of the oracle on trot but lie 8e-3 / 0.11 / 0.31 Nm from it on
# walk / bound / pace ticks: the active set is not found yet.  Measured over
# the oracle cascade's first 40 ticks of each gait, warm-started tick to tick:
# 600 iterations still leave 5.6e-4 Nm on two pace ticks, 1200 iterations
# 3.0e-7 Nm at most (tests/test_torch_oracle_parity.py).
CONTRACT_ITERS = 1200
CONTRACT_ADAPT_ROUNDS = 3


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
    return _build_wbc_qp(tree, cfg, q, v, refs, extra_base_inertia,
                         exact_pin=False)


def _build_wbc_qp(tree: KinematicTree, cfg: WbcConfig, q, v, refs: WbcRefs,
                  extra_base_inertia, exact_pin: bool):
    """`build_wbc_qp`; exact_pin: the swing forces pinned as
    `solve_wbc_contract` pins them (see the module docstring)."""
    return wbc_build(tree, cfg, q, v, refs,
                     extra_base_inertia=extra_base_inertia,
                     exact_pin=exact_pin)


# ------------------------------------------------- the build kernel's wrapper

def wbc_build(tree: KinematicTree, cfg: WbcConfig, q, v, refs: WbcRefs,
              extra_base_inertia=None, exact_pin: bool = False):
    """`_build_wbc_qp`'s tuple (H, g, A, l, u, M, h_bias, JcT).

    CUDA tensors: one launch of the hand-written kernel on the current
    stream (dyn/csrc/wbc_build.cu; dyn/kernels.py launches it), or an
    exception: there is no fallback.  CPU tensors, and only because they lie
    on the CPU: `build_wbc_qp_reference`.  Either way the arguments are
    checked first.  `wbc_build.launches` counts kernel launches."""
    if q.device.type == "cpu":
        _wbc_operands(cfg, q, v, refs, extra_base_inertia, exact_pin)
        return build_wbc_qp_reference(tree, cfg, q, v, refs,
                                      extra_base_inertia, exact_pin)
    out = rbd.launch("wbc_build", run_wbc_build, q.device, tree, cfg, q, v,
                     refs, extra_base_inertia, exact_pin)
    wbc_build.launches += 1
    return out


wbc_build.launches = 0


def _wbc_operands(cfg, q, v, refs, extra_base_inertia, exact_pin):
    """(inputs, parameters) of one build in rbd.h's WbcIn / WbcPar order;
    raises unless the arguments are what the kernel takes."""
    B = rbd.check_batch(q, v)
    row = lambda n, t, *tail: rbd.rows(n, t, B, tail, q)  # noqa: E731
    ins = [row("q", q, 19), row("v", v, NV),
           row("contacts", refs.contacts, 4),
           row("f_mpc", refs.f_mpc, 4, 3),
           row("foot_pos_ref", refs.foot_pos_ref, 4, 3),
           row("foot_vel_ref", refs.foot_vel_ref, 4, 3),
           row("foot_acc_ref", refs.foot_acc_ref, 4, 3),
           row("q_posture", refs.q_posture, 12),
           row("base_rpy_ref", refs.base_rpy_ref, 2),
           row("h_ref", refs.h_ref, 1),
           (None, 0) if extra_base_inertia is None else
           row("extra_base_inertia", extra_base_inertia, 6, 6)]
    par = [cfg.w_foot, cfg.w_force, cfg.w_posture, cfg.w_base, cfg.kp_foot,
           cfg.kd_foot, cfg.kp_posture, cfg.kd_posture, cfg.kp_base,
           cfg.kd_base, cfg.mu, cfg.tau_max, cfg.fz_min, cfg.fz_max,
           KD_CONTACT, W_PIN, WBC_EPS, INF, 1.0 if exact_pin else 0.0]
    return ins, par


def run_wbc_build(launch_fn, tree, cfg, q, v, refs, extra_base_inertia=None,
                  exact_pin: bool = False):
    """The build through `launch_fn(dtype, B, consts, in, stride, out, par)
    -> rc` (the kernel's C signature less the stream; dyn/kernels.py::call);
    returns (rc, (H, g, A, l, u, M, h, JcT)), JcT the transposed view of the
    J the kernel writes, as the plain version's."""
    ins, par = _wbc_operands(cfg, q, v, refs, extra_base_inertia, exact_pin)
    B = q.shape[0]
    outs = [q.new_empty((B, NXW, NXW)), q.new_empty((B, NXW)),
            q.new_empty((B, NCW, NXW)), q.new_empty((B, NCW)),
            q.new_empty((B, NCW)), q.new_empty((B, NV, NV)),
            q.new_empty((B, NV)), q.new_empty((B, NF, NV))]
    rc = rbd.call(launch_fn, tree, q, ins, outs, par)
    H, g, A, l, u, M, h, J = outs
    return rc, (H, g, A, l, u, M, h, J.transpose(1, 2))


# ---------------------------------------------------------- the plain version

def build_wbc_qp_reference(tree: KinematicTree, cfg: WbcConfig, q, v,
                           refs: WbcRefs, extra_base_inertia=None,
                           exact_pin: bool = False):
    """Plain PyTorch version of `wbc_build`."""
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
    H_diag[:, :NV] += WBC_EPS
    ridge = W_PIN * (1.0 - c).repeat_interleave(3, dim=-1)
    H_diag[:, NV:] += WBC_EPS + (0.0 if exact_pin else ridge)

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
    if exact_pin:
        in_cols = torch.cat([q.new_ones((B, NV)), crep], dim=1)
        A_c = A_c * in_cols[:, None, :]
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
    qp = build_wbc_qp(tree, cfg, q, v, refs,
                      extra_base_inertia=extra_base_inertia)
    return _solve_tick(qp, iters, adapt_rounds, warm_x, warm_y, backend,
                       polish)


def solve_wbc_contract(tree: KinematicTree, cfg: WbcConfig, q, v,
                       refs: WbcRefs, warm_x=None, warm_y=None):
    """One WBC tick of the tier held to the float64 oracle within the
    contract's 1e-4 Nm: the inputs promoted to float64, the swing forces
    pinned exactly (module docstring), CONTRACT_ITERS iterations in
    CONTRACT_ADAPT_ROUNDS rounds on the plain backend, then the KKT polish.
    Returns what `solve_wbc` returns, in float64."""
    f64 = torch.float64
    q, v = q.to(f64), v.to(f64)
    refs = WbcRefs(**{f.name: getattr(refs, f.name).to(f64)
                      for f in dataclasses.fields(refs)})
    warm_x = None if warm_x is None else warm_x.to(f64)
    warm_y = None if warm_y is None else warm_y.to(f64)
    qp = _build_wbc_qp(tree, cfg, q, v, refs, None, exact_pin=True)
    return _solve_tick(qp, CONTRACT_ITERS, CONTRACT_ADAPT_ROUNDS, warm_x,
                       warm_y, "torch", True)


def takes_solve_kernel(H, backend: str, polish: bool) -> bool:
    """Whether `_solve_tick` solves on `admm_solve_plain_warp`: the plain
    backend asked for, unpolished, float32 on a CUDA device (module
    docstring)."""
    return (not polish and H.dtype == torch.float32
            and H.device.type == "cuda"
            and _resolve_backend(backend, H.device) == "torch")


def _solve_tick(qp, iters: int, adapt_rounds: int, warm_x, warm_y,
                backend: str, polish: bool):
    """Solve one tick's QP (`build_wbc_qp`'s tuple): (tau, qdd, f, sol)."""
    H, g, A, l, u, M, h, JcT = qp
    # status_tol 0.5: a cold-started fixed-iteration WBC solve legitimately
    # sits at prim ~0.2 on the acceleration-scale constraint rows (m/s^2);
    # the failure policy should only trip on divergence/non-finite solves
    kw = dict(x0=warm_x, y0=warm_y, iters=iters, adapt_rounds=adapt_rounds,
              rho=0.1, status_tol=0.5)
    if takes_solve_kernel(H, backend, polish):
        sol = admm_solve_warp(H, g, A, l, u, **kw)
    else:
        sol = admm_solve(H, g, A, l, u, backend=backend, polish_kkt=polish,
                         **kw)
    qdd = sol.x[:, :NV]
    f = sol.x[:, NV:]
    tau = (torch.bmm(M[:, 6:], qdd[:, :, None])[:, :, 0] + h[:, 6:]
           - torch.bmm(JcT[:, 6:], f[:, :, None])[:, :, 0])
    return tau, qdd, f.reshape(-1, 4, 3), sol
