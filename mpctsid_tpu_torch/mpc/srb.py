"""Centroidal MPC: batched SRB discretization, condensation, QP assembly
(counterpart of the JAX package's mpc/srb.py, batch written out).

12-state single rigid body, horizon 16, dt 20 ms, friction pyramid + force
bounds, swing forces pinned to zero by a ridge.  The horizon recursion
(condensation) is a Python loop over the N = 16 steps, each step one batched
(B, 12, 12) @ (B, 12, 12 N) product.

State x = [p(3), rpy(3), v(3), w_world(3)]; input u = 4 stacked forces (12,).
Every argument carries a leading scenario axis.
"""

from __future__ import annotations

import numpy as np
import torch

from mpctsid_tpu_torch.config import MpcConfig
from mpctsid_tpu_torch.model.solo12 import Solo12Model
from mpctsid_tpu_torch.qp.admm import INF, admm_solve
from mpctsid_tpu_torch.qp.blockinv import inv3
from mpctsid_tpu_torch.utils import device_constant

NX = 12
NU = 12
N_FEET = 4
ROWS_PER_FOOT = 5


def rot_z(yaw):
    """(...,) yaw angles -> (..., 3, 3) rotations about +z."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    z = torch.zeros_like(yaw)
    o = torch.ones_like(yaw)
    return torch.stack([
        torch.stack([c, -s, z], -1),
        torch.stack([s, c, z], -1),
        torch.stack([z, z, o], -1),
    ], -2)


def _skew(r):
    z = torch.zeros_like(r[..., 0])
    return torch.stack([
        torch.stack([z, -r[..., 2], r[..., 1]], -1),
        torch.stack([r[..., 2], z, -r[..., 0]], -1),
        torch.stack([-r[..., 1], r[..., 0], z], -1),
    ], -2)


def reference_rollout(model: Solo12Model, cfg: MpcConfig, x0, v_cmd):
    """(B, N, 12) reference states x_1..x_N from the commanded velocity.

    x0 (B, 12), v_cmd (B, 3) body-frame [vx, vy, wz].

    CUDA tensors: one launch of the hand-written kernel `plan_rollout`
    (plan/csrc/planner.cu: a thread per scenario; float32 or float64), or an
    exception.  CPU tensors: the plain version, `reference_rollout_reference`
    (about 276 kernels a call on the card)."""
    from mpctsid_tpu_torch.plan import kernels

    kernels.require_dtype("x0", x0)
    if x0.device.type == "cpu":
        return reference_rollout_reference(model, cfg, x0, v_cmd)
    out = kernels.launch("rollout", run_rollout, x0.device, model, cfg, x0,
                         v_cmd)
    reference_rollout.launches += 1
    return out


reference_rollout.launches = 0


def run_rollout(launch_fn, model: Solo12Model, cfg: MpcConfig, x0, v_cmd):
    """(rc, x_ref): the rollout kernel's operands packed for `launch_fn`
    (plan/kernels.py's signature less the stream), its output allocated
    here."""
    from mpctsid_tpu_torch.plan import kernels

    B, N = x0.shape[0], cfg.horizon
    ins = [kernels.rows("x0", x0, B, (12,), x0),
           kernels.rows("v_cmd", v_cmd, B, (3,), x0)]
    out = x0.new_empty((B, N, NX))
    rc = kernels.call(launch_fn, x0.dtype, B, N, None, ins, [out],
                      [cfg.dt, model.h_ref,
                       kernels.rotation_forms(x0.dtype, B)[0]])
    return rc, out


def reference_rollout_reference(model: Solo12Model, cfg: MpcConfig, x0,
                                v_cmd):
    """Plain version of `reference_rollout` (any device and dtype)."""
    N = cfg.horizon
    dt = cfg.dt
    p, yaw = x0[:, 0:3], x0[:, 5]
    zero = torch.zeros_like(yaw)
    h_ref = torch.full_like(yaw, model.h_ref)
    v_body = torch.stack([v_cmd[:, 0], v_cmd[:, 1], zero], dim=-1)
    xs = []
    for _ in range(N):
        v_world = torch.bmm(rot_z(yaw), v_body[:, :, None])[:, :, 0]
        p = p + dt * v_world
        yaw = yaw + dt * v_cmd[:, 2]
        xs.append(torch.cat([
            torch.stack([p[:, 0], p[:, 1], h_ref], dim=-1),
            torch.stack([zero, zero, yaw], dim=-1),
            v_world,
            torch.stack([zero, zero, v_cmd[:, 2]], dim=-1),
        ], dim=-1))
    return torch.stack(xs, dim=1)


def srb_discrete(model: Solo12Model, cfg: MpcConfig, yaw, feet, p_ref,
                 total_mass=None):
    """One-step Euler (A (..., 12, 12), B (..., 12, 12), c (..., 12)).

    yaw (...,), feet (..., 4, 3), p_ref (..., 3) share their leading axes.
    total_mass: optional tensor broadcastable to yaw's shape, overriding
    model.total_mass (the SRB-model side of a payload perturbation)."""
    dt = cfg.dt
    dtype = feet.dtype
    dev = feet.device
    lead = yaw.shape
    Rz = rot_z(yaw)
    I_b = device_constant(("srb_inertia", model), lambda: model.srb_inertia,
                          dev, dtype)
    I_w = Rz @ I_b @ Rz.transpose(-1, -2)
    # closed form: batched linalg.inv on CUDA checks `info` on the host
    I_w_inv = inv3(I_w)

    eye3 = torch.eye(3, dtype=dtype, device=dev)
    A = torch.eye(NX, dtype=dtype, device=dev).expand(lead + (NX, NX)).clone()
    A[..., 0:3, 6:9] = dt * eye3
    A[..., 3:6, 9:12] = dt * Rz.transpose(-1, -2)

    r = feet - p_ref[..., None, :]                               # (..., 4, 3)
    Bw = dt * (I_w_inv[..., None, :, :] @ _skew(r))              # (..., 4, 3, 3)
    if total_mass is None:
        Bv = (dt / model.total_mass) * eye3                      # (3, 3)
    else:
        Bv = (dt / total_mass.to(dtype))[..., None, None] * eye3  # (..., 3, 3)
    B = feet.new_zeros(lead + (NX, NU))
    for i in range(N_FEET):
        B[..., 6:9, 3 * i:3 * i + 3] = Bv
    # columns [3i, 3i+3) of rows 9:12 hold Bw[i]
    B[..., 9:12, :] = Bw.transpose(-3, -2).reshape(lead + (3, NU))

    c = feet.new_zeros(lead + (NX,))
    c[..., 8] = -dt * model.g
    return A, B, c


def _pyramid(mu: float) -> np.ndarray:
    return np.array([[1.0, 0.0, -mu], [1.0, 0.0, mu],
                     [0.0, 1.0, -mu], [0.0, 1.0, mu],
                     [0.0, 0.0, 1.0]])


def _constraint_matrix(N: int, mu: float) -> np.ndarray:
    """Block-diagonal 5x3 pyramid per (step, foot): a constant matrix."""
    A_np = np.zeros((N * N_FEET * ROWS_PER_FOOT, N * NU))
    C_np = _pyramid(mu)
    for kf in range(N * N_FEET):
        A_np[kf * ROWS_PER_FOOT:(kf + 1) * ROWS_PER_FOOT,
             kf * 3:(kf + 1) * 3] = C_np
    return A_np


def build_mpc_qp(model: Solo12Model, cfg: MpcConfig, x0, x_ref, feet, contacts,
                 total_mass=None):
    """Condensed MPC QP (P, q, A, l, u) over U in R^{12N}, per scenario.

    x0 (B, 12), x_ref (B, N, 12), feet (B, N, 4, 3), contacts (B, N, 4) in
    {0, 1}; total_mass: optional (B,) per-scenario mass (payload).
    Returns P (B, 12N, 12N), q (B, 12N), A (B, 20N, 12N), l, u (B, 20N).  A
    is the same constant for every scenario and comes back as a stride-0
    view; do not write into it."""
    N = cfg.horizon
    dtype = x0.dtype
    dev = x0.device
    Bsz = x0.shape[0]

    # all N one-step models in one batched op over the (B, N) axes
    A_ks, B_ks, c_ks = srb_discrete(
        model, cfg, x_ref[..., 5], feet, x_ref[..., 0:3],
        total_mass=None if total_mass is None else total_mass[:, None])

    # condensation over the horizon: each step is ONE row-level product
    # (12, 12) @ (12, 12N), 16 batched ops in all
    Sx_p = torch.eye(NX, dtype=dtype, device=dev).expand(Bsz, NX, NX)
    Sc_p = x0.new_zeros((Bsz, NX))
    Su_p = x0.new_zeros((Bsz, NX, N * NU))
    Sx_r, Sc_r, Su_r = [], [], []
    for k in range(N):
        A_k = A_ks[:, k]
        Sx_p = torch.bmm(A_k, Sx_p)
        Sc_p = torch.bmm(A_k, Sc_p[:, :, None])[:, :, 0] + c_ks[:, k]
        Su_p = torch.bmm(A_k, Su_p)
        Su_p[:, :, k * NU:(k + 1) * NU] = B_ks[:, k]
        Sx_r.append(Sx_p)
        Sc_r.append(Sc_p)
        Su_r.append(Su_p)
    Su = torch.stack(Su_r, dim=1).reshape(Bsz, N * NX, N * NU)
    Sx = torch.stack(Sx_r, dim=1).reshape(Bsz, N * NX, NX)
    Sc = torch.stack(Sc_r, dim=1).reshape(Bsz, N * NX)

    q_diag = device_constant(("mpc_q_diag", cfg, N),
                             lambda: np.tile(cfg.q_diag, N), dev, dtype)
    P = torch.bmm(Su.transpose(1, 2), q_diag[:, None] * Su)   # + w_force I below
    drift = (torch.bmm(Sx, x0[:, :, None])[:, :, 0] + Sc
             - x_ref.reshape(Bsz, -1))
    q = torch.bmm((q_diag * drift)[:, None, :], Su)[:, 0]

    # Swing-foot forces are pinned by a large ridge instead of l = u = 0
    # constraint rows: the row formulation makes the active set rank-
    # deficient at mu*fz = 0 (5 rows, rank 3).  The ridge shifts the solution
    # by O(|q| / w_pin) ~ 1e-6 N.
    w_pin = 1e6
    cvec = contacts.reshape(Bsz, -1)                             # (B, N*4)
    pin = w_pin * (1.0 - cvec.repeat_interleave(3, dim=-1))
    P_diag = P.diagonal(dim1=-2, dim2=-1)
    P_diag.add_(cfg.w_force)
    P_diag.add_(pin.to(dtype))

    # constraints: the constant block-diagonal pyramid matrix
    A_c = device_constant(("mpc_A", N, cfg.mu),
                          lambda: _constraint_matrix(N, cfg.mu), dev, dtype)
    A_c = A_c.expand(Bsz, -1, -1)
    # bounds: stance feet get the pyramid/box rows; swing feet rows are FREE
    # (their forces are pinned by the ridge above, keeping every possible
    # active set full-rank)
    stance = cvec > 0.5
    ninf = torch.full_like(cvec, -INF)
    pinf = torch.full_like(cvec, INF)
    zero = torch.zeros_like(cvec)
    l_blk = torch.stack([
        ninf,
        torch.where(stance, zero, ninf),
        ninf,
        torch.where(stance, zero, ninf),
        torch.where(stance, torch.full_like(cvec, cfg.fz_min), ninf),
    ], dim=-1).reshape(Bsz, -1)
    u_blk = torch.stack([
        torch.where(stance, zero, pinf),
        pinf,
        torch.where(stance, zero, pinf),
        pinf,
        torch.where(stance, torch.full_like(cvec, cfg.fz_max), pinf),
    ], dim=-1).reshape(Bsz, -1)
    return P, q, A_c, l_blk, u_blk


def solve_mpc_batch(model: Solo12Model, cfg: MpcConfig, x0, x_ref, feet,
                    contacts, warm_x=None, warm_y=None, iters: int = 200):
    """Batched MPC solve: build the QPs of every scenario and solve them with
    `admm_solve(iters=iters)` (the JAX function's budget and defaults: one
    adapt round, the plain backend), warm-started from zeros unless
    `warm_x` (B, 12 N) / `warm_y` (B, 20 N) are given.

    Returns (forces (B, N, 4, 3), QPSolution)."""
    P, q, A, l, u = build_mpc_qp(model, cfg, x0, x_ref, feet, contacts)
    Bsz = x0.shape[0]
    if warm_x is None:
        warm_x = x0.new_zeros((Bsz, cfg.horizon * NU))
    if warm_y is None:
        warm_y = x0.new_zeros((Bsz, cfg.horizon * N_FEET * ROWS_PER_FOOT))
    sol = admm_solve(P, q, A, l, u, x0=warm_x, y0=warm_y, iters=iters)
    forces = sol.x.reshape(Bsz, cfg.horizon, N_FEET, 3)
    return forces, sol


# The budget of `solve_mpc_contract`: 100 iterations in 4 rounds, then two
# rounds of the KKT polish.  Over 512 problems of four gaits on an H100 it
# lies at most 3.1e-5 from the oracle's solve_mpc (chip_smoke.py phase 11a).
CONTRACT_BUDGET = dict(iters=100, adapt_rounds=4, rho=0.1, polish_kkt=True)


def solve_mpc_contract(model: Solo12Model, cfg: MpcConfig, x0, x_ref, feet,
                       contacts, backend: str = "torch"):
    """The MPC tier held to the float64 oracle within the contract's 1e-4:
    the QP condensed in float64 from the inputs, rounded once to float32,
    and solved in float32 with CONTRACT_BUDGET on `backend` ("torch" or a
    kernel backend of `admm_solve`), from zeros.

    The float64 condensation is what the bar needs: the float32 one moves
    the optimum by up to 1.3e-4 on its own (the same float32 QP solved in
    float64 lies 1.4e-4 from the oracle; tests/test_torch_oracle_parity.py).

    Returns (forces (B, N, 4, 3) float32, QPSolution)."""
    f64 = torch.float64
    qp = build_mpc_qp(model, cfg, x0.to(f64), x_ref.to(f64), feet.to(f64),
                      contacts.to(f64))
    sol = admm_solve(*(t.float() for t in qp), backend=backend,
                     **CONTRACT_BUDGET)
    forces = sol.x.reshape(x0.shape[0], cfg.horizon, N_FEET, 3)
    return forces, sol
