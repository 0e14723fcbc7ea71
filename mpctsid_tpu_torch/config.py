"""Config tree for the whole engine (SURVEY.md §5.6).

Plain frozen dataclasses; every BASELINE.json config (lines 7-11) is a named preset in
``PRESETS``.  All timing, weighting, solver and batching knobs live here.

This is the PyTorch port's own copy (numpy only): the port imports nothing
from the JAX package, and tests/test_torch_imports.py holds every preset equal
to the JAX package's field by field.  That is also why the backend names keep
their original spelling: ``"xla"`` names the plain tensor path (``"torch"``
here) and ``"auto_mpc"`` the MPC-stage default (the hand-written M2 kernel on
a CUDA device, the plain path on the CPU); see qp/admm.py.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class MpcConfig:
    """Centroidal MPC problem definition (BASELINE.json:5,7).

    State x = [p(3), rpy(3), v(3), omega_world(3)] in R^12; input u = stacked
    ground-reaction forces f in R^12 (4 feet x 3).  Horizon 16 at dt = 20 ms."""

    horizon: int = 16
    dt: float = 0.02
    # state-tracking weights, diag(Q):  p, rpy, v, omega
    w_pos: Tuple[float, float, float] = (2.0, 2.0, 40.0)
    w_rpy: Tuple[float, float, float] = (15.0, 15.0, 2.0)
    w_vel: Tuple[float, float, float] = (4.0, 4.0, 8.0)
    w_omega: Tuple[float, float, float] = (0.3, 0.3, 0.6)
    # diag(R) force regularization.  1e-2 (not the family-typical 1e-4..1e-5)
    # is a deliberate conditioning choice: it bounds the QP's flat directions
    # so the f32 fixed-iteration device solver reaches <1e-4 force parity in
    # ~100 iterations (see qp/admm.py); behavior impact is negligible.
    w_force: float = 1e-2
    # controller-side friction margin: plant/real mu is ~0.7, planning with 0.5
    # keeps commanded forces strictly inside the true cone (no chronic slip)
    mu: float = 0.5
    fz_min: float = 0.2
    fz_max: float = 25.0

    @property
    def q_diag(self) -> np.ndarray:
        return np.array(self.w_pos + self.w_rpy + self.w_vel + self.w_omega)


@dataclasses.dataclass(frozen=True)
class WbcConfig:
    """TSID-style whole-body inverse-dynamics QP weights (SURVEY.md §2.1 "TSID WBC")."""

    w_foot: float = 1000.0         # swing-foot acceleration task
    # force tracking must dominate posture: stance-leg joint accelerations are
    # fully determined by the contact constraint + base motion, so any posture
    # weight there directly fights the MPC force plan (see oracle/wbc.py).
    w_force: float = 50.0          # contact-force tracking of the MPC plan
    w_posture: float = 0.05        # joint posture regularizer
    w_base: float = 10.0           # base orientation/height task
    kp_foot: float = 400.0
    kd_foot: float = 40.0
    kp_posture: float = 36.0
    kd_posture: float = 6.0
    kp_base: float = 100.0
    kd_base: float = 20.0
    mu: float = 0.5
    tau_max: float = 2.7
    fz_min: float = 0.0
    fz_max: float = 30.0


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """ADMM solver knobs (OSQP-faithful splitting; SURVEY.md §2.1 native table)."""

    rho: float = 0.1
    sigma: float = 1e-6
    alpha: float = 1.6             # over-relaxation
    # In-cascade solver budgets (fixed trip counts; SURVEY.md §7.3).  The
    # MPC runs 60 iterations in 2 adapt rounds: one refactorization with an
    # adapted rho is what brings the dual residual down.  The WBC runs 40
    # iterations in 3 adapt rounds; its third refactorization is load-bearing
    # for the walk gait (2 rounds stall its forward progress at any iteration
    # count), so budget cuts are judged on the gait sweep, never on trot
    # alone.  Parity-tier solves pass their own higher budgets explicitly.
    mpc_iters: int = 60
    mpc_adapt_rounds: int = 2
    wbc_iters: int = 40
    wbc_adapt_rounds: int = 3
    # QP backends (qp/admm.py): "auto_mpc" resolves to the M2 iteration
    # kernel on a CUDA device (valid for the inequality-only MPC QP; its K^-1
    # on the SPD-inverse kernel) and to the plain tensor path on the CPU;
    # "xla" (alias "torch") is the plain path's function.  The WBC's
    # equality-row rho boost puts it outside the M2 kernel's validity domain;
    # on a CUDA device its default float32 solve is one launch of a
    # hand-written kernel computing the plain path's function
    # (wbc/tsid.py::_solve_tick), the plain path itself on the CPU.
    mpc_backend: str = "auto_mpc"
    wbc_backend: str = "xla"
    eps_abs: float = 1e-8          # oracle convergence tolerance (CPU only)
    eps_rel: float = 1e-8
    max_iters_oracle: int = 4000
    polish: bool = True            # oracle: active-set KKT polish after ADMM


@dataclasses.dataclass(frozen=True)
class CascadeConfig:
    """Cadence of the cascade: 1 kHz WBC / 50 Hz MPC (BASELINE.json:10)."""

    wbc_dt: float = 0.001
    mpc_every: int = 20            # WBC ticks per MPC solve
    swing_height: float = 0.05     # swing apex (SURVEY.md §2.1 swing generator)
    k_raibert: float = 0.03        # feedback gain on (v - v_ref)
    t_stance_factor: float = 0.5   # T_stance/2 velocity feed-forward
    # offset-free velocity tracking: the penalty plant drags the trot below
    # the commanded speed.  The cascade integrates the body-frame velocity
    # error once per MPC period and biases the command fed to the reference
    # rollout + footstep planner (the classic offset-free-MPC disturbance
    # integrator).  ki_vint is 1/s; the clamp bounds windup (and the bias
    # itself) to v_int_max m/s.
    ki_vint: float = 3.0
    v_int_max: float = 0.2


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    mpc: MpcConfig = MpcConfig()
    wbc: WbcConfig = WbcConfig()
    solver: SolverConfig = SolverConfig()
    cascade: CascadeConfig = CascadeConfig()
    gait: str = "trot"
    batch: int = 1
    v_ref: Tuple[float, float, float] = (0.3, 0.0, 0.0)  # vx, vy, wz command


# --- named WBC parity tier (BASELINE.json:5 "per-solve control error < 1e-4") --------
#
# The WBC stage's 1e-4-of-tau_max tier (budget 2.7e-4 Nm) runs the same
# admm_solve algorithm with this budget in a float64 island: float64 QPs,
# backend "torch", warm-started, with the active-set KKT polish
# (solve_wbc(polish=True) / admm_solve(polish_kkt=True)).  It exists to show
# the contract number; the cascade runs float32.
WBC_PARITY_SOLVER = SolverConfig(wbc_iters=150, wbc_adapt_rounds=3)


# --- named presets, one per BASELINE.json config line --------------------------------

PRESETS = {
    # BASELINE.json:7 — single-rollout flat-ground trot vs CPU reference
    "config1_trot_single": EngineConfig(batch=1, gait="trot"),
    # BASELINE.json:8 — gait sweep, 256 batched MPC QPs
    "config2_gait_sweep": EngineConfig(batch=256, gait="trot"),
    # BASELINE.json:9 — mu/load perturbation batches with warm starts
    "config3_robustness": EngineConfig(batch=256, gait="trot"),
    # BASELINE.json:10 — full cascade, 4k scenario rollouts, one host
    "config4_cascade_4k": EngineConfig(batch=4096, gait="trot"),
    # BASELINE.json:11 — multi-host Monte-Carlo, 32k+ scenarios
    "config5_multihost_32k": EngineConfig(batch=32768, gait="trot"),
}
