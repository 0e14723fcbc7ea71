"""Solo-12 robot model parameters (pure data, numpy).

The reference consumes the Solo-12 URDF from example-robot-data through Pinocchio
(SURVEY.md §2.1 "Robot model data"; the reference tree itself is unreadable, SURVEY.md §0).
No URDF exists on disk and there is no network, so the kinematic/inertial parameters
below are authored from the published open-dynamic-robot-initiative Solo-12 geometry
(hip spacing 2x0.1946 m fore-aft, 2x0.0875 m lateral, 0.16 m upper/lower leg segments)
with box/rod inertias for each body.  Total mass lands in the documented ~2.5 kg class
(SURVEY.md §7.3).  Every consumer (the dynamics in dyn/, the planners, the plant) is
generated from THIS file, so parity tests are well-defined regardless of how close these
numbers are to the physical robot.

Kinematic tree (18 DoF = free-flyer (6) + 4 legs x 3 revolute joints):

  base (free-flyer)
   └─ per leg i in (FL, FR, HL, HR):
      HAA_i  revolute about +x, at base frame offset ``hip_offsets[i]``
      HFE_i  revolute about +y, at (0, ±hfe_y, 0) from HAA frame
      KFE_i  revolute about +y, at (0, 0, -l_upper) from HFE frame
      foot_i point at (0, 0, -l_lower) from KFE frame

Leg order everywhere in this repo: 0=FL, 1=FR, 2=HL, 3=HR.
Joint vector order: [FL_HAA, FL_HFE, FL_KFE, FR_..., HL_..., HR_...] (12 entries).

This is the PyTorch port's own copy of the robot constants (numpy only); the port
imports nothing from the JAX package, and tests/test_torch_imports.py holds
the two copies equal value by value.
"""

from __future__ import annotations

import dataclasses

import numpy as np

LEG_NAMES = ("FL", "FR", "HL", "HR")
JOINT_NAMES = tuple(f"{leg}_{j}" for leg in LEG_NAMES for j in ("HAA", "HFE", "KFE"))


def _box_inertia(m: float, lx: float, ly: float, lz: float) -> np.ndarray:
    """Inertia tensor of a solid box of mass m, full side lengths (lx, ly, lz)."""
    return np.diag([
        m / 12.0 * (ly * ly + lz * lz),
        m / 12.0 * (lx * lx + lz * lz),
        m / 12.0 * (lx * lx + ly * ly),
    ])


def _rod_inertia_z(m: float, length: float, radius: float = 0.015) -> np.ndarray:
    """Inertia of a thin rod of mass m along -z (leg segment), about its COM."""
    i_perp = m / 12.0 * length * length + m / 4.0 * radius * radius
    i_axis = m / 2.0 * radius * radius
    return np.diag([i_perp, i_perp, i_axis])


@dataclasses.dataclass(frozen=True)
class Solo12Model:
    """All physical constants of the model.  Frozen; numpy float64 arrays."""

    # --- masses (kg) ---
    base_mass: float = 1.30
    hip_mass: float = 0.14      # HAA-driven shoulder block
    upper_mass: float = 0.14    # HFE-driven upper leg
    lower_mass: float = 0.04    # KFE-driven lower leg (incl. foot)

    # --- geometry (m) ---
    hip_x: float = 0.1946       # fore-aft distance base-center -> HAA axis
    hip_y: float = 0.0875       # lateral  distance base-center -> HAA axis
    hfe_y: float = 0.014        # lateral offset HAA -> HFE
    l_upper: float = 0.160      # HFE -> KFE
    l_lower: float = 0.160      # KFE -> foot point

    # base box dimensions for inertia
    base_lx: float = 0.38
    base_ly: float = 0.22
    base_lz: float = 0.06

    # --- limits ---
    tau_max: float = 2.7        # N m, per joint (Solo-12 class actuator)
    qd_max: float = 40.0        # rad/s
    mu_default: float = 0.7     # friction coefficient on flat ground
    fz_min: float = 0.2         # N, minimum stance normal force
    fz_max: float = 25.0        # N, maximum stance normal force

    # --- nominal configuration ---
    h_ref: float = 0.2447       # standing base height
    g: float = 9.81

    # ------------------------------------------------------------------ derived

    @property
    def total_mass(self) -> float:
        return self.base_mass + 4.0 * (self.hip_mass + self.upper_mass + self.lower_mass)

    @property
    def leg_sign(self) -> np.ndarray:
        """(4,2) signs of (x, y) hip placement per leg: FL, FR, HL, HR."""
        return np.array([[1, 1], [1, -1], [-1, 1], [-1, -1]], dtype=np.float64)

    @property
    def hip_offsets(self) -> np.ndarray:
        """(4,3) HAA joint origins in the base frame."""
        s = self.leg_sign
        out = np.zeros((4, 3))
        out[:, 0] = s[:, 0] * self.hip_x
        out[:, 1] = s[:, 1] * self.hip_y
        return out

    @property
    def shoulder_offsets(self) -> np.ndarray:
        """(4,3) nominal foot x-y positions under the shoulders, in the base frame.

        Used by the Raibert footstep heuristic (SURVEY.md §2.1 "Footstep planner")."""
        s = self.leg_sign
        out = np.zeros((4, 3))
        out[:, 0] = s[:, 0] * self.hip_x
        out[:, 1] = s[:, 1] * (self.hip_y + self.hfe_y)
        return out

    @property
    def base_inertia(self) -> np.ndarray:
        """(3,3) base-frame rotational inertia of the trunk box about its COM."""
        return _box_inertia(self.base_mass, self.base_lx, self.base_ly, self.base_lz)

    @property
    def srb_inertia(self) -> np.ndarray:
        """(3,3) lumped single-rigid-body inertia used by the centroidal MPC.

        Trunk box inertia plus point-mass contributions of the leg masses frozen at
        their nominal standing positions (legs folded under the hips).  This is the
        12-state SRB model's I (BASELINE.json:5 "12-state SRB model")."""
        inertia = self.base_inertia.copy()
        leg_m = self.hip_mass + self.upper_mass + self.lower_mass
        for i in range(4):
            r = self.hip_offsets[i] + np.array([0.0, 0.0, -0.5 * self.h_ref])
            r2 = float(r @ r)
            inertia += leg_m * (r2 * np.eye(3) - np.outer(r, r))
        return inertia

    @property
    def q_stand(self) -> np.ndarray:
        """(12,) nominal standing joint angles (x2 knee-inward pattern).

        With both segments 0.16 m, the standing height is 0.32*cos(0.7) = h_ref."""
        q = np.zeros(12)
        for i in range(4):
            q[3 * i + 1] = 0.7   # HFE
            q[3 * i + 2] = -1.4  # KFE
        return q

    # center-of-mass offsets of each body in its own joint frame
    @property
    def hip_com(self) -> np.ndarray:
        return np.array([0.0, 0.0, 0.0])

    @property
    def upper_com(self) -> np.ndarray:
        return np.array([0.0, 0.0, -0.5 * self.l_upper])

    @property
    def lower_com(self) -> np.ndarray:
        return np.array([0.0, 0.0, -0.5 * self.l_lower])

    @property
    def hip_inertia(self) -> np.ndarray:
        return _box_inertia(self.hip_mass, 0.06, 0.04, 0.06)

    @property
    def upper_inertia(self) -> np.ndarray:
        return _rod_inertia_z(self.upper_mass, self.l_upper)

    @property
    def lower_inertia(self) -> np.ndarray:
        return _rod_inertia_z(self.lower_mass, self.l_lower)


SOLO12 = Solo12Model()
