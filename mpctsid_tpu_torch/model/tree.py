"""Kinematic-tree data for the 18-DoF Solo-12 model (pure numpy data).

Replaces the reference's URDF + Pinocchio model object (SURVEY.md §2.1 "Rigid-body
dynamics" / "Robot model data").  Single source of truth for every dynamics consumer:
the batched PyTorch dynamics (dyn/) and the generated MuJoCo
MJCF used for validation (SURVEY.md §4.1).

Bodies: 0 = base (free-flyer); for leg i in (FL, FR, HL, HR):
  body 1+3i = hip (HAA, revolute +x), 2+3i = upper (HFE, revolute +y),
  body 3+3i = lower (KFE, revolute +y).  Joint j drives body j+1.
All joint frames are axis-aligned with the base frame at q = 0 (rotations in the
fixed placements are identity; only translations differ per leg).

This is the PyTorch port's own copy of the kinematic tree (numpy only); the port
imports nothing from the JAX package, and tests/test_torch_imports.py holds
the two copies equal value by value.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mpctsid_tpu_torch.model.solo12 import Solo12Model

N_BODIES = 13  # base + 12
N_JOINTS = 12
NV = 18        # 6 base + 12 joints


@dataclasses.dataclass(frozen=True)
class KinematicTree:
    parent: np.ndarray      # (13,) int; parent body index, -1 for base
    placement: np.ndarray   # (13,3) translation of the body's joint frame in parent frame
    axis: np.ndarray        # (13,3) joint axis in the local frame (row 0 unused)
    mass: np.ndarray        # (13,)
    com: np.ndarray         # (13,3) body COM in its own joint frame
    inertia: np.ndarray     # (13,3,3) rotational inertia about the body COM
    foot_body: np.ndarray   # (4,) int; body index carrying each foot point
    foot_offset: np.ndarray # (4,3) foot point in its body frame


def build_tree(model: Solo12Model) -> KinematicTree:
    parent = np.full(N_BODIES, -1, dtype=np.int64)
    placement = np.zeros((N_BODIES, 3))
    axis = np.zeros((N_BODIES, 3))
    mass = np.zeros(N_BODIES)
    com = np.zeros((N_BODIES, 3))
    inertia = np.zeros((N_BODIES, 3, 3))

    mass[0] = model.base_mass
    inertia[0] = model.base_inertia

    s = model.leg_sign
    for i in range(4):
        hip, upper, lower = 1 + 3 * i, 2 + 3 * i, 3 + 3 * i
        parent[hip] = 0
        placement[hip] = model.hip_offsets[i]
        axis[hip] = (1.0, 0.0, 0.0)           # HAA
        mass[hip] = model.hip_mass
        com[hip] = model.hip_com
        inertia[hip] = model.hip_inertia

        parent[upper] = hip
        placement[upper] = (0.0, s[i, 1] * model.hfe_y, 0.0)
        axis[upper] = (0.0, 1.0, 0.0)         # HFE
        mass[upper] = model.upper_mass
        com[upper] = model.upper_com
        inertia[upper] = model.upper_inertia

        parent[lower] = upper
        placement[lower] = (0.0, 0.0, -model.l_upper)
        axis[lower] = (0.0, 1.0, 0.0)         # KFE
        mass[lower] = model.lower_mass
        com[lower] = model.lower_com
        inertia[lower] = model.lower_inertia

    foot_body = np.array([3, 6, 9, 12], dtype=np.int64)
    foot_offset = np.tile(np.array([0.0, 0.0, -model.l_lower]), (4, 1))
    return KinematicTree(parent, placement, axis, mass, com, inertia,
                         foot_body, foot_offset)


def to_mjcf(model: Solo12Model) -> str:
    """Generate a MuJoCo MJCF string with EXACTLY the same kinematics/inertias,
    for cross-validation of the from-scratch dynamics (SURVEY.md §4.1)."""
    t = build_tree(model)

    def body_xml(b: int, indent: str) -> str:
        i = (b - 1) // 3
        kind = (b - 1) % 3  # 0 hip, 1 upper, 2 lower
        name = ["hip", "upper", "lower"][kind] + f"_{i}"
        ax = t.axis[b]
        full_inertia = t.inertia[b]
        diag = np.diag(full_inertia)
        pos = t.placement[b]
        s = (f'{indent}<body name="{name}" pos="{pos[0]} {pos[1]} {pos[2]}">\n'
             f'{indent}  <joint name="j_{b-1}" type="hinge" '
             f'axis="{ax[0]} {ax[1]} {ax[2]}" limited="false"/>\n'
             f'{indent}  <inertial pos="{t.com[b][0]} {t.com[b][1]} {t.com[b][2]}" '
             f'mass="{t.mass[b]}" diaginertia="{diag[0]} {diag[1]} {diag[2]}"/>\n')
        if kind == 2:
            fo = t.foot_offset[i]
            s += (f'{indent}  <site name="foot_{i}" '
                  f'pos="{fo[0]} {fo[1]} {fo[2]}" size="0.005"/>\n')
        return s

    base_diag = np.diag(model.base_inertia)
    legs = []
    for i in range(4):
        hip, upper, lower = 1 + 3 * i, 2 + 3 * i, 3 + 3 * i
        legs.append(
            body_xml(hip, "      ")
            + body_xml(upper, "        ")
            + body_xml(lower, "          ")
            + "          </body>\n        </body>\n      </body>\n")
    return f"""
<mujoco model="solo12_mpctsid">
  <option gravity="0 0 -{model.g}"/>
  <compiler inertiafromgeom="false"/>
  <worldbody>
    <body name="base" pos="0 0 {model.h_ref}">
      <freejoint name="root"/>
      <inertial pos="0 0 0" mass="{model.base_mass}"
        diaginertia="{base_diag[0]} {base_diag[1]} {base_diag[2]}"/>
{''.join(legs)}    </body>
  </worldbody>
</mujoco>
"""
