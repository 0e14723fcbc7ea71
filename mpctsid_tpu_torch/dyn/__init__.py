from mpctsid_tpu_torch.dyn.rigid_body import (crba, fk, foot_drifts,
                                              foot_jacobians, foot_positions,
                                              foot_velocities, integrate_q,
                                              point_mass_spatial, quat_to_rot,
                                              rnea, rot_to_rpy)

__all__ = ["fk", "crba", "rnea", "foot_positions", "foot_jacobians",
           "foot_velocities", "foot_drifts", "integrate_q", "quat_to_rot",
           "point_mass_spatial", "rot_to_rpy"]
