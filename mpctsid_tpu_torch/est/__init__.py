from mpctsid_tpu_torch.est.filter import (GRAV, EstimatorState,
                                          estimator_init, estimator_tick,
                                          estimator_update, imu_from_plant)

__all__ = ["GRAV", "EstimatorState", "estimator_init", "estimator_tick",
           "estimator_update", "imu_from_plant"]
