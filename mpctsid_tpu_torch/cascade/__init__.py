from mpctsid_tpu_torch.cascade.engine import (CascadeConfigured,
                                              ControllerState, cascade_period,
                                              cascade_rollout,
                                              init_controller, srb_state)

__all__ = ["CascadeConfigured", "ControllerState", "cascade_period",
           "cascade_rollout", "init_controller", "srb_state"]
