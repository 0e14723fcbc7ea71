from mpctsid_tpu_torch.cascade.engine import (CascadeConfigured,
                                              ControllerState, cascade_period,
                                              cascade_rollout,
                                              init_controller, srb_state)
from mpctsid_tpu_torch.cascade.graphed import (cascade_rollout_graphed,
                                               clear_runners, period_runner)

__all__ = ["CascadeConfigured", "ControllerState", "cascade_period",
           "cascade_rollout", "cascade_rollout_graphed", "clear_runners",
           "init_controller", "period_runner", "srb_state"]
