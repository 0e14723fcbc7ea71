from mpctsid_tpu_torch.plan.gait import (contacts_at, contacts_horizon,
                                         swing_tables)
from mpctsid_tpu_torch.plan.footsteps import (plan_footsteps_horizon,
                                              raibert_touchdown)
from mpctsid_tpu_torch.plan.swing import swing_foot_ref

__all__ = ["contacts_at", "contacts_horizon", "swing_tables",
           "plan_footsteps_horizon", "raibert_touchdown", "swing_foot_ref"]
