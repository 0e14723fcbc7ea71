from mpctsid_tpu_torch.dist.mesh import (init_scenario_group, scenario_summary,
                                         shard_scenarios,
                                         shard_scenarios_multihost,
                                         sharded_cascade_rollout, tree_map)

__all__ = ["init_scenario_group", "scenario_summary", "shard_scenarios",
           "shard_scenarios_multihost", "sharded_cascade_rollout",
           "tree_map"]
