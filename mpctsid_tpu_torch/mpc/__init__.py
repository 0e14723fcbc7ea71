from mpctsid_tpu_torch.mpc.srb import (build_mpc_qp, reference_rollout,
                                       solve_mpc_batch)

__all__ = ["build_mpc_qp", "reference_rollout", "solve_mpc_batch"]
