from mpctsid_tpu_torch.wbc.tsid import WbcRefs, build_wbc_qp, solve_wbc

__all__ = ["WbcRefs", "build_wbc_qp", "solve_wbc"]
