from mpctsid_tpu_torch.qp.admm import QPSolution, admm_solve, ruiz_equilibrate

__all__ = ["admm_solve", "ruiz_equilibrate", "QPSolution"]
