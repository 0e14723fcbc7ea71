"""Numerical sanitizers of the port (the twins of tests/test_sanitizers.py):
the cascade with its outputs checked for NaN after every period, as
`jax_debug_nans` checks every jitted call's outputs; every output of a
rollout finite; the production QP solver finite and ok on a batch of
perturbed random QPs."""

import dataclasses

import numpy as np
import torch

from _torch_port_util import random_qp, standing_q0
from mpctsid_tpu_torch.cascade import (CascadeConfigured, cascade_period,
                                       cascade_rollout, init_controller)
from mpctsid_tpu_torch.config import EngineConfig
from mpctsid_tpu_torch.env.plant import ContactParams, PlantState
from mpctsid_tpu_torch.model.gaits import GAIT_IDS
from mpctsid_tpu_torch.model.solo12 import SOLO12 as M
from mpctsid_tpu_torch.qp.admm import admm_solve


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _leaves(v)]
    if dataclasses.is_dataclass(tree):
        return [t for f in dataclasses.fields(tree)
                for t in _leaves(getattr(tree, f.name))]
    return []


def _start(gait="trot"):
    cfg = EngineConfig(gait=gait, v_ref=(0.25, 0.0, 0.0))
    cc = CascadeConfigured(M, cfg)
    q0 = standing_q0(1)
    gid = np.full((1,), GAIT_IDS[gait], np.int32)
    ctl = init_controller(M, cfg, cc.tree, q0, gid, device="cpu")
    plant = PlantState.init(q0, device="cpu")
    v = torch.tensor([cfg.v_ref], dtype=torch.float32)
    return cc, ctl, plant, torch.as_tensor(gid), v, ContactParams.default(
        1, device="cpu")


def test_cascade_outputs_checked_for_nan_after_every_period():
    """Two periods, each period's every output (controller state, plant
    state, metrics) checked for NaN as soon as it is produced."""
    cc, ctl, plant, gid, v, cp = _start()
    for period in range(2):
        ctl, plant, _, metrics = cascade_period(cc, ctl, plant, gid, v, cp)
        leaves = _leaves((ctl, plant, metrics))
        assert len(leaves) >= 20
        nan = [i for i, t in enumerate(leaves)
               if t.is_floating_point() and bool(torch.isnan(t).any())]
        assert not nan, f"NaN in period {period}, outputs {nan}"


def test_all_outputs_of_a_rollout_finite():
    cc, ctl, plant, gid, v, cp = _start()
    out = cascade_rollout(cc, ctl, plant, gid, v, cp, n_periods=3,
                          device="cpu")
    for t in _leaves(out):
        if t.is_floating_point():
            assert bool(torch.isfinite(t).all())
    assert tuple(out[2]["x_srb"].shape) == (1, 3, 12)


def test_qp_solution_finite_on_perturbed_batch():
    """Random valid QPs (tests/test_pallas_admm.py's generator) through the
    production solver: finite outputs and every solve ok."""
    P, q, A, l, u = [torch.as_tensor(np.stack(a)) for a in
                     zip(*[random_qp(s) for s in range(8)])]
    sol = admm_solve(P, q, A, l, u, iters=80, adapt_rounds=2, rho=0.1)
    for t in (sol.x, sol.y, sol.z):
        assert tuple(t.shape[:1]) == (8,)
        assert bool(torch.isfinite(t).all())
    assert bool(sol.ok.all())
