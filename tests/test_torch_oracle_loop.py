"""The port's batched closed loop against the float64 oracle's closed loop:
`cascade_rollout` with one gait per scenario (walk, bound, pace, trot at the
commands of tests/test_cascade_jax.py, friction 0.7) against
`OracleController` on the oracle's own simulator, 10 periods from standing.

Chaotic contact makes the two trajectories part slowly.  Measured on a CPU, the
largest difference over the 10 period starts (x, height, roll/pitch): walk
8.3e-4 m, 4.7e-3 m, 8e-4 rad (x parts from period 6 on: 2.3e-4, then 5.6e-4,
7.0e-4, 8.3e-4 m); bound 2.8e-4 m, 6e-4 m, 1.8e-3 rad; pace 2.9e-4 m,
2.1e-3 m, 4.1e-3 rad; trot 8.2e-6 m, 1e-4 m, 2e-5 rad.  Held to a band of
5e-3 m in x, 0.02 m in height and 0.02 rad in roll and pitch.  Over 40
periods the same comparison parts further (x 5.5e-3 m at most, on pace; the
oracle's own pace then rolls to 0.93 rad where the port's stays under 0.13):
chip_smoke.py phase 11d holds that run on the card.
"""

import numpy as np
from threadpoolctl import threadpool_limits

from mpctsid_tpu_torch.cascade import (CascadeConfigured, cascade_rollout,
                                       init_controller)
from mpctsid_tpu_torch.config import EngineConfig
from mpctsid_tpu_torch.env.plant import ContactParams, PlantState
from mpctsid_tpu_torch.model.gaits import GAIT_IDS
from mpctsid_tpu_torch.model.solo12 import SOLO12
from mpctsid_tpu_torch.oracle.cascade import OracleController
from mpctsid_tpu_torch.oracle.sim import SimState, step

from _torch_port_util import standing_q0

GAITS = ["walk", "bound", "pace", "trot"]
V_CMD = np.array([[0.2, 0.0, 0.0], [0.25, 0.0, 0.0], [0.3, 0.0, 0.0],
                  [0.3, 0.0, 0.0]], np.float32)
PERIODS = 10
BAND_X, BAND_Z, BAND_RP = 5e-3, 0.02, 0.02


def oracle_period_starts(gait, v_cmd, periods):
    """The oracle's SRB state at the start of each period, (periods, 12)."""
    cfg = EngineConfig(gait=gait, v_ref=tuple(float(c) for c in v_cmd))
    q0 = standing_q0(1)[0].astype(np.float64)
    ctl = OracleController(SOLO12, cfg, q0)
    sim = SimState.init(q0)
    tree = ctl.tree
    starts = []
    for k in range(periods * cfg.cascade.mpc_every):
        cmd, log = ctl.compute(sim.q, sim.v)
        if k % cfg.cascade.mpc_every == 0:
            starts.append(log.x_srb)
        sim, _ = step(tree, sim, cmd.torque(sim.q[7:], sim.v[6:]))
    return np.stack(starts)


def test_closed_loop_stays_in_the_oracles_band_for_ten_periods():
    cfg = EngineConfig()
    cc = CascadeConfigured(SOLO12, cfg)
    gid = np.array([GAIT_IDS[g] for g in GAITS], np.int32)
    q0 = standing_q0(len(GAITS))
    ctl = init_controller(SOLO12, cfg, cc.tree, q0, gid, device="cpu")
    plant = PlantState.init(q0, device="cpu")
    _, _, met = cascade_rollout(cc, ctl, plant, gid, V_CMD,
                                ContactParams.default(len(GAITS),
                                                      device="cpu"),
                                n_periods=PERIODS, device="cpu")
    x = met["x_srb"].numpy().astype(np.float64)
    assert bool(met["mpc_ok"].all())
    with threadpool_limits(1):
        for b, gait in enumerate(GAITS):
            xo = oracle_period_starts(gait, V_CMD[b], PERIODS)
            d = np.abs(x[b] - xo)
            where = f"{gait}: |dx| {d[:, 0].max():.2e}, |dz| " \
                    f"{d[:, 2].max():.2e}, |d rp| {d[:, 3:5].max():.2e}"
            assert d[:, 0].max() < BAND_X, where
            assert d[:, 2].max() < BAND_Z, where
            assert d[:, 3:5].max() < BAND_RP, where
