"""The port's single-robot controller (host.py, sync, on the CPU) against the
float64 oracle's controller and the JAX package's, tick by tick, on walk,
bound and pace (tests/test_torch_host.py holds trot): the oracle runs two
periods from standing on its own simulator, and the same (q, v) sequence is
fed to the port's HostController and to the JAX package's.

On these gaits the in-loop WBC solve (40 float32 iterations in 3 rounds) is
far from the oracle's converged QP in BOTH packages: measured on a CPU, the
largest torque difference over the 40 ticks was 0.107-0.119 / 0.233-0.238 /
0.923-1.029 Nm (port) against 0.121-0.218 / 0.190-0.245 / 1.077-1.214 Nm
(JAX package; two runs, its XLA build changes the float32 rounding) on walk
/ bound / pace, where trot gives 4.0e-3 / 4.2e-3.  TAU_TOL = 1e-2 Nm, the
contract's torque bar, is met on trot only: a standing shortfall of the
in-loop budget (ROADMAP queue 3), which the test records for the reference.

The port is held to the JAX package directly.  The consumed and pending
MPC plans (a function of the (q, v) sequence alone) within 1e-3 N, as
tests/test_torch_host.py holds trot (measured 1.5e-4 / 6.2e-5 / 2.2e-4 N).  The torques tick by tick within the
spread of two float32 solvers of one QP: each package warm-starts from its
own previous solution, and the 40-iteration solve of these ill-conditioned
QPs (the 1e6 swing ridge, the equality rows' 1e3 rho) turns a rounding into
tenths of a Nm.  Measured largest / median difference over the 40 ticks:
0.250 / 0.035 (walk), 0.170 / 0.019 (bound), 0.540 / 0.069 Nm (pace); the
bounds are twice that (the JAX package's rounding moves with its build).
"""

import numpy as np
import pytest
from threadpoolctl import threadpool_limits

from mpctsid_tpu_torch.config import EngineConfig
from mpctsid_tpu_torch.host import HostController
from mpctsid_tpu_torch.model.solo12 import SOLO12
from mpctsid_tpu_torch.oracle.cascade import OracleController
from mpctsid_tpu_torch.oracle.sim import SimState, step

from _torch_port_util import standing_q0

V_CMD = {"walk": (0.2, 0.0, 0.0), "bound": (0.25, 0.0, 0.0),
         "pace": (0.3, 0.0, 0.0)}
TICKS = 40
# the contract's torque bar against the oracle, Nm (tests/test_torch_host.py)
TAU_TOL = 1e-2
PLAN_TOL = 1e-3                     # N, port against JAX
# port against JAX, Nm: (largest, median) over the 40 ticks; twice the
# measured spread (module docstring)
SPREAD = {"walk": (0.5, 0.07), "bound": (0.34, 0.04), "pace": (1.08, 0.14)}


def oracle_sequence(gait):
    """(q, v, applied torque) of the oracle controller's first TICKS ticks
    in closed loop on its own simulator."""
    q0 = standing_q0(1)[0].astype(np.float64)
    ctl = OracleController(SOLO12, EngineConfig(gait=gait,
                                                v_ref=V_CMD[gait]), q0)
    sim = SimState.init(q0)
    qs, vs, taus = [], [], []
    with threadpool_limits(1):
        for _ in range(TICKS):
            cmd, _ = ctl.compute(sim.q, sim.v)
            tau = cmd.torque(sim.q[7:], sim.v[6:])
            qs.append(sim.q.copy())
            vs.append(sim.v.copy())
            taus.append(tau)
            sim, _ = step(ctl.tree, sim, tau)
    return qs, vs, np.stack(taus)


@pytest.mark.parametrize("gait", sorted(V_CMD))
def test_host_torques_against_the_oracle_controller(gait):
    from mpctsid_tpu.config import EngineConfig as JEngineConfig
    from mpctsid_tpu.host import HostController as JHostController
    from mpctsid_tpu.model.solo12 import SOLO12 as J_SOLO12

    qs, vs, o_tau = oracle_sequence(gait)
    q0 = qs[0].astype(np.float32)
    ctl = HostController(SOLO12, EngineConfig(gait=gait, v_ref=V_CMD[gait]),
                         q0, async_mpc=False, device="cpu")
    jctl = JHostController(J_SOLO12, JEngineConfig(gait=gait,
                                                   v_ref=V_CMD[gait]),
                           q0, async_mpc=False)
    port, ref, d_plan = [], [], 0.0
    try:
        for q, v in zip(qs, vs):
            port.append(ctl.compute(q, v))
            ref.append(jctl.compute(q, v))
            d_plan = max(d_plan, np.abs(ctl.f_plan - jctl.f_plan).max(),
                         np.abs(ctl._pending_plan[0]
                                - jctl._pending_plan[0]).max())
    finally:
        ctl.close()
    port, ref = np.stack(port), np.stack(ref)
    assert np.isfinite(port).all() and port.shape == (TICKS, 12)
    assert (ctl.phase, ctl.plan_period, ctl.k) == (
        jctl.phase, jctl.plan_period, jctl.k)
    assert d_plan < PLAN_TOL, (gait, d_plan)
    d = np.abs(port - ref).max(axis=1)
    assert d.max() < SPREAD[gait][0], (gait, d.max())
    assert np.median(d) < SPREAD[gait][1], (gait, np.median(d))
    # the shortfall the port shares with the reference (module docstring)
    assert np.abs(ref - o_tau).max() > TAU_TOL
