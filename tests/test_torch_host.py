"""The port's single-robot deployment path (mpctsid_tpu_torch/host.py) on the
CPU, where every captured call runs eagerly: the JAX package's four host
tests (tests/test_host_controller.py) with its thresholds, the torques tick
by tick against the JAX HostController and the float64 oracle's controller
on the same (q, v) sequence, and the capture helper's CPU behaviour."""

import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_port_util import standing_q0 as standing_batch
from mpctsid_tpu_torch.cascade import (CascadeConfigured, cascade_period,
                                       init_controller)
from mpctsid_tpu_torch.config import EngineConfig
from mpctsid_tpu_torch.env.interface import SimPlant
from mpctsid_tpu_torch.env.plant import ContactParams, PlantState
from mpctsid_tpu_torch.host import HostController
from mpctsid_tpu_torch.model.gaits import GAIT_IDS
from mpctsid_tpu_torch.model.solo12 import SOLO12 as M
from mpctsid_tpu_torch.model.tree import build_tree
from mpctsid_tpu_torch.utils.graphs import CapturedCall

# Torques of the port against the JAX package and the oracle, Nm, every tick
# of two periods from standing (the second consumes the first MPC plan).
# Measured: at most 2.1e-3 against JAX (both float32) and 4.0e-3 against the
# float64 oracle.  The bound is the WBC's float32 noise: the 40-iteration
# solve is flat along some directions of the QP, where the JAX package
# differs from ITSELF by up to 5.9e-2 Nm between two lowerings (ROADMAP
# queue 3); 1e-2 sits above what was measured and well inside that noise.
TAU_TOL = 1e-2
# Simulated time of the closed-loop runs: half the JAX tests' 1.2 s, which
# takes about 25 s here on one CPU thread (the JAX tests' thresholds hold).
SECONDS = 0.6


def standing_q0():
    return standing_batch(1)[0]


def run_host(async_mpc, seconds=SECONDS, settle=None, telemetry=False):
    cfg = EngineConfig(gait="trot", v_ref=(0.25, 0.0, 0.0))
    q0 = standing_q0()
    plant = SimPlant(build_tree(M), q0, device="cpu")
    ctl = HostController(M, cfg, q0, async_mpc=async_mpc, telemetry=telemetry,
                         device="cpu")
    n = int(round(seconds / cfg.cascade.wbc_dt))
    zs, xs, taus = [], [], []
    try:
        for _ in range(n):
            s = plant.read()
            tau = ctl.compute(s.q.numpy(), s.v.numpy())
            plant.apply(torch.as_tensor(tau))
            if settle:
                time.sleep(settle)   # give the planner thread real time
            zs.append(float(s.q[2]))
            xs.append(float(s.q[0]))
            taus.append(tau)
    finally:
        ctl.close()
    return np.array(zs), np.array(xs), ctl, np.stack(taus)


def test_sync_host_controller_trot_stays_upright():
    zs, xs, ctl, _ = run_host(async_mpc=False)
    assert zs.min() > 0.15, f"fell (min z {zs.min():.3f})"
    assert xs[-1] > 0.05, f"no forward progress (x {xs[-1]:.3f})"
    assert ctl.plan_period > 0, "plans never consumed"


def test_async_host_controller_uses_native_buffer():
    """Async mode: the MPC runs on the planner thread and publishes through
    the native seqlock PlanBuffer; the tick loop never waits for a solve and
    the robot walks."""
    zs, _, ctl, _ = run_host(async_mpc=True, settle=0.0005)
    assert zs.min() > 0.15, f"fell (min z {zs.min():.3f})"
    assert ctl.plan_period > 0, "no plan ever published/consumed"
    assert ctl._buf.read_latest()[0] >= ctl.plan_period


def test_sync_matches_cascade_engine_first_period():
    """The host controller's first period must match the port's batched
    cascade from the same state (same formulation, same staleness): the
    plant after 20 ticks, with the JAX test's 5e-3."""
    cfg = EngineConfig(gait="trot", v_ref=(0.25, 0.0, 0.0))
    q0 = standing_batch(1)
    cc = CascadeConfigured(M, cfg)
    gid = np.full((1,), GAIT_IDS["trot"], np.int32)
    ctl_e = init_controller(M, cfg, cc.tree, q0, gid, device="cpu")
    plant_e = PlantState.init(q0, device="cpu")
    _, plant_e2, _, _ = cascade_period(
        cc, ctl_e, plant_e, torch.as_tensor(gid),
        torch.tensor([cfg.v_ref], dtype=torch.float32),
        ContactParams.default(1, device="cpu"))

    plant = SimPlant(cc.tree, q0[0], device="cpu")
    host = HostController(M, cfg, q0[0], async_mpc=False, device="cpu")
    for _ in range(cfg.cascade.mpc_every):
        s = plant.read()
        tau = host.compute(s.q.numpy(), s.v.numpy())
        plant.apply(torch.as_tensor(tau))
    np.testing.assert_allclose(plant.state.q.numpy(), plant_e2.q.numpy(),
                               atol=5e-3)


def test_host_telemetry_ring_records_every_tick():
    """telemetry=True: one native-ring record per compute() with the tick
    index, phase, WBC status and the commanded torques."""
    n = 40
    _, _, ctl, taus = run_host(async_mpc=False, seconds=n * 1e-3,
                               telemetry=True)
    rec = ctl.drain_telemetry()
    assert rec.shape == (n, HostController.TELEM_LEN)
    np.testing.assert_array_equal(rec[:, 0], np.arange(n, dtype=np.float32))
    assert set(np.unique(rec[:, 1])) <= {0.0, 1.0}   # phases 0..1 in 2 periods
    assert (rec[:, 2] == 1.0).all()
    np.testing.assert_allclose(rec[:, 3:], taus, atol=1e-6)
    assert ctl._telem.dropped == 0
    assert ctl.drain_telemetry().shape[0] == 0


def _port_torques(qs, vs, v_ref):
    """The port's sync controller fed a recorded (q, v) sequence open loop."""
    cfg = EngineConfig(gait="trot", v_ref=v_ref)
    ctl = HostController(M, cfg, standing_q0(), async_mpc=False,
                         device="cpu")
    taus = np.stack([ctl.compute(q, v) for q, v in zip(qs, vs)])
    return taus, ctl


def test_host_torques_match_the_jax_host_controller():
    """Two periods of the JAX HostController (sync) in closed loop on its
    SimPlant; the same (q, v) sequence fed to the port's controller: the
    torques agree tick by tick within TAU_TOL, the consumed plans within
    1e-3 N."""
    from mpctsid_tpu.config import EngineConfig as JEngineConfig
    from mpctsid_tpu.env import SimPlant as JSimPlant
    from mpctsid_tpu.host import HostController as JHostController
    from mpctsid_tpu.model.solo12 import SOLO12 as JM
    from mpctsid_tpu.model.tree import build_tree as j_build_tree

    v_ref = (0.25, 0.0, 0.0)
    q0 = standing_q0()
    jctl = JHostController(JM, JEngineConfig(gait="trot", v_ref=v_ref), q0,
                           async_mpc=False)
    plant = JSimPlant(j_build_tree(JM), jnp.asarray(q0))
    qs, vs, j_taus = [], [], []
    for _ in range(40):
        s = plant.read()
        q, v = np.asarray(s.q), np.asarray(s.v)
        tau = jctl.compute(q, v)
        plant.apply(jnp.asarray(tau, jnp.float32))
        qs.append(q)
        vs.append(v)
        j_taus.append(tau)
    taus, ctl = _port_torques(qs, vs, v_ref)
    np.testing.assert_allclose(taus, np.stack(j_taus), rtol=0, atol=TAU_TOL)
    assert (ctl.phase, ctl.plan_period, ctl.k) == (jctl.phase,
                                                   jctl.plan_period, jctl.k)
    np.testing.assert_allclose(ctl.f_plan, jctl.f_plan, rtol=0, atol=1e-3)
    np.testing.assert_allclose(ctl._pending_plan[0], jctl._pending_plan[0],
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(ctl.v_int, jctl.v_int, rtol=0, atol=1e-6)


def test_host_torques_match_the_oracle_controller():
    """The float64 oracle's controller (mpctsid_tpu.oracle.cascade, the
    reference's own Controller.compute() loop) for two periods on its own
    simulator; the same (q, v) sequence fed to the port: torques tick by
    tick within TAU_TOL."""
    from mpctsid_tpu.config import EngineConfig as JEngineConfig
    from mpctsid_tpu.model.solo12 import SOLO12 as JM
    from mpctsid_tpu.model.tree import build_tree as j_build_tree
    from mpctsid_tpu.oracle.cascade import OracleController
    from mpctsid_tpu.oracle.sim import SimState, step as o_step

    v_ref = (0.3, 0.0, 0.0)
    q0 = standing_q0().astype(np.float64)
    octl = OracleController(JM, JEngineConfig(gait="trot", v_ref=v_ref), q0)
    sim = SimState.init(q0)
    tree = j_build_tree(JM)
    qs, vs, o_taus = [], [], []
    for _ in range(40):
        cmd, _ = octl.compute(sim.q, sim.v)
        tau = cmd.torque(sim.q[7:], sim.v[6:])
        qs.append(sim.q.copy())
        vs.append(sim.v.copy())
        o_taus.append(tau)
        sim, _ = o_step(tree, sim, tau)
    taus, _ = _port_torques(qs, vs, v_ref)
    np.testing.assert_allclose(taus, np.stack(o_taus), rtol=0, atol=TAU_TOL)


def _accumulate(x, warm, out):
    warm.copy_(warm * 0.5 + x)
    out.copy_(torch.cat([warm, warm.sum(dim=1, keepdim=True)], dim=1))
    return out


def test_captured_call_is_eager_on_the_cpu_and_keeps_state_moving():
    """On the CPU there is no graph: each call copies the new values into
    the static inputs and runs the function, whose in-place writes (the warm
    start) carry over to the next call, exactly as calling it by hand."""
    x = torch.zeros(1, 3)
    warm = torch.zeros(1, 3)
    out = torch.zeros(1, 4)
    call = CapturedCall(_accumulate, dict(x=x, warm=warm, out=out), "cpu",
                        "accumulate")
    assert call.graph is None and call.name == "accumulate"
    want_warm = torch.zeros(1, 3)
    r = np.random.default_rng(0)
    for _ in range(5):
        xi = torch.tensor(r.normal(size=(1, 3)), dtype=torch.float32)
        got = call(x=xi)
        want_warm = want_warm * 0.5 + xi
        assert got is out
        torch.testing.assert_close(got[:, :3], want_warm, rtol=0, atol=0)
        torch.testing.assert_close(got[:, 3], want_warm.sum(1), rtol=0,
                                   atol=0)
        assert torch.equal(x, xi)
    # no new values: the same inputs again, the state moves on
    before = warm.clone()
    call()
    torch.testing.assert_close(warm, before * 0.5 + x, rtol=0, atol=0)


def test_captured_call_checks_its_static_inputs():
    with pytest.raises(ValueError, match="static input 'x'"):
        CapturedCall(_accumulate, dict(x=np.zeros((1, 3)),
                                       warm=torch.zeros(1, 3),
                                       out=torch.zeros(1, 4)), "cpu")


def test_host_controller_defaults_to_the_card():
    """No CUDA here: the default device raises instead of running on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    cfg = EngineConfig(gait="trot")
    with pytest.raises(RuntimeError, match="cuda"):
        HostController(M, cfg, standing_q0())
