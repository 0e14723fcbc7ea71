"""Port parity for the slice as a whole: cascade/engine.py vs the JAX cascade.

One `cascade_period` from a MID-GAIT state: the JAX package (jit + vmap, as
run.py batches it) rolls four scenarios (trot, walk, bound, pace; four
friction values, four commands, two of them carrying a payload) three periods
from standing; that state is carried over through interop.py; then both
packages run the fourth period from it.  One JAX compile serves the whole
module.  Plus closed-loop behaviour of the port alone.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpctsid_tpu.cascade import engine as jengine
from mpctsid_tpu.config import EngineConfig as JEngineConfig
from mpctsid_tpu.env import plant as jplant
from mpctsid_tpu.model.solo12 import SOLO12 as J_SOLO12
from mpctsid_tpu_torch import interop
from mpctsid_tpu_torch.cascade import engine as tengine
from mpctsid_tpu_torch.config import EngineConfig
from mpctsid_tpu_torch.env.plant import ContactParams, PlantState
from mpctsid_tpu_torch.model.gaits import GAIT_IDS
from mpctsid_tpu_torch.model.solo12 import SOLO12
from mpctsid_tpu_torch.qp import kernels

from _torch_port_util import fields_to_numpy, jj, npy, standing_q0, tt

B = 4
GID = np.array([GAIT_IDS[g] for g in ("trot", "walk", "bound", "pace")],
               np.int32)
V_CMD = np.array([[0.3, 0.0, 0.0], [0.2, 0.0, 0.1], [0.25, 0.0, 0.0],
                  [0.2, 0.05, 0.0]], np.float32)
MU = np.array([0.5, 0.7, 0.9, 0.6], np.float32)
PAYLOAD = np.array([0.0, 0.3, 0.0, 0.2], np.float32)
WARM_PERIODS = 3


def _params_numpy():
    one = np.ones(B, np.float32)
    return dict(kp_n=8000.0 * one, kd_n=100.0 * one, kp_t=2000.0 * one,
                kd_t=30.0 * one, mu=MU)


@pytest.fixture(scope="module")
def handoff():
    """JAX side: (state before the 4th period, state and metrics after)."""
    cfg = JEngineConfig()
    cc = jengine.CascadeConfigured(J_SOLO12, cfg)
    q0 = jj(standing_q0(B))
    ctl = jax.vmap(lambda q, g, m: jengine.init_controller(
        J_SOLO12, cfg, cc.tree, q, g, payload=m))(
            q0, jnp.asarray(GID), jj(PAYLOAD))
    plant = jax.vmap(jplant.PlantState.init)(q0)
    cp = jplant.ContactParams(**{k: jj(a) for k, a in _params_numpy().items()})
    period = jax.jit(jax.vmap(
        lambda c, p, g, v, k, m: jengine.cascade_period(
            cc, c, p, g, v, k, payload=m)))
    args = (jnp.asarray(GID), jj(V_CMD), cp, jj(PAYLOAD))
    for _ in range(WARM_PERIODS):
        ctl, plant, _, _ = period(ctl, plant, *args)
    before = (fields_to_numpy(ctl), fields_to_numpy(plant))
    ctl2, plant2, _, metrics = period(ctl, plant, *args)
    after = (fields_to_numpy(ctl2), fields_to_numpy(plant2),
             {k: npy(v) for k, v in metrics.items()})
    return before, after


@pytest.fixture(scope="module")
def port_period(handoff):
    (ctl_np, plant_np), _ = handoff
    cfg = EngineConfig()
    cc = tengine.CascadeConfigured(SOLO12, cfg)
    ctl = interop.controller_state_from_numpy(ctl_np, device="cpu")
    plant = interop.plant_state_from_numpy(plant_np, device="cpu")
    cp = interop.contact_params_from_numpy(_params_numpy(), device="cpu")
    launches = kernels.admm_iterate_m2.launches
    ctl2, plant2, est, metrics = tengine.cascade_period(
        cc, ctl, plant, torch.as_tensor(GID), tt(V_CMD), cp,
        payload=tt(PAYLOAD))
    assert est is None
    assert kernels.admm_iterate_m2.launches == launches   # CPU: plain path
    return ctl2, plant2, metrics


def test_handoff_state_is_mid_gait(handoff):
    (ctl_np, plant_np), _ = handoff
    assert ctl_np["phase"].tolist() == [WARM_PERIODS] * B
    assert ctl_np["phase"].dtype == np.int32
    assert np.abs(ctl_np["mpc_warm_x"]).max() > 1.0      # a solved plan
    assert np.abs(plant_np["v"]).max() > 0.05            # moving
    assert plant_np["in_contact"].sum() >= 2 * B


def test_period_mpc_plan_matches_jax(handoff, port_period):
    """The MPC solved from the same state: 60 f32 iterations in 2 adapt
    rounds drift ~1e-4 between reduction orders; budget 1e-3 N on forces of
    ~10 N."""
    _, (ctl_j, _, met_j) = handoff
    ctl_t, _, met_t = port_period
    np.testing.assert_allclose(npy(ctl_t.f_plan), ctl_j["f_plan"], atol=1e-3)
    np.testing.assert_allclose(npy(ctl_t.mpc_warm_x), ctl_j["mpc_warm_x"],
                               atol=1e-3)
    assert npy(met_t["mpc_ok"]).tolist() == met_j["mpc_ok"].tolist()
    assert npy(met_t["mpc_ok"]).all()


def test_period_plant_state_matches_jax(handoff, port_period):
    """20 WBC ticks + plant steps from the same state.  Budget: what the JAX
    package gives itself against its float64 oracle over one period
    (tests/test_cascade_jax.py): q 2e-3, v 5e-2.  It holds as it is for the
    trot and walk scenarios.  The bound and pace scenarios are caught at
    touchdown (joint velocities up to 16 rad/s), where the WBC's f32 noise is
    amplified: from this very state the JAX package differs from ITSELF
    (single-scenario vs vmapped lowering) by 0.12 and 0.13 rad/s; the port
    measured 0.04 and 0.10 against vmapped JAX.  That noise is chaotic (it
    changes with the CPU's summation order), so their v budget is 0.3."""
    _, (_, plant_j, _) = handoff
    _, plant_t, _ = port_period
    np.testing.assert_allclose(npy(plant_t.q), plant_j["q"], atol=2e-3)
    np.testing.assert_allclose(npy(plant_t.v)[:2], plant_j["v"][:2],
                               atol=5e-2)
    np.testing.assert_allclose(npy(plant_t.v)[2:], plant_j["v"][2:],
                               atol=0.3)
    np.testing.assert_array_equal(npy(plant_t.in_contact),
                                  plant_j["in_contact"])
    np.testing.assert_allclose(npy(plant_t.anchor), plant_j["anchor"],
                               atol=2e-3)


def test_period_controller_bookkeeping_matches_jax(handoff, port_period):
    _, (ctl_j, _, _) = handoff
    ctl_t, _, _ = port_period
    got = interop.controller_state_to_numpy(ctl_t)
    assert got["phase"].tolist() == [WARM_PERIODS + 1] * B
    assert got["phase"].dtype == np.int32
    for name in ("liftoff", "touchdown", "prev_contacts", "v_int"):
        np.testing.assert_allclose(got[name], ctl_j[name], atol=1e-5,
                                   err_msg=name)
    # warm starts follow the last WBC solution and carry its f32 noise (see
    # tests/test_torch_wbc.py): joint accelerations reach 250 rad/s^2 here
    # and differ by up to 3 between the two packages
    np.testing.assert_allclose(got["wbc_warm_x"], ctl_j["wbc_warm_x"],
                               atol=10.0)


def test_period_metrics_match_jax(handoff, port_period):
    _, (_, _, met_j) = handoff
    _, _, met_t = port_period
    assert set(met_t) == set(met_j)
    np.testing.assert_allclose(npy(met_t["x_srb"]), met_j["x_srb"], atol=1e-5)
    # torques and ground forces carry the WBC's f32 noise (measured 8e-3 Nm
    # and 0.17 N here; see tests/test_torch_wbc.py for the noise itself)
    np.testing.assert_allclose(npy(met_t["tau_rms"]), met_j["tau_rms"],
                               atol=5e-2)
    np.testing.assert_allclose(npy(met_t["fz_sum"]), met_j["fz_sum"],
                               atol=1.0)
    np.testing.assert_allclose(npy(met_t["wbc_ok_frac"]),
                               met_j["wbc_ok_frac"], atol=0)
    np.testing.assert_allclose(npy(met_t["mpc_prim_res"]),
                               met_j["mpc_prim_res"], atol=1e-3)
    for name in ("tau_rms", "fz_sum", "mpc_prim_res", "mpc_dual_res",
                 "mpc_ok", "wbc_ok_frac"):
        assert tuple(met_t[name].shape) == (B,), name


def _standing(batch, gait="trot", **cfg_kw):
    cfg = EngineConfig(gait=gait, **cfg_kw)
    cc = tengine.CascadeConfigured(SOLO12, cfg)
    q0 = standing_q0(batch)
    gid = np.full((batch,), GAIT_IDS[gait], np.int32)
    ctl = tengine.init_controller(SOLO12, cfg, cc.tree, q0, gid, device="cpu")
    return cc, ctl, PlantState.init(q0, device="cpu"), gid


@pytest.fixture(scope="module")
def trot_rollout():
    cc, ctl, plant, gid = _standing(2)
    cp = ContactParams.default(2, device="cpu")
    cp.mu = tt([0.6, 0.8])
    v = np.tile([[0.3, 0.0, 0.0]], (2, 1)).astype(np.float32)
    return tengine.cascade_rollout(cc, ctl, plant, gid, v, cp, n_periods=6,
                                   device="cpu")


def test_trot_rollout_stays_upright(trot_rollout):
    """Six periods (120 ticks) of closed-loop trot: every MPC solve ok, the
    base within 0.03 m of its reference height, moving forward, metrics
    stacked (B, periods, ...)."""
    ctl, plant, metrics = trot_rollout
    x = npy(metrics["x_srb"])
    assert x.shape == (2, 6, 12)
    assert npy(metrics["mpc_ok"]).all()
    assert npy(metrics["wbc_ok_frac"]).min() == 1.0
    assert np.abs(x[:, :, 2] - SOLO12.h_ref).max() < 0.03
    assert np.abs(x[:, :, 3:5]).max() < 0.15
    assert np.all(npy(plant.q)[:, 0] > 0.001)     # leaving the stand
    assert np.isfinite(npy(plant.q)).all() and np.isfinite(npy(plant.v)).all()
    assert ctl.phase.tolist() == [6, 6]
    # the two friction values give two different trajectories
    assert not np.allclose(x[0], x[1])


SWEEP = [
    # (gait, command, min height, max roll/pitch, min forward progress, then
    # what the JAX cascade gave for this very batch: x after 40 periods and
    # the least wbc_ok_frac of any period).  The bounds are the ones
    # tests/test_cascade_jax.py holds the JAX cascade to over the same 40
    # periods (its gait sweep and its standing test).  The JAX values were
    # measured once on the CPU (jit + vmap of cascade_rollout, mu 0.7): the
    # standing robot creeps 2 cm backwards and the pace loses WBC ticks to the
    # impedance fallback in 6 of 40 periods there too; the port reproduces
    # both.
    ("walk", (0.2, 0.0, 0.0), 0.20, 0.10, 0.05, 0.1051, 1.0),
    ("bound", (0.25, 0.0, 0.0), 0.12, 0.25, 0.07, 0.1657, 1.0),
    ("pace", (0.3, 0.0, 0.0), 0.20, 0.25, 0.05, 0.0895, 0.55),
    ("static", (0.0, 0.0, 0.0), SOLO12.h_ref - 0.01, 0.02, -0.03, -0.0195,
     1.0),
]


@pytest.fixture(scope="module")
def gait_sweep():
    """One batch of four scenarios, one gait each, 40 periods (800 ticks)."""
    cfg = EngineConfig()
    cc = tengine.CascadeConfigured(SOLO12, cfg)
    n = len(SWEEP)
    q0 = standing_q0(n)
    gid = np.array([GAIT_IDS[s[0]] for s in SWEEP], np.int32)
    ctl = tengine.init_controller(SOLO12, cfg, cc.tree, q0, gid, device="cpu")
    plant = PlantState.init(q0, device="cpu")
    v = np.array([s[1] for s in SWEEP], np.float32)
    _, _, metrics = tengine.cascade_rollout(
        cc, ctl, plant, gid, v, ContactParams.default(n, device="cpu"),
        n_periods=40, device="cpu")
    return {k: npy(t) for k, t in metrics.items()}


@pytest.mark.parametrize("i", range(len(SWEEP)), ids=[s[0] for s in SWEEP])
def test_gait_sweep_closed_loop(gait_sweep, i):
    """Mixed gaits in ONE batch, each held to the JAX package's closed-loop
    bounds for that gait."""
    gait, _, min_z, max_rp, min_x, jax_x_end, jax_wbc_ok_min = SWEEP[i]
    x = gait_sweep["x_srb"][i]
    assert np.all(x[:, 2] > min_z), f"{gait} fell (min z {x[:, 2].min():.3f})"
    assert np.abs(x[:, 3:5]).max() < max_rp, f"{gait} attitude blew up"
    assert x[-1, 0] > min_x, f"{gait}: no forward progress"
    assert gait_sweep["mpc_ok"][i].all()
    # 800 ticks of a chaotic closed loop in f32: the two packages ended 5 mm
    # apart on the walk and under 1 mm elsewhere; budget 3 cm, and a worst
    # period that loses at most 6 more WBC ticks than JAX's worst
    assert abs(x[-1, 0] - jax_x_end) < 0.03, (gait, x[-1, 0], jax_x_end)
    assert gait_sweep["wbc_ok_frac"][i].min() >= jax_wbc_ok_min - 0.3


def test_rollout_takes_a_command_profile(trot_rollout):
    """An (B, n_periods, 3) profile equal to the constant command reproduces
    the constant-command rollout bit for bit; a wrong length raises."""
    cc, ctl, plant, gid = _standing(2)
    cp = ContactParams.default(2, device="cpu")
    cp.mu = tt([0.6, 0.8])
    prof = np.tile([[[0.3, 0.0, 0.0]]], (2, 2, 1)).astype(np.float32)
    _, _, metrics = tengine.cascade_rollout(cc, ctl, plant, gid, prof, cp,
                                            n_periods=2, device="cpu")
    assert torch.equal(metrics["x_srb"], trot_rollout[2]["x_srb"][:, :2])
    with pytest.raises(ValueError, match="periods"):
        tengine.cascade_rollout(cc, ctl, plant, gid, prof, cp, n_periods=3,
                                device="cpu")


def test_poisoned_scenario_falls_back_and_stays_alone():
    """Failure policy, per scenario: a NaN command poisons scenario 1's MPC
    and WBC solves; it holds its last plan, falls back to joint impedance and
    its plant stays finite, while scenarios 0 and 2 are bit-identical to a
    run without it."""
    cc, ctl, plant, gid = _standing(3)
    cp = ContactParams.default(3, device="cpu")
    v = np.tile([[0.3, 0.0, 0.0]], (3, 1)).astype(np.float32)
    clean = tengine.cascade_rollout(cc, ctl, plant, gid, v, cp, n_periods=2,
                                    device="cpu")
    v_bad = v.copy()
    v_bad[1] = np.nan
    ctl_b, plant_b, met_b = tengine.cascade_rollout(
        cc, ctl, plant, gid, v_bad, cp, n_periods=2, device="cpu")
    assert npy(met_b["mpc_ok"]).tolist() == [[True, True], [False, False],
                                             [True, True]]
    assert npy(met_b["wbc_ok_frac"])[1].max() == 0.0
    assert torch.isfinite(plant_b.q).all() and torch.isfinite(plant_b.v).all()
    assert torch.isfinite(ctl_b.f_plan).all()
    # the fallback plan is the initial gravity-compensation plan, shifted
    assert torch.equal(ctl_b.f_plan[1], ctl.f_plan[1])
    keep = [0, 2]
    assert torch.equal(plant_b.q[keep], clean[1].q[keep])
    assert torch.equal(ctl_b.f_plan[keep], clean[0].f_plan[keep])


def test_unknown_payload_is_carried_by_the_plant_only():
    cc, ctl, plant, gid = _standing(2, gait="static",
                                    v_ref=(0.0, 0.0, 0.0))
    cp = ContactParams.default(2, device="cpu")
    v = np.zeros((2, 3), np.float32)
    payload = tt([0.0, 0.5])
    known = tengine.cascade_rollout(cc, ctl, plant, gid, v, cp, n_periods=3,
                                    payload=payload, device="cpu")
    unknown = tengine.cascade_rollout(cc, ctl, plant, gid, v, cp, n_periods=3,
                                      payload=payload, payload_known=False,
                                      device="cpu")
    z_known, z_unknown = npy(known[1].q)[:, 2], npy(unknown[1].q)[:, 2]
    # scenario 0 carries nothing: knowing it or not changes nothing
    assert abs(z_known[0] - z_unknown[0]) < 1e-6
    # scenario 1: the unmodelled 0.5 kg makes the base sag further
    assert z_unknown[1] < z_known[1] - 1e-4
    assert np.abs(z_known - SOLO12.h_ref).max() < 0.02


def test_entry_points_default_to_the_gpu_and_raise_without_one():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device exists")
    cc, ctl, plant, gid = _standing(1)
    cp = ContactParams.default(1, device="cpu")
    v = np.zeros((1, 3), np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        tengine.cascade_rollout(cc, ctl, plant, gid, v, cp, n_periods=1)
    with pytest.raises(RuntimeError, match="cuda"):
        tengine.init_controller(SOLO12, cc.cfg, cc.tree, standing_q0(1), gid)


def test_estimator_in_the_loop_raises_by_name():
    """use_estimator=True without an estimator state is refused, naming what
    is missing (the estimator loop itself: tests/test_torch_estimator.py)."""
    cc, ctl, plant, gid = _standing(1)
    cp = ContactParams.default(1, device="cpu")
    with pytest.raises(ValueError, match="EstimatorState"):
        tengine.cascade_period(cc, ctl, plant, torch.as_tensor(gid),
                               torch.zeros(1, 3), cp, use_estimator=True)


def test_run_cli_on_the_cpu(capsys):
    from mpctsid_tpu_torch import run
    rc = run.main(["--cpu", "--seconds", "0.04", "--batch", "2",
                   "--gait", "walk", "--vx", "0.2"])
    out = capsys.readouterr().out
    assert rc == 0 and "device=cpu" in out and "ticks/s" in out
    rc = run.main(["--cpu", "--estimator", "--seconds", "0.02"])
    out = capsys.readouterr().out
    assert rc == 0 and "estimator=True" in out and "fell=False" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            run.main(["--seconds", "0.02"])
