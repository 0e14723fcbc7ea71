"""Port parity: est/filter.py and the estimator-in-the-loop cascade vs the
JAX package.

The filter: the same random sensor streams (numpy seed) go through JAX's
`estimator_update` under `jax.vmap` and through the port's batched one.  The
loop: the JAX package (jit + vmap of `cascade_period`, `use_estimator=True`)
rolls three scenarios 30 periods from standing, once hint-free and once with
the mocap hint; the port is held to that trajectory, to the bounds
tests/test_estimator.py holds the JAX loop to, and, from JAX's state after
three periods, to JAX's fourth period.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpctsid_tpu.cascade import engine as jengine
from mpctsid_tpu.config import EngineConfig as JEngineConfig
from mpctsid_tpu.env import plant as jplant
from mpctsid_tpu.est import filter as jfilter
from mpctsid_tpu.model.solo12 import SOLO12 as J_SOLO12
from mpctsid_tpu.model.tree import build_tree as j_build_tree
from mpctsid_tpu_torch import interop
from mpctsid_tpu_torch.cascade import engine as tengine
from mpctsid_tpu_torch.config import EngineConfig
from mpctsid_tpu_torch.env.plant import ContactParams, PlantState
from mpctsid_tpu_torch.est import filter as tfilter
from mpctsid_tpu_torch.model.gaits import GAIT_IDS
from mpctsid_tpu_torch.model.solo12 import SOLO12
from mpctsid_tpu_torch.model.tree import build_tree

from _torch_port_util import (fields_to_numpy, jj, npy, random_qv,
                              standing_q0, tt)

JTREE = j_build_tree(J_SOLO12)
TTREE = build_tree(SOLO12)

# mixed contact patterns, one scenario with no stance foot at all
CONTACTS = np.array([[1, 0, 0, 1], [0, 0, 0, 0], [1, 1, 1, 1], [0, 1, 1, 0],
                     [1, 0, 0, 0]], np.float32)


def _sensor_stream(seed, steps, B):
    r = np.random.default_rng(seed)
    gyro = r.normal(size=(steps, B, 3)) * 0.1
    accel = np.array([0.0, 0.0, 9.81]) + r.normal(size=(steps, B, 3)) * 0.05
    accel[:, 3] = 0.0            # a dead accelerometer: the tilt gain is 0
    qj = SOLO12.q_stand + r.normal(size=(steps, B, 12)) * 0.01
    qdj = r.normal(size=(steps, B, 12)) * 0.1
    hint = r.normal(size=(steps, B, 3)) * 0.05
    return [a.astype(np.float32) for a in (gyro, accel, qj, qdj, hint)]


@pytest.mark.parametrize("with_hint", [False, True],
                         ids=["hint_free", "with_hint"])
def test_fifty_updates_match_jax(with_hint):
    """50 updates, each side carrying its own state: quaternion products,
    3x3 rotations and one 15-term Jacobian product per foot, all at unit
    scale; the two f32 runs stay within 2e-5 of each other (measured 3e-6 on
    q, 4e-6 on v)."""
    B = len(CONTACTS)
    gyro, accel, qj, qdj, hint = _sensor_stream(0, 50, B)
    q0 = standing_q0(B)
    upd = jax.jit(jax.vmap(
        lambda st, g, a, q_, qd_, c, h: jfilter.estimator_update(
            JTREE, st, g, a, q_, qd_, c,
            base_pos_hint=h if with_hint else None)))
    st_j = jax.vmap(jfilter.estimator_init)(jj(q0))
    st_t = tfilter.estimator_init(q0, device="cpu")
    for k in range(50):
        st_j = upd(st_j, jj(gyro[k]), jj(accel[k]), jj(qj[k]), jj(qdj[k]),
                   jj(CONTACTS), jj(hint[k]))
        st_t = tfilter.estimator_update(
            TTREE, st_t, tt(gyro[k]), tt(accel[k]), tt(qj[k]), tt(qdj[k]),
            tt(CONTACTS), base_pos_hint=tt(hint[k]) if with_hint else None)
    assert st_t.q.shape == (B, 19) and st_t.v.shape == (B, 18)
    np.testing.assert_allclose(npy(st_t.q), npy(st_j.q), atol=2e-5)
    np.testing.assert_allclose(npy(st_t.v), npy(st_j.v), atol=2e-5)
    if with_hint:
        # the hint overrides x-y only; z stays estimated
        np.testing.assert_array_equal(npy(st_t.q)[:, 0:2], hint[-1][:, 0:2])
        assert np.abs(npy(st_t.q)[:, 2] - hint[-1][:, 2]).min() > 0.05


def test_update_is_per_scenario_and_leaves_its_input_alone():
    """A scenario's update does not depend on its neighbours (the no-stance
    and dead-accelerometer switches are per-scenario masks), and the state
    handed in is not written into."""
    B = len(CONTACTS)
    gyro, accel, qj, qdj, _ = _sensor_stream(1, 1, B)
    q, v = random_qv(3, B)
    st = tfilter.EstimatorState(q=tt(q), v=tt(v))
    q_before, v_before = st.q.clone(), st.v.clone()
    args = [tt(a[0]) for a in (gyro, accel, qj, qdj)] + [tt(CONTACTS)]
    out = tfilter.estimator_update(TTREE, st, *args)
    assert torch.equal(st.q, q_before) and torch.equal(st.v, v_before)
    for b in range(B):
        one = tfilter.estimator_update(
            TTREE, tfilter.EstimatorState(q=st.q[b:b + 1], v=st.v[b:b + 1]),
            *[a[b:b + 1] for a in args])
        np.testing.assert_allclose(npy(one.q), npy(out.q[b:b + 1]), atol=1e-6)
        np.testing.assert_allclose(npy(one.v), npy(out.v[b:b + 1]), atol=1e-6)
    # no stance foot: the velocity is the pure prediction, no odometry blend
    dt = 0.001
    R0 = npy(tfilter.dyn.quat_to_rot(out.q[1:2, 3:7]))[0]
    a_local = accel[0, 1] - R0.T @ np.array([0.0, 0.0, tfilter.GRAV])
    v_pred = v[1, 0:3] + dt * (a_local - np.cross(gyro[0, 1], v[1, 0:3]))
    np.testing.assert_allclose(npy(out.v)[1, 0:3], v_pred, atol=1e-5)


def test_height_estimated_from_stance_kinematics():
    """The JAX package's height test on the port, B = 2 (one scenario with
    the x-y hint, as there; both must converge): started 3 cm high with all
    feet in stance, the kinematic-height blend pulls z back to the standing
    height, and one step does not adopt the hint's z."""
    q_true = standing_q0(2)
    q_bad = q_true.copy()
    q_bad[:, 2] += 0.03
    contacts = torch.ones(2, 4)
    gyro = torch.zeros(2, 3)
    accel = tt(np.tile([0.0, 0.0, 9.81], (2, 1)))
    qj, qdj = tt(q_true[:, 7:]), torch.zeros(2, 12)
    hint = tt(q_true[:, 0:3])
    est = tfilter.estimator_init(q_bad, device="cpu")
    est1 = tfilter.estimator_update(TTREE, est, gyro, accel, qj, qdj,
                                    contacts, base_pos_hint=hint)
    assert np.abs(npy(est1.q)[:, 2] - (SOLO12.h_ref + 0.03)).max() < 0.005
    for _ in range(150):
        est = tfilter.estimator_update(TTREE, est, gyro, accel, qj, qdj,
                                       contacts, base_pos_hint=hint)
    assert np.abs(npy(est.q)[:, 2] - SOLO12.h_ref).max() < 0.003


@pytest.mark.parametrize("with_qdd", [False, True])
def test_imu_from_plant_matches_jax(with_qdd):
    q, v = random_qv(5, 6)
    qdd = np.random.default_rng(6).normal(size=(6, 18)).astype(np.float32)
    if with_qdd:
        want = jax.vmap(lambda q_, v_, a_: jfilter.imu_from_plant(
            JTREE, q_, v_, a_))(jj(q), jj(v), jj(qdd))
        got = tfilter.imu_from_plant(TTREE, tt(q), tt(v), tt(qdd))
    else:
        want = jax.vmap(lambda q_, v_: jfilter.imu_from_plant(
            JTREE, q_, v_))(jj(q), jj(v))
        got = tfilter.imu_from_plant(TTREE, tt(q), tt(v))
    for g, w in zip(got, want):
        assert tuple(g.shape) == (6, 3)
        np.testing.assert_allclose(npy(g), npy(w), atol=2e-6)
    assert tfilter.GRAV == jfilter.GRAV


def test_estimator_init_is_batched_on_an_explicit_device():
    est = tfilter.estimator_init(standing_q0(3), device="cpu")
    assert est.q.shape == (3, 19) and est.v.shape == (3, 18)
    assert est.q.dtype == torch.float32 and not est.v.any()
    with pytest.raises(ValueError, match=r"\(B, 19\)"):
        tfilter.estimator_init(standing_q0(1)[0], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tfilter.estimator_init(standing_q0(1))


# ---------------------------------------------------------------------------
# the estimator in the loop
# ---------------------------------------------------------------------------

B = 3
GAITS = ("trot", "trot", "walk")
GID = np.array([GAIT_IDS[g] for g in GAITS], np.int32)
# scenario 0 is the JAX package's own estimator-loop test (trot, 0.25 m/s,
# friction 0.7)
V_CMD = np.array([[0.25, 0.0, 0.0], [0.3, 0.0, 0.05], [0.2, 0.0, 0.0]],
                 np.float32)
MU = np.array([0.7, 0.5, 0.9], np.float32)
N_PERIODS = 30
HANDOFF = 3


def _params_numpy():
    one = np.ones(B, np.float32)
    return dict(kp_n=8000.0 * one, kd_n=100.0 * one, kp_t=2000.0 * one,
                kd_t=30.0 * one, mu=MU)


def _jax_loop(est_mocap):
    """JAX: 30 periods, one jitted + vmapped `cascade_period`; returns the
    per-period metrics and the (ctl, plant, est) states after each period."""
    cfg = JEngineConfig()
    cc = jengine.CascadeConfigured(J_SOLO12, cfg)
    q0 = jj(standing_q0(B))
    ctl = jax.vmap(lambda q, g: jengine.init_controller(
        J_SOLO12, cfg, cc.tree, q, g))(q0, jnp.asarray(GID))
    plant = jax.vmap(jplant.PlantState.init)(q0)
    est = jax.vmap(jfilter.estimator_init)(q0)
    cp = jplant.ContactParams(**{k: jj(a) for k, a in _params_numpy().items()})
    period = jax.jit(jax.vmap(
        lambda c, p, e, g, v, k: jengine.cascade_period(
            cc, c, p, g, v, k, est=e, use_estimator=True,
            est_mocap=est_mocap)))
    metrics, states = [], []
    for _ in range(N_PERIODS):
        ctl, plant, est, m = period(ctl, plant, est, jnp.asarray(GID),
                                    jj(V_CMD), cp)
        metrics.append({k: npy(v) for k, v in m.items()})
        states.append((ctl, plant, est))
    stacked = {k: np.stack([m[k] for m in metrics], axis=1)
               for k in metrics[0]}
    return stacked, states


def _port_loop(est_mocap):
    cfg = EngineConfig()
    cc = tengine.CascadeConfigured(SOLO12, cfg)
    q0 = standing_q0(B)
    ctl = tengine.init_controller(SOLO12, cfg, cc.tree, q0, GID, device="cpu")
    plant = PlantState.init(q0, device="cpu")
    est = tfilter.estimator_init(q0, device="cpu")
    cp = interop.contact_params_from_numpy(_params_numpy(), device="cpu")
    _, _, metrics = tengine.cascade_rollout(
        cc, ctl, plant, GID, V_CMD, cp, n_periods=N_PERIODS, est=est,
        use_estimator=True, est_mocap=est_mocap, device="cpu")
    return {k: npy(v) for k, v in metrics.items()}


@pytest.fixture(scope="module")
def jax_hint_free():
    return _jax_loop(est_mocap=False)


@pytest.fixture(scope="module")
def port_period_from_jax_state(jax_hint_free):
    """The port's period from JAX's (ctl, plant, est) after HANDOFF periods."""
    ctl_j, plant_j, est_j = jax_hint_free[1][HANDOFF - 1]
    cc = tengine.CascadeConfigured(SOLO12, EngineConfig())
    ctl = interop.controller_state_from_numpy(fields_to_numpy(ctl_j),
                                              device="cpu")
    plant = interop.plant_state_from_numpy(fields_to_numpy(plant_j),
                                           device="cpu")
    est = interop.estimator_state_from_numpy(fields_to_numpy(est_j),
                                             device="cpu")
    cp = interop.contact_params_from_numpy(_params_numpy(), device="cpu")
    est_q_before = est.q.clone()
    out = tengine.cascade_period(cc, ctl, plant, torch.as_tensor(GID),
                                 tt(V_CMD), cp, est=est, use_estimator=True)
    assert torch.equal(est.q, est_q_before)     # the caller's state is kept
    return out


def test_period_on_the_estimate_matches_jax(jax_hint_free,
                                            port_period_from_jax_state):
    """One period (20 estimator updates, WBC solves and plant steps) from the
    same mid-gait state, the controller on the ESTIMATE in both packages.
    Budgets are those of tests/test_torch_cascade.py, for its reason (the
    WBC's f32 noise): plant and estimate q 2e-3, v 5e-2; the MPC plan
    1e-3 N; the drift metric follows q."""
    ctl_t, plant_t, est_t, met_t = port_period_from_jax_state
    ctl_j, plant_j, est_j = jax_hint_free[1][HANDOFF]
    met_j = {k: v[:, HANDOFF] for k, v in jax_hint_free[0].items()}
    np.testing.assert_allclose(npy(ctl_t.f_plan), npy(ctl_j.f_plan),
                               atol=1e-3)
    np.testing.assert_allclose(npy(plant_t.q), npy(plant_j.q), atol=2e-3)
    np.testing.assert_allclose(npy(plant_t.v), npy(plant_j.v), atol=5e-2)
    np.testing.assert_allclose(npy(est_t.q), npy(est_j.q), atol=2e-3)
    np.testing.assert_allclose(npy(est_t.v), npy(est_j.v), atol=5e-2)
    assert set(met_t) == set(met_j) and "est_xy_err" in met_t
    assert tuple(met_t["est_xy_err"].shape) == (B,)
    np.testing.assert_allclose(npy(met_t["est_xy_err"]), met_j["est_xy_err"],
                               atol=2e-3)
    # x_srb is read from the estimate at the start of the period: the same
    # numbers went in on both sides
    np.testing.assert_allclose(npy(met_t["x_srb"]), met_j["x_srb"], atol=1e-5)
    assert npy(met_t["mpc_ok"]).all() and npy(met_t["wbc_ok_frac"]).min() == 1


def test_period_without_the_estimator_has_no_drift_metric():
    cc = tengine.CascadeConfigured(SOLO12, EngineConfig())
    q0 = standing_q0(1)
    ctl = tengine.init_controller(SOLO12, cc.cfg, cc.tree, q0, GID[:1],
                                  device="cpu")
    plant = PlantState.init(q0, device="cpu")
    cp = ContactParams.default(1, device="cpu")
    est = tfilter.estimator_init(q0, device="cpu")
    # an estimate that is handed in but not used is handed back untouched
    _, _, est_out, met = tengine.cascade_period(
        cc, ctl, plant, torch.as_tensor(GID[:1]), tt(V_CMD[:1]), cp, est=est)
    assert est_out is est and "est_xy_err" not in met


@pytest.mark.parametrize("est_mocap", [False, True],
                         ids=["hint_free", "mocap"])
def test_thirty_period_loop_on_the_estimate(est_mocap, request):
    """0.6 s of closed loop on the estimated state.  Scenario 0 is held to
    the bounds tests/test_estimator.py gives the JAX loop (upright, forward
    progress, hint-free drift under 6.5 cm, mocap drift under 5 mm), every
    scenario to JAX's own trajectory: two f32 runs of a chaotic loop, 600
    ticks; budget 3 cm on x and y, 1 cm on z, 2 cm on the drift (measured
    under 5 mm, 1 mm and 3 mm)."""
    met_j = (request.getfixturevalue("jax_hint_free")[0] if not est_mocap
             else _jax_loop(est_mocap=True)[0])
    met_t = _port_loop(est_mocap)
    x, xj = met_t["x_srb"], met_j["x_srb"]
    assert x.shape == (B, N_PERIODS, 12)
    assert met_t["est_xy_err"].shape == (B, N_PERIODS)
    assert np.all(x[0, :, 2] > 0.15), "fell on the estimated state"
    assert x[0, -1, 0] > 0.02, "no forward progress"
    drift = met_t["est_xy_err"]
    assert drift[0].max() < (0.005 if est_mocap else 0.065), drift[0].max()
    if not est_mocap:
        assert drift[0, -1] > 1e-4       # hint-free: the frame does drift
    assert met_t["mpc_ok"].all()
    np.testing.assert_allclose(x[:, -1, 0:2], xj[:, -1, 0:2], atol=0.03)
    np.testing.assert_allclose(x[:, :, 2], xj[:, :, 2], atol=0.01)
    np.testing.assert_allclose(drift, met_j["est_xy_err"], atol=0.02)
    assert np.array_equal(met_t["wbc_ok_frac"].min(axis=1) == 1.0,
                          met_j["wbc_ok_frac"].min(axis=1) == 1.0)
