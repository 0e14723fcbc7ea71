"""Port parity: plan/ (gait tables, footsteps, swing) vs the JAX functions.

Table gathers are exact; the planners are short closed-form chains in f32
(positions < 1 m), so 1e-6 absolute holds; swing accelerations reach ~1e2
m/s^2, hence 1e-4 there.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from mpctsid_tpu.config import EngineConfig as JEngineConfig
from mpctsid_tpu.model.solo12 import SOLO12 as J_SOLO12
from mpctsid_tpu.plan import footsteps as jfs
from mpctsid_tpu.plan import gait as jgait
from mpctsid_tpu.plan import swing as jswing
from mpctsid_tpu_torch.config import EngineConfig
from mpctsid_tpu_torch.model.solo12 import SOLO12
from mpctsid_tpu_torch.plan import footsteps as tfs
from mpctsid_tpu_torch.plan import gait as tgait
from mpctsid_tpu_torch.plan import swing as tswing

from _torch_port_util import jj, npy, tt

JCFG = JEngineConfig()
CFG = EngineConfig()

# every (gait, phase) pair, phases running past one period
GID = np.repeat(np.arange(5), 20).astype(np.int32)
PHASE = np.tile(np.arange(20), 5).astype(np.int32)


def test_contacts_at_all_gaits_and_phases():
    want = jax.vmap(jgait.contacts_at)(jnp.asarray(GID), jnp.asarray(PHASE))
    got = tgait.contacts_at(torch.as_tensor(GID), torch.as_tensor(PHASE))
    assert got.dtype == torch.float32 and got.shape == (100, 4)
    np.testing.assert_array_equal(npy(got), npy(want))


def test_contacts_horizon_all_gaits_and_phases():
    want = jax.vmap(lambda g, p: jgait.contacts_horizon(g, p, 17))(
        jnp.asarray(GID), jnp.asarray(PHASE))
    got = tgait.contacts_horizon(torch.as_tensor(GID),
                                 torch.as_tensor(PHASE), 17)
    assert got.shape == (100, 17, 4)
    np.testing.assert_array_equal(npy(got), npy(want))


def test_swing_tables_all_gaits_and_phases():
    want = jax.vmap(jgait.swing_tables)(jnp.asarray(GID), jnp.asarray(PHASE))
    got = tgait.swing_tables(torch.as_tensor(GID), torch.as_tensor(PHASE))
    for name, g, w in zip(["back", "fwd", "dur", "stance"], got, want):
        np.testing.assert_array_equal(npy(g), npy(w), err_msg=name)


def test_index_dtypes_int64_and_int32_agree():
    a = tgait.contacts_at(torch.as_tensor(GID).long(),
                          torch.as_tensor(PHASE).long())
    b = tgait.contacts_at(torch.as_tensor(GID), torch.as_tensor(PHASE))
    assert torch.equal(a, b)


def _plan_inputs(seed, B):
    r = np.random.default_rng(seed)
    x = np.zeros((B, 12))
    x[:, 0:2] = r.normal(size=(B, 2)) * 0.3
    x[:, 2] = SOLO12.h_ref + r.normal(size=B) * 0.01
    x[:, 3:6] = r.normal(size=(B, 3)) * 0.1
    x[:, 6:9] = r.normal(size=(B, 3)) * 0.2
    x[:, 9:12] = r.normal(size=(B, 3)) * 0.2
    v_cmd = np.stack([r.uniform(-0.5, 0.5, B), r.uniform(-0.2, 0.2, B),
                      r.uniform(-0.5, 0.5, B)], 1)
    feet = SOLO12.shoulder_offsets[None] + r.normal(size=(B, 4, 3)) * 0.03
    feet[:, :, 0:2] += x[:, None, 0:2]
    gid = r.integers(0, 5, size=B).astype(np.int32)
    phase = r.integers(0, 40, size=B).astype(np.int32)
    return (x.astype(np.float32), v_cmd.astype(np.float32),
            feet.astype(np.float32), gid, phase)


def test_raibert_touchdown():
    B = 6
    x, v_cmd, _, _, _ = _plan_inputs(0, B)
    r = np.random.default_rng(1)
    t_stance = r.uniform(0.1, 0.3, size=(B, 4)).astype(np.float32)
    vref = (r.normal(size=(B, 3)) * 0.3).astype(np.float32)
    want = jax.vmap(lambda p, yaw, v, vr, wz, ts: jfs.raibert_touchdown(
        J_SOLO12, JCFG.cascade, p, yaw, v, vr, wz, ts))(
            jj(x[:, 0:3]), jj(x[:, 5]), jj(x[:, 6:9]), jj(vref),
            jj(v_cmd[:, 2]), jj(t_stance))
    got = tfs.raibert_touchdown(SOLO12, CFG.cascade, tt(x[:, 0:3]),
                                tt(x[:, 5]), tt(x[:, 6:9]), tt(vref),
                                tt(v_cmd[:, 2]), tt(t_stance))
    assert got.shape == (B, 4, 3)
    np.testing.assert_allclose(npy(got), npy(want), atol=1e-6)


def test_plan_footsteps_horizon_mixed_gaits():
    B = 12
    x, v_cmd, feet, gid, phase = _plan_inputs(2, B)
    want_f, want_td = jax.vmap(lambda g, p, x_, vc, ft:
                               jfs.plan_footsteps_horizon(
                                   J_SOLO12, JCFG.mpc, JCFG.cascade,
                                   g, p, x_, vc, ft))(
        jnp.asarray(gid), jnp.asarray(phase), jj(x), jj(v_cmd), jj(feet))
    got_f, got_td = tfs.plan_footsteps_horizon(
        SOLO12, CFG.mpc, CFG.cascade, torch.as_tensor(gid),
        torch.as_tensor(phase), tt(x), tt(v_cmd), tt(feet))
    assert got_f.shape == (B, 16, 4, 3) and got_td.shape == (B, 4, 3)
    np.testing.assert_allclose(npy(got_f), npy(want_f), atol=2e-6)
    np.testing.assert_allclose(npy(got_td), npy(want_td), atol=2e-6)


def test_swing_foot_ref():
    B = 7
    r = np.random.default_rng(3)
    lo = (r.normal(size=(B, 4, 3)) * 0.2).astype(np.float32)
    td = (lo + r.normal(size=(B, 4, 3)) * 0.1).astype(np.float32)
    s = r.uniform(0.0, 1.0, size=(B, 4)).astype(np.float32)
    s[0] = [0.0, 1.0, 0.5, 0.0]
    T = r.choice([0.0, 0.08, 0.16], size=(B, 4)).astype(np.float32)
    want = jax.vmap(lambda a, b, c, d: jswing.swing_foot_ref(a, b, c, d, 0.05))(
        jj(lo), jj(td), jj(s), jj(T))
    got = tswing.swing_foot_ref(tt(lo), tt(td), tt(s), tt(T), 0.05)
    for name, g, w, tol in zip(["pos", "vel", "acc"], got, want,
                               [1e-6, 1e-5, 1e-4]):
        # T = 0 (stance) rows divide by the 1e-6 floor: compare relatively
        np.testing.assert_allclose(npy(g), npy(w), atol=tol, rtol=1e-5,
                                   err_msg=name)
