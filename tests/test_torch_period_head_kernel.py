"""The period-head kernel's arithmetic on the CPU: dyn/csrc/period_head.h
(over rbd.h's leg kinematics) built with g++
(`_torch_port_util.build_period_head_harness`: each scenario's warp run lane
after lane between the phases, in order and reversed, from a NaN-filled
slot, with the kernel's C signature less the stream) and driven by the
wrapper's own packing (`cascade.engine.run_period_head`), held against the
plain version (`period_head_reference`); the plain version against the JAX
package's `foot_positions`, `srb_state` and the velocity integrator of its
cascade (mpctsid_tpu/cascade/engine.py) and host (mpctsid_tpu/host.py).

Tolerances.  The header takes the rotations as rbd.h's products and the
angles from the math library where the plain version calls torch.bmm and
PyTorch's atan2 / asin: feet and x_srb within 1e-5 (float32) / 1e-12
(float64) of each output's largest entry, v_int and v_used within 1e-5 /
1e-12 (measured on a CPU: 2.2e-8 in float32 and 0 in float64 for the feet,
0 for the rest).  The lift-off points of feet that stay put are the
inputs' bits, and the lanes' order does not move a bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpctsid_tpu import dyn as jdyn
from mpctsid_tpu.cascade import engine as jengine
from mpctsid_tpu.config import EngineConfig as JEngineConfig
from mpctsid_tpu.model.solo12 import SOLO12 as J_SOLO12
from mpctsid_tpu.model.tree import build_tree as j_build_tree
from mpctsid_tpu_torch.cascade import engine
from mpctsid_tpu_torch.config import EngineConfig
from mpctsid_tpu_torch.dyn import kernels as dk
from mpctsid_tpu_torch.model.solo12 import SOLO12
from mpctsid_tpu_torch.model.tree import build_tree

from _torch_port_util import build_period_head_harness, jj, npy, random_qv

CFG = EngineConfig()
JCFG = JEngineConfig()
TREE = build_tree(SOLO12)
DTYPES = [torch.float32, torch.float64]
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
# an H100's limits: shared memory a block may opt in to, multiprocessors
H100_OPTIN, H100_SMS = 232448, 132


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    return build_period_head_harness(tmp_path_factory.mktemp("period_head"))


def inputs(seed, B, dtype=torch.float32):
    """(q, v, to_swing, liftoff, v_int, v_cmd) of B scenarios: states near
    standing with any yaw, lift-off masks of every kind, integrals on both
    sides of the clamp (|v_int| up to 0.25 against v_int_max 0.2)."""
    q, v = random_qv(seed, B)
    r = np.random.default_rng(seed + 100)
    yaw = r.uniform(-np.pi, np.pi, B)
    quat = q[:, 3:7].astype(np.float64)
    # a yaw turn on top of the small tilt: q = q_yaw * q_tilt (xyzw)
    cz, sz = np.cos(yaw / 2), np.sin(yaw / 2)
    x, y, z, w = quat.T
    q[:, 3:7] = np.stack([cz * x - sz * y, cz * y + sz * x,
                          cz * z + sz * w, cz * w - sz * z], 1)
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype)  # noqa: E731
    to_swing = (r.random((B, 4)) < 0.4).astype(np.float64)
    liftoff = r.normal(size=(B, 4, 3)) * 0.2
    v_int = r.uniform(-0.25, 0.25, (B, 3))
    v_cmd = r.uniform(-0.5, 0.5, (B, 3))
    return (t(q), t(v), t(to_swing), t(liftoff), t(v_int), t(v_cmd))


def rel_err(got, want):
    """Largest |got - want| over the largest |want| (1 where that is 0)."""
    scale = max(float(want.abs().max()), 1.0)
    return float((got.double() - want.double()).abs().max()) / scale


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", [1, 5, 37])
def test_kernel_body_matches_plain(harness, dtype, B):
    args = inputs(B, B, dtype)
    rc, got = engine.run_period_head(harness.launch, TREE, CFG.cascade,
                                     *args)
    assert rc == 0
    want = engine.period_head_reference(TREE, CFG.cascade, *args)
    assert all(g.shape == w.shape and g.dtype == w.dtype
               for g, w in zip(got, want))
    for g, w in zip(got, want):
        assert rel_err(g, w) <= TOL[dtype]
    # feet that do not lift off keep their lift-off point's bits
    stay = args[2] < 0.5
    assert torch.equal(got[2][stay], args[3][stay])
    assert torch.equal(got[2][~stay], got[0][~stay])
    # the integral is clamped and v_used is v_cmd plus it
    bound = torch.tensor(CFG.cascade.v_int_max, dtype=dtype)
    assert bool((got[3].abs() <= bound).all())
    assert torch.equal(got[4], args[5] + got[3])


@pytest.mark.parametrize("dtype", DTYPES)
def test_lanes_in_either_order_give_the_same_bits(harness, dtype):
    args = inputs(3, 9, dtype)
    _, fwd = engine.run_period_head(harness.launch, TREE, CFG.cascade, *args)
    _, rev = engine.run_period_head(harness.launch_reversed, TREE,
                                    CFG.cascade, *args)
    assert all(torch.equal(a, b) for a, b in zip(fwd, rev))


def test_packed_rows_and_bool_mask(harness):
    """Inputs as column slices of one packed buffer (the host path's tick)
    give the contiguous inputs' bits; a bool mask the float mask's."""
    q, v, ts, lo, vi, vc = inputs(4, 6)
    packed = torch.cat([q, v, ts, vc], dim=1)
    _, got = engine.run_period_head(
        harness.launch, TREE, CFG.cascade, packed[:, 0:19], packed[:, 19:37],
        packed[:, 37:41], lo, vi, packed[:, 41:44])
    _, want = engine.run_period_head(harness.launch, TREE, CFG.cascade, q, v,
                                     ts, lo, vi, vc)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    _, from_bool = engine.run_period_head(harness.launch, TREE, CFG.cascade,
                                          q, v, ts > 0.5, lo, vi, vc)
    assert all(torch.equal(a, b) for a, b in zip(from_bool, want))
    ref_bool = engine.period_head_reference(TREE, CFG.cascade, q, v, ts > 0.5,
                                            lo, vi, vc)
    ref = engine.period_head_reference(TREE, CFG.cascade, q, v, ts, lo, vi,
                                       vc)
    assert all(torch.equal(a, b) for a, b in zip(ref_bool, ref))


def test_cpu_wrapper_is_the_plain_version():
    args = inputs(5, 4)
    before = engine.period_head.launches
    got = engine.period_head(TREE, CFG.cascade, *args)
    want = engine.period_head_reference(TREE, CFG.cascade, *args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert engine.period_head.launches == before


def test_wrapper_checks_its_arguments(harness):
    q, v, ts, lo, vi, vc = inputs(6, 3)
    with pytest.raises(ValueError):
        engine.period_head(TREE, CFG.cascade, q, v[:, :17], ts, lo, vi, vc)
    with pytest.raises(ValueError):
        engine.run_period_head(harness.launch, TREE, CFG.cascade, q, v,
                               ts[:, :3], lo, vi, vc)
    with pytest.raises(TypeError):
        engine.run_period_head(harness.launch, TREE, CFG.cascade, q, v,
                               ts, lo.double(), vi, vc)


def test_layout_and_counts(harness):
    """rbd_layout("period_head") on the H100's limits against the header's
    warps_per_block; the slot and the counts against the header's."""
    assert harness.slot_values() == dk.SLOT_VALUES["period_head"]
    want = list(dk.LAYOUT.values()) + list(dk.HEAD_LAYOUT.values())
    assert [harness.layout(i) for i in range(len(want))] == want
    for dtype in DTYPES:
        for B in (1, 37, 131, 132, 133, 1000, 4096, 8193):
            lay = dk.rbd_layout("period_head", B, dtype, H100_OPTIN,
                                H100_SMS)
            assert lay.warps == harness.warps_per_block(
                B, lay.slot_bytes, H100_OPTIN, H100_SMS)
            assert lay.blocks * lay.warps >= B > (lay.blocks - 1) * lay.warps
        assert dk.rbd_layout("period_head", 1, dtype, H100_OPTIN,
                             H100_SMS).warps == 1
        assert dk.rbd_layout("period_head", 4096, dtype, H100_OPTIN,
                             H100_SMS).warps == dk.MAX_WARPS


# ------------------------------------------------ the plain version vs JAX

def test_plain_version_matches_jax_engine():
    """foot_positions and srb_state against the JAX functions (vmapped);
    the lift-off select and the integrator against the JAX cascade's ops
    (mpctsid_tpu/cascade/engine.py:176-197), written out here with jnp on
    the JAX package's own x_srb."""
    q, v, ts, lo, vi, vc = inputs(7, 6)
    feet, x_srb, liftoff, v_int, v_used = engine.period_head_reference(
        TREE, CFG.cascade, q, v, ts > 0.5, lo, vi, vc)
    jtree = j_build_tree(J_SOLO12)
    feet_j = jax.vmap(lambda qq: jdyn.foot_positions(jtree, qq))(jj(npy(q)))
    x_j = jax.vmap(jengine.srb_state)(jj(npy(q)), jj(npy(v)))
    np.testing.assert_allclose(npy(feet), npy(feet_j), atol=2e-6)
    np.testing.assert_allclose(npy(x_srb), npy(x_j), atol=2e-6)

    def integrate(x_srb, v_int, v_cmd):
        cy, sy = jnp.cos(x_srb[5]), jnp.sin(x_srb[5])
        v_meas = jnp.stack([cy * x_srb[6] + sy * x_srb[7],
                            -sy * x_srb[6] + cy * x_srb[7], x_srb[11]])
        t_period = JCFG.cascade.mpc_every * JCFG.cascade.wbc_dt
        return jnp.clip(
            v_int + JCFG.cascade.ki_vint * t_period * (v_cmd - v_meas),
            -JCFG.cascade.v_int_max, JCFG.cascade.v_int_max)

    v_int_j = jax.vmap(integrate)(x_j, jj(npy(vi)), jj(npy(vc)))
    np.testing.assert_allclose(npy(v_int), npy(v_int_j), atol=1e-6)
    np.testing.assert_allclose(npy(v_used), npy(vc) + npy(v_int_j),
                               atol=1e-6)
    lo_j = jnp.where(jj(npy(ts))[..., None] > 0.5, feet_j, jj(npy(lo)))
    np.testing.assert_allclose(npy(liftoff), npy(lo_j), atol=2e-6)


def test_plain_version_matches_jax_host_integrator():
    """The integrator against the JAX host's numpy formula
    (mpctsid_tpu/host.py:281-290) on the JAX package's x_srb, one robot at
    a time as the JAX host runs it."""
    q, v, ts, lo, vi, vc = inputs(8, 4)
    _, _, _, v_int, v_used = engine.period_head_reference(
        TREE, CFG.cascade, q, v, ts, lo, vi, vc)
    for b in range(4):
        xs = np.asarray(jengine.srb_state(jj(npy(q[b])), jj(npy(v[b]))))
        cy, sy = np.cos(xs[5]), np.sin(xs[5])
        v_meas = np.array([cy * xs[6] + sy * xs[7],
                           -sy * xs[6] + cy * xs[7], xs[11]],
                          dtype=np.float32)
        t_period = JCFG.cascade.mpc_every * JCFG.cascade.wbc_dt
        want = np.clip(npy(vi[b]) + JCFG.cascade.ki_vint * t_period
                       * (npy(vc[b]) - v_meas),
                       -JCFG.cascade.v_int_max,
                       JCFG.cascade.v_int_max).astype(np.float32)
        np.testing.assert_allclose(npy(v_int[b]), want, atol=1e-6)
        np.testing.assert_allclose(npy(v_used[b]), npy(vc[b]) + want,
                                   atol=1e-6)
