"""The planner kernels' arithmetic on the CPU: plan/csrc/planner.h built
with g++ (`_torch_port_util.build_planner_harness`: each kernel's threads
run one after another, with the kernels' C signature less the stream) and
driven by the wrappers' own packing (`plan.footsteps.run_footsteps`,
`mpc.srb.run_rollout`, `plan.swing.run_swing`, `plan.swing.run_swing_at`),
held against the plain versions and against the JAX functions on
numpy-seeded inputs of four gaits.

Tolerances.  The header writes each expression of the plain version op by
op, but in the card's rounding (a tensor over a Python number is the product
with its reciprocal; sin, cos and pow are the C library's, not PyTorch's
vectorized ones) and the rotations as two products and one sum where the
plain version calls a BLAS: float32 within 1e-6 absolute of the plain
version (positions below 2 m; measured 6e-8), float64 within 1e-12
(measured 6e-17); the swing accelerations (up to 1e5 where T is clamped to
1e-6) relative 1e-6.  Against the JAX functions in float32: the budgets of
tests/test_torch_plan.py (2e-6 for the footsteps; 1e-6 / 1e-5 / 1e-4 and
relative 1e-5 for the swing reference where T > 0; where T = 0 is clamped
to 1e-6, relative 1e-3: there the acceleration's bracket cancels and
ds^2 = 1e12 scales the rounding up).  The swing reference at a tick
(`swing_reference_at`) forms T and s op by op as its plain prelude does:
bit for bit `plan_swing` on the prelude's T and s, over every gait, phase
and tick.  The swing reference's redesign (a block 64 scenarios, its
(scenario, foot) units into staging rows, then the rows copied out) gives
the first design's bits (a thread per (scenario, foot) storing where its
values lie; planner.h kept verbatim in scripts/probe_planner_designs.py,
`build_first_planner_harness`), each block's units in order and reversed
from NaN-filled staging, over one, several and partly filled blocks.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpctsid_tpu.config import EngineConfig as JEngineConfig
from mpctsid_tpu.model.solo12 import SOLO12 as J_SOLO12
from mpctsid_tpu.mpc import srb as jsrb
from mpctsid_tpu.plan import footsteps as jfs
from mpctsid_tpu.plan import gait as jgait
from mpctsid_tpu.plan import swing as jswing
from mpctsid_tpu_torch.config import EngineConfig
from mpctsid_tpu_torch.model.gaits import GAIT_IDS
from mpctsid_tpu_torch.model.solo12 import SOLO12
from mpctsid_tpu_torch.mpc import srb as tsrb
from mpctsid_tpu_torch.plan import footsteps as tfs
from mpctsid_tpu_torch.plan import kernels as pk
from mpctsid_tpu_torch.plan import swing as tswing
from mpctsid_tpu_torch.plan.gait import swing_tables

from _torch_port_util import (build_first_planner_harness,
                              build_planner_harness, jj, npy)

JCFG = JEngineConfig()
CFG = EngineConfig()
GAITS4 = [GAIT_IDS[g] for g in ("trot", "walk", "bound", "pace")]
DTYPES = [torch.float32, torch.float64]
TOL = {torch.float32: 1e-6, torch.float64: 1e-12}


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    return build_planner_harness(tmp_path_factory.mktemp("planner"))


@pytest.fixture(scope="module")
def first(tmp_path_factory):
    return build_first_planner_harness(tmp_path_factory.mktemp("first"))


def inputs(seed, B):
    """numpy float64: the four gaits in turn at phases over three periods,
    states with any yaw, commands, feet near the shoulders, swing phases
    (0 and 1 among them) and durations (0 among them: the clamp)."""
    r = np.random.default_rng(seed)
    x = np.zeros((B, 12))
    x[:, 0:2] = r.normal(size=(B, 2)) * 0.5
    x[:, 2] = SOLO12.h_ref + r.normal(size=B) * 0.01
    x[:, 3:5] = r.normal(size=(B, 2)) * 0.05
    x[:, 5] = r.uniform(-np.pi, np.pi, B)
    x[:, 6:12] = r.normal(size=(B, 6)) * 0.3
    v_cmd = np.stack([r.uniform(-0.5, 0.5, B), r.uniform(-0.3, 0.3, B),
                      r.uniform(-1.0, 1.0, B)], 1)
    feet = x[:, None, 0:3] + SOLO12.shoulder_offsets \
        + r.normal(size=(B, 4, 3)) * 0.02
    feet[:, :, 2] = r.normal(size=(B, 4)) * 0.01
    s = r.uniform(0.0, 1.0, (B, 4))
    s[0] = [0.0, 1.0, 0.5, 0.0]
    T = r.choice([0.0, 0.06, 0.12, 0.2], size=(B, 4))
    return dict(gid=np.array([GAITS4[i % 4] for i in range(B)], np.int32),
                phase=r.integers(0, 48, B).astype(np.int32), x=x,
                v_cmd=v_cmd, feet=feet,
                lift=feet + r.normal(size=(B, 4, 3)) * 0.05,
                td=feet + r.normal(size=(B, 4, 3)) * 0.05, s=s, T=T)


def tick_inputs(seed, dtype):
    """Every (gait, phase over three periods, tick of the period) of the
    swing reference at a tick: gait ids and phases (int32), the ticks'
    fractions t / 20 in `dtype`, lift-off and touchdown points."""
    r = np.random.default_rng(seed)
    g, ph, t = np.meshgrid(np.arange(len(GAIT_IDS)), np.arange(48),
                           np.arange(CFG.cascade.mpc_every), indexing="ij")
    B = g.size
    lift = r.normal(size=(B, 4, 3)) * 0.1
    return (torch.tensor(g.ravel(), dtype=torch.int32),
            torch.tensor(ph.ravel(), dtype=torch.int32),
            torch.tensor(t.ravel() / CFG.cascade.mpc_every, dtype=dtype),
            torch.tensor(lift, dtype=dtype),
            torch.tensor(lift + r.normal(size=(B, 4, 3)) * 0.05,
                         dtype=dtype))


def plain_prelude(gid, phase, t_frac, dtype):
    """The swing reference's per-tick prelude as the cascade and the host
    path ran it before `swing_reference_at`: (s, T)."""
    back, _, dur, _ = swing_tables(gid, phase, dtype)
    s = torch.where(dur > 0, (back + t_frac[:, None])
                    / torch.clamp_min(dur, 1.0), torch.zeros_like(dur))
    return s, dur * CFG.mpc.dt


def tensors(d, dtype):
    t = {k: torch.tensor(a, dtype=dtype) for k, a in d.items()
         if k not in ("gid", "phase")}
    t["gid"] = torch.as_tensor(d["gid"])
    t["phase"] = torch.as_tensor(d["phase"])
    return t


def max_err(got, want):
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def test_layout_counts_match_the_header(harness):
    assert [harness.layout(i) for i in range(len(pk.LAYOUT))] == \
        list(pk.LAYOUT.values())
    assert harness.layout(len(pk.LAYOUT)) == -1
    assert pk.gait_tables("cpu").dtype == torch.int32
    assert pk.gait_tables("cpu").numel() == pk.LAYOUT["table_ints"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_footsteps_header_against_plain(harness, dtype):
    t = tensors(inputs(0, 48), dtype)
    args = (SOLO12, CFG.mpc, CFG.cascade, t["gid"], t["phase"], t["x"],
            t["v_cmd"], t["feet"])
    rc, got = tfs.run_footsteps(harness.footsteps, *args)
    want = tfs.plan_footsteps_horizon_reference(*args)
    assert rc == 0
    assert [g.shape for g in got] == [(48, 16, 4, 3), (48, 4, 3)]
    assert all(g.dtype == dtype for g in got)
    assert max_err(got, want) < TOL[dtype]
    # the z of every planned position is the plain version's (+-0 or 0)
    assert torch.equal(got[0][..., 2], want[0][..., 2])


@pytest.mark.parametrize("dtype", DTYPES)
def test_rollout_header_against_plain(harness, dtype):
    t = tensors(inputs(1, 40), dtype)
    rc, got = tsrb.run_rollout(harness.rollout, SOLO12, CFG.mpc, t["x"],
                               t["v_cmd"])
    want = tsrb.reference_rollout_reference(SOLO12, CFG.mpc, t["x"],
                                            t["v_cmd"])
    assert rc == 0 and got.shape == (40, 16, 12) and got.dtype == dtype
    assert max_err([got], [want]) < TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_swing_header_against_plain(harness, dtype):
    t = tensors(inputs(2, 40), dtype)
    h = CFG.cascade.swing_height
    rc, got = tswing.run_swing(harness.swing, t["lift"], t["td"], t["s"],
                               t["T"], h)
    want = tswing.swing_foot_ref_reference(t["lift"], t["td"], t["s"], t["T"],
                                           h)
    assert rc == 0
    for g, w in zip(got, want):
        assert g.shape == (40, 4, 3) and g.dtype == dtype
        assert float(((g - w).abs() / (1.0 + w.abs())).max()) < TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", [1, 5, 64, 65, 150])
def test_swing_redesign_is_the_first_design(harness, first, dtype, B):
    """The staged swing reference (blocks of 64 scenarios, units in order
    and reversed from NaN-filled staging) bit for bit the first design on the
    same inputs, whole blocks and a partly filled last one."""
    t = tensors(inputs(20 + B, B), dtype)
    h = CFG.cascade.swing_height
    args = (t["lift"], t["td"], t["s"], t["T"], h)
    rc, got = tswing.run_swing(harness.swing, *args)
    rc2, rev = tswing.run_swing(harness.swing_reversed, *args)
    rc3, want = tswing.run_swing(first.swing, *args)
    assert rc == rc2 == rc3 == 0
    for g, r, w in zip(got, rev, want):
        assert g.shape == (B, 4, 3) and torch.isfinite(g).all()
        assert torch.equal(g, w) and torch.equal(r, w)


def test_footsteps_header_against_jax(harness):
    d = inputs(3, 32)
    t = tensors(d, torch.float32)
    rc, got = tfs.run_footsteps(harness.footsteps, SOLO12, CFG.mpc,
                                CFG.cascade, t["gid"], t["phase"], t["x"],
                                t["v_cmd"], t["feet"])
    want = jax.vmap(lambda g, p, x_, vc, ft: jfs.plan_footsteps_horizon(
        J_SOLO12, JCFG.mpc, JCFG.cascade, g, p, x_, vc, ft))(
        jnp.asarray(d["gid"]), jnp.asarray(d["phase"]), jj(d["x"]),
        jj(d["v_cmd"]), jj(d["feet"]))
    assert rc == 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(npy(g), npy(w), atol=2e-6)


def test_rollout_header_against_jax(harness):
    d = inputs(4, 32)
    t = tensors(d, torch.float32)
    rc, got = tsrb.run_rollout(harness.rollout, SOLO12, CFG.mpc, t["x"],
                               t["v_cmd"])
    want = jax.vmap(lambda x_, vc: jsrb.reference_rollout(
        J_SOLO12, JCFG.mpc, x_, vc))(jj(d["x"]), jj(d["v_cmd"]))
    assert rc == 0
    np.testing.assert_allclose(npy(got), npy(want), atol=2e-6)


def test_swing_header_against_jax(harness):
    d = inputs(5, 32)
    t = tensors(d, torch.float32)
    h = CFG.cascade.swing_height
    rc, got = tswing.run_swing(harness.swing, t["lift"], t["td"], t["s"],
                               t["T"], h)
    want = jax.vmap(lambda a, b, c, e: jswing.swing_foot_ref(a, b, c, e, h))(
        jj(d["lift"]), jj(d["td"]), jj(d["s"]), jj(d["T"]))
    assert rc == 0
    live = d["T"] > 0
    for g, w, tol in zip(got, want, [1e-6, 1e-5, 1e-4]):
        np.testing.assert_allclose(npy(g)[live], npy(w)[live], atol=tol,
                                   rtol=1e-5)
        # T = 0 (a stance foot, whose reference the caller masks) divides
        # by the 1e-6 floor: the acceleration's bracket 60 s - 180 s^2 +
        # 120 s^3 cancels to a few ulps of its terms, times ds^2 = 1e12
        np.testing.assert_allclose(npy(g)[~live], npy(w)[~live], atol=tol,
                                   rtol=1e-3)


def test_rows_of_a_packed_buffer_and_a_shared_row(harness):
    """Inputs as the host path hands them over (slices of one packed row,
    B = 1) and one command row shared by every scenario (a leading axis of
    1) give what contiguous per-scenario copies give, bit for bit."""
    d = inputs(6, 8)
    t = tensors(d, torch.float32)
    snap = torch.cat([t["x"][:1], t["feet"][:1].reshape(1, 12),
                      t["v_cmd"][:1]], dim=1)
    packed = (snap[:, 0:12], snap[:, 24:27], snap[:, 12:24].reshape(1, 4, 3))
    assert not packed[1].is_contiguous() or packed[1].stride(0) == 27
    rc, got = tfs.run_footsteps(harness.footsteps, SOLO12, CFG.mpc,
                                CFG.cascade, t["gid"][:1], t["phase"][:1],
                                *packed)
    rc2, want = tfs.run_footsteps(
        harness.footsteps, SOLO12, CFG.mpc, CFG.cascade, t["gid"][:1],
        t["phase"][:1], *(a.contiguous() for a in packed))
    assert rc == rc2 == 0 and all(torch.equal(g, w)
                                  for g, w in zip(got, want))
    shared = t["v_cmd"][:1]
    _, a = tsrb.run_rollout(harness.rollout, SOLO12, CFG.mpc, t["x"], shared)
    _, b = tsrb.run_rollout(harness.rollout, SOLO12, CFG.mpc, t["x"],
                            shared.expand(8, 3).contiguous())
    assert torch.equal(a, b)
    # int64 gait ids and phases are taken as int32
    _, c = tfs.run_footsteps(harness.footsteps, SOLO12, CFG.mpc, CFG.cascade,
                             t["gid"].long(), t["phase"].long(), t["x"],
                             t["v_cmd"], t["feet"])
    _, e = tfs.run_footsteps(harness.footsteps, SOLO12, CFG.mpc, CFG.cascade,
                             t["gid"], t["phase"], t["x"], t["v_cmd"],
                             t["feet"])
    assert all(torch.equal(g, w) for g, w in zip(c, e))


def test_cpu_wrappers_are_the_plain_versions():
    t = tensors(inputs(7, 12), torch.float32)
    args = (SOLO12, CFG.mpc, CFG.cascade, t["gid"], t["phase"], t["x"],
            t["v_cmd"], t["feet"])
    for got, want in (
            (tfs.plan_footsteps_horizon(*args),
             tfs.plan_footsteps_horizon_reference(*args)),
            ([tsrb.reference_rollout(SOLO12, CFG.mpc, t["x"], t["v_cmd"])],
             [tsrb.reference_rollout_reference(SOLO12, CFG.mpc, t["x"],
                                               t["v_cmd"])]),
            (tswing.swing_foot_ref(t["lift"], t["td"], t["s"], t["T"], 0.05),
             tswing.swing_foot_ref_reference(t["lift"], t["td"], t["s"],
                                             t["T"], 0.05))):
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_argument_checks(harness):
    t = tensors(inputs(8, 4), torch.float32)
    with pytest.raises(TypeError):
        tfs.plan_footsteps_horizon(SOLO12, CFG.mpc, CFG.cascade, t["gid"],
                                   t["phase"], t["x"].half(), t["v_cmd"],
                                   t["feet"])
    with pytest.raises(TypeError):
        tfs.run_footsteps(harness.footsteps, SOLO12, CFG.mpc, CFG.cascade,
                          t["gid"].float(), t["phase"], t["x"], t["v_cmd"],
                          t["feet"])
    with pytest.raises(TypeError):
        tsrb.run_rollout(harness.rollout, SOLO12, CFG.mpc, t["x"],
                         t["v_cmd"].double())
    with pytest.raises(ValueError):
        tsrb.run_rollout(harness.rollout, SOLO12, CFG.mpc, t["x"],
                         t["v_cmd"][:3])
    with pytest.raises(TypeError):
        tswing.run_swing(harness.swing, t["lift"], t["td"], t["s"], t["T"],
                         torch.tensor(0.05))
    with pytest.raises(ValueError):
        tswing.run_swing(harness.swing, t["lift"], t["td"],
                         t["s"][:, :3], t["T"], 0.05)


@pytest.mark.parametrize("dtype", DTYPES)
def test_swing_at_header_is_plan_swing_on_the_plain_prelude(harness, dtype):
    """The swing reference at a tick: bit for bit the swing kernel's
    arithmetic on the plain prelude's s and T, at every gait, phase and
    tick; against the plain version within the swing reference's
    tolerance."""
    gid, ph, tf, lift, td = tick_inputs(9, dtype)
    h = CFG.cascade.swing_height
    rc, got = tswing.run_swing_at(harness.swing_at, gid, ph, tf, lift, td,
                                  CFG.mpc.dt, h)
    s, T = plain_prelude(gid, ph, tf, dtype)
    rc2, want = tswing.run_swing(harness.swing, lift, td, s, T, h)
    assert rc == rc2 == 0
    for g, w in zip(got, want):
        assert g.shape == (gid.shape[0], 4, 3) and g.dtype == dtype
        assert torch.equal(g, w)
    # the plain version's s ** 4 and s ** 5 are PyTorch's vectorized
    # powers: an ulp of them, amplified where the velocity's bracket
    # 30 s^2 - 60 s^3 + 30 s^4 cancels near s = 1, parts the float32
    # velocity by 1.5e-6 of 1 + |v| (measured)
    plain = tswing.swing_reference_at_reference(gid, ph, tf, lift, td,
                                                CFG.mpc.dt, h)
    tol = {torch.float32: 1e-5, torch.float64: 1e-12}[dtype]
    for g, w in zip(got, plain):
        assert float(((g - w).abs() / (1.0 + w.abs())).max()) < tol


def test_swing_at_plain_version_against_jax():
    """swing_reference_at_reference against the JAX package's swing_tables
    and swing_foot_ref with the cascade's prelude, in float32: the budgets
    of test_swing_header_against_jax."""
    gid, ph, tf, lift, td = tick_inputs(10, torch.float32)
    h = CFG.cascade.swing_height
    got = tswing.swing_reference_at_reference(gid, ph, tf, lift, td,
                                              CFG.mpc.dt, h)

    def one(g, p, f, lo, tdn):
        back, _, dur, _ = jgait.swing_tables(g, p)
        s = jnp.where(dur > 0, (back + f) / jnp.maximum(dur, 1.0), 0.0)
        return jswing.swing_foot_ref(lo, tdn, s, dur * JCFG.mpc.dt, h)

    want = jax.vmap(one)(jnp.asarray(npy(gid)), jnp.asarray(npy(ph)),
                         jj(npy(tf)), jj(npy(lift)), jj(npy(td)))
    _, _, dur, _ = swing_tables(gid, ph)
    live = npy(dur) > 0
    for g, w, tol in zip(got, want, [1e-6, 1e-5, 1e-4]):
        np.testing.assert_allclose(npy(g)[live], npy(w)[live], atol=tol,
                                   rtol=1e-5)
        np.testing.assert_allclose(npy(g)[~live], npy(w)[~live], atol=tol,
                                   rtol=1e-3)


def test_swing_at_shared_tick_row_and_cpu_wrapper(harness):
    """A tick fraction shared by every scenario (a leading axis of 1, the
    cascade's stride-0 row) gives what a per-scenario copy gives, bit for
    bit; on CPU tensors the entry is its plain version; its arguments are
    checked."""
    gid, ph, tf, lift, td = tick_inputs(11, torch.float32)
    h = CFG.cascade.swing_height
    shared = tf[5:6]
    _, a = tswing.run_swing_at(harness.swing_at, gid, ph, shared, lift, td,
                               CFG.mpc.dt, h)
    _, b = tswing.run_swing_at(harness.swing_at, gid, ph,
                               shared.expand(gid.shape[0]).contiguous(), lift,
                               td, CFG.mpc.dt, h)
    assert all(torch.equal(g, w) for g, w in zip(a, b))
    for frac in (tf, shared, shared[:, None]):
        got = tswing.swing_reference_at(gid, ph, frac, lift, td, CFG.mpc.dt,
                                        h)
        want = tswing.swing_reference_at_reference(gid, ph, frac, lift, td,
                                                   CFG.mpc.dt, h)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(TypeError):
        tswing.run_swing_at(harness.swing_at, gid.float(), ph, tf, lift, td,
                            CFG.mpc.dt, h)
    with pytest.raises(TypeError):
        tswing.run_swing_at(harness.swing_at, gid, ph, tf.double(), lift, td,
                            CFG.mpc.dt, h)
    with pytest.raises(TypeError):
        tswing.run_swing_at(harness.swing_at, gid, ph, tf, lift, td,
                            torch.tensor(CFG.mpc.dt), h)
    with pytest.raises(ValueError):
        tswing.run_swing_at(harness.swing_at, gid, ph, tf, lift[:, :3], td,
                            CFG.mpc.dt, h)
