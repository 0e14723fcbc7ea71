"""The period plan on the CPU: a period boundary's head, footstep plan and
touchdown select in one launch (`cascade.engine.period_plan`, the kernel
`period_plan` of dyn/csrc/period_head.cu), and the footstep horizon's
(step, foot) units it shares with the planner's kernel
(plan/csrc/planner.h's `footstep_unit`, `footsteps_warp`).

The headers are built with g++ (`_torch_port_util.build_period_head_harness`
with its plan phase, `build_planner_harness`; the lanes in order and
reversed, from NaN-filled slots and staging rows) and driven by the
wrappers' own packing (`cascade.engine.run_period_plan`,
`plan.footsteps.run_footsteps`).  The first design of the footsteps (a
thread per (scenario, foot) looping over the horizon) is the planner.h kept
verbatim in scripts/probe_planner_designs.py (`FIRST_PLANNER_H`, built by
`build_first_planner_harness`).  Then the callers: `cascade_period` calls
`period_plan` once a period and the footstep kernel never; the host path's
MPC graph takes the footsteps from the boundary's snapshot.

Bits.  The units repeat the first design's operations in its order, so the
footsteps are its bits on all five gaits, every phase, at N = 16 and 40.  The
plan's head outputs are the plan-off build's bits, and its footsteps the
planner's on the plan's own x_srb, v_used and feet.  Against the plain
version (`period_plan_reference`) the head's tolerances
(tests/test_torch_period_head_kernel.py: 1e-5 / 1e-12 of each output's
largest entry): the footsteps take x_srb's rounding (measured on a CPU at
B = 1 to 200: every output within 1.2e-7 of its largest entry in float32,
5.6e-17 in float64).  The plain version against the JAX engine's
boundary block (mpctsid_tpu/cascade/engine.py:175-201) within the budgets of
tests/test_torch_period_head_kernel.py (2e-6 for the feet, x_srb and
lift-off points, 1e-6 for the integrator) and tests/test_torch_plan.py
(2e-6 for the footsteps).
"""

import dataclasses
import time

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
from mpctsid_tpu.plan import footsteps as jfs
from mpctsid_tpu.plan import gait as jgait
from mpctsid_tpu_torch import host as thost
from mpctsid_tpu_torch.cascade import CascadeConfigured, init_controller
from mpctsid_tpu_torch.cascade import engine
from mpctsid_tpu_torch.config import EngineConfig
from mpctsid_tpu_torch.dyn import kernels as dk
from mpctsid_tpu_torch.env.plant import ContactParams, PlantState
from mpctsid_tpu_torch.model.gaits import GAIT_IDS
from mpctsid_tpu_torch.model.solo12 import SOLO12
from mpctsid_tpu_torch.model.tree import build_tree
from mpctsid_tpu_torch.mpc.srb import (MPC_A_BLOCKS, build_mpc_qp,
                                       reference_rollout)
from mpctsid_tpu_torch.plan import footsteps as tfs
from mpctsid_tpu_torch.plan import kernels as pk
from mpctsid_tpu_torch.plan.gait import contacts_at, contacts_horizon
from mpctsid_tpu_torch.qp.admm import admm_solve

from _torch_port_util import (build_first_planner_harness,
                              build_period_head_harness,
                              build_planner_harness, jj, npy, random_qv,
                              standing_q0)

CFG = EngineConfig()
JCFG = JEngineConfig()
TREE = build_tree(SOLO12)
DTYPES = [torch.float32, torch.float64]
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
N_GAITS = len(GAIT_IDS)


@pytest.fixture(scope="module")
def head(tmp_path_factory):
    return build_period_head_harness(tmp_path_factory.mktemp("period_plan"))


@pytest.fixture(scope="module")
def planner(tmp_path_factory):
    return build_planner_harness(tmp_path_factory.mktemp("plan_units"))


@pytest.fixture(scope="module")
def first(tmp_path_factory):
    return build_first_planner_harness(tmp_path_factory.mktemp("first_plan"))


def inputs(seed, B, dtype=torch.float32):
    """(gait_id, phase, q, v, to_swing, liftoff, touchdown, v_int, v_cmd) of
    B scenarios: every gait id, phases over four periods, states near
    standing with any yaw, lift-off masks of every kind, integrals on both
    sides of the clamp, touchdown points near the feet."""
    q, v = random_qv(seed, B)
    r = np.random.default_rng(seed + 200)
    yaw = r.uniform(-np.pi, np.pi, B)
    cz, sz = np.cos(yaw / 2), np.sin(yaw / 2)
    x, y, z, w = q[:, 3:7].astype(np.float64).T
    q[:, 3:7] = np.stack([cz * x - sz * y, cz * y + sz * x,
                          cz * z + sz * w, cz * w - sz * z], 1)
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype)  # noqa: E731
    gid = torch.as_tensor(np.arange(B) % N_GAITS, dtype=torch.int32)
    phase = torch.as_tensor(r.integers(0, 64, B), dtype=torch.int32)
    return (gid, phase, t(q), t(v),
            t((r.random((B, 4)) < 0.4).astype(np.float64)),
            t(r.normal(size=(B, 4, 3)) * 0.2),
            t(r.normal(size=(B, 4, 3)) * 0.2),
            t(r.uniform(-0.25, 0.25, (B, 3))),
            t(r.uniform(-0.5, 0.5, (B, 3))))


def rel_err(got, want):
    """Largest |got - want| over the largest |want| (1 where that is 0)."""
    scale = max(float(want.abs().max()), 1.0)
    return float((got.double() - want.double()).abs().max()) / scale


def equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------- the g++ builds

@pytest.mark.parametrize("dtype", DTYPES)
def test_lanes_in_either_order_give_the_same_bits(head, dtype):
    args = inputs(1, 11, dtype)
    rc, fwd = engine.run_period_plan(head.plan, SOLO12, TREE, CFG, *args)
    rc2, rev = engine.run_period_plan(head.plan_reversed, SOLO12, TREE, CFG,
                                      *args)
    assert rc == rc2 == 0
    assert equal(fwd, rev)
    assert all(bool(torch.isfinite(t).all()) for t in fwd)


@pytest.mark.parametrize("dtype", DTYPES)
def test_head_outputs_are_the_plan_off_build(head, dtype):
    gid, phase, q, v, ts, lo, td, vi, vc = inputs(2, 23, dtype)
    _, plan = engine.run_period_plan(head.plan, SOLO12, TREE, CFG, gid,
                                     phase, q, v, ts, lo, td, vi, vc)
    _, alone = engine.run_period_head(head.launch, TREE, CFG.cascade, q, v,
                                      ts, lo, vi, vc)
    assert equal(plan[:5], alone)


@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_is_the_planner_on_its_own_head_outputs(head, planner, dtype):
    """fsteps and next_td bit for bit the planner's host build on the
    plan's own x_srb, v_used and feet; the touchdown points the select of
    the plain chain on them."""
    gid, phase, q, v, ts, lo, td, vi, vc = inputs(3, 40, dtype)
    _, got = engine.run_period_plan(head.plan, SOLO12, TREE, CFG, gid, phase,
                                    q, v, ts, lo, td, vi, vc)
    feet, x_srb, _, _, v_used, fsteps, next_td, touchdown = got
    rc, (f_want, td_want) = tfs.run_footsteps(
        planner.footsteps, SOLO12, CFG.mpc, CFG.cascade, gid, phase, x_srb,
        v_used, feet)
    assert rc == 0
    assert torch.equal(fsteps, f_want) and torch.equal(next_td, td_want)
    swing = contacts_at(gid, phase, dtype) < 0.5
    assert torch.equal(touchdown, torch.where(swing[..., None], next_td, td))
    assert bool(swing.any()) and bool((~swing).any())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", [1, 5, 37])
def test_plan_header_against_plain(head, dtype, B):
    args = inputs(B + 4, B, dtype)
    rc, got = engine.run_period_plan(head.plan, SOLO12, TREE, CFG, *args)
    assert rc == 0
    want = engine.period_plan_reference(SOLO12, TREE, CFG, *args)
    assert [g.shape for g in got] == [w.shape for w in want]
    assert all(g.dtype == w.dtype for g, w in zip(got, want))
    for g, w in zip(got, want):
        assert rel_err(g, w) <= TOL[dtype]
    # the z of every planned position is the plain version's (+-0 or 0)
    assert torch.equal(got[5][..., 2], want[5][..., 2])


def test_packed_rows_and_shared_rows(head):
    """Inputs as column slices of one packed buffer (the host path's tick)
    and a gait id shared by every scenario give the contiguous inputs'
    bits."""
    gid, phase, q, v, ts, lo, td, vi, vc = inputs(5, 6)
    packed = torch.cat([q, v, ts, vc], dim=1)
    one = torch.full((1,), 2, dtype=torch.int32)
    _, got = engine.run_period_plan(
        head.plan, SOLO12, TREE, CFG, one, phase, packed[:, 0:19],
        packed[:, 19:37], packed[:, 37:41], lo, td, vi, packed[:, 41:44])
    _, want = engine.run_period_plan(
        head.plan, SOLO12, TREE, CFG, one.expand(6).contiguous(), phase, q,
        v, ts, lo, td, vi, vc)
    assert equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N", [16, 40])
def test_footstep_units_are_the_first_design(planner, first, dtype, N):
    """The units glued on a warp (lanes in order and reversed, chunks of 16
    steps above N = 16) bit for bit the first design's loop, on all five
    gaits and all 16 phases."""
    mpc = dataclasses.replace(CFG.mpc, horizon=N)
    B = N_GAITS * 16
    r = np.random.default_rng(N)
    x = np.zeros((B, 12))
    x[:, 0:2] = r.normal(size=(B, 2)) * 0.5
    x[:, 2] = SOLO12.h_ref
    x[:, 5] = r.uniform(-np.pi, np.pi, B)
    x[:, 6:12] = r.normal(size=(B, 6)) * 0.3
    feet = x[:, None, 0:3] + SOLO12.shoulder_offsets + r.normal(
        size=(B, 4, 3)) * 0.02
    feet[:, :, 2] = r.normal(size=(B, 4)) * 0.01   # some below 0: -0 * 0
    t = lambda a: torch.tensor(a, dtype=dtype)  # noqa: E731
    args = (SOLO12, mpc, CFG.cascade,
            torch.as_tensor(np.repeat(np.arange(N_GAITS), 16),
                            dtype=torch.int32),
            torch.as_tensor(np.tile(np.arange(16), N_GAITS),
                            dtype=torch.int32),
            t(x), t(r.uniform(-0.5, 0.5, (B, 3))), t(feet))
    rc, want = tfs.run_footsteps(first.footsteps, *args)
    assert rc == 0 and want[0].shape == (B, N, 4, 3)
    for fn in (planner.footsteps, planner.footsteps_reversed):
        rc, got = tfs.run_footsteps(fn, *args)
        assert rc == 0 and equal(got, want)


# ------------------------------------------- the plain version vs JAX

def test_plain_version_matches_jax_engine():
    """period_plan_reference against the JAX engine's boundary block
    (mpctsid_tpu/cascade/engine.py:175-201), written out here over its own
    functions and vmapped."""
    gid, phase, q, v, _, lo, td, vi, vc = inputs(6, 10)
    r = np.random.default_rng(7)
    prev = (r.random((10, 4)) < 0.6).astype(np.float32)
    contacts = contacts_at(gid, phase)
    to_swing = (contacts < 0.5) & (torch.as_tensor(prev) > 0.5)
    got = engine.period_plan_reference(SOLO12, TREE, CFG, gid, phase, q, v,
                                       to_swing, lo, td, vi, vc)
    jtree = j_build_tree(J_SOLO12)

    def block(g, ph, q_, v_, prev_c, lo_, td_, vi_, vc_):
        contacts_j = jgait.contacts_at(g, ph).astype(q_.dtype)
        feet_now = jdyn.foot_positions(jtree, q_)
        x_srb = jengine.srb_state(q_, v_)
        ts = (contacts_j < 0.5) & (prev_c > 0.5)
        liftoff = jnp.where(ts[:, None], feet_now, lo_)
        cy, sy = jnp.cos(x_srb[5]), jnp.sin(x_srb[5])
        v_meas = jnp.stack([cy * x_srb[6] + sy * x_srb[7],
                            -sy * x_srb[6] + cy * x_srb[7], x_srb[11]])
        t_period = JCFG.cascade.mpc_every * JCFG.cascade.wbc_dt
        v_int = jnp.clip(
            vi_ + JCFG.cascade.ki_vint * t_period * (vc_ - v_meas),
            -JCFG.cascade.v_int_max, JCFG.cascade.v_int_max)
        v_used = vc_ + v_int
        fsteps, next_td = jfs.plan_footsteps_horizon(
            J_SOLO12, JCFG.mpc, JCFG.cascade, g, ph, x_srb, v_used, feet_now)
        touchdown = jnp.where((contacts_j < 0.5)[:, None], next_td, td_)
        return (feet_now, x_srb, liftoff, v_int, v_used, fsteps, next_td,
                touchdown)

    want = jax.vmap(block)(jnp.asarray(npy(gid)), jnp.asarray(npy(phase)),
                           jj(npy(q)), jj(npy(v)), jj(prev), jj(npy(lo)),
                           jj(npy(td)), jj(npy(vi)), jj(npy(vc)))
    atol = (2e-6, 2e-6, 2e-6, 1e-6, 1e-6, 2e-6, 2e-6, 2e-6)
    for g, w, a in zip(got, want, atol):
        np.testing.assert_allclose(npy(g), np.asarray(w), atol=a)
    assert bool(to_swing.any())


def test_cpu_wrapper_is_the_plain_version():
    args = inputs(8, 4)
    before = engine.period_plan.launches
    got = engine.period_plan(SOLO12, TREE, CFG, *args)
    want = engine.period_plan_reference(SOLO12, TREE, CFG, *args)
    assert equal(got, want)
    assert engine.period_plan.launches == before


def test_wrapper_checks_its_arguments(head):
    gid, phase, q, v, ts, lo, td, vi, vc = inputs(9, 3)
    with pytest.raises(ValueError):
        engine.period_plan(SOLO12, TREE, CFG, gid, phase, q, v[:, :17], ts,
                           lo, td, vi, vc)
    with pytest.raises(ValueError):
        engine.run_period_plan(head.plan, SOLO12, TREE, CFG, gid, phase, q,
                               v, ts, lo, td[:, :3], vi, vc)
    with pytest.raises(TypeError):
        engine.run_period_plan(head.plan, SOLO12, TREE, CFG, gid.float(),
                               phase, q, v, ts, lo, td, vi, vc)
    with pytest.raises(TypeError):
        engine.run_period_plan(head.plan, SOLO12, TREE, CFG, gid, phase, q,
                               v, ts, lo, td.double(), vi, vc)


def test_layout_counts(head):
    """The plan's operand counts and the slot, as the header reports them
    and as dyn/kernels.py and the wrapper pack them."""
    want = list(dk.LAYOUT.values()) + list(dk.HEAD_LAYOUT.values())
    assert [head.layout(i) for i in range(len(want))] == want
    assert head.layout(len(want)) == -1
    assert dk.HEAD_LAYOUT["plan_par"] == 1 + pk.LAYOUT["foot_par"]
    assert head.slot_values() == dk.SLOT_VALUES["period_head"]
    seen = {}

    def spy(dtype, B, consts, ins, stride, outs, par):
        seen.update(ins=len(ins), outs=len(outs), par=len(par))
        return 0

    engine.run_period_plan(spy, SOLO12, TREE, CFG, *inputs(10, 2))
    lay = dk.HEAD_LAYOUT
    assert seen == dict(ins=lay["head_in"] + lay["plan_in"],
                        outs=lay["head_out"] + lay["plan_out"],
                        par=lay["head_par"] + lay["plan_par"])


# ------------------------------------------------------------ the callers

def _mid_gait(B=2):
    cfg = EngineConfig(gait="trot", v_ref=(0.3, 0.0, 0.0))
    cc = CascadeConfigured(SOLO12, cfg)
    q0 = standing_q0(B)
    gid = np.full((B,), GAIT_IDS["trot"], np.int32)
    ctl = init_controller(SOLO12, cfg, cc.tree, q0, gid, device="cpu")
    plant = PlantState.init(q0, device="cpu")
    gid_t = torch.as_tensor(gid)
    v = torch.tensor([cfg.v_ref] * B, dtype=torch.float32)
    cp = ContactParams.default(B, device="cpu")
    return cc, ctl, plant, gid_t, v, cp


def test_cascade_period_calls_period_plan_once(monkeypatch):
    """cascade_period plans through period_plan once a period and never
    through the footstep kernel's wrapper or the period head alone; the
    MPC's QP takes period_plan's footsteps."""
    cc, ctl, plant, gid, v, cp = _mid_gait()
    calls, built = [], []
    shipped = engine.period_plan

    def counted(*a, **kw):
        out = shipped(*a, **kw)
        calls.append(out)
        return out

    def recorded(model, cfg, x0, x_ref, feet, contacts, **kw):
        built.append(feet)
        return build_mpc_qp(model, cfg, x0, x_ref, feet, contacts, **kw)

    def never(*a, **kw):
        raise AssertionError("called in cascade_period")

    monkeypatch.setattr(engine, "period_plan", counted)
    monkeypatch.setattr(engine, "build_mpc_qp", recorded)
    monkeypatch.setattr(tfs, "plan_footsteps_horizon", never)
    monkeypatch.setattr(engine, "period_head", never)
    for _ in range(3):
        ctl, plant, _, _ = engine.cascade_period(cc, ctl, plant, gid, v, cp)
    assert len(calls) == 3 and len(built) == 3
    assert all(torch.equal(c[5], f) for c, f in zip(calls, built))
    assert torch.equal(ctl.touchdown, calls[-1][7])


def _planning_mpc(ctl, cfg, gid):
    """The MPC call as the host path ran it before the footsteps went into
    the boundary's snapshot: it plans them itself from the snapshot's
    x_srb, command and feet."""
    N = cfg.mpc.horizon

    def run(snap, warm_x, warm_y, out):
        x_srb, v_used = snap[:, 0:12], snap[:, 24:27]
        feet = snap[:, 12:24].reshape(1, 4, 3)
        phase = snap[:, 27].to(torch.int32)
        fsteps, _ = tfs.plan_footsteps_horizon(
            SOLO12, cfg.mpc, cfg.cascade, gid, phase, x_srb, v_used, feet)
        x_ref = reference_rollout(SOLO12, cfg.mpc, x_srb, v_used)
        cont = contacts_horizon(gid, phase, N)
        P, q_lin, A, l, u = build_mpc_qp(SOLO12, cfg.mpc, x_srb, x_ref,
                                         fsteps, cont)
        sol = admm_solve(P, q_lin, A, l, u, x0=warm_x, y0=warm_y,
                         iters=cfg.solver.mpc_iters,
                         adapt_rounds=cfg.solver.mpc_adapt_rounds, rho=0.1,
                         backend=cfg.solver.mpc_backend,
                         a_blocks=MPC_A_BLOCKS)
        ok = sol.ok[:, None]
        warm_x.copy_(torch.where(ok, sol.x, warm_x))
        warm_y.copy_(torch.where(ok, sol.y, warm_y))
        out.copy_(torch.cat([sol.x, ok.to(sol.x.dtype)], dim=1))
        return out
    return run


def settle(ctl, seconds=60.0):
    """Async mode: wait until the planner thread has published the solve
    of the current period (a period's plan is consumed from the next one
    on; phase 0's never is)."""
    if not ctl.async_mpc or ctl.phase == 0:
        return
    t0 = time.monotonic()
    while ctl._buf.read_latest()[0] < ctl.phase:
        assert ctl._planner_error is None, ctl._planner_error
        assert time.monotonic() - t0 < seconds, "the planner did not publish"
        time.sleep(1e-3)


@pytest.mark.parametrize("async_mpc", [False, True])
def test_host_mpc_reads_the_snapshots_footsteps(async_mpc):
    """HostController's snapshot holds the boundary's footsteps, which the
    MPC call reads; over the same (q, v) sequence its plans and torques are
    bit for bit those of a controller whose MPC call plans the footsteps
    itself."""
    from mpctsid_tpu_torch.env.interface import SimPlant

    cfg = EngineConfig(gait="trot", v_ref=(0.25, 0.0, 0.0))
    gid = torch.full((1,), GAIT_IDS["trot"], dtype=torch.int32)
    q0 = standing_q0(1)[0]
    new = thost.HostController(SOLO12, cfg, q0, async_mpc=async_mpc,
                               device="cpu")
    old = thost.HostController(SOLO12, cfg, q0, async_mpc=async_mpc,
                               device="cpu")
    assert new._boundary.inputs["out"].shape == (
        1, thost.snap_len(cfg.mpc.horizon))
    assert thost.snap_len(cfg.mpc.horizon) == 220
    old._mpc.fn = _planning_mpc(old, cfg, gid)
    snaps = []
    shipped = new._mpc.fn

    def reading(snap, **kw):
        fsteps = snap[:, thost.SNAP_HEAD:].reshape(1, -1, 4, 3)
        want, _ = tfs.plan_footsteps_horizon(
            SOLO12, cfg.mpc, cfg.cascade, gid, snap[:, 27].to(torch.int32),
            snap[:, 0:12], snap[:, 24:27], snap[:, 12:24].reshape(1, 4, 3))
        snaps.append(torch.equal(fsteps, want))
        return shipped(snap=snap, **kw)

    new._mpc.fn = reading
    plant = SimPlant(build_tree(SOLO12), q0, device="cpu")
    ticks = 3 * cfg.cascade.mpc_every
    taus, plans = [], []
    try:
        for k in range(ticks):
            s = plant.read()
            q, v = s.q.numpy(), s.v.numpy()
            a, b = new.compute(q, v), old.compute(q, v)
            if k % cfg.cascade.mpc_every == 0:
                # both planner threads publish this period's solve before
                # the next boundary, so that both consume the same plans
                settle(new)
                settle(old)
            taus.append(np.array_equal(a, b))
            plans.append(np.array_equal(new.f_plan, old.f_plan))
            plant.apply(torch.as_tensor(a))
    finally:
        new.close()
        old.close()
    assert all(taus) and all(plans)
    assert len(snaps) >= (1 if async_mpc else 3) and all(snaps)
    assert float(plant.read().q[2]) > 0.15
