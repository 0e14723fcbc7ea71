"""The redesigned planner kernels on the CPU: the swing reference over a
period (`plan/swing.py::swing_references_period`, the kernel `plan_swing_at`)
and the reference rollout's pieces (`mpc/srb.py::reference_rollout`, the
kernel `plan_rollout`), through plan/csrc/planner.h built with g++
(`_torch_port_util.build_planner_harness`: the period kernel's blocks,
phases and units one after another from NaN-filled staging; the rollout's
step terms and their ordered prefix glued by an array where the kernel
uses shuffles) and the first designs' header kept in
scripts/probe_planner_designs.py (`build_first_planner_harness`), driven by
the wrappers' own packing.  Then the callers: `cascade_period` takes the
period's references in one call, the host path's WBC graph takes the
reference at its tick.

Bits.  Each kernel repeats its first design's operations in their order:
the period kernel is bit for bit the first design at every tick, and the
redesigned rollout bit for bit the first design's `rollout_step`.  Against
the plain PyTorch versions on this CPU the swing reference's host build is
their bits in float64; in float32, and the rollout in both, it holds the
budgets of tests/test_torch_plan_kernels.py (PyTorch's vectorized sin, cos
and pow on the CPU are not the C library's: an ulp, amplified where the
swing's velocity bracket cancels); on the card, where the plain version
runs PyTorch's CUDA functions, chip_smoke.py phase 3g holds the kernels to
it bit for bit.  Against the JAX engine's per-tick formula the budgets of
tests/test_torch_plan_kernels.py's swing tests.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpctsid_tpu.config import EngineConfig as JEngineConfig
from mpctsid_tpu.plan import gait as jgait
from mpctsid_tpu.plan import swing as jswing
from mpctsid_tpu_torch.cascade import CascadeConfigured, init_controller
from mpctsid_tpu_torch.cascade import engine as tengine
from mpctsid_tpu_torch.config import EngineConfig
from mpctsid_tpu_torch.env.plant import ContactParams, PlantState
from mpctsid_tpu_torch.host import HostController
from mpctsid_tpu_torch.model.gaits import GAIT_IDS
from mpctsid_tpu_torch.model.solo12 import SOLO12
from mpctsid_tpu_torch.mpc import srb as tsrb
from mpctsid_tpu_torch.plan import swing as tswing
from mpctsid_tpu_torch.plan.gait import swing_tables
from mpctsid_tpu_torch.utils.graphs import CapturedCall
from mpctsid_tpu_torch.wbc.tsid import WbcRefs, solve_wbc

from _torch_port_util import (build_first_planner_harness,
                              build_planner_harness, jj, npy, standing_q0)

CFG = EngineConfig()
JCFG = JEngineConfig()
DT, H = CFG.mpc.dt, CFG.cascade.swing_height
TICKS = CFG.cascade.mpc_every
DTYPES = [torch.float32, torch.float64]
# the plain version on this CPU (tests/test_torch_plan_kernels.py): the
# swing reference relative to 1 + |value|, the rollout absolute
SWING_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
ROLL_TOL = {torch.float32: 1e-6, torch.float64: 1e-12}


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    return build_planner_harness(tmp_path_factory.mktemp("planner"))


@pytest.fixture(scope="module")
def first(tmp_path_factory):
    return build_first_planner_harness(
        tmp_path_factory.mktemp("first_planner"))


def swing_inputs(seed, B, dtype):
    """Every gait in turn at phases over three periods, lift-off and
    touchdown points near each other: (gait ids, phases, lift, td)."""
    r = np.random.default_rng(seed)
    lift = r.normal(size=(B, 4, 3)) * 0.1
    return (torch.tensor(np.arange(B) % len(GAIT_IDS), dtype=torch.int32),
            torch.tensor(r.integers(0, 48, B), dtype=torch.int32),
            torch.tensor(lift, dtype=dtype),
            torch.tensor(lift + r.normal(size=(B, 4, 3)) * 0.05,
                         dtype=dtype))


def fractions(T, dtype):
    return torch.tensor(np.arange(T) / T, dtype=dtype)


def rollout_inputs(seed, B, dtype):
    r = np.random.default_rng(seed)
    x = np.zeros((B, 12))
    x[:, 0:2] = r.normal(size=(B, 2)) * 0.5
    x[:, 2] = SOLO12.h_ref
    x[:, 5] = r.uniform(-np.pi, np.pi, B)
    v_cmd = np.stack([r.uniform(-0.5, 0.5, B), r.uniform(-0.3, 0.3, B),
                      r.uniform(-1.0, 1.0, B)], 1)
    return torch.tensor(x, dtype=dtype), torch.tensor(v_cmd, dtype=dtype)


def equal(got, want):
    return all(torch.equal(g, w) for g, w in zip(got, want))


def stacked_ticks(launch, gid, ph, fracs, lift, td):
    """A run_swing_at launcher at each fraction, stacked on axis 1."""
    ticks = []
    for t in range(fracs.shape[0]):
        rc, out = tswing.run_swing_at(launch, gid, ph, fracs[t:t + 1], lift,
                                      td, DT, H)
        assert rc == 0
        ticks.append(out)
    return tuple(torch.stack([k[i] for k in ticks], dim=1) for i in range(3))


@pytest.mark.parametrize("dtype", DTYPES)
def test_period_plain_version_is_the_stacked_ticks(dtype):
    """swing_references_period_reference at fractions (T,), (1, T) and
    (B, T) is swing_reference_at_reference at each tick, bit for bit; the
    CPU entry point is the plain version."""
    gid, ph, lift, td = swing_inputs(0, 15, dtype)
    fr = fractions(TICKS, dtype)
    want = [tswing.swing_reference_at_reference(gid, ph, fr[t:t + 1], lift,
                                                td, DT, H)
            for t in range(TICKS)]
    want = tuple(torch.stack([w[i] for w in want], dim=1) for i in range(3))
    for rows in (fr, fr[None], fr[None].expand(15, TICKS)):
        got = tswing.swing_references_period_reference(gid, ph, rows, lift,
                                                       td, DT, H)
        assert all(g.shape == (15, TICKS, 4, 3) and g.dtype == dtype
                   for g in got)
        assert equal(got, want)
        assert equal(tswing.swing_references_period(gid, ph, rows, lift, td,
                                                    DT, H), want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,T", [(1, 20), (5, 20), (37, 20), (7, 1),
                                 (70, 1), (3, 3), (4, 64), (3, 65), (2, 150)])
def test_period_header_is_the_first_design_at_every_tick(harness, first,
                                                         dtype, B, T):
    """The period kernel's host build (blocks of `swing_block_rows(T)` rows:
    whole scenarios, a scenario over two blocks where T > 64), its units in
    order and reversed, is bit for bit the first design at each tick and
    its own launches at T = 1; the plain version's bits in float64, within
    the swing budget of it in float32."""
    gid, ph, lift, td = swing_inputs(1 + B + T, B, dtype)
    fr = fractions(T, dtype)
    rc, got = tswing.run_swing_period(harness.swing_at, gid, ph, fr, lift,
                                      td, DT, H)
    rc2, rev = tswing.run_swing_period(harness.swing_at_reversed, gid, ph,
                                       fr, lift, td, DT, H)
    assert rc == rc2 == 0
    assert all(g.shape == (B, T, 4, 3) and g.dtype == dtype for g in got)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert equal(got, rev)
    assert equal(got, stacked_ticks(first.swing_at, gid, ph, fr, lift, td))
    assert equal(got, stacked_ticks(harness.swing_at, gid, ph, fr, lift, td))
    plain = tswing.swing_references_period_reference(gid, ph, fr, lift, td,
                                                     DT, H)
    if dtype == torch.float64:
        assert equal(got, plain)
    for g, w in zip(got, plain):
        assert float(((g - w).abs() / (1.0 + w.abs())).max()) < \
            SWING_TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_period_header_rows_of_fractions(harness, dtype):
    """Fractions as one shared row (stride 0) and as a row per scenario
    give the same bits; a row per scenario with other fractions gives each
    scenario its own."""
    gid, ph, lift, td = swing_inputs(2, 9, dtype)
    fr = fractions(TICKS, dtype)
    _, a = tswing.run_swing_period(harness.swing_at, gid, ph, fr, lift, td,
                                   DT, H)
    _, b = tswing.run_swing_period(harness.swing_at, gid, ph,
                                   fr[None].expand(9, TICKS).contiguous(),
                                   lift, td, DT, H)
    assert equal(a, b)
    own = torch.rand(9, 4, generator=torch.Generator().manual_seed(3),
                     dtype=dtype)
    _, c = tswing.run_swing_period(harness.swing_at, gid, ph, own, lift, td,
                                   DT, H)
    for b_ in range(9):
        _, one = tswing.run_swing_period(harness.swing_at, gid[b_:b_ + 1],
                                         ph[b_:b_ + 1], own[b_], lift[b_:b_ + 1],
                                         td[b_:b_ + 1], DT, H)
        assert equal([x[b_:b_ + 1] for x in c], one)


def test_period_matches_the_jax_engines_per_tick_formula():
    """The JAX cascade takes `swing_tables` once a period and evaluates
    `swing_foot_ref` at t / 20 every tick (mpctsid_tpu/cascade/engine.py:
    236-255); the port's period function on the same inputs, float32,
    within test_torch_plan_kernels.py's swing budgets."""
    gid, ph, lift, td = swing_inputs(4, 40, torch.float32)
    got = tswing.swing_references_period(gid, ph, fractions(TICKS,
                                                            torch.float32),
                                         lift, td, DT, H)

    def one(g, p, lo, tdn):
        back, _, dur, _ = jgait.swing_tables(g, p)
        T_swing = dur.astype(jnp.float32) * JCFG.mpc.dt

        def tick(t):
            frac = t.astype(jnp.float32) / JCFG.cascade.mpc_every
            s = jnp.where(dur > 0, (back.astype(jnp.float32) + frac)
                          / jnp.maximum(dur.astype(jnp.float32), 1.0), 0.0)
            return jswing.swing_foot_ref(lo, tdn, s, T_swing,
                                         JCFG.cascade.swing_height)
        return jax.vmap(tick)(jnp.arange(JCFG.cascade.mpc_every))

    want = jax.vmap(one)(jnp.asarray(npy(gid)), jnp.asarray(npy(ph)),
                         jj(npy(lift)), jj(npy(td)))
    _, _, dur, _ = swing_tables(gid, ph)
    live = np.broadcast_to(npy(dur)[:, None, :] > 0, (40, TICKS, 4))
    for g, w, tol in zip(got, want, [1e-6, 1e-5, 1e-4]):
        g, w = npy(g), np.asarray(w)
        assert g.shape == w.shape == (40, TICKS, 4, 3)
        np.testing.assert_allclose(g[live], w[live], atol=tol, rtol=1e-5)
        np.testing.assert_allclose(g[~live], w[~live], atol=tol, rtol=1e-3)


def test_period_argument_checks(harness):
    gid, ph, lift, td = swing_inputs(5, 4, torch.float32)
    fr = fractions(TICKS, torch.float32)
    with pytest.raises(ValueError):
        tswing.run_swing_period(harness.swing_at, gid, ph, fr[None, None],
                                lift, td, DT, H)
    with pytest.raises(ValueError):
        tswing.run_swing_period(harness.swing_at, gid, ph, fr[:0], lift, td,
                                DT, H)
    with pytest.raises(ValueError):
        tswing.run_swing_period(harness.swing_at, gid, ph, fr[None].expand(
            3, TICKS), lift, td, DT, H)
    with pytest.raises(TypeError):
        tswing.run_swing_period(harness.swing_at, gid, ph, fr.double(), lift,
                                td, DT, H)
    with pytest.raises(TypeError):
        tswing.run_swing_period(harness.swing_at, gid.float(), ph, fr, lift,
                                td, DT, H)
    with pytest.raises(TypeError):
        tswing.run_swing_period(harness.swing_at, gid, ph, fr, lift, td,
                                torch.tensor(DT), H)
    with pytest.raises(TypeError):
        tswing.swing_references_period(gid, ph, fr, lift.half(), td, DT, H)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N", [16, 1, 5, 32, 33, 40, 70])
def test_rollout_pieces_are_the_first_design(harness, first, dtype, N):
    """The rollout's pieces (each step's terms from its own yaw, then the
    ordered prefix of the terms; chunks of `rollout_lanes(N)` steps, N
    above 32 in chunks of 32) glued by an array: bit for bit the first
    design's rollout_step, and within the rollout's budget of the plain
    version."""
    B = 11
    x, vc = rollout_inputs(6 + N, B, dtype)
    cfg = dataclasses.replace(CFG.mpc, horizon=N)
    rc, got = tsrb.run_rollout(harness.rollout, SOLO12, cfg, x, vc)
    rc2, want = tsrb.run_rollout(first.rollout, SOLO12, cfg, x, vc)
    assert rc == rc2 == 0
    assert got.shape == (B, N, 12) and got.dtype == dtype
    assert torch.equal(got, want)
    plain = tsrb.reference_rollout_reference(SOLO12, cfg, x, vc)
    assert float((got - plain).abs().max()) < ROLL_TOL[dtype] * max(1, N / 16)


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
    for _ in range(2):
        ctl, plant, _, _ = tengine.cascade_period(cc, ctl, plant, gid_t, v,
                                                  cp)
    return cc, ctl, plant, gid_t, v, cp


def test_cascade_period_takes_the_period_references_once(monkeypatch):
    """cascade_period calls swing_references_period once, before its tick
    loop, and tick t's WBC reads slice [:, t]: the references of the
    per-tick chain at t / 20, bit for bit; swing_reference_at is not
    called."""
    cc, ctl, plant, gid, v, cp = _mid_gait()
    calls, refs = [], []
    shipped = tengine.swing_references_period

    def counted(*a, **kw):
        calls.append(a)
        return shipped(*a, **kw)

    def recorded(tree, cfg, q, v_, r, **kw):
        refs.append(r)
        return solve_wbc(tree, cfg, q, v_, r, **kw)

    def never(*a, **kw):
        raise AssertionError("swing_reference_at called in cascade_period")

    monkeypatch.setattr(tengine, "swing_references_period", counted)
    monkeypatch.setattr(tengine, "solve_wbc", recorded)
    monkeypatch.setattr(tswing, "swing_reference_at", never)
    new_ctl, _, _, _ = tengine.cascade_period(cc, ctl, plant, gid, v, cp)
    assert len(calls) == 1 and len(refs) == TICKS
    swinging = 0
    for t, r in enumerate(refs):
        want = tswing.swing_reference_at_reference(
            gid, ctl.phase, torch.tensor([t / TICKS], dtype=torch.float32),
            new_ctl.liftoff, new_ctl.touchdown, DT, H)
        assert equal((r.foot_pos_ref, r.foot_vel_ref, r.foot_acc_ref), want)
        swinging += int((want[0][..., 2] > 0).sum())
    assert swinging > 0     # mid-gait: some feet are in the air


def _two_call_wbc(ctl, cfg, gid):
    """The tick as two captured calls: the swing reference at the tick into
    a buffer of 36 values, then the WBC on that buffer (what host.py ran
    before the swing reference went into the WBC graph)."""
    wbc_iters, wbc_rounds = cfg.solver.wbc_iters, cfg.solver.wbc_adapt_rounds

    def run(tick, phase, liftoff, touchdown, warm_x, warm_y, out):
        phase = tick[:, 53:54][:, 0].to(torch.int32)
        pos, vel, acc = tswing.swing_reference_at(
            gid, phase, tick[:, 54:55], liftoff, touchdown, cfg.mpc.dt,
            cfg.cascade.swing_height)
        swing = torch.cat([pos.reshape(1, 12), vel.reshape(1, 12),
                           acc.reshape(1, 12)], dim=1)
        refs = WbcRefs(
            contacts=tick[:, 37:41], f_mpc=tick[:, 41:53].reshape(1, 4, 3),
            foot_pos_ref=swing[:, 0:12].reshape(1, 4, 3),
            foot_vel_ref=swing[:, 12:24].reshape(1, 4, 3),
            foot_acc_ref=swing[:, 24:36].reshape(1, 4, 3),
            q_posture=torch.as_tensor(np.asarray(SOLO12.q_stand,
                                                 np.float32))[None],
            base_rpy_ref=torch.zeros((1, 2)),
            h_ref=torch.full((1,), SOLO12.h_ref))
        tau, qdd, _, sol = solve_wbc(ctl.tree, cfg.wbc, tick[:, 0:19],
                                     tick[:, 19:37], refs, iters=wbc_iters,
                                     adapt_rounds=wbc_rounds, warm_x=warm_x,
                                     warm_y=warm_y,
                                     backend=cfg.solver.wbc_backend)
        tau = torch.clamp(tau, -cfg.wbc.tau_max, cfg.wbc.tau_max)
        ok = sol.ok[:, None]
        warm_x.copy_(torch.where(ok, sol.x, warm_x))
        warm_y.copy_(torch.where(ok, sol.y, warm_y))
        out.copy_(torch.cat([tau, qdd, ok.to(tau.dtype)], dim=1))
        return out
    return run


def test_host_controller_captures_three_graphs_and_keeps_the_torques():
    """HostController captures the boundary, MPC and WBC calls (the swing
    reference inside the WBC's); over two periods of closed loop on its
    plant each WBC call's result is the two-call path's on the same
    inputs, bit for bit, the int32 phase the boundary wrote the tick's."""
    from mpctsid_tpu_torch.env.interface import SimPlant
    from mpctsid_tpu_torch.model.tree import build_tree

    cfg = EngineConfig(gait="trot", v_ref=(0.25, 0.0, 0.0))
    q0 = standing_q0(1)[0]
    ctl = HostController(SOLO12, cfg, q0, async_mpc=False, device="cpu")
    graphs = {k: v for k, v in vars(ctl).items()
              if isinstance(v, CapturedCall)}
    assert sorted(graphs) == ["_boundary", "_mpc", "_wbc"]
    gid = torch.full((1,), GAIT_IDS["trot"], dtype=torch.int32)
    two_calls = _two_call_wbc(ctl, cfg, gid)
    shipped = ctl._wbc.fn
    diffs = []

    def both(**inputs):
        copies = {k: t.clone() for k, t in inputs.items()}
        want = two_calls(**copies).clone()
        got = shipped(**inputs)
        tick = inputs["tick"]
        diffs.append(torch.equal(got, want) and torch.equal(
            inputs["phase"], tick[:, 53:54][:, 0].to(torch.int32)))
        return got

    ctl._wbc.fn = both
    plant = SimPlant(build_tree(SOLO12), q0, device="cpu")
    for _ in range(2 * TICKS):
        s = plant.read()
        plant.apply(torch.as_tensor(ctl.compute(s.q.numpy(), s.v.numpy())))
    assert len(diffs) == 2 * TICKS and all(diffs)
    assert float(plant.read().q[2]) > 0.15
