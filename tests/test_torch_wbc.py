"""Port parity: wbc/tsid.py (batched PyTorch) vs the JAX functions, on
mid-gait-like ticks: random states near standing, mixed contact patterns,
swing references and an MPC force plan.
"""

import numpy as np
import pytest
import torch

import jax

from mpctsid_tpu.config import EngineConfig as JEngineConfig
from mpctsid_tpu.model.solo12 import SOLO12 as J_SOLO12
from mpctsid_tpu.model.tree import build_tree as j_build_tree
from mpctsid_tpu.wbc import tsid as jtsid
from mpctsid_tpu_torch import dyn as tdyn
from mpctsid_tpu_torch.config import EngineConfig
from mpctsid_tpu_torch.model.solo12 import SOLO12
from mpctsid_tpu_torch.model.tree import build_tree
from mpctsid_tpu_torch.wbc import tsid as ttsid

from _torch_port_util import jj, npy, tt

JCFG = JEngineConfig()
CFG = EngineConfig()
JTREE = j_build_tree(J_SOLO12)
TTREE = build_tree(SOLO12)
FIELDS = ["contacts", "f_mpc", "foot_pos_ref", "foot_vel_ref", "foot_acc_ref",
          "q_posture", "base_rpy_ref", "h_ref"]


@pytest.fixture(scope="module")
def ticks():
    """REAL mid-gait WBC ticks: (q, v, refs, warm_x, warm_y, payload) captured
    from the port's own closed loop (trot / walk / bound / pace, third MPC
    period, ticks 0, 7 and 15), so the QPs cover stance/swing transitions and
    mid-swing references with a consistent warm start.  Random unphysical
    ticks are no use here: their QPs have flat directions along which two f32
    runs of a 40-iteration solver legitimately sit metres/s^2 apart."""
    from mpctsid_tpu_torch.cascade import engine
    from mpctsid_tpu_torch.env.plant import ContactParams, PlantState
    from mpctsid_tpu_torch.model.gaits import GAIT_IDS
    from _torch_port_util import standing_q0

    cfg = EngineConfig(v_ref=(0.25, 0.0, 0.0))
    cc = engine.CascadeConfigured(SOLO12, cfg)
    gid = np.array([GAIT_IDS[g] for g in ("trot", "walk", "bound", "pace")],
                   np.int32)
    q0 = standing_q0(4)
    ctl = engine.init_controller(SOLO12, cfg, cc.tree, q0, gid, device="cpu")
    plant = PlantState.init(q0, device="cpu")
    cp = ContactParams.default(4, device="cpu")
    captured = []
    orig = engine.solve_wbc

    def hook(tree, cfgw, q, v, refs, **kw):
        captured.append((q, v, refs, kw["warm_x"], kw["warm_y"]))
        return orig(tree, cfgw, q, v, refs, **kw)

    engine.solve_wbc = hook
    try:
        engine.cascade_rollout(cc, ctl, plant, gid,
                               np.tile([[0.25, 0.0, 0.0]], (4, 1)), cp,
                               n_periods=3, device="cpu")
    finally:
        engine.solve_wbc = orig
    picks = [captured[40 + t] for t in (0, 7, 15)]
    cat = lambda xs: np.concatenate([npy(x) for x in xs])  # noqa: E731
    q = cat([p[0] for p in picks])
    v = cat([p[1] for p in picks])
    refs = {k: cat([getattr(p[2], k) for p in picks]) for k in FIELDS}
    wx = cat([p[3] for p in picks])
    wy = cat([p[4] for p in picks])
    r = np.random.default_rng(1)
    payload = r.uniform(0.0, 0.4, size=len(q)).astype(np.float32)
    return q, v, refs, wx, wy, payload


B = 12


def _jrefs(refs):
    return jtsid.WbcRefs(**{k: jj(refs[k]) for k in FIELDS})


def _trefs(refs):
    return ttsid.WbcRefs(**{k: tt(refs[k]) for k in FIELDS})


@pytest.mark.parametrize("with_payload", [False, True])
def test_build_wbc_qp(ticks, with_payload):
    """Entries are sums of cancelling terms as large as the array's largest
    (H: 1e6 ridge, kp J'J ~1e3; g ~1e4), so the absolute tolerance is a few
    f32 ulp of each array's own scale."""
    from mpctsid_tpu import dyn as jdyn
    q, v, refs, _, _, payload = ticks
    if with_payload:
        want = jax.vmap(lambda q_, v_, r_, m: jtsid.build_wbc_qp(
            JTREE, JCFG.wbc, q_, v_, r_,
            extra_base_inertia=jdyn.point_mass_spatial(m)))(
                jj(q), jj(v), _jrefs(refs), jj(payload))
        got = ttsid.build_wbc_qp(
            TTREE, CFG.wbc, tt(q), tt(v), _trefs(refs),
            extra_base_inertia=tdyn.point_mass_spatial(tt(payload)))
    else:
        want = jax.vmap(lambda q_, v_, r_: jtsid.build_wbc_qp(
            JTREE, JCFG.wbc, q_, v_, r_))(jj(q), jj(v), _jrefs(refs))
        got = ttsid.build_wbc_qp(TTREE, CFG.wbc, tt(q), tt(v), _trefs(refs))
    names = ["H", "g", "A", "l", "u", "M", "h", "JcT"]
    shapes = [(B, 30, 30), (B, 30), (B, 50, 30), (B, 50), (B, 50),
              (B, 18, 18), (B, 18), (B, 18, 12)]
    for name, shape, g, w in zip(names, shapes, got, want):
        assert tuple(g.shape) == shape, name
        w = npy(w)
        finite = np.abs(w) < 1e19
        scale = max(np.abs(w[finite]).max(), 1.0)
        np.testing.assert_allclose(npy(g), w, atol=2e-6 * scale, rtol=1e-5,
                                   err_msg=name)
    # equality rows are where the JAX package puts them: l == u on the base
    # dynamics rows and on stance-contact rows only
    l, u = npy(got[3]), npy(got[4])
    assert np.all(l[:, :6] == u[:, :6])
    stance_rows = np.repeat(refs["contacts"] > 0.5, 3, axis=1)
    assert np.all((l[:, 38:] == u[:, 38:]) == stance_rows)


def test_solve_wbc_matches_jax_on_cascade_ticks(ticks):
    """The production budget (40 iterations, 3 adapt rounds), warm-started as
    the cascade does.  Two f32 runs of the fixed-iteration solver differ by
    reduction order, amplified by the cond~1e5 KKT inverse.  On these very
    ticks the JAX package differs from ITSELF (vmapped vs single-scenario
    lowering) by up to 5.9e-2 Nm, median 8e-3, and both packages sit up to
    1e-1 Nm from a float64 run of the same algorithm; the port measured
    5.9e-2 max, 1.2e-2 median against vmapped JAX.  The noise is chaotic (it
    changes with the CPU's summation order), so the budget is twice the
    float64 distance: 0.2 Nm max (7 % of tau_max) and 3e-2 Nm median.  What
    this noise does to the closed loop is bounded by
    tests/test_torch_cascade.py."""
    q, v, refs, wx, wy, _ = ticks
    kw = dict(iters=40, adapt_rounds=3)
    j_solve = jax.jit(jax.vmap(lambda q_, v_, r_, wx_, wy_: jtsid.solve_wbc(
        JTREE, JCFG.wbc, q_, v_, r_, warm_x=wx_, warm_y=wy_, **kw)))
    tau_j, qdd_j, f_j, sol_j = j_solve(jj(q), jj(v), _jrefs(refs),
                                       jj(wx), jj(wy))
    tau_t, qdd_t, f_t, sol_t = ttsid.solve_wbc(
        TTREE, CFG.wbc, tt(q), tt(v), _trefs(refs),
        warm_x=tt(wx), warm_y=tt(wy), backend="xla", **kw)
    assert tau_t.shape == (B, 12) and f_t.shape == (B, 4, 3)
    assert qdd_t.shape == (B, 18)
    d_tau = np.abs(npy(tau_t) - npy(tau_j)).max(axis=1)
    assert d_tau.max() < 0.2 and np.median(d_tau) < 3e-2, d_tau
    # forces of ~10 N ride the same flat directions: measured 0.38 N max
    np.testing.assert_allclose(npy(f_t), npy(f_j), atol=1.0)
    assert npy(sol_t.ok).all() and npy(sol_j.ok).all()


@pytest.fixture
def jax_kernels_interpreted(monkeypatch):
    """The JAX `solve_wbc` passes `backend` to `admm_solve` but has no switch
    for Pallas interpret mode; on the CPU its kernels run only interpreted.
    The switch is set from outside, in this test process: nothing in the JAX
    package changes."""
    import functools

    from mpctsid_tpu.qp import admm as jadmm
    monkeypatch.setattr(jtsid, "admm_solve", functools.partial(
        jadmm.admm_solve, backend_interpret=True))


@pytest.mark.parametrize("backend", ["pallas_vpu", "pallas_packed", "fused",
                                     "pallas"])
def test_solve_wbc_kernel_backend_matches_jax_same_backend(
        ticks, jax_kernels_interpreted, backend):
    """The production budget on the cascade's own ticks, the same backend on
    both sides (JAX: the Pallas kernel interpreted; the port: the plain
    version of its CUDA kernel), under the JAX spelling of the name.  The
    budget comes from the WBC's f32 noise, as for the plain backends above,
    not from the backend.  Measured max / median |dtau|: pallas_vpu and
    pallas_packed 5.4e-2 / 2.2e-2, fused 1.2e-1 / 1.6e-2 Nm, max |df| 0.54 N;
    the noise is chaotic, so the budget is 0.2 Nm max (as above) and 5e-2 Nm
    median (twice the largest measured)."""
    q, v, refs, wx, wy, _ = ticks
    kw = dict(iters=40, adapt_rounds=3, backend=backend)
    j_solve = jax.jit(jax.vmap(lambda q_, v_, r_, wx_, wy_: jtsid.solve_wbc(
        JTREE, JCFG.wbc, q_, v_, r_, warm_x=wx_, warm_y=wy_, **kw)))
    tau_j, _, f_j, sol_j = j_solve(jj(q), jj(v), _jrefs(refs), jj(wx), jj(wy))
    tau_t, _, f_t, sol_t = ttsid.solve_wbc(
        TTREE, CFG.wbc, tt(q), tt(v), _trefs(refs),
        warm_x=tt(wx), warm_y=tt(wy), **kw)
    d_tau = np.abs(npy(tau_t) - npy(tau_j)).max(axis=1)
    assert d_tau.max() < 0.2 and np.median(d_tau) < 5e-2, d_tau
    np.testing.assert_allclose(npy(f_t), npy(f_j), atol=1.0)
    assert npy(sol_t.ok).all() and npy(sol_j.ok).all()


@pytest.mark.parametrize("backend", ["vpu", "packed", "fused", "auto", "mma",
                                     "pallas"])
def test_solve_wbc_kernel_backend_matches_plain_backend(ticks, backend):
    """Within the port: a kernel backend against the plain one on the same
    ticks, same noise budget.  On CPU tensors "auto" IS the plain backend."""
    q, v, refs, wx, wy, _ = ticks
    args = (TTREE, CFG.wbc, tt(q), tt(v), _trefs(refs))
    kw = dict(iters=40, adapt_rounds=3, warm_x=tt(wx), warm_y=tt(wy))
    tau_p, _, _, sol_p = ttsid.solve_wbc(*args, backend="torch", **kw)
    tau_k, _, _, sol_k = ttsid.solve_wbc(*args, backend=backend, **kw)
    d_tau = (tau_k - tau_p).abs().amax(dim=1)
    if backend == "auto":
        assert float(d_tau.max()) == 0.0
    assert float(d_tau.max()) < 0.2 and float(d_tau.median()) < 5e-2, d_tau
    assert bool(sol_k.ok.all())


def test_solve_wbc_kernel_backends_raise_by_name(ticks):
    """The M2 backends stay refused here, with the reason: the WBC QP has
    equality rows.  (The kernels that serve it are covered above.)"""
    q, v, refs = ticks[:3]
    for backend in ("m2", "pallas_m2", "auto_mpc"):
        with pytest.raises(ValueError, match="equality rows"):
            ttsid.solve_wbc(TTREE, CFG.wbc, tt(q), tt(v), _trefs(refs),
                            backend=backend)
    with pytest.raises(ValueError, match="unknown backend"):
        ttsid.solve_wbc(TTREE, CFG.wbc, tt(q), tt(v), _trefs(refs),
                        backend="cublas")


# ---------------------------------------------------- the float64 parity tier

N_ORACLE_TICKS = 12


@pytest.fixture(scope="module")
def oracle_ticks():
    """(q, v, refs, oracle_tau) of the first ticks of the float64 oracle
    cascade's trot from standing (tests/test_wbc_jax.py's fixture, cut to
    N_ORACLE_TICKS ticks), numpy float64."""
    import mpctsid_tpu.oracle.cascade as ocas
    from mpctsid_tpu.oracle.cascade import OracleController
    from mpctsid_tpu.oracle.sim import SimState, step as o_step

    captured = []
    orig = ocas.solve_wbc

    def hook(tree, cfgw, q, v, refs, **kw):
        out = orig(tree, cfgw, q, v, refs, **kw)
        captured.append((q.copy(), v.copy(), refs, out[0].copy()))
        return out

    ocas.solve_wbc = hook
    try:
        q0 = np.zeros(19)
        q0[2] = J_SOLO12.h_ref
        q0[6] = 1.0
        q0[7:] = J_SOLO12.q_stand
        ctl = OracleController(J_SOLO12, JCFG, q0)
        sim = SimState.init(q0)
        for _ in range(N_ORACLE_TICKS):
            cmd, _ = ctl.compute(sim.q, sim.v)
            sim, _ = o_step(JTREE, sim, cmd.torque(sim.q[7:], sim.v[6:]))
    finally:
        ocas.solve_wbc = orig
    return captured


def _refs64(refs_list):
    """Oracle WbcRefs of several ticks -> the port's, float64, batched."""
    return ttsid.WbcRefs(**{k: torch.tensor(np.stack(
        [np.asarray(getattr(r, k), np.float64) for r in refs_list]))
        for k in FIELDS})


def _tier64(q, v, refs, wx, wy):
    """The port's float64 tier on a batch of ticks: solve_wbc(polish=True)
    on float64 QPs with WBC_PARITY_SOLVER's budget, warm-started."""
    from mpctsid_tpu_torch.config import WBC_PARITY_SOLVER as TIER

    return ttsid.solve_wbc(
        TTREE, CFG.wbc, torch.tensor(q), torch.tensor(v), refs,
        iters=TIER.wbc_iters, adapt_rounds=TIER.wbc_adapt_rounds,
        warm_x=wx, warm_y=wy, backend="torch", polish=True)


def test_wbc_parity_tier_float64_under_1e4_of_the_oracle(oracle_ticks):
    """The NAMED WBC tier (config.py WBC_PARITY_SOLVER) as
    tests/test_wbc_jax.py holds the JAX package: float64 island, warm-started
    tick to tick, polished, under 1e-4 tau_max (2.7e-4 Nm) against the
    oracle cascade's torques, mean and max (the max under 1e-4 Nm, ~4x the
    JAX package's measured 2.5e-5).  The port's float64 solve runs the same
    arithmetic; everything it computes stays float64.  Measured over these
    12 ticks: mean 1.5e-5, max 2.0e-5 Nm."""
    errs = []
    wx = wy = None
    for q, v, refs, o_tau in oracle_ticks:
        tau, _, _, sol = _tier64(q[None], v[None], _refs64([refs]), wx, wy)
        assert tau.dtype == torch.float64 and sol.x.dtype == torch.float64
        assert bool(sol.ok.all())
        wx, wy = sol.x, sol.y
        errs.append(np.abs(npy(tau)[0] - o_tau).max())
    errs = np.asarray(errs)
    assert errs.mean() < 1e-4 * CFG.wbc.tau_max, errs
    assert errs.max() < 1e-4, errs


def test_wbc_parity_tier_float64_matches_jax_x64(oracle_ticks):
    """Four of those ticks at once, cold-started, against the JAX package's
    float64 build and solve under x64 (toggled back in `finally`), one tick
    at a time: two float64 runs of the same algorithm agree to 1e-8 Nm
    (measured 3.9e-12)."""
    from mpctsid_tpu.config import WBC_PARITY_SOLVER as JTIER
    from mpctsid_tpu.qp.admm import admm_solve as j_admm

    picks = [oracle_ticks[k] for k in (0, 3, 7, 11)]
    q = np.stack([p[0] for p in picks])
    v = np.stack([p[1] for p in picks])
    tau_t = npy(_tier64(q, v, _refs64([p[2] for p in picks]), None,
                        None)[0])
    jax.config.update("jax_enable_x64", True)
    try:
        f64 = jax.numpy.float64
        solve = jax.jit(lambda H, g, A, l, u: j_admm(
            H, g, A, l, u, iters=JTIER.wbc_iters,
            adapt_rounds=JTIER.wbc_adapt_rounds, rho=JTIER.rho,
            status_tol=0.5, polish_kkt=True))
        tau_j = []
        for qk, vk, refs, _ in picks:
            H, g, A, l, u, Mm, h, JcT = jtsid.build_wbc_qp(
                JTREE, JCFG.wbc, jax.numpy.asarray(qk, f64),
                jax.numpy.asarray(vk, f64),
                jtsid.WbcRefs(*[jax.numpy.asarray(np.asarray(getattr(refs, f)),
                                                  f64) for f in FIELDS]))
            x = np.asarray(solve(H, g, A, l, u).x)
            assert x.dtype == np.float64
            tau_j.append(np.asarray(Mm)[6:] @ x[:18] + np.asarray(h)[6:]
                         - np.asarray(JcT)[6:] @ x[18:])
    finally:
        jax.config.update("jax_enable_x64", False)
    np.testing.assert_allclose(tau_t, np.stack(tau_j), atol=1e-8, rtol=0)
