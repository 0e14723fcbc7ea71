"""Port parity: wbc/tsid.py (batched PyTorch) vs the JAX functions, on
mid-gait-like ticks: random states near standing, mixed contact patterns,
swing references and an MPC force plan.
"""

import numpy as np
import pytest

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
