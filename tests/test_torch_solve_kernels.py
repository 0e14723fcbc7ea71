"""The default WBC solve and the kernel backends' K^-1 as hand-written
kernels (qp/kernels.py: `admm_solve_plain_warp`, kernel A, and
`chol_inverse`, kernel B), on the CPU.

The CUDA kernels run only on the card (chip_smoke.py, phase 3f).  Here: the
pure-Python layouts that decide their paths on the H100's limits, the
wrappers' argument checks, that the routes leave every CPU result bit for
bit as the plain chains give it, and the plain versions (qp/admm.py's chain
and blockinv.spd_inverse_chol) against the JAX package on the QPs and the K
matrices the cascade's stages really build.
"""

import types

import numpy as np
import pytest
import torch

import jax

from mpctsid_tpu.qp import admm as jadmm
from mpctsid_tpu.qp import blockinv as jbi
from mpctsid_tpu_torch.config import EngineConfig
from mpctsid_tpu_torch.model.solo12 import SOLO12
from mpctsid_tpu_torch.model.tree import build_tree
from mpctsid_tpu_torch.qp import admm as tadmm
from mpctsid_tpu_torch.qp import kernels
from mpctsid_tpu_torch.qp.blockinv import spd_inverse_chol
from mpctsid_tpu_torch.wbc import tsid as ttsid

from _torch_port_util import jj, npy, random_qp, standing_q0, tt

H100_SMEM = 232448      # shared memory a block may opt in to (bytes)
H100_SMS = 132
WBC_KW = dict(iters=40, adapt_rounds=3, equilibrate_iters=8, rho0=0.1,
              sigma=1e-6, alpha=1.6, rho_eq_scale=1e3, inf=tadmm.INF)


# ---------------------------------------------------------------- layouts

def _block(np_, in_smem):
    """kernel B's block-path shared memory: the Jacobi scale (np), the panel
    buffer (np rows of 36), the load's barrier (4), and in shared memory the
    working matrix (np rows of np + 4)."""
    return np_ + 36 * np_ + 4 + (np_ * (np_ + 4) if in_smem else 0)


@pytest.mark.parametrize("n, B, path, g, threads, in_smem, floats, ld", [
    (1, 1, "warp", 1, 32, False, 32, 0),
    (30, 1, "warp", 1, 32, False, 960, 0),
    (30, 37, "warp", 1, 32, False, 960, 0),
    (30, 4096, "warp", 8, 256, False, 8 * 960, 0),
    (32, 4096, "warp", 8, 256, False, 8 * 1024, 0),
    (33, 1, "block", 0, 128, True, _block(64, True), 68),
    (63, 37, "block", 0, 128, True, _block(64, True), 68),
    (64, 8, "block", 0, 128, True, _block(64, True), 68),
    (65, 8, "block", 0, 256, True, _block(96, True), 100),
    (129, 8, "block", 0, 512, True, _block(160, True), 164),
    (191, 1, "block", 0, 512, True, _block(192, True), 196),
    (192, 4096, "block", 0, 512, True, 44740, 196),
    (193, 1, "block", 0, 512, False, _block(224, False), 228),
    (239, 37, "block", 0, 512, False, _block(256, False), 260),
    (240, 1, "block", 0, 512, False, 9476, 260),
])
def test_spd_inverse_layout(n, B, path, g, threads, in_smem, floats, ld):
    """Kernel B's path on the H100: a warp per matrix up to n = 32, at most
    8 a block and no more than spreads B over 132 SMs; a block per matrix
    above, panels of 32 columns and 4 x 4 register tiles (64 threads a
    32 x 32 tile: 128 threads up to two panels, 256 up to three, else 512),
    n padded to np, a multiple of 32, its working matrix (rows of np + 4
    floats, 16-byte aligned) in shared memory beside the panel buffer up to
    n = 192 (178,960 bytes), else in a device-memory workspace."""
    lay = kernels.spd_inverse_layout(n, B, H100_SMEM, H100_SMS)
    panel, tile = (32, 4) if path == "block" else (0, 0)
    assert lay == kernels.SpdLayout(path, g, threads, in_smem, floats, panel,
                                    tile, ld)
    assert 4 * lay.smem_floats <= H100_SMEM
    if path == "block":
        assert lay.ld % 4 == 0 and (lay.ld - 4) % 32 == 0 and lay.ld - 4 >= n
        assert lay.smem_floats == kernels.spd_block_floats(n, in_smem)


@pytest.mark.parametrize("n, m, B, g", [(30, 50, 1, 1), (30, 50, 37, 1),
                                        (30, 50, 4096, 12), (32, 50, 4096, 12),
                                        (24, 40, 300, 3)])
def test_plain_warp_layout(n, m, B, g):
    """Kernel A: a warp per scenario, rows of P and A at the stride 36 (4
    mod 8: the register loop's slot, warp_regs.cuh), twelve WBC-sized
    scenarios a block at B = 4096 (18.4 KB each)."""
    lay = kernels.plain_warp_layout(n, m, B, H100_SMEM, H100_SMS)
    assert lay.path == "warp" and lay.g == g and lay.ld == 36
    assert lay.slot_floats == kernels.plain_warp_slot_floats(n, m)
    assert lay.slot_floats % 4 == 0
    assert 4 * lay.g * lay.slot_floats <= H100_SMEM


@pytest.mark.parametrize("n, m, floats", [(30, 50, 4592), (32, 50, 4728),
                                          (24, 40, 3632), (1, 1, 412)])
def test_plain_warp_slot_floats(n, m, floats):
    """Kernel A's slot (admm_fused.cu's plain_slot_floats): the scratch of
    the factorization (n rows of 32), P (n rows of 36), A (round4(m) rows of
    36), rhs, x_a, r, x_t (32 each), w, z, y, l, u, rho, 1 / rho, E, the
    Ruiz row scale and the rho pattern (round4(m) each) and D (32)."""
    mp = -(-m // 4) * 4
    assert floats == 32 * n + 36 * n + 36 * mp + 4 * 32 + 10 * mp + 32
    assert kernels.plain_warp_slot_floats(n, m) == floats


@pytest.mark.parametrize("n, m, smem", [(33, 50, H100_SMEM),
                                        (30, 50, 3 * 20320)])
def test_plain_warp_layout_refuses_the_block_path(n, m, smem):
    """n = 33, or fewer than four slots in a block: kernel 4 would take its
    block path, which kernel A does not have; the layout raises."""
    with pytest.raises(ValueError, match="no block path"):
        kernels.plain_warp_layout(n, m, 64, smem, H100_SMS)


# ------------------------------------------------------ argument checks

def _qp_args(B=3, n=30, m=50, dtype=torch.float32):
    P, q, A, l, u = (np.stack(a) for a in zip(*[random_qp(b, n, m)
                                                for b in range(B)]))
    eqf = ((u - l) < 1e-9).astype(np.float64)
    x0, y0 = np.zeros((B, n)), np.zeros((B, m))
    return [torch.tensor(a, dtype=dtype) for a in (P, q, A, l, u, eqf, x0,
                                                   y0)]


def test_wrappers_check_arguments():
    """Both wrappers check their arguments before they look at the device:
    what the CUDA route refuses (float64, wrong shapes, non-contiguous
    inputs) is refused on the CPU too, with the reason."""
    K = torch.eye(30).repeat(2, 1, 1)
    with pytest.raises(TypeError, match="K must be float32"):
        kernels.chol_inverse(K.double())
    with pytest.raises(ValueError, match=r"K must be \(B, n, n\)"):
        kernels.chol_inverse(K[:, :, :29].contiguous())
    with pytest.raises(ValueError, match=r"K must be \(B, n, n\)"):
        kernels.chol_inverse(K[0])
    with pytest.raises(ValueError, match="must be contiguous"):
        kernels.chol_inverse(torch.eye(30).expand(2, 30, 30))
    with pytest.raises(TypeError, match="must be a torch.Tensor"):
        kernels.chol_inverse(np.eye(3)[None])
    args = _qp_args()
    with pytest.raises(TypeError, match="P must be float32"):
        kernels.admm_solve_plain_warp(*_qp_args(dtype=torch.float64),
                                      **WBC_KW)
    bad = list(args)
    bad[2] = args[2][:, :, :29].contiguous()
    with pytest.raises(ValueError, match=r"A must be \(B=3, m, n=30\)"):
        kernels.admm_solve_plain_warp(*bad, **WBC_KW)
    bad = list(args)
    bad[0] = args[0].transpose(1, 2)
    with pytest.raises(ValueError, match="P must be contiguous"):
        kernels.admm_solve_plain_warp(*bad, **WBC_KW)
    with pytest.raises(ValueError, match="equilibrate_iters must be >= 0"):
        kernels.admm_solve_plain_warp(*args, **{**WBC_KW,
                                                "equilibrate_iters": -1})
    with pytest.raises(ValueError, match="iters must be >= 0"):
        kernels.admm_solve_plain_warp(*args, **{**WBC_KW, "iters": -1})
    with pytest.raises(ValueError, match="the plain chain's INF"):
        kernels.admm_solve_plain_warp(*args, **{**WBC_KW, "inf": 1e30})


@pytest.mark.parametrize("dtype, device, backend, polish, takes", [
    (torch.float32, "cuda", "xla", False, True),
    (torch.float32, "cuda", "torch", False, True),
    (torch.float32, "cuda", "xla", True, False),
    (torch.float64, "cuda", "xla", False, False),
    (torch.float32, "cpu", "xla", False, False),
    (torch.float32, "cuda", "fused", False, False),
    (torch.float32, "cuda", "vpu", False, False),
    (torch.float32, "cuda", "auto", False, False),
])
def test_solve_route(dtype, device, backend, polish, takes):
    """The default WBC solve takes kernel A exactly when the plain backend
    is asked for, unpolished, in float32 on a CUDA device: the polished and
    the float64 tiers ask for the plain chain by their arguments."""
    H = types.SimpleNamespace(dtype=dtype, device=torch.device(device))
    assert ttsid.takes_solve_kernel(H, backend, polish) is takes


# ------------------------------------------- CPU results bit for bit as before

def _equal(a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("x", "y", "z", "prim_res", "dual_res", "ok"))


def test_cpu_wrappers_are_the_plain_chains():
    """On CPU tensors kernel B is blockinv.spd_inverse_chol and kernel A's
    route is admm_solve(backend="torch"), bit for bit."""
    r = np.random.default_rng(3)
    Q = r.normal(size=(4, 30, 30))
    K = tt(Q @ Q.transpose(0, 2, 1) + 0.1 * np.eye(30))
    assert torch.equal(kernels.chol_inverse(K), spd_inverse_chol(K))
    P, q, A, l, u, _, x0, y0 = _qp_args(B=4)
    kw = dict(iters=40, adapt_rounds=3, rho=0.1, status_tol=0.5)
    for warm in (None, (x0 + 0.1, y0 - 0.1)):
        w = {} if warm is None else dict(x0=warm[0], y0=warm[1])
        assert _equal(tadmm.admm_solve_warp(P, q, A, l, u, **w, **kw),
                      tadmm.admm_solve(P, q, A, l, u, backend="torch", **w,
                                       **kw))


@pytest.mark.parametrize("backend", ["torch", "xla", "vpu", "packed", "mma",
                                     "pallas", "fused", "auto", "m2",
                                     "auto_mpc"])
def test_cpu_admm_solve_unchanged(monkeypatch, backend):
    """Every backend of admm_solve on CPU tensors gives what it gave before
    kernel B's route: the route replaced by the plain inverse it replaces
    changes no bit (M2 backends on inequality-only QPs, their domain)."""
    eq = backend not in ("m2", "auto_mpc")
    P, q, A, l, u = (tt(np.stack(a)) for a in zip(*[
        random_qp(10 + b, 24, 40, eq=eq) for b in range(3)]))
    kw = dict(iters=30, adapt_rounds=2, backend=backend)
    got = tadmm.admm_solve(P, q, A, l, u, **kw)
    monkeypatch.setattr(tadmm, "chol_inverse",
                        lambda K: spd_inverse_chol(K, ns_steps=1))
    assert _equal(got, tadmm.admm_solve(P, q, A, l, u, **kw))


@pytest.mark.parametrize("backend", ["xla", "torch", "vpu", "packed", "fused",
                                     "pallas", "auto"])
def test_cpu_solve_wbc_unchanged(ticks, monkeypatch, backend):
    """solve_wbc on CPU tensors never takes kernel A's route and gives, bit
    for bit, the build, admm_solve and torque formula it gave before."""
    q, v, refs, wx, wy, _ = ticks
    kw = dict(iters=40, adapt_rounds=3, warm_x=wx, warm_y=wy)
    cfg = EngineConfig()
    tree = build_tree(SOLO12)

    def refuse(*a, **k):
        raise AssertionError("kernel A's route taken on the CPU")

    monkeypatch.setattr(ttsid, "admm_solve_warp", refuse)
    tau, qdd, f, sol = ttsid.solve_wbc(tree, cfg.wbc, q, v, refs,
                                       backend=backend, **kw)
    H, g, A, l, u, M, h, JcT = ttsid.build_wbc_qp(tree, cfg.wbc, q, v, refs)
    want = tadmm.admm_solve(H, g, A, l, u, x0=wx, y0=wy, iters=40,
                            adapt_rounds=3, rho=0.1, status_tol=0.5,
                            backend=backend)
    assert _equal(sol, want)
    qdd_w = want.x[:, :18]
    tau_w = (torch.bmm(M[:, 6:], qdd_w[:, :, None])[:, :, 0] + h[:, 6:]
             - torch.bmm(JcT[:, 6:], want.x[:, 18:, None])[:, :, 0])
    assert torch.equal(tau, tau_w) and torch.equal(qdd, qdd_w)


# ------------------------------------------------- the plain versions vs JAX

@pytest.fixture(scope="module")
def ticks():
    """The cascade's own stages on the CPU: three trot scenarios at
    different commands from standing; the third period's MPC inputs and its
    WBC ticks 0 and 10 (mid-gait, two feet in swing) with their warm
    starts: (q, v, refs, warm_x, warm_y, mpc inputs), the ticks stacked."""
    from mpctsid_tpu_torch.cascade import engine
    from mpctsid_tpu_torch.env.plant import ContactParams, PlantState
    from mpctsid_tpu_torch.model.gaits import GAIT_IDS

    cfg = EngineConfig()
    cc = engine.CascadeConfigured(SOLO12, cfg)
    B = 3
    gid = np.full((B,), GAIT_IDS["trot"], np.int32)
    q0 = standing_q0(B)
    ctl = engine.init_controller(SOLO12, cfg, cc.tree, q0, gid, device="cpu")
    plant = PlantState.init(q0, device="cpu")
    cp = ContactParams.default(B, device="cpu")
    wbc, mpc = [], []
    orig_wbc, orig_mpc = engine.solve_wbc, engine.build_mpc_qp

    def hook_wbc(tree, cfgw, q, v, refs, **kw):
        wbc.append((q, v, refs, kw["warm_x"], kw["warm_y"]))
        return orig_wbc(tree, cfgw, q, v, refs, **kw)

    def hook_mpc(model, cfgm, x0, x_ref, feet, contacts, **kw):
        mpc.append((x0, x_ref, feet, contacts))
        return orig_mpc(model, cfgm, x0, x_ref, feet, contacts, **kw)

    engine.solve_wbc, engine.build_mpc_qp = hook_wbc, hook_mpc
    try:
        engine.cascade_rollout(cc, ctl, plant, gid,
                               np.array([[0.3, 0.0, 0.0], [0.2, 0.1, 0.0],
                                         [0.1, 0.0, 0.4]], np.float32),
                               cp, n_periods=3, device="cpu")
    finally:
        engine.solve_wbc, engine.build_mpc_qp = orig_wbc, orig_mpc
    picks = [wbc[40], wbc[50]]
    refs = ttsid.WbcRefs(**{
        f: torch.cat([getattr(p[2], f) for p in picks])
        for f in ("contacts", "f_mpc", "foot_pos_ref", "foot_vel_ref",
                  "foot_acc_ref", "q_posture", "base_rpy_ref", "h_ref")})
    cat = lambda i: torch.cat([p[i] for p in picks])  # noqa: E731
    return cat(0), cat(1), refs, cat(3), cat(4), mpc[2]


@pytest.fixture(scope="module")
def stage_qps(ticks):
    """(the WBC QPs of the ticks with their M, h, JcT and warm starts, the
    MPC QP of the third period, the K matrices the plain solves invert:
    every adapt round of each)."""
    from mpctsid_tpu_torch.mpc.srb import build_mpc_qp

    q, v, refs, wx, wy, mpc_in = ticks
    cfg = EngineConfig()
    wbc_qp = ttsid.build_wbc_qp(build_tree(SOLO12), cfg.wbc, q, v, refs)
    mpc_qp = build_mpc_qp(SOLO12, cfg.mpc, *mpc_in)
    Ks = []

    def recording(K, ns_steps=1):
        Ks.append(K.clone())
        return spd_inverse_chol(K, ns_steps=ns_steps)

    tadmm_inverse = tadmm.spd_inverse_chol
    tadmm.spd_inverse_chol = recording
    try:
        tadmm.admm_solve(*wbc_qp[:5], x0=wx, y0=wy, iters=40, adapt_rounds=3,
                         rho=0.1, status_tol=0.5, backend="torch")
        tadmm.admm_solve(*mpc_qp, iters=60, adapt_rounds=2, backend="torch")
    finally:
        tadmm.spd_inverse_chol = tadmm_inverse
    return wbc_qp, (wx, wy), mpc_qp, Ks


def test_plain_wbc_solve_matches_jax(stage_qps):
    """admm_solve(backend="torch"), the plain version of kernel A, against
    the JAX package's admm_solve(backend="xla") on the cascade's own WBC
    QPs, at tests/test_torch_wbc.py's budget for the same production solve:
    torques within 0.2 Nm (median 3e-2), forces within 1 N, every solve ok
    (the float32 noise of a 40-iteration solve through a cond ~1e5 KKT;
    that file measures it)."""
    (H, g, A, l, u, M, h, JcT), (wx, wy), _, _ = stage_qps
    kw = dict(iters=40, adapt_rounds=3, rho=0.1, status_tol=0.5)
    sol = tadmm.admm_solve(H, g, A, l, u, x0=wx, y0=wy, backend="torch",
                           **kw)
    jsol = jax.jit(jax.vmap(lambda *a: jadmm.admm_solve(
        *a, backend="xla", **kw)))(*(jj(npy(t)) for t in (H, g, A, l, u, wx,
                                                          wy)))

    def torques(x):
        x = np.asarray(x, np.float64)
        M_, h_, J_ = (npy(t).astype(np.float64) for t in (M, h, JcT))
        return (np.einsum("bij,bj->bi", M_[:, 6:], x[:, :18]) + h_[:, 6:]
                - np.einsum("bij,bj->bi", J_[:, 6:], x[:, 18:]))

    d_tau = np.abs(torques(npy(sol.x)) - torques(npy(jsol.x))).max(axis=1)
    assert d_tau.max() < 0.2 and np.median(d_tau) < 3e-2, d_tau
    np.testing.assert_allclose(npy(sol.x)[:, 18:], npy(jsol.x)[:, 18:],
                               atol=1.0)
    assert npy(sol.ok).all() and npy(jsol.ok).all()


@pytest.mark.parametrize("stage", ["wbc", "mpc"])
def test_plain_inverse_matches_jax_on_stage_k(stage_qps, stage):
    """blockinv.spd_inverse_chol, the plain version of kernel B, against the
    JAX package's on the K the stages build: the WBC's (n = 30, the 1e6
    swing-force ridge and the 1e3 equality boost) and the MPC's (n = 192),
    every adapt round of a solve.  Both are float32 inverses of matrices up
    to cond ~1e7 before their Jacobi scaling: the port's residual
    |I - K X|_F (float64) within twice the JAX package's plus 1e-5 per
    matrix, and the two results as close as their residuals allow:
    X_port - X_jax = K^-1 ((K X_port - I) - (K X_jax - I)), so its largest
    entry is at most |K^-1|_2 (r_port + r_jax), |K^-1|_2 taken as |X_jax|_2
    with a tenth to spare.  (A fixed budget relative to the largest entry,
    tests/test_torch_blockinv.py's 2e-3 at cond 1e4, is exceeded on the
    WBC's K: 4.2e-3.)"""
    n = 30 if stage == "wbc" else 192
    K = torch.cat([k for k in stage_qps[3] if k.shape[-1] == n])
    assert len(K) == (18 if stage == "wbc" else 6)
    got = npy(spd_inverse_chol(K, ns_steps=1)).astype(np.float64)
    want = np.asarray(jax.vmap(jbi.spd_inverse_chol)(jj(npy(K))), np.float64)
    K64 = npy(K).astype(np.float64)
    eye = np.eye(n)
    r_got = np.linalg.norm(eye - K64 @ got, axis=(1, 2))
    r_want = np.linalg.norm(eye - K64 @ want, axis=(1, 2))
    assert np.all(r_got <= 2.0 * r_want + 1e-5), (r_got, r_want)
    bound = 1.1 * (r_got + r_want) * np.linalg.norm(want, 2, axis=(1, 2))
    assert np.all(np.abs(got - want).max(axis=(1, 2)) <= bound)
