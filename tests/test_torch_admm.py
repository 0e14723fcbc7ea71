"""Port parity: qp/admm.py (batched PyTorch) vs the JAX package.

`ruiz_equilibrate` and `admm_solve` against the JAX functions under
`jax.vmap`, on the random QPs of tests/test_pallas_admm.py: backend "torch"
against "xla", and the kernel backends "vpu", "packed", "mma" and "fused" (on
the CPU: their plain versions) against "pallas_vpu", "pallas_packed", "pallas"
and "fused" in Pallas interpret mode; the modes "inv", "exact_inv" and
"cholesky", the KKT polish (also against the float64 oracle) and float64
solves.
"""

import numpy as np
import pytest
import torch

import jax

from mpctsid_tpu.qp import admm as jadmm
from mpctsid_tpu_torch.qp import admm as tadmm

from _torch_port_util import jj, npy, random_qp, stacked, tt


@pytest.mark.parametrize("eq", [True, False])
def test_ruiz_scales_match_jax(eq):
    """The scale vectors are products of rsqrt's of abs-max reductions: no
    summation order is involved except one mean, so they agree to 1e-5
    relative."""
    qp = stacked(range(4), eq=eq)
    # an all-zero constraint row keeps scale 1 (the guard the cascade needs)
    qp[2][1, 7, :] = 0.0
    want = jax.vmap(jadmm.ruiz_equilibrate)(*[jj(a) for a in qp])
    got = tadmm.ruiz_equilibrate(*[tt(a) for a in qp])
    names = ["Pb", "qb", "Ab", "lb", "ub", "D", "E", "c"]
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(npy(g), npy(w), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    assert npy(got[6])[1, 7] == 1.0


@pytest.mark.parametrize("eq", [True, False])
@pytest.mark.parametrize("seed", range(3))
def test_admm_solve_torch_matches_jax_xla(seed, eq):
    """Same update, different matmul reduction orders: 60 f32 iterations of a
    fixed-point method drift ~1e-4 (the budget tests/test_pallas_admm.py
    gives two backends of one package)."""
    qp = random_qp(seed, eq=eq)
    kw = dict(iters=60, adapt_rounds=2, rho=0.1)
    s_j = jadmm.admm_solve(*[jj(a) for a in qp], backend="xla", **kw)
    s_t = tadmm.admm_solve(*[tt(a)[None] for a in qp], backend="torch", **kw)
    np.testing.assert_allclose(npy(s_t.x)[0], npy(s_j.x), atol=1e-3)
    np.testing.assert_allclose(npy(s_t.y)[0], npy(s_j.y), atol=1e-2)
    # z = clip(A x): rows of A (|row|_1 ~ 20) amplify the x budget
    np.testing.assert_allclose(npy(s_t.z)[0], npy(s_j.z), atol=5e-3)
    assert bool(s_t.ok[0]) == bool(s_j.ok)
    np.testing.assert_allclose(npy(s_t.prim_res)[0], npy(s_j.prim_res),
                               atol=1e-3)


def test_admm_solve_batched_with_warm_start_matches_jax():
    qp = stacked(range(4), eq=True)
    r = np.random.default_rng(7)
    x0 = (r.normal(size=(4, 24)) * 0.1).astype(np.float32)
    y0 = (r.normal(size=(4, 40)) * 0.1).astype(np.float32)
    kw = dict(iters=40, adapt_rounds=3, rho=0.1, status_tol=0.5)
    s_j = jax.vmap(lambda *a: jadmm.admm_solve(
        *a[:5], x0=a[5], y0=a[6], backend="xla", **kw))(
            *[jj(a) for a in qp], jj(x0), jj(y0))
    s_t = tadmm.admm_solve(*[tt(a) for a in qp], x0=tt(x0), y0=tt(y0),
                           backend="xla", **kw)   # config-tree alias
    np.testing.assert_allclose(npy(s_t.x), npy(s_j.x), atol=1e-3)
    np.testing.assert_allclose(npy(s_t.y), npy(s_j.y), atol=1e-2)
    assert s_t.ok.shape == (4,) and s_t.prim_res.shape == (4,)


def test_ok_is_per_scenario_with_one_poisoned_scenario():
    """A NaN problem in the batch flags ITS `ok` false and changes nothing in
    the other scenarios' solutions."""
    qp = stacked(range(4), eq=False)
    kw = dict(iters=60, adapt_rounds=2, rho=0.1)
    clean = tadmm.admm_solve(*[tt(a) for a in qp], **kw)
    assert clean.ok.all()
    poisoned = [a.copy() for a in qp]
    poisoned[1][2, 5] = np.nan            # q of scenario 2
    sol = tadmm.admm_solve(*[tt(a) for a in poisoned], **kw)
    assert sol.ok.tolist() == [True, True, False, True]
    keep = [0, 1, 3]
    assert torch.equal(sol.x[keep], clean.x[keep])
    assert torch.equal(sol.y[keep], clean.y[keep])


@pytest.mark.parametrize("mode,eq", [("inv", False), ("exact_inv", True),
                                     ("cholesky", True)])
@pytest.mark.parametrize("seed", range(2))
def test_admm_solve_modes_match_jax_xla(seed, mode, eq):
    """The three reference modes against the JAX function's "xla" path on
    the same QP.  "inv" (22 cold Newton-Schulz steps) is valid without
    equality rows only, as in JAX.  The JAX package's budget between two of
    its backends, x 1e-3 and y 1e-2 (measured: inv 5e-7, exact_inv 2.8e-4,
    cholesky 2.1e-4 on x)."""
    qp = random_qp(seed, eq=eq)
    kw = dict(iters=60, adapt_rounds=2, rho=0.1, mode=mode)
    s_j = jadmm.admm_solve(*[jj(a) for a in qp], backend="xla", **kw)
    s_t = tadmm.admm_solve(*[tt(a)[None] for a in qp], backend="torch", **kw)
    np.testing.assert_allclose(npy(s_t.x)[0], npy(s_j.x), atol=1e-3)
    np.testing.assert_allclose(npy(s_t.y)[0], npy(s_j.y), atol=1e-2)
    assert bool(s_t.ok[0]) == bool(s_j.ok)


@pytest.mark.parametrize("backend", ["vpu", "packed", "mma", "m2"])
@pytest.mark.parametrize("mode", ["inv", "exact_inv", "cholesky"])
def test_kernel_backends_take_the_modes_as_jax_does(backend, mode,
                                                    monkeypatch):
    """As in JAX, the kernel backends iterate on the mode's inverse ("inv",
    "exact_inv"; "m2" folds it into M2) and run "cholesky", which has no
    inverse, on the plain loop: there bit for bit the plain backend.  On the
    CPU the kernels' plain versions run (the kernel's wrapper is called, once
    per adapt round); the side K is applied from and M2's rounding are the
    only differences elsewhere (x within 1e-3)."""
    calls = []

    def counted(fn):
        def wrapper(*a, **k):
            calls.append(tuple(t.is_contiguous() for t in a))
            return fn(*a, **k)
        return wrapper

    if backend == "m2":
        monkeypatch.setattr(tadmm, "admm_iterate_m2",
                            counted(tadmm.admm_iterate_m2))
    else:
        monkeypatch.setitem(tadmm._ITERATION_KERNELS, backend,
                            counted(tadmm._ITERATION_KERNELS[backend]))
    qp = [tt(a) for a in stacked(range(3), eq=False)]
    kw = dict(iters=60, adapt_rounds=2, rho=0.1, mode=mode)
    s_k = tadmm.admm_solve(*qp, backend=backend, **kw)
    s_p = tadmm.admm_solve(*qp, backend="torch", **kw)
    if mode == "cholesky":
        assert calls == []
        assert torch.equal(s_k.x, s_p.x) and torch.equal(s_k.y, s_p.y)
    else:
        # every argument handed to the kernel is contiguous, as the kernel
        # demands (torch.linalg.inv_ex returns column-major matrices)
        assert len(calls) == 2 and all(all(c) for c in calls)
        np.testing.assert_allclose(npy(s_k.x), npy(s_p.x), atol=1e-3)
    assert s_k.ok.all()


@pytest.mark.parametrize("eq", [True, False])
@pytest.mark.parametrize("seed", range(3))
def test_polish_matches_jax_and_the_float64_oracle(seed, eq):
    """polish_kkt=True: two rounds of the active-set KKT polish after the
    iterations.  Against the JAX polish on the same QP, and both against the
    float64 oracle (mpctsid_tpu/oracle/qp.py), the bar the JAX package's MPC
    tier is held to (1e-4, tests/test_mpc_jax.py).  Measured: port and JAX
    4e-8 - 1.3e-7 apart, each 4e-8 - 9e-8 from the oracle; held to 1e-5."""
    from mpctsid_tpu.oracle.qp import solve_qp
    qp = random_qp(seed, eq=eq)
    kw = dict(iters=60, adapt_rounds=2, rho=0.1, polish_kkt=True)
    s_j = jadmm.admm_solve(*[jj(a) for a in qp], backend="xla", **kw)
    s_t = tadmm.admm_solve(*[tt(a)[None] for a in qp], backend="torch", **kw)
    oracle = solve_qp(*qp)
    np.testing.assert_allclose(npy(s_t.x)[0], npy(s_j.x), atol=1e-5)
    np.testing.assert_allclose(npy(s_t.x)[0], oracle.x, atol=1e-5)
    np.testing.assert_allclose(npy(s_t.y)[0], oracle.y, atol=1e-3)
    # the polish only ever replaces the iterate by a point with a smaller
    # df32 KKT error: far below the unpolished solve's
    s_u = tadmm.admm_solve(*[tt(a)[None] for a in qp], backend="torch",
                           **{**kw, "polish_kkt": False})
    assert (np.abs(npy(s_t.x)[0] - oracle.x).max()
            < np.abs(npy(s_u.x)[0] - oracle.x).max())


def test_polish_is_per_scenario_with_one_poisoned_scenario():
    """A NaN problem flags ITS `ok` false; the batched LU and the acceptance
    test leave the other scenarios bit for bit as a clean batch has them."""
    qp = stacked(range(4), eq=True)
    kw = dict(iters=60, adapt_rounds=2, rho=0.1, polish_kkt=True)
    clean = tadmm.admm_solve(*[tt(a) for a in qp], **kw)
    assert clean.ok.all()
    poisoned = [a.copy() for a in qp]
    poisoned[1][2, 5] = np.nan
    sol = tadmm.admm_solve(*[tt(a) for a in poisoned], **kw)
    assert sol.ok.tolist() == [True, True, False, True]
    keep = [0, 1, 3]
    assert torch.equal(sol.x[keep], clean.x[keep])
    assert torch.equal(sol.y[keep], clean.y[keep])


def test_float64_solve_stays_float64_and_matches_jax_x64():
    """backend "torch" on float64 QPs computes in float64 throughout, as the
    JAX function does under x64 (toggled back in `finally`).  With the polish
    both land on the float64 oracle's solution; they agree to 1e-9."""
    from mpctsid_tpu.oracle.qp import solve_qp
    qp = random_qp(4, eq=True)
    kw = dict(iters=60, adapt_rounds=2, rho=0.1, polish_kkt=True)
    s_t = tadmm.admm_solve(*[torch.tensor(a, dtype=torch.float64)[None]
                             for a in qp], backend="torch", **kw)
    assert s_t.x.dtype == torch.float64 and s_t.prim_res.dtype == torch.float64
    jax.config.update("jax_enable_x64", True)
    try:
        s_j = jadmm.admm_solve(*[jax.numpy.asarray(a, jax.numpy.float64)
                                 for a in qp], backend="xla", **kw)
        x_j = np.asarray(s_j.x)
        assert x_j.dtype == np.float64
    finally:
        jax.config.update("jax_enable_x64", False)
    np.testing.assert_allclose(npy(s_t.x)[0], x_j, atol=1e-9)
    np.testing.assert_allclose(npy(s_t.x)[0], solve_qp(*qp).x, atol=1e-8)


@pytest.mark.parametrize("backend", ["vpu", "packed", "mma", "m2", "fused"])
def test_kernel_backends_refuse_float64(backend):
    """The kernels take float32 only: a float64 QP raises TypeError, never a
    quiet cast (on the CPU the same check runs before the plain version)."""
    qp = [torch.tensor(a, dtype=torch.float64) for a in stacked(range(2),
                                                                eq=False)]
    with pytest.raises(TypeError, match="float32"):
        tadmm.admm_solve(*qp, iters=10, backend=backend)


def test_unknown_mode_raises():
    qp = [tt(a)[None] for a in random_qp(0)]
    with pytest.raises(ValueError, match="unknown mode"):
        tadmm.admm_solve(*qp, mode="lu")


def test_unknown_backend_and_unbatched_input_raise():
    qp = [tt(a) for a in random_qp(0)]
    with pytest.raises(ValueError, match="scenario axis"):
        tadmm.admm_solve(*qp)
    with pytest.raises(ValueError, match="unknown backend"):
        tadmm.admm_solve(*[a[None] for a in qp], backend="cublas")


KERNEL_BACKENDS = [("vpu", "pallas_vpu"), ("packed", "pallas_packed"),
                   ("mma", "pallas"), ("fused", "fused")]


@pytest.mark.parametrize("backend,jax_backend", KERNEL_BACKENDS)
@pytest.mark.parametrize("seed", range(3))
def test_admm_solve_kernel_backend_matches_jax_interpret(seed, backend,
                                                         jax_backend):
    """QPs with equality rows, 60 iterations in 2 rounds: the budget
    tests/test_pallas_admm.py gives two backends of the JAX package (x 1e-3,
    y 1e-2).  Measured here: x 2.5e-4, y 3.1e-4.  The port's backend is also
    held to its own plain backend on the same QP."""
    qp = random_qp(seed)
    kw = dict(iters=60, adapt_rounds=2, rho=0.1)
    s_j = jadmm.admm_solve(*[jj(a) for a in qp], backend=jax_backend,
                           backend_interpret=True, **kw)
    s_t = tadmm.admm_solve(*[tt(a)[None] for a in qp], backend=backend, **kw)
    s_p = tadmm.admm_solve(*[tt(a)[None] for a in qp], backend="torch", **kw)
    np.testing.assert_allclose(npy(s_t.x)[0], npy(s_j.x), atol=1e-3)
    np.testing.assert_allclose(npy(s_t.y)[0], npy(s_j.y), atol=1e-2)
    np.testing.assert_allclose(npy(s_t.x), npy(s_p.x), atol=1e-3)
    assert bool(s_t.ok[0]) == bool(s_j.ok)
    np.testing.assert_allclose(npy(s_t.prim_res)[0], npy(s_j.prim_res),
                               atol=1e-3)


@pytest.mark.parametrize("backend,jax_backend", KERNEL_BACKENDS)
def test_admm_solve_kernel_backend_batched_warm_start_matches_jax(
        backend, jax_backend):
    """Batched, warm-started, the WBC's budget (40 iterations in 3 rounds is
    13 per round, 39 in all, in every backend) and the JAX spelling of the
    backend's name on the port's side."""
    qp = stacked(range(4), eq=True)
    r = np.random.default_rng(7)
    x0 = (r.normal(size=(4, 24)) * 0.1).astype(np.float32)
    y0 = (r.normal(size=(4, 40)) * 0.1).astype(np.float32)
    kw = dict(iters=40, adapt_rounds=3, rho=0.1, status_tol=0.5)
    s_j = jax.vmap(lambda *a: jadmm.admm_solve(
        *a[:5], x0=a[5], y0=a[6], backend=jax_backend,
        backend_interpret=True, **kw))(*[jj(a) for a in qp], jj(x0), jj(y0))
    s_t = tadmm.admm_solve(*[tt(a) for a in qp], x0=tt(x0), y0=tt(y0),
                           backend=jax_backend, **kw)
    np.testing.assert_allclose(npy(s_t.x), npy(s_j.x), atol=1e-3)
    np.testing.assert_allclose(npy(s_t.y), npy(s_j.y), atol=1e-2)
    assert s_t.ok.shape == (4,) and s_t.prim_res.shape == (4,)


def test_fused_backend_on_wbc_sized_qps_matches_jax_and_plain():
    """n = 30, m = 50: the TPU kernel pads n to 32 with identity-diagonal
    variables, the port does not pad.  The unscaled solution does not depend
    on the cost scale the padding touches: JAX's own 1e-3 on x (measured
    2.1e-4 against JAX, 4.8e-4 against the port's plain backend)."""
    qp = stacked(range(3), n=30, m=50)
    kw = dict(iters=60, adapt_rounds=2, rho=0.1)
    s_j = jax.vmap(lambda *a: jadmm.admm_solve(
        *a, backend="fused", backend_interpret=True, **kw))(
            *[jj(a) for a in qp])
    s_t = tadmm.admm_solve(*[tt(a) for a in qp], backend="fused", **kw)
    s_p = tadmm.admm_solve(*[tt(a) for a in qp], backend="torch", **kw)
    np.testing.assert_allclose(npy(s_t.x), npy(s_j.x), atol=1e-3)
    np.testing.assert_allclose(npy(s_t.x), npy(s_p.x), atol=1e-3)


@pytest.mark.parametrize("backend", ["vpu", "packed", "mma", "pallas",
                                     "fused"])
def test_kernel_backend_keeps_a_poisoned_scenario_alone(backend):
    """A NaN problem in the batch flags ITS `ok` false and changes nothing,
    bit for bit, in the other scenarios' solutions (equality rows in)."""
    qp = stacked(range(4), eq=True)
    kw = dict(iters=60, adapt_rounds=2, rho=0.1, backend=backend)
    clean = tadmm.admm_solve(*[tt(a) for a in qp], **kw)
    assert clean.ok.all()
    poisoned = [a.copy() for a in qp]
    poisoned[1][2, 5] = np.nan            # q of scenario 2
    sol = tadmm.admm_solve(*[tt(a) for a in poisoned], **kw)
    assert sol.ok.tolist() == [True, True, False, True]
    keep = [0, 1, 3]
    assert torch.equal(sol.x[keep], clean.x[keep])
    assert torch.equal(sol.y[keep], clean.y[keep])


@pytest.mark.parametrize("name,cpu,cuda", [
    ("torch", "torch", "torch"), ("xla", "torch", "torch"),
    ("m2", "m2", "m2"), ("pallas_m2", "m2", "m2"),
    ("auto_mpc", "torch", "m2"),
    ("vpu", "vpu", "vpu"), ("pallas_vpu", "vpu", "vpu"),
    ("packed", "packed", "packed"), ("pallas_packed", "packed", "packed"),
    ("fused", "fused", "fused"),
    ("mma", "mma", "mma"), ("pallas", "mma", "mma"),
    ("auto", "torch", "vpu"),
])
def test_backend_names_resolve(name, cpu, cuda):
    """Port and JAX spellings; "auto" and "auto_mpc" follow the device."""
    assert tadmm._resolve_backend(name, torch.device("cpu")) == cpu
    assert tadmm._resolve_backend(name, torch.device("cuda", 0)) == cuda


def test_pallas_m2_spelling_runs_and_auto_is_plain_on_the_cpu():
    qp = [tt(a) for a in stacked(range(2), eq=False)]
    kw = dict(iters=60, adapt_rounds=2, rho=0.1)
    s_m = tadmm.admm_solve(*qp, backend="m2", **kw)
    s_j = tadmm.admm_solve(*qp, backend="pallas_m2", **kw)
    assert torch.equal(s_m.x, s_j.x)
    s_p = tadmm.admm_solve(*qp, backend="torch", **kw)
    s_a = tadmm.admm_solve(*qp, backend="auto", **kw)
    assert torch.equal(s_a.x, s_p.x)


def test_mma_backend_applies_k_as_given_and_differs_from_vpu_only_by_rounding():
    """"mma" and "vpu" differ in one thing, the side K is applied from in
    the refinement residual; K is symmetric up to rounding, so the two solves
    agree far inside the backend budget but need not be bit-equal, and the
    JAX spelling "pallas" IS "mma"."""
    qp = [tt(a) for a in stacked(range(4), eq=True)]
    kw = dict(iters=60, adapt_rounds=2, rho=0.1)
    s_m = tadmm.admm_solve(*qp, backend="mma", **kw)
    s_j = tadmm.admm_solve(*qp, backend="pallas", **kw)
    s_v = tadmm.admm_solve(*qp, backend="vpu", **kw)
    assert torch.equal(s_m.x, s_j.x) and torch.equal(s_m.y, s_j.y)
    np.testing.assert_allclose(npy(s_m.x), npy(s_v.x), atol=1e-3)
    np.testing.assert_allclose(npy(s_m.y), npy(s_v.y), atol=1e-2)
