"""Port parity for the kernels' module, qp/kernels.py.

On the CPU a wrapper (`admm_iterate_m2`, `admm_iterate_vpu`,
`admm_iterate_vpu_packed`, `admm_solve_fused`, `admm_iterate`) runs its
kernel's plain
version; the hand-written CUDA kernels themselves are held against those same
plain versions on the GPU by chip_smoke.py.  Here each plain version is held
against the TPU kernel it replaces, run as the JAX package's own tests run it
on the CPU (Pallas interpret mode).
"""

import numpy as np
import pytest
import torch

import jax

from mpctsid_tpu.qp import admm as jadmm
from mpctsid_tpu.qp import pallas_kernels as jk
from mpctsid_tpu.qp.pallas_kernels import admm_iterate_m2_packed_batch
from mpctsid_tpu_torch.qp import admm as tadmm
from mpctsid_tpu_torch.qp import kernels as tk

from _torch_port_util import jj, npy, random_qp, stacked, tt


def m2_inputs(seed, B=4, n=24, m=40):
    """Unit-scaled M2-iteration inputs from random inequality-only QPs.  M2
    is the refined inverse of K = P + sigma I + rho A'A, left as NON-symmetric
    as f32 rounding makes it (plus a deliberate 1e-4 skew, so the test fixes
    which of M2 / M2' the kernel applies)."""
    r = np.random.default_rng(seed)
    P, q, A, l, u = stacked(range(seed, seed + B), n=n, m=m, eq=False)
    rho = np.full((B, m), 0.1, np.float32) * (1 + r.uniform(size=(B, m)))
    K = P + 1e-6 * np.eye(n) + np.einsum("bmi,bm,bmj->bij", A, rho, A)
    Ki = np.linalg.inv(K.astype(np.float64))
    M2 = 2 * Ki - Ki @ K @ Ki
    M2 = M2 + 1e-4 * np.abs(M2).max() * np.triu(r.normal(size=(B, n, n)), 1)
    x = r.normal(size=(B, n)) * 0.1
    y = r.normal(size=(B, m)) * 0.1
    z = np.clip(np.einsum("bmn,bn->bm", A, x), l, u)
    return [np.asarray(a, np.float32)
            for a in (M2, A, q, l, u, rho, x, z, y)]


@pytest.mark.parametrize("g", [1, 4])
def test_reference_matches_tpu_kernel_interpret(g):
    """30 iterations, B = 4 (g = 1: one scenario per grid step; g = 4: the
    packed grid).  Same arithmetic, different summation order: atol 1e-4 on
    unit-scaled QPs."""
    args = m2_inputs(0)
    kw = dict(iters=30, sigma=1e-6, alpha=1.6)
    want = admm_iterate_m2_packed_batch(*[jj(a) for a in args], g=g,
                                        interpret=True, **kw)
    got = tk.admm_iterate_m2_reference(*[tt(a) for a in args], **kw)
    for name, gt, wt in zip("xzy", got, want):
        np.testing.assert_allclose(npy(gt), npy(wt), atol=1e-4, err_msg=name)


def test_reference_applies_m2_transposed():
    """With the skewed M2, applying M2 instead of M2' moves x by far more
    than the tolerance: the parity test above does fix the side."""
    args = [tt(a) for a in m2_inputs(0)]
    kw = dict(iters=30, sigma=1e-6, alpha=1.6)
    x_t, _, _ = tk.admm_iterate_m2_reference(*args, **kw)
    flipped = [args[0].transpose(1, 2).contiguous()] + args[1:]
    x_f, _, _ = tk.admm_iterate_m2_reference(*flipped, **kw)
    assert (x_t - x_f).abs().max() > 1e-3


def test_wrapper_on_cpu_is_the_plain_version_and_counts_no_launch():
    args = [tt(a) for a in m2_inputs(1, B=3)]
    before = tk.admm_iterate_m2.launches
    got = tk.admm_iterate_m2(*args, iters=10, sigma=1e-6, alpha=1.6)
    want = tk.admm_iterate_m2_reference(*args, iters=10, sigma=1e-6,
                                        alpha=1.6)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert tk.admm_iterate_m2.launches == before


@pytest.mark.parametrize("seed", range(3))
def test_admm_solve_m2_matches_jax_pallas_m2(seed):
    """The whole solve through the M2 fold, inequality-only QPs (the M2
    backend's domain): port backend="m2" on the CPU vs JAX "pallas_m2" in
    interpret mode; budget as tests/test_pallas_admm.py."""
    qp = random_qp(seed, eq=False)
    kw = dict(iters=60, adapt_rounds=2, rho=0.1)
    s_j = jadmm.admm_solve(*[jj(a) for a in qp], backend="pallas_m2",
                           backend_interpret=True, **kw)
    s_t = tadmm.admm_solve(*[tt(a)[None] for a in qp], backend="m2", **kw)
    np.testing.assert_allclose(npy(s_t.x)[0], npy(s_j.x), atol=1e-3)
    np.testing.assert_allclose(npy(s_t.y)[0], npy(s_j.y), atol=1e-2)


def test_admm_solve_m2_batched_matches_torch_backend():
    qp = [tt(a) for a in stacked(range(4), eq=False)]
    kw = dict(iters=60, adapt_rounds=2, rho=0.1)
    s_m = tadmm.admm_solve(*qp, backend="m2", **kw)
    s_p = tadmm.admm_solve(*qp, backend="torch", **kw)
    np.testing.assert_allclose(npy(s_m.x), npy(s_p.x), atol=1e-3)
    # on CPU tensors "auto_mpc" is the plain path, bit for bit
    s_a = tadmm.admm_solve(*qp, backend="auto_mpc", **kw)
    assert torch.equal(s_a.x, s_p.x)


def _bad_args(kind):
    a = [tt(x) for x in m2_inputs(2, B=2)]
    if kind == "dtype":
        a[1] = a[1].double()
    elif kind == "M2 not square":
        a[0] = a[0][:, :, :-1].contiguous()
    elif kind == "A width":
        a[1] = a[1][:, :, :-1].contiguous()
    elif kind == "vector length":
        a[3] = a[3][:, :-1].contiguous()
    elif kind == "batch mismatch":
        a[6] = a[6][:1].contiguous()
    elif kind == "A not contiguous":
        a[1] = a[1].transpose(1, 2).contiguous().transpose(1, 2)
    elif kind == "vector not contiguous":
        a[2] = a[2].repeat(1, 2)[:, ::2]
    elif kind == "unbatched":
        a = [t[0] for t in a]
    elif kind == "not a tensor":
        a[4] = a[4].numpy()
    return a


@pytest.mark.parametrize("kind", [
    "dtype", "M2 not square", "A width", "vector length", "batch mismatch",
    "A not contiguous", "vector not contiguous", "unbatched", "not a tensor"])
def test_argument_checks_raise(kind):
    """The checks the wrapper applies before any launch."""
    with pytest.raises((TypeError, ValueError)):
        tk.check_m2_args(*_bad_args(kind))
    with pytest.raises((TypeError, ValueError)):
        tk.admm_iterate_m2(*_bad_args(kind), iters=1)


def test_argument_check_accepts_good_arguments():
    assert tk.check_m2_args(*[tt(x) for x in m2_inputs(2, B=2)]) == (2, 24, 40)


def test_block_size_choice():
    # one thread per column, up to four row-chunk groups, warp multiples
    assert tk._pick_threads(192) == 768
    assert tk._pick_threads(24) == 128
    assert tk._pick_threads(30) == 128
    assert tk._pick_threads(1500) == 1024
    for n in (1, 24, 33, 192, 300, 1024, 5000):
        t = tk._pick_threads(n)
        assert t % 32 == 0 and 32 <= t <= 1024


# ---------------------------------------------------------------------------
# the refined iteration (kernels 2 and 3) and the whole solve (kernel 4)
# ---------------------------------------------------------------------------

ITER_KW = dict(iters=30, sigma=1e-6, alpha=1.6)


# Tolerance of the refined iteration against the TPU kernel on these inputs.
# Same arithmetic in another summation order, but not at 1e-6: on an equality
# row rho is ~200, so y += rho (z_r - z) turns one f32 rounding of z (|z| ~ 3:
# 2e-7) into 4e-5 of y per iteration, and A' (rho z - y) feeds it back into x.
# Measured over 3 seeds, 13 and 30 iterations: x 1.4e-4, z 3.7e-4, y 1.6e-4.
REFINED_ATOL = 1e-3


def refined_inputs(seed, B=4, n=24, m=40, skew=0.0, eq=True):
    """Unit-scaled inputs of the refined iteration from random QPs WITH
    equality rows (rho boosted 1e3 on them, as the solver does) and a few
    infinite bounds (+-1e20, as the WBC's swing rows).  K^-1 is the float64
    inverse rounded to f32.  `skew` adds a deliberate relative asymmetry to K
    and K^-1, so a test can fix which side each is applied from.  With
    eq=False the QPs are inequality-only."""
    r = np.random.default_rng(seed)
    P, q, A, l, u = stacked(range(seed, seed + B), n=n, m=m, eq=eq)
    l[:, 10:13] = -1e20
    u[:, 12:15] = 1e20
    eq = (u - l) < 1e-9
    rho = (0.1 * (1 + r.uniform(size=(B, m))) * np.where(eq, 1e3, 1.0))
    K = P + 1e-6 * np.eye(n) + np.einsum("bmi,bm,bmj->bij", A, rho, A)
    Ki = np.linalg.inv(K.astype(np.float64))
    K = K + skew * np.abs(K).max() * np.triu(r.normal(size=(B, n, n)), 1)
    Ki = Ki + skew * np.abs(Ki).max() * np.tril(r.normal(size=(B, n, n)), -1)
    x = r.normal(size=(B, n)) * 0.1
    y = r.normal(size=(B, m)) * 0.1
    z = np.clip(np.einsum("bmn,bn->bm", A, x), l, u)
    return [np.asarray(a, np.float32)
            for a in (Ki, K, A, q, l, u, rho, x, z, y)]


def _assert_xzy(got, want, atol):
    for name, gt, wt in zip("xzy", got, want):
        np.testing.assert_allclose(npy(gt), npy(wt), atol=atol, err_msg=name)


def test_refined_reference_matches_tpu_vpu_kernel_interpret():
    """`admm_iterate_vpu` takes one scenario; vmap gives it the batch, as the
    solver does.  30 iterations, equality rows; see REFINED_ATOL."""
    args = refined_inputs(0)
    want = jax.vmap(lambda *a: jk.admm_iterate_vpu(*a, interpret=True,
                                                   **ITER_KW))(
        *[jj(a) for a in args])
    got = tk.admm_iterate_refined_reference(*[tt(a) for a in args], **ITER_KW)
    _assert_xzy(got, want, REFINED_ATOL)


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("B", [4, 3])
def test_refined_reference_matches_tpu_packed_kernel_interpret(g, B):
    """The packed TPU kernel at g = 1 and g = 4, with a batch that fills the
    grid (B = 4) and one that leaves inert padding scenarios (B = 3): the
    plain version has no padding and gives the same answers."""
    args = refined_inputs(1, B=B)
    want = jk.admm_iterate_vpu_packed(*[jj(a) for a in args], g=g,
                                      interpret=True, **ITER_KW)
    got = tk.admm_iterate_refined_reference(*[tt(a) for a in args], **ITER_KW)
    _assert_xzy(got, want, REFINED_ATOL)


@pytest.mark.parametrize("which", ["K_inv", "K"])
def test_refined_reference_applies_the_tpu_kernels_sides(which):
    """With K and K^-1 skewed by 3e-5 of their largest entry, the plain
    version still agrees with the TPU kernel on x and z, and flipping either
    matrix to its transpose moves x by several times the tolerance (measured
    5.8e-3 for K^-1, 6.6e-2 for K): the sides are K^-1 rhs and K' x_a.  y is
    left out: the skewed inverse makes the duals of the equality rows drift
    by 5e-3 between summation orders."""
    args = refined_inputs(2, skew=3e-5)
    want = jk.admm_iterate_vpu_packed(*[jj(a) for a in args], g=4,
                                      interpret=True, **ITER_KW)
    targs = [tt(a) for a in args]
    got = tk.admm_iterate_refined_reference(*targs, **ITER_KW)
    _assert_xzy(got[:2], want[:2], REFINED_ATOL)
    i = 0 if which == "K_inv" else 1
    flipped = list(targs)
    flipped[i] = targs[i].transpose(1, 2).contiguous()
    x_f, _, _ = tk.admm_iterate_refined_reference(*flipped, **ITER_KW)
    assert (got[0] - x_f).abs().max() > 3 * REFINED_ATOL


@pytest.mark.parametrize("wrapper", ["admm_iterate_vpu",
                                     "admm_iterate_vpu_packed"])
def test_refined_wrappers_on_cpu_are_the_plain_version(wrapper):
    fn = getattr(tk, wrapper)
    args = [tt(a) for a in refined_inputs(3, B=3)]
    before = fn.launches
    got = fn(*args, iters=10, sigma=1e-6, alpha=1.6)
    want = tk.admm_iterate_refined_reference(*args, iters=10, sigma=1e-6,
                                             alpha=1.6)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert fn.launches == before


FUSED_KW = dict(iters=60, adapt_rounds=2, equilibrate_iters=8, rho0=0.1,
                sigma=1e-6, alpha=1.6, rho_eq_scale=1e3, inf=1e20)


def fused_inputs(seed, B, n, m):
    P, q, A, l, u = stacked(range(seed, seed + B), n=n, m=m, eq=True)
    l[:, 10:13] = -1e20
    u[:, 12:15] = 1e20
    eqf = ((u - l) < 1e-9).astype(np.float32)
    r = np.random.default_rng(seed + 100)
    x0 = (r.normal(size=(B, n)) * 0.1).astype(np.float32)
    y0 = (r.normal(size=(B, m)) * 0.1).astype(np.float32)
    return [P, q, A, l, u, eqf, x0, y0]


@pytest.mark.parametrize("n,m", [(24, 40), (30, 50)])
def test_fused_reference_matches_tpu_fused_kernel_interpret(n, m):
    """The whole solve, 60 iterations in 2 rounds, warm-started, equality
    rows and infinite bounds, B = 3 on a g = 2 grid (one inert padding
    scenario on the TPU side).

    The scales are rsqrt's of abs-max reductions with one mean: D, E, c agree
    to 1e-5 relative at n = 24, where the TPU kernel does not pad, and also at
    n = 30, where it pads n to 32 (measured 2e-7 on these QPs: max|q|, not
    the padded mean(pcol), decides their cost scale).  The scaled iterates
    went through two factorizations of cond ~1e4 matrices and 60 iterations
    in another summation order (column-sweep-free blocked recursion with
    another base size): measured 6e-4 on x, 6e-4 on y; budget JAX's own 1e-3
    between two backends on x and 2e-3 on y."""
    args = fused_inputs(0, 3, n, m)
    want = jk.admm_solve_fused_batch(*[jj(a) for a in args], g=2,
                                     interpret=True, **FUSED_KW)
    got = tk.admm_solve_fused_reference(*[tt(a) for a in args], **FUSED_KW)
    assert tuple(got[4].shape) == (3,)
    for name, g_, w_ in zip(["D", "E", "c"], got[2:], want[2:]):
        np.testing.assert_allclose(npy(g_), npy(w_), rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(npy(got[0]), npy(want[0]), atol=1e-3)
    np.testing.assert_allclose(npy(got[1]), npy(want[1]), atol=2e-3)


def test_fused_wrapper_on_cpu_is_the_plain_version():
    args = [tt(a) for a in fused_inputs(1, 2, 24, 40)]
    before = tk.admm_solve_fused.launches
    got = tk.admm_solve_fused(*args, **FUSED_KW)
    want = tk.admm_solve_fused_reference(*args, **FUSED_KW)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert tk.admm_solve_fused.launches == before


def test_fused_reference_ruiz_is_the_full_rescale_form():
    """One round of the kernel's Ruiz on a matrix with one huge column: the
    scaled P's column abs-max equals its mean times n / n (all ones up to the
    cost scale), which the norm-only form of qp/admm.py reaches only in the
    limit; and zero iterations leave D = E = c = 1."""
    args = [tt(a) for a in fused_inputs(2, 2, 24, 40)]
    kw = dict(FUSED_KW, iters=0, adapt_rounds=1)
    _, _, D, E, c = tk.admm_solve_fused_reference(
        *args, **dict(kw, equilibrate_iters=0))
    assert torch.all(D == 1) and torch.all(E == 1) and torch.all(c == 1)
    _, _, D8, E8, c8 = tk.admm_solve_fused_reference(*args, **kw)
    P, A = args[0], args[2]
    Ps = c8[:, None, None] * D8[:, :, None] * P * D8[:, None, :]
    As = E8[:, :, None] * A * D8[:, None, :]
    col = torch.maximum(Ps.abs().amax(dim=1) / c8[:, None],
                        As.abs().amax(dim=1))
    # equilibrated: every column and row abs-max within 20 % of 1
    assert (col - 1).abs().max() < 0.2
    assert (As.abs().amax(dim=2) - 1).abs().max() < 0.2


def _bad_refined(kind):
    a = [tt(x) for x in refined_inputs(4, B=2)]
    if kind == "dtype":
        a[2] = a[2].double()
    elif kind == "K_inv not square":
        a[0] = a[0][:, :, :-1].contiguous()
    elif kind == "K other size":
        a[1] = a[1][:, :-1, :-1].contiguous()
    elif kind == "A width":
        a[2] = a[2][:, :, :-1].contiguous()
    elif kind == "vector length":
        a[4] = a[4][:, :-1].contiguous()
    elif kind == "batch mismatch":
        a[7] = a[7][:1].contiguous()
    elif kind == "K not contiguous":
        a[1] = a[1].transpose(1, 2)
    elif kind == "unbatched":
        a = [t[0] for t in a]
    elif kind == "not a tensor":
        a[5] = a[5].numpy()
    return a


@pytest.mark.parametrize("kind", [
    "dtype", "K_inv not square", "K other size", "A width", "vector length",
    "batch mismatch", "K not contiguous", "unbatched", "not a tensor"])
def test_refined_argument_checks_raise(kind):
    with pytest.raises((TypeError, ValueError)):
        tk.check_refined_args(*_bad_refined(kind))
    for fn in (tk.admm_iterate_vpu, tk.admm_iterate_vpu_packed,
               tk.admm_iterate):
        with pytest.raises((TypeError, ValueError)):
            fn(*_bad_refined(kind), iters=1)


def _bad_fused(kind):
    a = [tt(x) for x in fused_inputs(5, 2, 24, 40)]
    if kind == "dtype":
        a[0] = a[0].double()
    elif kind == "P not square":
        a[0] = a[0][:, :, :-1].contiguous()
    elif kind == "A width":
        a[2] = a[2][:, :, :-1].contiguous()
    elif kind == "eqf length":
        a[5] = a[5][:, :-1].contiguous()
    elif kind == "x0 length":
        a[6] = a[6][:, :-1].contiguous()
    elif kind == "batch mismatch":
        a[7] = a[7][:1].contiguous()
    elif kind == "A not contiguous":
        a[2] = a[2].transpose(1, 2).contiguous().transpose(1, 2)
    elif kind == "unbatched":
        a = [t[0] for t in a]
    return a


@pytest.mark.parametrize("kind", [
    "dtype", "P not square", "A width", "eqf length", "x0 length",
    "batch mismatch", "A not contiguous", "unbatched"])
def test_fused_argument_checks_raise(kind):
    with pytest.raises((TypeError, ValueError)):
        tk.check_fused_args(*_bad_fused(kind))
    with pytest.raises((TypeError, ValueError)):
        tk.admm_solve_fused(*_bad_fused(kind), **FUSED_KW)


def test_argument_checks_accept_good_arguments_and_refuse_bad_counts():
    assert tk.check_refined_args(
        *[tt(x) for x in refined_inputs(4, B=2)]) == (2, 24, 40)
    good = [tt(x) for x in fused_inputs(5, 2, 30, 50)]
    assert tk.check_fused_args(*good) == (2, 30, 50)
    with pytest.raises(ValueError, match="iters"):
        tk.admm_iterate_vpu(*[tt(x) for x in refined_inputs(4, B=2)],
                            iters=-1)
    with pytest.raises(ValueError, match="equilibrate_iters"):
        tk.admm_solve_fused(*good, **dict(FUSED_KW, equilibrate_iters=-1))


def test_packed_layout_choice():
    """G from the bytes: what fits of the block's shared memory, at most 16,
    no more than spreads the batch over the multiprocessors; an odd row
    stride; a scenario that does not fit is refused with the reason."""
    smem, n_sm = 232448, 132
    g, ld, slot = tk.packed_layout(30, 50, 4096, smem, n_sm)
    assert (ld, slot) == (31, 110 * 31 + 150 + 350)
    assert g == smem // (4 * slot) == 14
    assert tk.packed_layout(30, 50, 64, smem, n_sm)[0] == 1
    assert tk.packed_layout(30, 50, 400, smem, n_sm)[0] == 4
    assert tk.packed_layout(8, 12, 100000, smem, n_sm)[0] == 16
    assert tk.packed_layout(24, 40, 1, smem, n_sm) == (1, 25, 88 * 25 + 400)
    for n in (1, 7, 24, 30, 31, 64):
        assert tk.packed_layout(n, 2 * n, 5, smem, n_sm)[1] % 2 == 1
    with pytest.raises(ValueError, match="shared memory"):
        tk.packed_layout(192, 320, 8, smem, n_sm)


# ---------------------------------------------------------------------------
# the dot-product form of the generic iteration (kernel 5): K AS GIVEN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("eq", [True, False], ids=["eq_rows", "ineq_only"])
@pytest.mark.parametrize("seed", range(3))
def test_mma_reference_matches_tpu_dot_kernel_interpret(seed, eq):
    """`admm_iterate` (backend "pallas") takes one scenario; vmap gives it the
    batch, as the solver does.  30 iterations.  With equality rows the
    tolerance is REFINED_ATOL, for its reason; without them both sides run
    the same arithmetic in another summation order at unit scale: 1e-4, as
    for the M2 iteration."""
    args = refined_inputs(10 + seed, eq=eq)
    want = jax.vmap(lambda *a: jk.admm_iterate(*a, interpret=True,
                                               **ITER_KW))(
        *[jj(a) for a in args])
    got = tk.admm_iterate_reference(*[tt(a) for a in args], **ITER_KW)
    _assert_xzy(got, want, REFINED_ATOL if eq else 1e-4)


def test_mma_reference_applies_k_as_given():
    """With K skewed by 3e-5 of its largest entry the plain version still
    agrees with the TPU kernel on x and z (y left out, as in the sides test
    above), while applying K transposed (what kernels 2 and 3 do: the other
    plain version, or K flipped) moves x by several times the tolerance.
    This is the test that fails if `admm_iterate_reference` shared the
    transposed side."""
    args = refined_inputs(2, skew=3e-5)
    want = jax.vmap(lambda *a: jk.admm_iterate(*a, interpret=True,
                                               **ITER_KW))(
        *[jj(a) for a in args])
    targs = [tt(a) for a in args]
    got = tk.admm_iterate_reference(*targs, **ITER_KW)
    _assert_xzy(got[:2], want[:2], REFINED_ATOL)
    x_other, _, _ = tk.admm_iterate_refined_reference(*targs, **ITER_KW)
    assert (got[0] - x_other).abs().max() > 3 * REFINED_ATOL
    assert (tt(npy(want[0])) - x_other).abs().max() > 3 * REFINED_ATOL
    flipped = list(targs)
    flipped[1] = targs[1].transpose(1, 2).contiguous()
    x_f, _, _ = tk.admm_iterate_reference(*flipped, **ITER_KW)
    # K' as given IS K transposed, up to the two products' summation orders
    np.testing.assert_allclose(npy(x_f), npy(x_other), atol=REFINED_ATOL)


def test_mma_and_refined_references_agree_on_a_symmetric_k():
    """The two plain versions share one loop and differ only in K's side: on
    an exactly symmetric K they agree up to the two batched products'
    summation orders."""
    targs = [tt(a) for a in refined_inputs(5, eq=False)]
    targs[1] = (0.5 * (targs[1] + targs[1].transpose(1, 2))).contiguous()
    a = tk.admm_iterate_reference(*targs, **ITER_KW)
    b = tk.admm_iterate_refined_reference(*targs, **ITER_KW)
    _assert_xzy(a, b, 1e-4)


def test_mma_wrapper_on_cpu_is_the_plain_version():
    """On CPU tensors nothing is launched or built."""
    args = [tt(a) for a in refined_inputs(3, B=3)]
    before = tk.admm_iterate.launches
    want = tk.admm_iterate_reference(*args, iters=10, sigma=1e-6, alpha=1.6)
    got = tk.admm_iterate(*args, iters=10, sigma=1e-6, alpha=1.6)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert tk.admm_iterate.launches == before
    assert not torch.equal(
        want[0], tk.admm_iterate_refined_reference(*args, iters=10)[0])


def test_mma_block_size_choice_and_library_entry():
    # cluster path: about five 16 x 16 tiles of the block's slice of A per
    # warp, 2 to 16 warps; warp path: one warp per scenario of the block
    smem, n_sm = 232448, 132
    assert tk.mma_layout(192, 320, 4096, smem, n_sm).threads == 384
    assert tk.mma_layout(128, 208, 8, smem, n_sm).threads == 352
    assert tk.mma_layout(30, 50, 4096, smem, n_sm).threads == 32 * 4
    assert tk.mma_layout(24, 40, 3, smem, n_sm).threads == 32
    for n, m in ((1, 1), (30, 50), (100, 7), (192, 320), (1000, 2000)):
        t = tk.mma_layout(n, m, 4096, smem, n_sm).threads
        assert t % 32 == 0 and 32 <= t <= 512
    assert tk.LIBRARIES["admm_mma"] == (("admm_mma.cu",), ("admm_block.cuh",))
    # the launcher's ABI: the iteration kernels' arguments, then the six
    # integers of MmaLayout.geometry, then the stream
    vpu = tk._LAUNCH_ARGTYPES["admm_vpu"]
    assert tk._LAUNCH_ARGTYPES["admm_mma"] == (
        vpu[:-2] + [tk._INT] * len(tk.mma_layout(30, 50, 1, smem, n_sm)
                                   .geometry) + vpu[-1:])
    with pytest.raises(ValueError, match="iters"):
        tk.admm_iterate(*[tt(x) for x in refined_inputs(4, B=2)], iters=-1)
