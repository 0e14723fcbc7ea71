"""Port parity for the kernel's module, qp/kernels.py.

On the CPU the wrapper `admm_iterate_m2` runs the kernel's plain version
(`admm_iterate_m2_reference`); the hand-written CUDA kernel itself is held
against that same plain version on the GPU by chip_smoke.py.  Here the plain
version is held against the TPU kernel it replaces, run as the JAX package's
own tests run it on the CPU (Pallas interpret mode).
"""

import numpy as np
import pytest
import torch

from mpctsid_tpu.qp import admm as jadmm
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
