"""Kernel B's blocked factorization (qp/csrc/spd_blocked.h) on the CPU.

The block path of the SPD-inverse kernel (qp/csrc/spd_inverse.cu, n > 32)
runs spd_blocked.h's units between its barriers: per panel of 32 columns the
diagonal block's factor and inverse, the panel solve and a block row of
L^-1, the trailing update and the forward substitution's sums; then X0 =
L^-T L^-1.  The header is plain C++ under a host compiler, so g++ builds the
same arithmetic here and runs it in the kernel's panel order (its host
executor; the diagonal block by `diag_factor_host`, the warp sweep's
arithmetic lane after lane).  The kernel's own prologue (the bulk-copy load,
the Jacobi scale, the plain version's bit for bit) and its guard launch run
on the card only (chip_smoke.py, phase 3f); here the Jacobi scale is the
plain version's and the Newton-Schulz step and its guard are written out in
PyTorch as the wrapper and the guard launch compute them.

Held against blockinv.spd_inverse_chol (the plain version) and the JAX
package's spd_inverse_chol on numpy-seeded K at n = 33, 64 and 192 and on
the K of the cascade's own MPC solve.
"""

import ctypes
import subprocess

import numpy as np
import pytest
import torch

import jax

from mpctsid_tpu.qp import blockinv as jbi
from mpctsid_tpu_torch.qp import _build, kernels
from mpctsid_tpu_torch.qp.blockinv import (chol_blocked, spd_inverse_chol,
                                           tri_lower_inverse)

from _torch_port_util import jj, npy, standing_q0, tt

HARNESS = r'''
#include <vector>

#include "spd_blocked.h"

extern "C" {

int spd_blocked_smem_floats(int n, int w_in_smem)
{
    return spd_blocked::smem_floats(n, w_in_smem != 0);
}

// Ks (B, n, n, Jacobi-scaled) -> L^-1 and X0 = L^-T L^-1 (B, n, n): the
// kernel's identity pad, factor_and_invert in its panel order, the lower
// triangle out, then the X0 tiles g a round (the kernel's threads / 64)
int spd_blocked_host(const float* Ks, float* Li, float* X0, int B, int n,
                     int g)
{
    using namespace spd_blocked;
    const int np = padded(n), ld = stride(np);
    std::vector<float> W((size_t)np * ld), P((size_t)np * PLD);
    HostExec ex;
    for (int b = 0; b < B; ++b) {
        const float* k = Ks + (size_t)b * n * n;
        for (int i = 0; i < np; ++i)
            for (int j = 0; j < np; ++j)
                W[i * ld + j] = i < n && j < n ? k[i * n + j]
                                               : (i == j ? 1.0f : 0.0f);
        factor_and_invert(ex, W.data(), ld, P.data(), np);
        float* li = Li + (size_t)b * n * n;
        for (int i = 0; i < n; ++i)
            for (int c = 0; c < n; ++c)
                li[i * n + c] = c <= i ? W[i * ld + c] : 0.0f;
        for (int u = 0; u < tri(np / PW) * UNITS; ++u)
            x0_unit(W.data(), ld, np, X0 + (size_t)b * n * n, n, u, g);
    }
    return 0;
}

// one 32 x 32 block (its lower triangle) -> its Cholesky factor's inverse,
// by the diagonal block's arithmetic (the warp sweep, lane after lane)
int spd_blocked_diag(const float* A, float* out)
{
    for (int k = 0; k < 32 * 32; ++k) out[k] = A[k];
    spd_blocked::diag_factor_host(out, 32);
    return 0;
}

}
'''


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    d = tmp_path_factory.mktemp("spd_blocked")
    (d / "harness.cc").write_text(HARNESS)
    so = d / "libspd_blocked.so"
    subprocess.run(["g++", "-std=c++17", "-shared", "-fPIC", "-O2", "-I",
                    str(_build.CSRC), "-o", str(so), str(d / "harness.cc")],
                   check=True)
    lib = ctypes.CDLL(str(so))
    lib.spd_blocked_host.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
    lib.spd_blocked_host.restype = ctypes.c_int
    lib.spd_blocked_diag.argtypes = [ctypes.c_void_p] * 2
    lib.spd_blocked_diag.restype = ctypes.c_int
    lib.spd_blocked_smem_floats.argtypes = [ctypes.c_int] * 2
    lib.spd_blocked_smem_floats.restype = ctypes.c_int
    return lib


def blocked(lib, Ks, g=8):
    """(L^-1, X0) of the Jacobi-scaled Ks (B, n, n) by the header's core."""
    Ks = Ks.contiguous()
    B, n = Ks.shape[:2]
    Li, X0 = torch.empty_like(Ks), torch.empty_like(Ks)
    assert lib.spd_blocked_host(Ks.data_ptr(), Li.data_ptr(), X0.data_ptr(),
                                B, n, g) == 0
    return Li, X0


def block_path(lib, K):
    """chol_inverse's block path with the header's core in the factor
    launch's place: the Jacobi scale (the kernel's is the plain version's
    bit for bit), X0 from the core, the Newton-Schulz step as the wrapper
    forms it (2 I - Ks X0, X0 M, Ks X) and the guard launch's choice (X
    where |I - Ks X|^2 < 4 |M - I|^2 + 1, else X0; the identity where that
    is not finite), then s X s."""
    n = K.shape[-1]
    s = 1.0 / torch.sqrt(torch.clamp_min(torch.diagonal(K, dim1=-2, dim2=-1),
                                         1e-30))
    Ks = K * s[:, :, None] * s[:, None, :]
    X0 = blocked(lib, Ks)[1]
    eye = torch.eye(n, dtype=K.dtype)
    M = (2.0 * eye).expand_as(K).clone()
    M.baddbmm_(Ks, X0, alpha=-1.0)
    X = torch.bmm(X0, M)
    T1 = torch.bmm(Ks, X)
    r0 = ((M - eye) ** 2).sum(dim=(1, 2))
    r1 = ((eye - T1) ** 2).sum(dim=(1, 2))
    sel = torch.where((r1 < r0 * 4.0 + 1.0)[:, None, None], X, X0)
    fin = torch.isfinite(sel).flatten(1).all(dim=1)
    sel = torch.where(fin[:, None, None], sel, eye)
    return sel * s[:, :, None] * s[:, None, :]


def random_spd(seed, B, n, ridge=0.05):
    r = np.random.default_rng(seed)
    Q = r.normal(size=(B, n, n))
    return tt(Q @ Q.transpose(0, 2, 1) / n + ridge * np.eye(n))


def residual(K, X):
    K64, X64 = (npy(t).astype(np.float64) for t in (K, X))
    return np.linalg.norm(np.eye(K.shape[-1]) - K64 @ X64, axis=(1, 2))


def hold(K, got):
    """got against the plain version and the JAX package's spd_inverse_chol
    on the same K: |I - K X|_F (float64) within twice each one's plus 1e-6
    per matrix (chip_smoke.py holds the kernel to the plain version so), and
    X within what the residuals allow: X - X_ref = K^-1 ((K X - I) - (K X_ref
    - I)), so its largest entry is at most |K^-1|_2 (r + r_ref), |K^-1|_2
    taken as |X_ref|_2 with a tenth to spare."""
    plain = spd_inverse_chol(K, ns_steps=1)
    jx = torch.as_tensor(np.array(jax.vmap(jbi.spd_inverse_chol)(
        jj(npy(K)))))
    r = residual(K, got)
    for want in (plain, jx):
        r_w = residual(K, want)
        assert np.all(r <= 2.0 * r_w + 1e-6), (r, r_w)
        w64 = npy(want).astype(np.float64)
        bound = 1.1 * (r + r_w) * np.linalg.norm(w64, 2, axis=(1, 2))
        assert np.all(np.abs(npy(got) - w64).max(axis=(1, 2)) <= bound)


# ------------------------------------------------------------------ layout

@pytest.mark.parametrize("n", [33, 63, 64, 65, 191, 192, 193, 239, 240])
def test_smem_floats_match_the_layout(harness, n):
    """The wrapper's count of the block path's shared memory
    (kernels.spd_block_floats, which spd_inverse_layout uses) is the
    header's own (spd_blocked::smem_floats, which the launcher checks)."""
    for in_smem in (True, False):
        assert (harness.spd_blocked_smem_floats(n, int(in_smem))
                == kernels.spd_block_floats(n, in_smem))


# --------------------------------------------------- the core's arithmetic

@pytest.mark.parametrize("n", [33, 64, 192])
def test_factor_and_inverse_match_plain(harness, n):
    """L^-1 of the blocked core against blockinv's recursive
    tri_lower_inverse(chol_blocked(Ks)) on the same Jacobi-scaled K: both
    float32, cond(K) < 100 here (71-83), within 1e-5 of the largest entry
    (measured on a CPU: 4.4e-7 - 7.1e-7); zeros above the diagonal."""
    K = random_spd(n, 3, n)
    s = 1.0 / torch.sqrt(torch.diagonal(K, dim1=-2, dim2=-1))
    Ks = K * s[:, :, None] * s[:, None, :]
    Li = blocked(harness, Ks)[0]
    want = tri_lower_inverse(chol_blocked(Ks))
    scale = float(want.abs().max())
    assert float((Li - want).abs().max()) <= 1e-5 * scale
    assert torch.equal(torch.triu(Li, diagonal=1), torch.zeros_like(Li))


@pytest.mark.parametrize("n", [33, 64, 192])
def test_block_path_matches_plain_and_jax(harness, n):
    """K^-1 by the blocked core (and the Newton-Schulz step and guard as
    the kernel's launches form them) against spd_inverse_chol and the JAX
    package's on numpy-seeded SPD K (`hold`)."""
    K = random_spd(100 + n, 4, n)
    hold(K, block_path(harness, K))


@pytest.mark.parametrize("kind", ["spd", "floored pivot"])
def test_diagonal_block(harness, kind):
    """The diagonal block's arithmetic alone (the warp sweep of
    spd_inverse.cuh, lane after lane): its factor's inverse against
    blockinv's tri_lower_inverse(chol_blocked(A)) on a 32 x 32 block, within
    1e-5 of the largest entry; on a block whose last pivot falls to -3 (an
    indefinite 2 x 2 block in its corner) the 1e-10 floor takes it as in
    the plain version, and the last row of the inverse (1e5 times the rest)
    agrees as closely."""
    A = npy(random_spd(5, 1, 32))[0].astype(np.float32)
    if kind == "floored pivot":
        A[30:, :30] = A[:30, 30:] = 0.0
        A[30:, 30:] = [[1.0, 2.0], [2.0, 1.0]]
    out = np.empty_like(A)
    assert harness.spd_blocked_diag(A.ctypes.data, out.ctypes.data) == 0
    want = npy(tri_lower_inverse(chol_blocked(tt(A)[None])))[0]
    assert np.all(np.isfinite(out))
    assert np.abs(out - want).max() <= 1e-5 * np.abs(want).max()
    assert np.array_equal(np.triu(out, 1), np.zeros_like(out))


def test_x0_symmetric_and_independent_of_tile_order(harness):
    """X0 is symmetric bit for bit (tile (c, r) would form the same products
    in the same order), and the order in which the kernel's threads take its
    tiles (g = threads / 64 a round, every other round reversed) moves no
    bit: 128, 256 and 512 threads and one tile at a time give the same X0,
    which is L^-T L^-1 of the core's own L^-1 to rounding (1e-6 of its
    largest entry)."""
    K = random_spd(7, 2, 192)
    s = 1.0 / torch.sqrt(torch.diagonal(K, dim1=-2, dim2=-1))
    Ks = K * s[:, :, None] * s[:, None, :]
    runs = [blocked(harness, Ks, g) for g in (1, 2, 4, 8)]
    X0 = runs[0][1]
    assert all(torch.equal(X0, x) for _, x in runs[1:])
    assert torch.equal(X0, X0.transpose(1, 2))
    Li = runs[0][0].double()
    want = Li.transpose(1, 2) @ Li
    assert float((X0 - want).abs().max()) <= 1e-6 * float(want.abs().max())


def test_fallbacks_are_per_matrix(harness):
    """A NaN pair takes the identity (s I s), an indefinite 2 x 2 block the
    unpolished X0, as the plain version; the other matrices of the batch
    come out bit for bit as in a clean batch (every sum is over one
    matrix)."""
    n = 64
    K = random_spd(11, 5, n)
    bad = K.clone()
    bad[1, 3, 5] = bad[1, 5, 3] = float("nan")
    bad[2, :2, :2] = torch.tensor([[1.0, 2.0], [2.0, 1.0]]) * bad[2, 0, 0]
    got, clean = block_path(harness, bad), block_path(harness, K)
    want = spd_inverse_chol(bad, ns_steps=1)
    off = ~torch.eye(n, dtype=torch.bool)
    assert torch.equal(got[1][off], torch.zeros(n * n - n))
    torch.testing.assert_close(got[1].diagonal(), want[1].diagonal(),
                               rtol=1e-5, atol=0)
    assert bool(torch.isfinite(got[2]).all())
    assert float((got[2] - want[2]).abs().max()
                 / want[2].abs().max()) < 1e-3
    rest = [0, 3, 4]
    assert torch.equal(got[rest], clean[rest])


# ------------------------------------------------------- the stage's own K

@pytest.fixture(scope="module")
def mpc_k():
    """The K the MPC stage inverts (n = 192): the first period's MPC QP of
    two trot scenarios from standing, every adapt round of the plain
    backend's solve."""
    from mpctsid_tpu_torch.cascade import engine
    from mpctsid_tpu_torch.config import EngineConfig
    from mpctsid_tpu_torch.env.plant import ContactParams, PlantState
    from mpctsid_tpu_torch.model.gaits import GAIT_IDS
    from mpctsid_tpu_torch.model.solo12 import SOLO12
    from mpctsid_tpu_torch.mpc.srb import build_mpc_qp
    from mpctsid_tpu_torch.qp import admm as tadmm

    cfg = EngineConfig()
    cc = engine.CascadeConfigured(SOLO12, cfg)
    B = 2
    gid = np.full((B,), GAIT_IDS["trot"], np.int32)
    q0 = standing_q0(B)
    ctl = engine.init_controller(SOLO12, cfg, cc.tree, q0, gid, device="cpu")
    plant = PlantState.init(q0, device="cpu")
    mpc = []
    orig = engine.build_mpc_qp

    def hook(model, cfgm, x0, x_ref, feet, contacts, **kw):
        mpc.append((x0, x_ref, feet, contacts))
        return orig(model, cfgm, x0, x_ref, feet, contacts, **kw)

    engine.build_mpc_qp = hook
    try:
        engine.cascade_rollout(cc, ctl, plant, gid,
                               np.array([[0.3, 0.0, 0.0], [0.1, 0.0, 0.4]],
                                        np.float32),
                               ContactParams.default(B, device="cpu"),
                               n_periods=1, device="cpu")
    finally:
        engine.build_mpc_qp = orig
    Ks = []

    def recording(K, ns_steps=1):
        Ks.append(K.clone())
        return spd_inverse_chol(K, ns_steps=ns_steps)

    shipped = tadmm.spd_inverse_chol
    tadmm.spd_inverse_chol = recording
    try:
        tadmm.admm_solve(*build_mpc_qp(SOLO12, cfg.mpc, *mpc[0]), iters=60,
                         adapt_rounds=2, backend="torch")
    finally:
        tadmm.spd_inverse_chol = shipped
    return torch.cat(Ks)


def test_block_path_on_the_stage_mpc_k(harness, mpc_k):
    """The MPC's own K (n = 192, both adapt rounds, two scenarios): the
    blocked core's K^-1 against spd_inverse_chol and the JAX package's
    (`hold`)."""
    assert mpc_k.shape == (4, 192, 192)
    hold(mpc_k, block_path(harness, mpc_k))
