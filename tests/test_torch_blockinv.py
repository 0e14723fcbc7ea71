"""Port parity: qp/blockinv.py (batched PyTorch) vs the JAX functions.

Same inputs (numpy, seeded) through `jax.vmap(fn)` and the port's batched
`fn` on the CPU.  Both run the same matmul-only recursion in float32; they
differ only in the summation order inside each matmul, so the tolerances
scale with the conditioning each function faces.
"""

import numpy as np
import pytest
import torch

import jax

from mpctsid_tpu.qp import blockinv as jbi
from mpctsid_tpu_torch.qp import blockinv as tbi

from _torch_port_util import jj, npy, tt

SIZES = [18, 30, 192]
B = 3


def spd_with_cond(n, cond, seed):
    r = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(r.normal(size=(n, n)))
    eigs = np.logspace(0.0, -np.log10(cond), n)
    return (Q * eigs) @ Q.T


def batch(n, cond, seed0=0):
    return np.stack([spd_with_cond(n, cond, seed0 + b) for b in range(B)])


@pytest.mark.parametrize("n", SIZES)
def test_spd_inverse_matches_jax(n):
    # mass-matrix regime (cond 1e2): both sides are exact to ~cond * eps_f32
    # of |X| ~ 1e2, i.e. a few 1e-3 absolute at worst; measured well below
    K = batch(n, 1e2)
    want = jax.vmap(jbi.spd_inverse)(jj(K))
    got = tbi.spd_inverse(tt(K))
    np.testing.assert_allclose(npy(got), npy(want), atol=2e-3)
    resid = np.abs(np.eye(n) - K @ npy(got).astype(np.float64)).max()
    assert resid < 1e-3


@pytest.mark.parametrize("n", SIZES)
def test_chol_blocked_matches_jax(n):
    # Cholesky of a cond-1e3 matrix with unit top eigenvalue: entries <= 1,
    # backward-stable, so the two f32 factors agree to ~1e-4
    K = batch(n, 1e3, seed0=10)
    want = jax.vmap(jbi.chol_blocked)(jj(K))
    got = tbi.chol_blocked(tt(K))
    assert np.abs(np.triu(npy(got), 1)).max() == 0.0
    np.testing.assert_allclose(npy(got), npy(want), atol=2e-4)
    np.testing.assert_allclose(npy(got).astype(np.float64)
                               @ npy(got).astype(np.float64).transpose(0, 2, 1),
                               K, atol=1e-5)


@pytest.mark.parametrize("n", SIZES)
def test_tri_lower_inverse_matches_jax(n):
    # forward error scales with cond(L) = sqrt(cond K) ~ 30 and |X| ~ 30
    K = batch(n, 1e3, seed0=20)
    L = np.linalg.cholesky(K)
    want = jax.vmap(jbi.tri_lower_inverse)(jj(L))
    got = tbi.tri_lower_inverse(tt(L))
    np.testing.assert_allclose(npy(got), npy(want), atol=2e-3)
    resid = np.abs(npy(got).astype(np.float64) @ L - np.eye(n)).max()
    assert resid < 2e-4


@pytest.mark.parametrize("n", SIZES)
def test_spd_inverse_chol_matches_jax(n):
    # KKT regime (cond 1e4, |X| up to 1e4): after the Newton-Schulz polish
    # both sides sit at ~1e-3 relative residual; compare relative to |X|
    K = batch(n, 1e4, seed0=30)
    want = npy(jax.vmap(jbi.spd_inverse_chol)(jj(K)))
    got = npy(tbi.spd_inverse_chol(tt(K)))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() < 2e-3 * scale
    resid = np.linalg.norm(np.eye(n) - K @ got.astype(np.float64),
                           axis=(1, 2)) / np.sqrt(n)
    assert np.all(resid < 1e-3)


def test_leading_axes_are_batch_axes():
    """(2, 3, n, n) input gives the same as flattening the two batch axes."""
    K = np.stack([batch(12, 1e2, 40), batch(12, 1e2, 50)])
    a = tbi.spd_inverse_chol(tt(K))
    b = tbi.spd_inverse_chol(tt(K).reshape(6, 12, 12)).reshape(2, 3, 12, 12)
    assert torch.equal(a, b)


def test_indefinite_scenario_does_not_poison_the_batch():
    """One f32-indefinite matrix (cond 1e9) in the batch: its own result is
    finite (safeguards), and the OTHER scenarios' results are exactly what
    they are without it (cf. tests/test_blockinv.py
    test_ns_safeguard_no_nan_on_indefinite): the safeguard masks are per
    scenario."""
    good = batch(30, 1e4, seed0=60)
    bad = spd_with_cond(30, 1e9, seed=6)
    mixed = np.stack([good[0], bad, good[1], good[2]])
    out = tbi.spd_inverse_chol(tt(mixed))
    assert torch.isfinite(out).all()
    alone = tbi.spd_inverse_chol(tt(good))
    assert torch.equal(out[[0, 2, 3]], alone)
    # a NaN scenario takes the last-resort fallback and stays alone too
    mixed_nan = mixed.copy()
    mixed_nan[1, 3, 3] = np.nan
    out_nan = tbi.spd_inverse_chol(tt(mixed_nan))
    assert torch.equal(out_nan[[0, 2, 3]], alone)


def spread_diag(seed, n=30):
    """tests/test_blockinv.py's spread-diagonal matrix: a cond-1e3 base,
    symmetrically scaled by a shuffled diagonal spanning 1 .. 1e5 (the WBC
    KKT's rho boost and swing ridge)."""
    d = np.logspace(0, 5, n)
    np.random.default_rng(seed).shuffle(d)
    return spd_with_cond(n, 1e3, seed=seed) * np.sqrt(d)[:, None] * np.sqrt(
        d)[None, :]


def _rel_residual(K, X):
    return np.linalg.norm(np.eye(K.shape[-1]) - K @ X.astype(np.float64),
                          axis=(-2, -1))


@pytest.mark.parametrize("n", [18, 30])
def test_spd_inverse_sorted_matches_jax(n):
    """Same permutation (a stable argsort of each diagonal), the same
    recursion and the same Newton-Schulz steps: float32 summation orders
    apart, a few 1e-5 of |X| (measured 6.5e-6)."""
    K = np.stack([spread_diag(7 + b, n) for b in range(B)])
    want = npy(jax.vmap(jbi.spd_inverse_sorted)(jj(K)))
    got = npy(tbi.spd_inverse_sorted(tt(K)))
    assert np.abs(got - want).max() < 1e-4 * np.abs(want).max()
    np.testing.assert_allclose(_rel_residual(K, got), _rel_residual(K, want),
                               rtol=0.5, atol=1e-3)


def test_spd_inverse_sorted_beats_unsorted_on_spread_diag():
    """tests/test_blockinv.py's check (residual under 0.05), per scenario,
    and the reason the function exists: eliminating in descending diagonal
    order leaves a smaller residual than the unsorted recursion (measured
    0.9-1.8e-3 against 0.9-2.8e-2)."""
    K = np.stack([spread_diag(7 + b) for b in range(B)])
    r_sorted = _rel_residual(K, npy(tbi.spd_inverse_sorted(tt(K))))
    r_plain = _rel_residual(K, npy(tbi.spd_inverse(tt(K))))
    assert np.all(np.isfinite(r_sorted)) and np.all(r_sorted < 0.05)
    assert np.all(r_sorted < r_plain)


def test_spd_inverse_sorted_safeguard_is_per_scenario():
    """A NaN matrix takes the cold start and its NaN stays in its own
    scenario; a permutation of a batch of identical matrices is undone
    exactly (X of K's with permuted diagonals are the permuted X)."""
    K = np.stack([spread_diag(7 + b) for b in range(B)])
    alone = tbi.spd_inverse_sorted(tt(K))
    mixed = np.concatenate([K[:1], K[:1], K[1:]])
    mixed[1, 3, 3] = np.nan
    out = tbi.spd_inverse_sorted(tt(mixed))
    assert torch.equal(out[[0, 2, 3]], alone)
    perm = np.random.default_rng(0).permutation(30)
    Kp = K[0][perm][:, perm]
    Xp = tbi.spd_inverse_sorted(tt(Kp[None]))[0]
    assert torch.equal(Xp, alone[0][perm][:, perm])
