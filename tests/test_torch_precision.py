"""Port parity: qp/precision.py (batched PyTorch) vs the JAX function and a
numpy float64 reference.

`residual_matvec(b, K, x)` is b - K x in df32: float32 operations only, with
the products split exactly (Dekker) and the sums compensated (Neumaier).  On
a residual that cancels (b = K x + 1e-6) a plain float32 mat-vec is off by
~n eps |terms|; the df32 one by ~eps |r| + eps^2 n |terms|.
"""

import numpy as np
import pytest
import torch

import jax

from mpctsid_tpu.qp import precision as jprec
from mpctsid_tpu_torch.qp import precision as tprec

from _torch_port_util import jj, npy, tt


def cancelling(seed, B, m, n, scale=1e-6):
    """float32 b, K, x with b = K x + O(scale) (the float64 product of the
    float32 values), and the float64 value of b - K x."""
    r = np.random.default_rng(seed)
    K = r.normal(size=(B, m, n)).astype(np.float32)
    x = r.normal(size=(B, n)).astype(np.float32)
    exact = np.einsum("bmn,bn->bm", K.astype(np.float64),
                      x.astype(np.float64))
    b = (exact + r.normal(size=(B, m)) * scale).astype(np.float32)
    ref = b.astype(np.float64) - exact
    return b, K, x, ref


@pytest.mark.parametrize("m,n", [(70, 50), (40, 32), (512, 512), (5, 3)],
                         ids=["padded", "one-chunk", "mpc-kkt", "tiny"])
def test_residual_matvec_matches_jax_and_float64(m, n):
    """Same operations in the same order as the JAX function: the two agree
    to a few float32 ulp of the RESIDUAL (not of the terms), and both sit at
    ~1e-12 of a float64 reference where a plain float32 mat-vec is ~1e-6 off
    (measured 2.4e-13 against 2.7e-6 at 70 x 50)."""
    b, K, x, ref = cancelling(0, 3, m, n)
    got = npy(tprec.residual_matvec(tt(b), tt(K), tt(x)))
    want = np.asarray(jax.vmap(jprec.residual_matvec)(jj(b), jj(K), jj(x)))
    plain = b - np.einsum("bmn,bn->bm", K, x)
    err_plain = np.abs(plain - ref).max()
    err_port = np.abs(got - ref).max()
    assert got.dtype == np.float32 and got.shape == (3, m)
    np.testing.assert_allclose(got, want, atol=2e-12 * np.sqrt(n), rtol=0)
    assert err_port < 1e-11 * np.sqrt(n)
    assert err_port * 100 < err_plain


def test_residual_matvec_is_per_scenario_and_keeps_float64():
    """A NaN scenario leaves the others bit for bit; float64 inputs stay
    float64 (the float64 WBC tier)."""
    b, K, x, _ = cancelling(1, 4, 30, 40)
    clean = tprec.residual_matvec(tt(b), tt(K), tt(x))
    K2 = K.copy()
    K2[2, 3, 7] = np.nan
    poisoned = tprec.residual_matvec(tt(b), tt(K2), tt(x))
    keep = [0, 1, 3]
    assert torch.equal(poisoned[keep], clean[keep])
    assert not torch.isfinite(poisoned[2]).all()
    d = [torch.tensor(a, dtype=torch.float64) for a in (b, K, x)]
    r64 = tprec.residual_matvec(*d)
    assert r64.dtype == torch.float64
    # a plain float64 mat-vec rounds at ~n eps64 |terms| ~ 1e-14
    plain64 = d[0] - torch.einsum("bmn,bn->bm", d[1], d[2])
    assert float((r64 - plain64).abs().max()) < 1e-13


def test_split_and_two_prod_are_exact():
    """The error-free transformations themselves: hi + lo == a, p + e == a b
    and s + e == a + b exactly, checked in float64."""
    r = np.random.default_rng(2)
    a = tt(r.normal(size=1000) * 10.0 ** r.integers(-3, 4, size=1000))
    b = tt(r.normal(size=1000))
    hi, lo = tprec._split(a)
    assert torch.equal(hi.double() + lo.double(), a.double())
    p, e = tprec._two_prod(a, b)
    assert torch.equal(p.double() + e.double(), a.double() * b.double())
    s, e = tprec._two_sum(a, b)
    assert torch.equal(s.double() + e.double(), a.double() + b.double())
