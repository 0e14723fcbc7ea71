"""Double-float (df32) residual in float32 arithmetic (counterpart of the JAX
package's qp/precision.py, batch written out).

The polish step's iterative refinement (qp/admm.py `_polish`) needs the KKT
residual r = b - K x far more accurately than a plain float32 mat-vec gives:
at the solution r is ~1e-6 while the products K_ij x_j are O(1), so plain
float32 leaves an accumulation floor of ~n eps |terms|.  Error-free
transformations remove it with float32 operations only:

  * Dekker's split and product: a = a_hi + a_lo (12-bit hi mantissa), and
    a b = fl(a b) + err with err computed exactly in float32;
  * Neumaier's two-sum: the running sum carries a compensation term, so the
    summation error is O(eps^2 n) instead of O(eps n).

The card has fast float64, but the port keeps df32 so that it computes what
the JAX function computes.

Every operation here is a plain elementwise tensor op, one PyTorch kernel
each: in eager PyTorch `a * b - p` is a multiplication kernel and then a
subtraction kernel, so nothing contracts it into a fused multiply-add that
would break the exactness the splits rely on.  Nothing may `torch.compile`
this module (a compiler may fuse and contract).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["residual_matvec"]

# f32 has a 24-bit mantissa; split at 12 bits so hi * hi products are exact
_SPLIT = float((1 << 12) + 1)
# columns per step of the compensated sum (the JAX function's default)
_CHUNK = 32


def _split(a):
    """Dekker split a = hi + lo with hi holding the top 12 mantissa bits."""
    t = _SPLIT * a
    hi = t - (t - a)
    return hi, a - hi


def _two_prod(a, b):
    """p + e == a * b exactly (float32, no fused multiply-add)."""
    p = a * b
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, e


def _two_sum(a, b):
    """s + e == a + b exactly (Knuth's two-sum, branch-free)."""
    s = a + b
    t = s - a
    e = (a - (s - t)) + (b - t)
    return s, e


def residual_matvec(b, K, x):
    """b - K x with df32 accuracy, for every scenario of a batch.

    b (B, m), K (B, m, n), x (B, n) -> (B, m).  The JAX function's order:
    columns 32 at a time; per chunk every product is Dekker-split, the
    main parts are Neumaier-accumulated column by column into (s, comp) and
    the product errors summed plainly into comp; then b - (s + comp) with
    the compensation kept until the last add.  In float64 the same steps
    run in float64, as the JAX function does under x64."""
    chunk = _CHUNK
    B, m, n = K.shape
    pad = (-n) % chunk
    if pad:
        K = F.pad(K, (0, pad))
        x = F.pad(x, (0, pad))
    nc = (n + pad) // chunk
    Kc = K.reshape(B, m, nc, chunk)
    xc = x.reshape(B, 1, nc, chunk)
    s = K.new_zeros((B, m))
    comp = K.new_zeros((B, m))
    for c in range(nc):
        p, e = _two_prod(Kc[:, :, c], xc[:, :, c])        # (B, m, chunk)
        perr = e.sum(dim=-1)       # product errors: tiny, a plain sum will do
        for j in range(chunk):
            s, err = _two_sum(s, p[:, :, j])
            comp = comp + err
        comp = comp + perr
    d, e = _two_sum(b, -s)
    return d + (e - comp)
