"""Batched, matmul-only SPD matrix inversion (counterpart of the JAX
package's qp/blockinv.py; same math, batch written out).

Every function takes matrices with any number of leading batch axes
(..., n, n) and recurses on the LAST two.  The structure is the reference's:

  * `spd_inverse`: recursive 2x2-block Schur elimination with closed-form
    1/2/3 base cases.  Every pivot block of an SPD matrix is SPD, so no
    pivoting is needed.  Used for the 18x18 mass matrices (cond ~ 1e2).
  * `chol_blocked` + `tri_lower_inverse` + `spd_inverse_chol`: blocked
    Cholesky, blocked triangular inverse (nilpotent-product base case) and one
    Newton-Schulz polish, after symmetric Jacobi scaling.  The triangular
    inverse only faces cond(L) = sqrt(cond(K)), which is what keeps the f32
    result usable on the QP KKT matrices (cond up to ~1e7).

The matmul-only form was chosen for an accelerator whose batched LU
serialises pivots; the port keeps the same arithmetic first so that it can be
held against the reference value by value.  `torch.linalg.cholesky` is an A/B
for a later change, not part of this module.

Per-scenario safeguards (`bad`, `nonfinite` in `spd_inverse_chol`) reduce
over the last two axes ONLY: one indefinite matrix must never change the
result of another scenario of the batch.

`spd_inverse_sorted` (diagonal pivot ordering) is not ported yet.
"""

from __future__ import annotations

import torch

__all__ = ["spd_inverse", "spd_inverse_sorted", "chol_blocked",
           "tri_lower_inverse", "spd_inverse_chol", "inv3"]


def _inv1(A):
    return 1.0 / A


def _inv2(A):
    a, b = A[..., 0, 0], A[..., 0, 1]
    c, d = A[..., 1, 0], A[..., 1, 1]
    det = a * d - b * c
    adj = torch.stack([torch.stack([d, -b], -1),
                       torch.stack([-c, a], -1)], -2)
    return adj / det[..., None, None]


def inv3(A):
    """Closed-form inverse of (..., 3, 3) matrices (adjugate over determinant).

    Also the port's replacement for `linalg.inv` on 3x3 blocks, whose batched
    CUDA form checks its `info` output on the host."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A00 = e * i - f * h
    A01 = c * h - b * i
    A02 = b * f - c * e
    A10 = f * g - d * i
    A11 = a * i - c * g
    A12 = c * d - a * f
    A20 = d * h - e * g
    A21 = b * g - a * h
    A22 = a * e - b * d
    det = a * A00 + b * A10 + c * A20
    adj = torch.stack([torch.stack([A00, A01, A02], -1),
                       torch.stack([A10, A11, A12], -1),
                       torch.stack([A20, A21, A22], -1)], -2)
    return adj / det[..., None, None]


def _T(A):
    return A.transpose(-1, -2)


def _blocks(tl, tr, bl, br):
    return torch.cat([torch.cat([tl, tr], -1), torch.cat([bl, br], -1)], -2)


def _schur_inverse(A, b: int):
    """Inverse of SPD A (..., n, n) by 2x2 block partition at row b."""
    A11 = A[..., :b, :b]
    A12 = A[..., :b, b:]
    A22 = A[..., b:, b:]
    B11 = spd_inverse(A11)
    W = B11 @ A12                       # (..., b, n-b)
    S = A22 - _T(A12) @ W               # SPD Schur complement
    S_inv = spd_inverse(S)
    U = W @ S_inv                       # (..., b, n-b)
    return _blocks(B11 + U @ _T(W), -U, -_T(U), S_inv)


def spd_inverse(K):
    """Explicit inverse of symmetric positive-definite matrices (..., n, n).

    Recursive blocked Schur elimination with closed-form 1/2/3 base cases;
    matmul-only.  Use for the mass matrices (cond ~ 1e2, uniform diagonal)."""
    n = K.shape[-1]
    if n == 1:
        return _inv1(K)
    if n == 2:
        return _inv2(K)
    if n == 3:
        return inv3(K)
    return _schur_inverse(K, n // 2)


_PIVOT_FLOOR = 1e-10


def _sqrt_floor(x):
    # the floor keeps a rounding-negative trailing pivot (reachable at f32
    # cond ~ 1e7) from NaN-ing the whole factor; callers Jacobi-scale first so
    # diag(K) ~ 1 and the floor is ~eps-sized when it triggers
    return torch.sqrt(torch.clamp_min(x, _PIVOT_FLOOR))


def chol_blocked(K):
    """Lower Cholesky factor of SPD K (..., n, n), recursive blocked form.

    [[K11, K21'], [K21, K22]] -> [[L11, 0], [K21 L11^-T, chol(S)]] with
    S = K22 - L21 L21'.  Closed-form 1x1 / 2x2 / 3x3 bases."""
    n = K.shape[-1]
    if n == 1:
        return _sqrt_floor(K)
    if n == 2:
        l11 = _sqrt_floor(K[..., 0, 0])
        l21 = K[..., 1, 0] / l11
        l22 = _sqrt_floor(K[..., 1, 1] - l21 * l21)
        z = torch.zeros_like(l11)
        return torch.stack([torch.stack([l11, z], -1),
                            torch.stack([l21, l22], -1)], -2)
    if n == 3:
        l11 = _sqrt_floor(K[..., 0, 0])
        l21 = K[..., 1, 0] / l11
        l31 = K[..., 2, 0] / l11
        l22 = _sqrt_floor(K[..., 1, 1] - l21 * l21)
        l32 = (K[..., 2, 1] - l31 * l21) / l22
        l33 = _sqrt_floor(K[..., 2, 2] - l31 * l31 - l32 * l32)
        z = torch.zeros_like(l11)
        return torch.stack([torch.stack([l11, z, z], -1),
                            torch.stack([l21, l22, z], -1),
                            torch.stack([l31, l32, l33], -1)], -2)
    half = n // 2
    K11 = K[..., :half, :half]
    K21 = K[..., half:, :half]
    K22 = K[..., half:, half:]
    L11 = chol_blocked(K11)
    L11_inv = tri_lower_inverse(L11)
    L21 = K21 @ _T(L11_inv)
    S = K22 - L21 @ _T(L21)
    L22 = chol_blocked(S)
    z = K.new_zeros(K.shape[:-2] + (half, n - half))
    return _blocks(L11, z, L21, L22)


_TRI_NEUMANN_BASE = 12


def tri_lower_inverse(L):
    """Inverse of lower-triangular L (..., n, n), recursive blocked form.

    inv([[L11, 0], [L21, L22]]) = [[X11, 0], [-X22 L21 X11, X22]].
    Base case n <= 12: L = D (I + N) with N strictly lower and nilpotent
    (N^n = 0), so inv(I + N) = prod_j (I + M^(2^j)) with M = -N: an exact
    log-depth product of matmuls, then a diagonal column scale."""
    n = L.shape[-1]
    if n == 1:
        return 1.0 / L
    if n <= _TRI_NEUMANN_BASE:
        d = torch.diagonal(L, dim1=-2, dim2=-1)
        eye = torch.eye(n, dtype=L.dtype, device=L.device)
        M = eye - L / d[..., :, None]      # M = -N, strictly lower
        X = eye + M
        k = 1
        while k < n - 1:                   # product covers M^0 .. M^(2k-1)
            M = M @ M
            X = X @ (eye + M)
            k *= 2
        return X / d[..., None, :]
    half = n // 2
    X11 = tri_lower_inverse(L[..., :half, :half])
    X22 = tri_lower_inverse(L[..., half:, half:])
    X21 = -X22 @ (L[..., half:, :half] @ X11)
    z = L.new_zeros(L.shape[:-2] + (half, n - half))
    return _blocks(X11, z, X21, X22)


def spd_inverse_chol(K, ns_steps: int = 1):
    """SPD inverse via blocked Cholesky + triangular inverse + NS polish.

    K^-1 = L^-T L^-1 with L from `chol_blocked`, after symmetric Jacobi
    scaling Ks = S K S, S = diag(K)^-1/2 (the KKT conditioning is diagonal-
    scale driven: 1e6 swing-force ridge, 1e3 equality-rho boost).  `ns_steps`
    Newton-Schulz corrections X <- X (2I - Ks X) then tighten it.

    Both safeguards are per matrix: NS is rolled back where it diverged, and
    a non-finite result falls back to the Jacobi inverse (identity in the
    scaled frame), which ADMM degrades gracefully under."""
    n = K.shape[-1]
    d = torch.diagonal(K, dim1=-2, dim2=-1)
    s = 1.0 / torch.sqrt(torch.clamp_min(d, 1e-30))
    Ks = K * s[..., :, None] * s[..., None, :]
    L = chol_blocked(Ks)
    L_inv = tri_lower_inverse(L)
    X = _T(L_inv) @ L_inv
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    if ns_steps:
        X0 = X
        for _ in range(ns_steps):
            X = X @ (2.0 * eye - Ks @ X)
        # NS diverges iff ||I - Ks X|| >= 1 (only reachable when Ks is
        # numerically indefinite in f32); fall back to the unpolished
        # Cholesky inverse.  `~(a < b)` also catches NaN.
        r_new = ((eye - Ks @ X) ** 2).sum(dim=(-2, -1), keepdim=True)
        r_old = ((eye - Ks @ X0) ** 2).sum(dim=(-2, -1), keepdim=True)
        bad = ~(r_new < r_old * 4.0 + 1.0)
        X = torch.where(bad, X0, X)
    nonfinite = ~torch.isfinite(X).all(dim=-1, keepdim=True).all(
        dim=-2, keepdim=True)
    X = torch.where(nonfinite, eye, X)
    return X * s[..., :, None] * s[..., None, :]


def spd_inverse_sorted(K, ns_steps: int = 2):
    raise NotImplementedError(
        "spd_inverse_sorted is not ported to mpctsid_tpu_torch yet "
        "(no path of the cascade uses it); use spd_inverse_chol")
