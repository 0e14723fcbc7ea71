"""Oracle dense QP solver: OSQP-faithful ADMM + active-set polish (numpy, float64).

Solves   min_x  1/2 x'Px + q'x   s.t.  l <= Ax <= u
with the exact operator splitting of the OSQP paper (Stellato et al., 2020) that the
reference uses through the OSQP C library for its centroidal MPC (SURVEY.md §2.1
"Centroidal MPC — solver"; BASELINE.json:5 names OSQP).  Reduced direct linear system
(P + sigma*I + A' diag(rho) A) instead of the indefinite KKT — identical iterates.
Per-constraint rho with the OSQP equality boost (rho_eq = 1e3 * rho for rows with
l == u).  After convergence an OSQP-style polish solves the equality-constrained KKT
on the detected active set, giving ~machine-precision solutions suitable as the
parity target (BASELINE.json:5, control error < 1e-4).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class QPResult:
    x: np.ndarray
    z: np.ndarray
    y: np.ndarray
    iters: int
    prim_res: float
    dual_res: float
    converged: bool
    polished: bool


def ruiz_equilibrate(P, q, A, l, u, iters: int = 10):
    """OSQP modified-Ruiz equilibration of the stacked KKT matrix [[P, A'], [A, 0]]
    plus cost scaling.  Returns (Pb, qb, Ab, lb, ub, D, E, c) such that the scaled
    problem's solution maps back as x = D xb, y = E yb / c."""
    n, m = P.shape[0], A.shape[0]
    D = np.ones(n)
    E = np.ones(m)
    c = 1.0
    Pb, qb, Ab = P.copy(), q.copy(), A.copy()
    for _ in range(iters):
        # inf-norms of the columns of [[P, A'], [A, 0]]
        cn = np.maximum(np.abs(Pb).max(axis=0, initial=0.0),
                        np.abs(Ab).max(axis=0, initial=0.0))
        cm = np.abs(Ab).max(axis=1, initial=0.0)
        dn = 1.0 / np.sqrt(np.maximum(cn, 1e-12))
        dm = 1.0 / np.sqrt(np.maximum(cm, 1e-12))
        Pb = dn[:, None] * Pb * dn[None, :]
        qb = dn * qb
        Ab = dm[:, None] * Ab * dn[None, :]
        D *= dn
        E *= dm
        # cost scaling
        pcol = np.abs(Pb).max(axis=0, initial=0.0)
        gamma = 1.0 / max(np.mean(pcol), np.abs(qb).max(initial=0.0), 1e-12)
        Pb *= gamma
        qb *= gamma
        c *= gamma
    lb = E * l
    ub = E * u
    return Pb, qb, Ab, lb, ub, D, E, c


def solve_qp(
    P: np.ndarray,
    q: np.ndarray,
    A: np.ndarray,
    l: np.ndarray,
    u: np.ndarray,
    rho: float = 0.1,
    sigma: float = 1e-6,
    alpha: float = 1.6,
    eps_abs: float = 1e-8,
    eps_rel: float = 1e-8,
    max_iters: int = 4000,
    polish: bool = True,
    x0: np.ndarray | None = None,
    y0: np.ndarray | None = None,
) -> QPResult:
    n = P.shape[0]
    m = A.shape[0]
    P = np.asarray(P, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    A = np.asarray(A, dtype=np.float64)
    l = np.asarray(l, dtype=np.float64)
    u = np.asarray(u, dtype=np.float64)
    P0, q0, A0, l0, u0 = P, q, A, l, u  # unscaled, for residuals and polish

    P, q, A, l, u, D, E, cost_scale = ruiz_equilibrate(P, q, A, l, u)

    # per-row rho: OSQP boosts equality rows (l == u) by 1e3
    eq = np.isclose(l0, u0, rtol=0.0, atol=1e-12)
    rho_base = rho
    rho_vec = np.where(eq, 1e3 * rho_base, rho_base)

    x = np.zeros(n) if x0 is None else np.asarray(x0, dtype=np.float64) / D
    y = np.zeros(m) if y0 is None else np.asarray(y0, dtype=np.float64) * cost_scale / E
    z = np.clip(A @ x, l, u)

    def factor(rv):
        K = P + sigma * np.eye(n) + (A.T * rv) @ A
        return np.linalg.cholesky(K)

    L = factor(rho_vec)

    def k_solve(rhs: np.ndarray) -> np.ndarray:
        t = np.linalg.solve(L, rhs)
        return np.linalg.solve(L.T, t)

    prim_res = dual_res = np.inf
    converged = False
    it = 0
    for it in range(1, max_iters + 1):
        rho_inv = 1.0 / rho_vec
        rhs = sigma * x - q + A.T @ (rho_vec * z - y)
        x_t = k_solve(rhs)
        z_t = A @ x_t
        x = alpha * x_t + (1.0 - alpha) * x
        z_r = alpha * z_t + (1.0 - alpha) * z
        z = np.clip(z_r + rho_inv * y, l, u)
        y = y + rho_vec * (z_r - z)

        if it % 10 == 0 or it == max_iters:
            # unscaled residuals (OSQP termination criterion)
            xu = D * x
            yu = E * y / cost_scale
            zu = z / E
            Ax = A0 @ xu
            Px = P0 @ xu
            Aty = A0.T @ yu
            prim_res = float(np.max(np.abs(Ax - zu))) if m else 0.0
            dual_res = float(np.max(np.abs(Px + q0 + Aty)))
            eps_prim = eps_abs + eps_rel * max(
                np.max(np.abs(Ax), initial=0.0), np.max(np.abs(zu), initial=0.0))
            eps_dual = eps_abs + eps_rel * max(
                np.max(np.abs(Px)), np.max(np.abs(q0)),
                np.max(np.abs(Aty), initial=0.0))
            if prim_res <= eps_prim and dual_res <= eps_dual:
                converged = True
                break
            # adaptive rho (OSQP): compare scaled relative residuals
            if it % 50 == 0 and it < max_iters:
                Axs = A @ x
                rp = np.max(np.abs(Axs - z), initial=0.0) / max(
                    np.max(np.abs(Axs), initial=0.0),
                    np.max(np.abs(z), initial=0.0), 1e-12)
                Pxs = P @ x + q
                Atys = A.T @ y
                rd = np.max(np.abs(Pxs + Atys)) / max(
                    np.max(np.abs(Pxs)), np.max(np.abs(Atys), initial=0.0), 1e-12)
                new_rho = np.clip(rho_base * np.sqrt(rp / max(rd, 1e-12)),
                                  1e-6, 1e6)
                if new_rho > 5.0 * rho_base or new_rho < rho_base / 5.0:
                    rho_base = float(new_rho)
                    rho_vec = np.where(eq, 1e3 * rho_base, rho_base)
                    L = factor(rho_vec)

    x = D * x
    y = E * y / cost_scale
    P, q, A, l, u = P0, q0, A0, l0, u0
    z = np.clip(A @ x, l, u)

    polished_ok = False
    if polish and m:
        xp, yp, ok = _polish(P, q, A, l, u, x, y)
        if ok:
            x, y = xp, yp
            z = np.clip(A @ x, l, u)
            polished_ok = True

    return QPResult(x=x, z=z, y=y, iters=it, prim_res=prim_res,
                    dual_res=dual_res, converged=converged, polished=polished_ok)


def _polish(P, q, A, l, u, x, y, active_tol: float = 1e-6):
    """OSQP polish: solve the KKT system restricted to the detected active set.

    Lower-active rows: y_i < 0 or Ax_i near l_i; upper-active: y_i > 0 or near u_i.
    Returns (x, y, success); success requires the polished point to satisfy all
    inactive constraints and improve the KKT residual."""
    Ax = A @ x
    low = (y < -active_tol) | (np.abs(Ax - l) < active_tol)
    upp = (y > active_tol) | (np.abs(Ax - u) < active_tol)
    eq = np.isclose(l, u, rtol=0.0, atol=1e-12)
    low = (low | eq) & ~(upp & ~eq)
    act = low | upp
    if not np.any(act):
        # unconstrained: x = -P^{-1} q
        try:
            xp = np.linalg.solve(P + 1e-12 * np.eye(P.shape[0]), -q)
        except np.linalg.LinAlgError:
            return x, y, False
        return xp, np.zeros_like(y), True

    A_act = A[act]
    b_act = np.where(low, l, u)[act]
    n = P.shape[0]
    k = A_act.shape[0]
    # regularized KKT (OSQP uses delta-regularization + iterative refinement)
    delta = 1e-9
    KKT = np.block([[P + delta * np.eye(n), A_act.T],
                    [A_act, -delta * np.eye(k)]])
    rhs = np.concatenate([-q, b_act])
    try:
        sol = np.linalg.solve(KKT, rhs)
        # one step of iterative refinement against the unregularized system
        KKT0 = np.block([[P, A_act.T], [A_act, np.zeros((k, k))]])
        sol = sol + np.linalg.lstsq(KKT, rhs - KKT0 @ sol, rcond=None)[0]
    except np.linalg.LinAlgError:
        return x, y, False
    xp = sol[:n]
    yp_act = sol[n:]
    yp = np.zeros_like(y)
    yp[act] = yp_act
    # check feasibility of inactive rows and dual signs
    Axp = A @ xp
    feas = np.all(Axp <= u + 1e-7) and np.all(Axp >= l - 1e-7)
    old_kkt = _kkt_residual(P, q, A, l, u, x, y)
    new_kkt = _kkt_residual(P, q, A, l, u, xp, yp)
    if feas and new_kkt <= old_kkt:
        return xp, yp, True
    return x, y, False


def _kkt_residual(P, q, A, l, u, x, y) -> float:
    Ax = A @ x
    prim = np.maximum(Ax - u, 0.0) + np.maximum(l - Ax, 0.0)
    dual = P @ x + q + A.T @ y
    return float(max(np.max(np.abs(prim), initial=0.0), np.max(np.abs(dual))))
