"""Batched dense ADMM QP core (counterpart of the JAX package's qp/admm.py).

Solves, for every scenario b of a batch,

    min_x 1/2 x'P x + q'x   s.t.  l <= A x <= u

with the OSQP operator splitting and a FIXED iteration count, so every
scenario runs in lockstep and nothing depends on the data:

  * norm-only Ruiz equilibration + cost scaling (`ruiz_equilibrate`; on
    the kernel backends "m2", "vpu", "packed" and "mma" the Ruiz kernel
    `kernels.ruiz_equilibrate`, one launch, whose plain version it is);
  * K = P + sigma I + A' diag(rho) A inverted once per adapt round by the
    blocked Cholesky inverse (qp/blockinv.py) and applied as a dense inverse
    with one step of iterative refinement;
  * per-row rho with the 1e3 equality boost (rows with l == u), finite-
    infinity convention INF = 1e20;
  * per-scenario rho adaptation between rounds, rho clipped to [1e-3, 1e3].

Shapes: P (B, n, n), q (B, n), A (B, m, n), l, u (B, m).  Every per-scenario
quantity (`rho_s`, the residual ratios, Ruiz's cost scale, `QPSolution.ok`)
is a (B,) tensor reduced over the LAST axes only, so one diverged scenario
never changes another.

Backends (the JAX package's spelling is accepted beside the port's, because
the shared config tree uses it):
  "torch"    the plain loop of batched matmuls (JAX: "xla").  It stays the
             plain chain here, on every device: it is the plain version of
             kernel A, `admm_solve_warp` (the same function, unpolished, in
             one launch of `admm_solve_plain_warp`, n <= 32, float32), which
             wbc/tsid.py takes for the default WBC solve on the card.
  "m2"       the refinement folded into M2 = 2 K^-1 - K^-1 K K^-1 and the
             iterations run by the hand-written kernel `admm_iterate_m2`
             (JAX: "pallas_m2").  For INEQUALITY-ONLY QPs: with equality rows
             the rho boost pushes cond(K) up and the explicit M2 product
             loses the accuracy that the sequential residual form keeps.
  "auto_mpc" the MPC-stage default: "m2" when the problem lies on a CUDA
             device, "torch" when it lies on the CPU.
  "vpu"      K^-1, K and A handed to the generic iteration kernel
             `admm_iterate_vpu`, which keeps the explicit refinement
             r = rhs - K x_a and so is valid with equality rows; one block
             per scenario, any shape (JAX: "pallas_vpu").
  "packed"   the same function by `admm_iterate_vpu_packed`: several small
             scenarios per block, one warp each; raises when one scenario
             does not fit (JAX: "pallas_packed").
  "auto"     "vpu" when the problem lies on a CUDA device, "torch" on the CPU.
  "mma"      the same iteration with K applied as given and every mat-vec
             on the tensor cores (split-TF32 `mma.sync`), by `admm_iterate`;
             one block per scenario, any shape, valid with equality rows
             (JAX: "pallas").
  "fused"    the whole solve in one launch of `admm_solve_fused` (its own
             full-rescale Ruiz, factorization, iterations and rho
             adaptation); this function only unscales and computes the
             residuals and `ok`.

Modes (how K is inverted each adapt round; the JAX package's):
  "blockinv"  the Cholesky inverse with one Newton-Schulz step, the default
              and the one the cascade runs: on the plain backend the blocked
              chain of qp/blockinv.py (`spd_inverse_chol`); on the kernel
              backends ("m2", "vpu", "packed", "mma") the SPD-inverse kernel
              `chol_inverse` (kernel B: one launch for n <= 32, a
              factorization launch, four batched products and a guard launch
              above), whose plain version that chain is;
  "inv"       22 cold-started Newton-Schulz steps (`_ns_inverse`; valid only
              for cond(K) <~ 1e3 in float32, i.e. without equality rows);
  "exact_inv" the LU-based inverse (`torch.linalg.inv_ex`);
  "cholesky"  no inverse: every iteration solves with the Cholesky factor
              (two triangular solves), so it always runs the plain loop.
The kernel backends take "blockinv", "inv" and "exact_inv" (as the JAX
package's Pallas backends do) and run "cholesky" on the plain loop; "fused"
computes its own inverse and ignores `mode` (and `polish_kkt`), as in JAX.

`polish_kkt=True` adds two rounds of the device-side active-set KKT polish
(`_polish`: one regularised KKT solve by LU, three refinement steps on the
df32 residual of qp/precision.py, accepted per scenario by the df32 KKT
error).  This is the accuracy tier of the contract (control error < 1e-4
against the float64 reference).

Precision.  Float64 inputs with backend "torch" are computed in float64
throughout, as the JAX function is under x64 (the WBC parity tier's float64
island).  The kernels take float32 only and raise TypeError on anything
else; nothing is cast quietly.
"""

from __future__ import annotations

import dataclasses

import torch

from mpctsid_tpu_torch.qp.blockinv import spd_inverse_chol
from mpctsid_tpu_torch.qp.kernels import (_mtv, _mv, admm_iterate,
                                          admm_iterate_m2, admm_iterate_vpu,
                                          admm_iterate_vpu_packed,
                                          admm_solve_fused,
                                          admm_solve_plain_warp, chol_inverse)
from mpctsid_tpu_torch.qp.kernels import \
    ruiz_equilibrate as ruiz_equilibrate_kernel
from mpctsid_tpu_torch.qp.precision import residual_matvec

INF = 1e20

__all__ = ["INF", "QPSolution", "ruiz_equilibrate", "admm_solve",
           "admm_solve_warp", "scaled_solve"]

MODES = ("blockinv", "inv", "exact_inv", "cholesky")


@dataclasses.dataclass
class QPSolution:
    x: torch.Tensor          # (B, n) primal
    y: torch.Tensor          # (B, m) dual
    z: torch.Tensor          # (B, m) projected constraint value
    prim_res: torch.Tensor   # (B,) unscaled inf-norm
    dual_res: torch.Tensor   # (B,) unscaled inf-norm
    # Per-scenario solve status: True when the returned x is finite and
    # primal-feasible to `status_tol`.  Consumers use it for the
    # last-feasible-plan fallback (cascade/engine.py).
    ok: torch.Tensor         # (B,) bool


def _ns_inverse(K, iters: int):
    """Newton-Schulz iteration for K^-1 of SPD matrices (B, n, n):
    X <- X (2I - K X) from the cold start X0 = I / ||K||_inf (per scenario),
    which converges for SPD K.  Matmul-only; the residual ||I - X K||
    squares each step."""
    n = K.shape[-1]
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    norm_inf = K.abs().sum(dim=-1).amax(dim=-1)
    X = eye / norm_inf[:, None, None]
    eye2 = 2.0 * eye
    for _ in range(iters):
        X = torch.bmm(X, eye2 - torch.bmm(K, X))
    return X


def ruiz_equilibrate(P, q, A, l, u, iters: int = 8):
    """Modified-Ruiz equilibration of [[P, A'], [A, 0]] + cost scaling.

    Returns (Pb, qb, Ab, lb, ub, D, E, c) with x = D xb, y = E yb / c;
    D (B, n), E (B, m), c (B,).

    Norm-only iteration: the loop carries just the scale vectors and reads
    the ORIGINAL |P|, |A| through weighted abs-max reductions (the scaled
    matrix's column max is c D_j max_i(D_i |P_ij|)), then applies the
    accumulated scaling once at the end.  All-zero rows/columns keep scale 1."""
    B, n = q.shape
    m = A.shape[1]
    absP = P.abs()
    absA = A.abs()
    absq = q.abs()
    D = P.new_ones((B, n))
    E = P.new_ones((B, m))
    c = P.new_ones((B, 1))
    for _ in range(iters):
        wp = (absP * D[:, :, None]).amax(dim=1)         # max_i D_i |P_ij|
        wa_col = (absA * E[:, :, None]).amax(dim=1)     # max_i E_i |A_ij|
        wa_row = (absA * D[:, None, :]).amax(dim=2)     # max_j |A_ij| D_j
        cn = torch.maximum(c * D * wp, D * wa_col)
        cm = E * wa_row
        dn = torch.where(cn < 1e-10, torch.ones_like(cn),
                         torch.rsqrt(torch.clamp_min(cn, 1e-12)))
        dm = torch.where(cm < 1e-10, torch.ones_like(cm),
                         torch.rsqrt(torch.clamp_min(cm, 1e-12)))
        D = D * dn
        E = E * dm
        # cost scaling against the post-dn matrices
        pcol = c * D * (absP * D[:, :, None]).amax(dim=1)
        qb_max = c * (absq * D).amax(dim=1, keepdim=True)
        gamma = 1.0 / torch.clamp_min(
            torch.maximum(pcol.mean(dim=1, keepdim=True), qb_max), 1e-12)
        c = c * gamma
    del absP, absA
    Pb = (c * D)[:, :, None] * P * D[:, None, :]
    qb = c * D * q
    Ab = E[:, :, None] * A * D[:, None, :]
    # scale bounds, keeping the finite-infinity convention intact
    lb = torch.where(l <= -INF, l, E * l)
    ub = torch.where(u >= INF, u, E * u)
    return Pb, qb, Ab, lb, ub, D, E, c[:, 0]


# accepted spelling -> the port's name (the JAX package's names beside ours)
_BACKEND_NAMES = {
    "torch": "torch", "xla": "torch",
    "m2": "m2", "pallas_m2": "m2",
    "vpu": "vpu", "pallas_vpu": "vpu",
    "packed": "packed", "pallas_packed": "packed",
    "mma": "mma", "pallas": "mma",
    "fused": "fused",
}
_ITERATION_KERNELS = {"vpu": admm_iterate_vpu,
                      "packed": admm_iterate_vpu_packed,
                      "mma": admm_iterate}


def _resolve_backend(backend: str, device: torch.device) -> str:
    if backend == "auto_mpc":
        # the MPC QP is inequality-only by construction (friction pyramid +
        # force bounds): exactly the M2 kernel's validity domain
        return "m2" if device.type == "cuda" else "torch"
    if backend == "auto":
        return "vpu" if device.type == "cuda" else "torch"
    if backend not in _BACKEND_NAMES:
        raise ValueError(f"unknown backend {backend!r}")
    return _BACKEND_NAMES[backend]


def _k_inverse(K, mode: str, backend: str):
    """K^-1 by `mode`'s method; None for "cholesky" (no inverse)."""
    if mode == "blockinv":
        # Cholesky + triangular inverse + 1 Newton-Schulz correction: the
        # plain chain on the plain backend, the SPD-inverse kernel on the
        # kernel backends (which take float32 CUDA tensors; on the CPU it is
        # the same plain chain)
        if backend == "torch":
            return spd_inverse_chol(K, ns_steps=1)
        return chol_inverse(K)
    if mode == "inv":
        # cold-started every round: warm starts across rho changes can put
        # ||I - X0 K|| > 1, where Newton-Schulz diverges
        return _ns_inverse(K, iters=22)
    if mode == "exact_inv":
        # inv_ex: no host-side check of `info` (a singular K gives non-finite
        # entries in its own scenario only); it returns column-major
        # matrices, the kernels take row-major ones
        return torch.linalg.inv_ex(K)[0].contiguous()
    return None


def _cholesky_factor(K):
    """Lower Cholesky factors; a scenario whose K is not positive definite
    gets NaN (as jnp.linalg.cholesky gives), no host-side check."""
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where(info[:, None, None] == 0, L,
                       torch.full_like(L, float("nan")))


def _run_block(P, q, A, l, u, eqf, rho_s, x, z, y, n_iters: int,
               sigma: float, alpha: float, rho_eq_scale: float, backend: str,
               mode: str):
    """n_iters ADMM iterations at per-scenario rho_s (B,) with the eq boost.

    A function of its own so that K, K^-1 and M2 are freed when it returns:
    at B = 4096, n = 192 each of them is 604 MB."""
    rho_vec = ((1.0 + eqf * (rho_eq_scale - 1.0)) * rho_s[:, None]).contiguous()
    K = torch.bmm((A * rho_vec[:, :, None]).transpose(1, 2), A)
    K += P
    K.diagonal(dim1=-2, dim2=-1).add_(sigma)
    K_inv = _k_inverse(K, mode, backend)

    if backend == "m2" and K_inv is not None:
        # Fold the refinement into ONE precomputed map:
        #   x_t = x_a + K_inv (rhs - K x_a) = (2 K_inv - K_inv K K_inv) rhs
        # Two batched matmuls here; the kernel then streams one matrix and
        # does three mat-vecs per iteration instead of five.
        KKi = torch.bmm(K, K_inv)
        del K
        M2 = 2.0 * K_inv - torch.bmm(K_inv, KKi)
        del KKi, K_inv
        return admm_iterate_m2(M2, A, q, l, u, rho_vec, x, z, y,
                               iters=n_iters, sigma=sigma, alpha=alpha)

    if backend in _ITERATION_KERNELS and K_inv is not None:
        # K^-1, K and A go to the kernel as they are; it keeps them on chip
        # for all iterations and forms the refinement residual explicitly
        return _ITERATION_KERNELS[backend](
            K_inv.contiguous(), K, A, q, l, u, rho_vec, x, z, y,
            iters=n_iters, sigma=sigma, alpha=alpha)

    if K_inv is None:
        L = _cholesky_factor(K)

        def k_solve(rhs):
            t = torch.linalg.solve_triangular(L, rhs[:, :, None], upper=False)
            return torch.linalg.solve_triangular(L.transpose(1, 2), t,
                                                 upper=True)[:, :, 0]
    else:
        def k_solve(rhs):
            # one iterative-refinement step squares the explicit inverse's
            # relative error for two extra matmuls
            x_a = _mv(K_inv, rhs)
            return x_a + _mv(K_inv, rhs - _mv(K, x_a))

    rho_inv = 1.0 / rho_vec
    for _ in range(n_iters):
        rhs = sigma * x - q + _mtv(A, rho_vec * z - y)
        x_t = k_solve(rhs)
        z_t = _mv(A, x_t)
        x = alpha * x_t + (1.0 - alpha) * x
        z_r = alpha * z_t + (1.0 - alpha) * z
        z_n = torch.minimum(torch.maximum(z_r + rho_inv * y, l), u)
        y = y + rho_vec * (z_r - z_n)
        z = z_n
    return x, z, y


def _amax(t):
    return t.abs().amax(dim=-1)


def admm_solve(P, q, A, l, u,
               x0=None, y0=None,
               iters: int = 60,
               rho: float = 0.1,
               sigma: float = 1e-6,
               alpha: float = 1.6,
               rho_eq_scale: float = 1e3,
               mode: str = "blockinv",
               equilibrate_iters: int = 8,
               polish_kkt: bool = False,
               adapt_rounds: int = 1,
               backend: str = "torch",
               status_tol: float = 0.05) -> QPSolution:
    """Fixed-iteration OSQP-style ADMM over a batch; see the module docstring."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    if P.dim() != 3:
        raise ValueError(
            f"P must carry a leading scenario axis (B, n, n); got "
            f"{tuple(P.shape)}")
    backend = _resolve_backend(backend, P.device)
    kw = dict(iters=iters, rho=rho, sigma=sigma, alpha=alpha,
              rho_eq_scale=rho_eq_scale, equilibrate_iters=equilibrate_iters,
              adapt_rounds=adapt_rounds)
    if backend == "fused":
        # One launch per solve: Ruiz, K assembly, the Cholesky-based inverse,
        # all iterations and the rho adaptation (qp/kernels.py).  The plain
        # path of a WBC-sized solve is thousands of tiny device ops and is
        # launch bound.
        return _whole_solve(admm_solve_fused, P, q, A, l, u, x0, y0,
                            status_tol, **kw)

    eqf = ((u - l) < 1e-9).to(P.dtype)
    x, y, D, E, c, (Ps, qs, As, ls, us) = scaled_solve(
        P, q, A, l, u, eqf, x0, y0, mode=mode, backend=backend, **kw)
    if polish_kkt:
        # polish in the SCALED frame (a well-conditioned KKT for the float32
        # solve); the second round re-detects the active set at the polished
        # point
        eq = (u - l) < 1e-9
        x, y = _polish(Ps, qs, As, ls, us, x, y, eq)
        x, y = _polish(Ps, qs, As, ls, us, x, y, eq, active_tol=1e-5)
    return _unscaled_solution(P, q, A, l, u, x, y, D, E, c, status_tol)


def scaled_solve(P, q, A, l, u, eqf, x0=None, y0=None, iters: int = 60,
                 rho: float = 0.1, sigma: float = 1e-6, alpha: float = 1.6,
                 rho_eq_scale: float = 1e3, mode: str = "blockinv",
                 equilibrate_iters: int = 8, adapt_rounds: int = 1,
                 backend: str = "torch"):
    """The ADMM chain of `admm_solve` in the scaled frame: Ruiz, the warm
    start, the adapt rounds.  eqf (B, m): 1.0 on equality rows.  backend:
    one of the port's resolved names but "fused".  Returns (x, y, D, E, c,
    (P, q, A, l, u) scaled): x = D xs, y = E ys / c unscale the solution.
    With backend "torch" and mode "blockinv" this is the plain version of
    `kernels.admm_solve_plain_warp`."""
    B, n = q.shape
    m = A.shape[1]
    dtype = P.dtype
    # the plain chain on the plain backend; the Ruiz kernel on the kernel
    # backends (its plain version, this module's function, on the CPU)
    ruiz = ruiz_equilibrate if backend == "torch" else ruiz_equilibrate_kernel
    P, q, A, l, u, D, E, c = ruiz(P, q, A, l, u, equilibrate_iters)

    x = P.new_zeros((B, n)) if x0 is None else (x0 / D).to(dtype)
    y = P.new_zeros((B, m)) if y0 is None else (y0 * c[:, None] / E).to(dtype)
    z = torch.minimum(torch.maximum(_mv(A, x), l), u)
    if backend != "torch":
        A, q, l, u = (t.contiguous() for t in (A, q, l, u))
        x, y, z = x.contiguous(), y.contiguous(), z.contiguous()

    # OSQP-style adaptive rho: a fixed number of rounds, each refactoring
    # with a per-scenario rho from the scaled residual ratio.
    rho_s = torch.full((B,), rho, dtype=dtype, device=P.device)
    n_rounds = max(1, adapt_rounds)
    iters_per = max(1, iters // n_rounds)
    for r_i in range(n_rounds):
        x, z, y = _run_block(P, q, A, l, u, eqf, rho_s, x, z, y, iters_per,
                             sigma, alpha, rho_eq_scale, backend, mode)
        if r_i + 1 < n_rounds:
            Ax = _mv(A, x)
            Px = _mv(P, x)
            Aty = _mtv(A, y)
            rp = _amax(Ax - z) / torch.clamp_min(
                torch.maximum(_amax(Ax), _amax(z)), 1e-12)
            rd = _amax(Px + q + Aty) / torch.clamp_min(
                torch.maximum(_amax(Px),
                              torch.maximum(_amax(q), _amax(Aty))), 1e-12)
            # f32 deviation from OSQP's [1e-6, 1e6]: rho bounds [1e-3, 1e3];
            # tiny rho drives cond(K) past what an f32 factorization inverts
            rho_s = torch.clamp(
                rho_s * torch.sqrt(rp / torch.clamp_min(rd, 1e-12)),
                1e-3, 1e3)
    return x, y, D, E, c, (P, q, A, l, u)


def admm_solve_warp(P, q, A, l, u, x0=None, y0=None, iters: int = 60,
                    rho: float = 0.1, sigma: float = 1e-6, alpha: float = 1.6,
                    rho_eq_scale: float = 1e3, equilibrate_iters: int = 8,
                    adapt_rounds: int = 1,
                    status_tol: float = 0.05) -> QPSolution:
    """`admm_solve(backend="torch", mode="blockinv")`, unpolished, as one
    launch of `kernels.admm_solve_plain_warp` (n <= 32, float32; the default
    WBC solve on the card: wbc/tsid.py).  On CPU tensors the kernel's plain
    version runs: the same chain as `admm_solve`, bit for bit.  The
    arguments are `admm_solve`'s."""
    return _whole_solve(admm_solve_plain_warp, P, q, A, l, u, x0, y0,
                        status_tol, iters=iters, rho=rho, sigma=sigma,
                        alpha=alpha, rho_eq_scale=rho_eq_scale,
                        equilibrate_iters=equilibrate_iters,
                        adapt_rounds=adapt_rounds)


def _whole_solve(kernel, P, q, A, l, u, x0, y0, status_tol: float, *,
                 iters: int, rho: float, sigma: float, alpha: float,
                 rho_eq_scale: float, equilibrate_iters: int,
                 adapt_rounds: int) -> QPSolution:
    """One launch of a whole-solve kernel (`admm_solve_fused` or
    `admm_solve_plain_warp`: the scaled x, y and D, E, c), then the
    unscaling, the residuals and `ok` here."""
    B, n = q.shape
    m = A.shape[1]
    dtype = P.dtype
    eqf = ((u - l) < 1e-9).to(dtype)
    xs, ys, D, E, c = kernel(
        *(t.contiguous() for t in (P, q, A, l, u, eqf)),
        (P.new_zeros((B, n)) if x0 is None else x0.to(dtype)).contiguous(),
        (P.new_zeros((B, m)) if y0 is None else y0.to(dtype)).contiguous(),
        iters=iters, adapt_rounds=adapt_rounds,
        equilibrate_iters=equilibrate_iters, rho0=rho, sigma=sigma,
        alpha=alpha, rho_eq_scale=rho_eq_scale, inf=INF)
    return _unscaled_solution(P, q, A, l, u, xs, ys, D, E, c, status_tol)


def _kkt_error(P, q, A, l, u, x, y):
    """Per scenario max(|P x + q + A' y|, bound violation of A x), the
    stationarity in df32 (qp/precision.py)."""
    Ax = _mv(A, x)
    viol = torch.maximum(torch.clamp_min(Ax - u, 0.0).amax(dim=-1),
                         torch.clamp_min(l - Ax, 0.0).amax(dim=-1))
    stat = residual_matvec(-(q + _mtv(A, y)), P, x).abs().amax(dim=-1)
    return torch.maximum(stat, viol)


def _polish(P, q, A, l, u, x, y, eq, active_tol: float = 1e-3,
            delta: float = 1e-4):
    """Device-side OSQP polish: a masked-KKT solve on the detected active
    set, per scenario (JAX `_polish`), and one correction of that set.

    Fixed shapes instead of slicing the active rows:
        [[P + delta I,   A' diag(mask)], [x ]   [      -q        ]
         [diag(mask) A,  -D_nu        ]] [nu] = [ mask * b_active ]
    with D_nu = delta on active rows and 1 on inactive ones, which pins
    nu_i = 0 for inactive constraints.  One batched LU factorisation of the
    regularised system, three refinement steps against the UNregularised
    one with the residual in df32, and the polished point kept only where
    its df32 KKT error is no larger than the ADMM iterate's (a float32
    objective comparison is noise in the MPC QP's flat valleys).

    The correction.  An inequality row taken as active whose multiplier
    comes out with the wrong sign (> 0 at a lower bound, < 0 at an upper
    one, beyond the noise floor _SIGN_ULPS eps max|y|) may not be active at
    the optimum: pinned to a bound the optimum leaves, the point is
    stationary and feasible, so the KKT error cannot tell.  In float32 such
    rows (within active_tol of their bound, multipliers 5.9e-7 - 6.6e-6 of
    the wrong sign, 7.8e-5 - 1.0e-3 of the largest) moved 4 of 512 MPC
    solutions by 1.0e-4 - 6.6e-4 from the float64 oracle's; the other 508
    had no wrong sign at all.  The sign alone does not decide: it misfires
    on degenerate rows (both pyramid sides tight at mu fz = 0), as on 12 of
    160 float64 WBC polishes over the oracle's ticks, by up to 0.37 of the
    largest multiplier.  So the scenarios with a wrong sign solve once more
    without those rows, and that point replaces the first only where each
    dropped row still holds (within _SIGN_ULPS eps (1 + |bound|)) and its
    KKT error passes the same bar; else the first polish stands (or the
    iterate, as before).  The second solve runs on those scenarios alone,
    after one host synchronisation (the polish is never captured in a CUDA
    graph)."""
    Ax = _mv(A, x)
    # a side can only be active if its bound is finite
    low = (l > -INF) & ((y < -active_tol) | ((Ax - l).abs() < active_tol))
    upp = (u < INF) & ((y > active_tol) | ((Ax - u).abs() < active_tol))
    low = (low | eq) & ~(upp & ~eq)
    xp, yp = _active_set_solve(P, q, A, l, u, low, upp, delta)
    err_x = _kkt_error(P, q, A, l, u, x, y)
    noise = _SIGN_ULPS * torch.finfo(P.dtype).eps
    floor = noise * yp.abs().amax(dim=-1, keepdim=True)
    wrong = ~eq & ((low & (yp > floor)) | (upp & (yp < -floor)))
    ok = (_kkt_error(P, q, A, l, u, xp, yp) <= err_x)[:, None]
    xp, yp = torch.where(ok, xp, x), torch.where(ok, yp, y)
    redo = wrong.any(dim=-1)
    if bool(redo.any()):
        i = redo.nonzero()[:, 0]
        Pi, qi, Ai, li, ui = P[i], q[i], A[i], l[i], u[i]
        wi, lo_i, up_i = wrong[i], low[i], upp[i]
        xr, yr = _active_set_solve(Pi, qi, Ai, li, ui, lo_i & ~wi,
                                   up_i & ~wi, delta)
        Axr = _mv(Ai, xr)
        b = torch.where(lo_i, li, ui)
        slack = torch.where(lo_i, Axr - li, ui - Axr)
        holds = ~(wi & (slack < -noise * (1.0 + b.abs()))).any(dim=-1)
        take = (holds & (_kkt_error(Pi, qi, Ai, li, ui, xr, yr)
                         <= err_x[i]))[:, None]
        xp[i] = torch.where(take, xr, xp[i])
        yp[i] = torch.where(take, yr, yp[i])
    return xp, yp


# multipliers and slacks within this many ulps of their scale are rounding
# (`_polish`'s sign correction)
_SIGN_ULPS = 64


def _active_set_solve(P, q, A, l, u, low, upp, delta: float):
    """(x, y) of the equality-constrained QP with the rows `low` at l and
    `upp` at u, the rest free: `_polish`'s masked KKT system."""
    B, n = q.shape
    dtype = P.dtype
    act = low | upp
    mask = act.to(dtype)
    b = torch.where(low, l, u)

    AtM = A.transpose(1, 2) * mask[:, None, :]                # (B, n, m)
    eye = torch.eye(n, dtype=dtype, device=P.device)
    d_nu = torch.where(act, delta, 1.0).to(dtype)
    kkt_reg = torch.cat([
        torch.cat([P + delta * eye, AtM], dim=2),
        torch.cat([AtM.transpose(1, 2), torch.diag_embed(-d_nu)], dim=2),
    ], dim=1)
    rhs = torch.cat([-q, mask * b], dim=1)
    # lu_factor_ex: no host-side check of `info` (no synchronisation; a
    # singular system gives non-finite values in its own scenario, which the
    # acceptance test of `_polish` then rejects)
    lu, piv, _ = torch.linalg.lu_factor_ex(kkt_reg)

    def solve(r):
        return torch.linalg.lu_solve(lu, piv, r[:, :, None])[:, :, 0]

    sol = solve(rhs)
    kkt0 = torch.cat([
        torch.cat([P, AtM], dim=2),
        torch.cat([AtM.transpose(1, 2),
                   torch.diag_embed(-torch.where(act, 0.0, 1.0).to(dtype))],
                  dim=2),
    ], dim=1)
    # the refinement residual in df32: a plain float32 mat-vec has an
    # accumulation floor of ~n eps |terms| ~ 1e-4 in the unscaled frame
    for _ in range(3):
        sol = sol + solve(residual_matvec(rhs, kkt0, sol))
    return sol[:, :n], sol[:, n:] * mask


def _unscaled_solution(P0, q0, A0, l0, u0, xs, ys, D, E, c,
                       status_tol: float) -> QPSolution:
    """Unscale (x = D xs, y = E ys / c) and report unscaled residuals."""
    x = D * xs
    y = E * ys / c[:, None]
    Ax0 = _mv(A0, x)
    z_u = torch.minimum(torch.maximum(Ax0, l0), u0)
    prim = _amax(Ax0 - z_u) if A0.shape[1] else x.new_zeros((x.shape[0],))
    dual = _amax(_mv(P0, x) + q0 + _mtv(A0, y))
    # prim >= 0, and `prim < status_tol` is False where it is NaN or inf
    ok = torch.isfinite(x).all(dim=-1) & (prim < status_tol)
    return QPSolution(x=x, y=y, z=z_u, prim_res=prim, dual_res=dual, ok=ok)
