"""Batched dense ADMM QP core (counterpart of the JAX package's qp/admm.py).

Solves, for every scenario b of a batch,

    min_x 1/2 x'P x + q'x   s.t.  l <= A x <= u

with the OSQP operator splitting and a FIXED iteration count, so every
scenario runs in lockstep and nothing depends on the data:

  * norm-only Ruiz equilibration + cost scaling (`ruiz_equilibrate`);
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
  "torch"    the plain loop of batched matmuls (JAX: "xla").
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

Not ported yet, each raising NotImplementedError by name: modes "inv",
"exact_inv" and "cholesky", and `polish_kkt` (with qp/precision.py).
"""

from __future__ import annotations

import dataclasses

import torch

from mpctsid_tpu_torch.qp.blockinv import spd_inverse_chol
from mpctsid_tpu_torch.qp.kernels import (_mtv, _mv, admm_iterate,
                                          admm_iterate_m2, admm_iterate_vpu,
                                          admm_iterate_vpu_packed,
                                          admm_solve_fused)

INF = 1e20

__all__ = ["INF", "QPSolution", "ruiz_equilibrate", "admm_solve"]


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


def _run_block(P, q, A, l, u, eqf, rho_s, x, z, y, n_iters: int,
               sigma: float, alpha: float, rho_eq_scale: float, backend: str):
    """n_iters ADMM iterations at per-scenario rho_s (B,) with the eq boost.

    A function of its own so that K, K^-1 and M2 are freed when it returns:
    at B = 4096, n = 192 each of them is 604 MB."""
    rho_vec = ((1.0 + eqf * (rho_eq_scale - 1.0)) * rho_s[:, None]).contiguous()
    K = torch.bmm((A * rho_vec[:, :, None]).transpose(1, 2), A)
    K += P
    K.diagonal(dim1=-2, dim2=-1).add_(sigma)
    # Blocked Cholesky + triangular inverse + 1 Newton-Schulz correction
    K_inv = spd_inverse_chol(K, ns_steps=1)

    if backend == "m2":
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

    if backend in _ITERATION_KERNELS:
        # K^-1, K and A go to the kernel as they are; it keeps them on chip
        # for all iterations and forms the refinement residual explicitly
        return _ITERATION_KERNELS[backend](
            K_inv.contiguous(), K, A, q, l, u, rho_vec, x, z, y,
            iters=n_iters, sigma=sigma, alpha=alpha)

    rho_inv = 1.0 / rho_vec
    for _ in range(n_iters):
        rhs = sigma * x - q + _mtv(A, rho_vec * z - y)
        # one iterative-refinement step squares the explicit inverse's
        # relative error for two extra matmuls
        x_a = _mv(K_inv, rhs)
        x_t = x_a + _mv(K_inv, rhs - _mv(K, x_a))
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
    if mode != "blockinv":
        raise NotImplementedError(
            f"admm_solve mode {mode!r} is not ported to mpctsid_tpu_torch "
            "yet (modes 'inv', 'exact_inv' and 'cholesky' are reference "
            "paths of the JAX package); use mode='blockinv'")
    if polish_kkt:
        raise NotImplementedError(
            "admm_solve(polish_kkt=True): the active-set KKT polish (_polish, "
            "qp/precision.py) is not ported to mpctsid_tpu_torch yet")
    if P.dim() != 3:
        raise ValueError(
            f"P must carry a leading scenario axis (B, n, n); got "
            f"{tuple(P.shape)}")
    backend = _resolve_backend(backend, P.device)
    B, n, _ = P.shape
    m = A.shape[1]
    dtype = P.dtype

    P0, q0, A0, l0, u0 = P, q, A, l, u
    eqf = ((u0 - l0) < 1e-9).to(dtype)

    if backend == "fused":
        # One launch per solve: Ruiz, K assembly, the Cholesky-based inverse,
        # all iterations and the rho adaptation (qp/kernels.py).  The plain
        # path of a WBC-sized solve is thousands of tiny device ops and is
        # launch bound.
        xs, ys, D, E, c = admm_solve_fused(
            *(t.contiguous() for t in (P, q, A, l, u, eqf)),
            (P.new_zeros((B, n)) if x0 is None else x0.to(dtype)).contiguous(),
            (P.new_zeros((B, m)) if y0 is None else y0.to(dtype)).contiguous(),
            iters=iters, adapt_rounds=adapt_rounds,
            equilibrate_iters=equilibrate_iters, rho0=rho, sigma=sigma,
            alpha=alpha, rho_eq_scale=rho_eq_scale, inf=INF)
        return _unscaled_solution(P0, q0, A0, l0, u0, xs, ys, D, E, c,
                                  status_tol)

    P, q, A, l, u, D, E, c = ruiz_equilibrate(P, q, A, l, u, equilibrate_iters)

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
                             sigma, alpha, rho_eq_scale, backend)
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

    return _unscaled_solution(P0, q0, A0, l0, u0, x, y, D, E, c, status_tol)


def _unscaled_solution(P0, q0, A0, l0, u0, xs, ys, D, E, c,
                       status_tol: float) -> QPSolution:
    """Unscale (x = D xs, y = E ys / c) and report unscaled residuals."""
    x = D * xs
    y = E * ys / c[:, None]
    Ax0 = _mv(A0, x)
    z_u = torch.minimum(torch.maximum(Ax0, l0), u0)
    prim = _amax(Ax0 - z_u) if A0.shape[1] else x.new_zeros((x.shape[0],))
    dual = _amax(_mv(P0, x) + q0 + _mtv(A0, y))
    ok = (torch.isfinite(x).all(dim=-1) & torch.isfinite(prim)
          & (prim < status_tol))
    return QPSolution(x=x, y=y, z=z_u, prim_res=prim, dual_res=dual, ok=ok)
