"""The port's hand-written kernels and their plain PyTorch versions.

Eight kernels, all CUDA C++ under qp/csrc/: five replace a TPU kernel of the
JAX package's qp/pallas_kernels.py and keep its function name, three replace
stages that the JAX package leaves to XLA:

  * `admm_iterate_m2` (admm_m2.cu) <- `admm_iterate_m2` /
    `admm_iterate_m2_packed_batch`: `iters` ADMM updates with the refinement
    folded into one precomputed map M2 = 2 K^-1 - K^-1 K K^-1.  The MPC
    stage's iterations (inequality-only QPs).  A thread-block cluster per
    scenario, the least (1 to 8 blocks) that holds row slices of M2 (in
    registers where they fit) and of A (in shared memory): `m2_layout`.
  * `admm_iterate_vpu` (admm_vpu.cu) <- `admm_iterate_vpu`: `iters` updates
    with the EXPLICIT refinement x_a = K^-1 rhs, r = rhs - K' x_a,
    x_t = x_a + K^-1 r; valid with equality rows.  n <= 32: one warp per
    scenario with K^-1 and K in registers; larger: one block per scenario
    (`vpu_layout`).
  * `admm_iterate_vpu_packed` (admm_packed.cu) <- `admm_iterate_vpu_packed` /
    `admm_iterate_packed`: the same function for small matrices, several
    scenarios per block, one warp each: n <= 32 with K^-1 and K in
    registers by kernel 2's own loop (warp_regs.cuh) after a coalesced,
    staged load; larger n with the matrices in the warp's slice of shared
    memory (`packed_layout`).
  * `admm_solve_fused` (admm_fused.cu) <- `admm_solve_fused` /
    `admm_solve_fused_batch`: the whole solve in one launch (full-rescale
    Ruiz, per adapt round K, its Cholesky-based inverse with one
    Newton-Schulz step, the refined iterations, rho adaptation); returns the
    SCALED x, y and the scales D, E, c.  n <= 32: one warp per scenario,
    several per block; larger: one block per scenario (`fused_layout`).
  * `admm_solve_plain_warp` (admm_fused.cu, its second entry point): the
    function of qp/admm.py::admm_solve(backend="torch") — the JAX package's
    admm_solve(backend="xla"), which XLA compiles — in one launch: kernel
    4's warp factorization with the NORM-ONLY Ruiz form of
    `ruiz_equilibrate`, K and K^-1 held in registers, the iterations on the
    register loop of kernels 2 and 3 (warp_regs.cuh); returns the scaled x,
    y and D, E, c as kernel 4 does.  n <= 32 only
    (`plain_warp_layout`); the default WBC solve on the card
    (wbc/tsid.py::_solve_tick).  Its plain version is the eager chain itself
    (`admm_solve_plain_reference` stops it before the unscaling).
  * `chol_inverse` (spd_inverse.cu) <- the XLA compilation of
    `spd_inverse_chol(K, ns_steps=1)` (qp/blockinv.py): K^-1 of the kernel
    backends (qp/admm.py, mode "blockinv").  n <= 32: one warp per matrix,
    the whole function in one launch (the warp factorization shared with
    kernel 4, spd_inverse.cuh); larger: one block per matrix for the
    Cholesky factor, the triangular inverse and X0 = L^-T L^-1, blocked by
    panels of 32 columns (spd_blocked.h), the dense products of the
    Newton-Schulz step on torch.bmm, a second launch for the guard
    (`spd_inverse_layout`).  Plain version: blockinv.spd_inverse_chol.
  * `ruiz_equilibrate` (ruiz.cu) <- the XLA compilation of qp/admm.py's
    `ruiz_equilibrate` (the norm-only equilibration and cost scaling, and
    the scaled problem): the first step of every solve on the kernel
    backends (qp/admm.py::scaled_solve: "m2", "vpu", "packed", "mma").  A
    warp per scenario at the WBC's shape (n <= 32, m <= 64: columns in
    lanes' registers), else a thread-block cluster per scenario, each block
    a slice of the columns with its columns of P in shared memory where
    they fit; A read through its batch stride (the MPC's stride-0
    constraint matrix is never materialized): `ruiz_layout`.  Plain
    version: admm.ruiz_equilibrate.
  * `admm_iterate` (admm_mma.cu) <- `admm_iterate` (backend "pallas"): the
    generic iteration with K applied AS GIVEN (r = rhs - K x_a) and every
    mat-vec on the tensor cores: warp-level TF32 `mma.sync` with each
    operand split into two TF32 parts in the kernel (three for the
    cancelling product K x_a), so that the products keep f32 accuracy.  Any
    shape; small scenarios one WARP each, several per block, large ones a
    thread-block CLUSTER each with the matrices resident in the cluster's
    shared memory (`mma_layout` decides).

Every wrapper checks its arguments; on CUDA tensors it launches its kernel on
PyTorch's current stream and raises on any failure (bad argument, build
failure, launch error): there is no fallback.  On CPU tensors, and only
because the tensors lie on the CPU, it runs the plain version.
`<wrapper>.launches` counts kernel launches (a plain integer, incremented
only where the kernel launches; `chol_inverse`'s block path counts its two
launches, factor and guard, as one call).

Plain versions, used by the CPU tests and by the on-card comparison of
chip_smoke.py and by nothing on the CUDA main path:
`admm_iterate_m2_reference`, `admm_iterate_refined_reference` (ONE plain
version for `admm_iterate_vpu` and `admm_iterate_vpu_packed`: they compute
the same function), `admm_iterate_reference` (the same loop with K as given),
`admm_solve_fused_reference`, `admm_solve_plain_reference` (qp/admm.py's own
chain), blockinv.spd_inverse_chol and admm.ruiz_equilibrate.

Matrix sides.  M2, K and K^-1 are symmetric only up to rounding, so the side
each is applied from is part of the function, and is the TPU kernels': M2
TRANSPOSED (x_t[j] = sum_i M2[i, j] rhs[i]); K^-1 as given (x_a[i] =
sum_j K^-1[i, j] rhs[j]); K TRANSPOSED (sum_i K[i, j] x_a[i]) in
`admm_iterate_vpu`, `admm_iterate_vpu_packed` and `admm_solve_fused`, but AS
GIVEN (sum_j K[i, j] x_a[j]) in `admm_iterate`.  A is passed row-major
(B, m, n) as the caller holds it; no transposed copy is made.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from mpctsid_tpu_torch.dyn.kernels import rows
from mpctsid_tpu_torch.qp.blockinv import spd_inverse_chol

__all__ = ["admm_iterate_m2", "admm_iterate_m2_reference", "check_m2_args",
           "admm_iterate_vpu", "admm_iterate_vpu_packed",
           "admm_iterate_refined_reference", "check_refined_args",
           "admm_iterate", "admm_iterate_reference",
           "device_limits", "packed_layout", "packed_slot_floats",
           "fused_layout", "mma_layout",
           "m2_layout", "m2_block", "m2_active_clusters", "vpu_layout",
           "row_slices",
           "FusedLayout", "MmaLayout", "M2Layout", "PackedLayout",
           "VpuLayout",
           "admm_solve_fused",
           "admm_solve_fused_reference",
           "check_fused_args", "build_all", "LIBRARIES",
           "admm_solve_plain_warp", "admm_solve_plain_reference",
           "plain_warp_layout", "plain_warp_slot_floats", "chol_inverse",
           "check_spd_args", "spd_inverse_layout", "spd_block_floats",
           "SpdLayout", "ruiz_equilibrate", "ruiz_layout", "RuizLayout",
           "check_ruiz_args", "run_ruiz", "ruiz_smem_floats",
           "ruiz_slice_width", "build_specs"]


# ------------------------------------------------------------ argument checks

def _check_tensors(named: dict, first: str) -> None:
    """All float32 tensors, on the device of `first`, contiguous."""
    ref = named[first]
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != ref.device:
            raise ValueError(f"{name} is on {t.device}, {first} on "
                             f"{ref.device}: one device only")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (strides "
                             f"{t.stride()} for shape {tuple(t.shape)})")


def _check_shapes(named: dict, square: tuple, n_vecs: tuple, m_vecs: tuple):
    """Square matrices (B, n, n), A (B, m, n), vectors (B, n) / (B, m);
    returns (B, n, m)."""
    first = named[square[0]]
    if first.dim() != 3 or first.shape[1] != first.shape[2]:
        raise ValueError(f"{square[0]} must be (B, n, n), got "
                         f"{tuple(first.shape)}")
    B, n, _ = first.shape
    for name in square[1:]:
        if tuple(named[name].shape) != (B, n, n):
            raise ValueError(f"{name} must be ({B}, {n}, {n}), got "
                             f"{tuple(named[name].shape)}")
    A = named["A"]
    if A.dim() != 3 or A.shape[0] != B or A.shape[2] != n:
        raise ValueError(f"A must be (B={B}, m, n={n}), got {tuple(A.shape)}")
    m = A.shape[1]
    if B < 1 or n < 1 or m < 1:
        raise ValueError(f"empty problem: B={B}, n={n}, m={m}")
    for names, width in ((n_vecs, n), (m_vecs, m)):
        for name in names:
            if tuple(named[name].shape) != (B, width):
                raise ValueError(f"{name} must be ({B}, {width}), got "
                                 f"{tuple(named[name].shape)}")
    return B, n, m


def check_m2_args(M2, A, q, l, u, rho_vec, x, z, y):
    """Raise unless the arguments are what the M2 kernel takes; returns
    (B, n, m).

    All float32, on one device, contiguous; M2 (B, n, n), A (B, m, n),
    q, x (B, n), l, u, rho_vec, z, y (B, m)."""
    named = dict(M2=M2, A=A, q=q, l=l, u=u, rho_vec=rho_vec, x=x, z=z, y=y)
    _check_tensors(named, "M2")
    return _check_shapes(named, ("M2",), ("q", "x"),
                         ("l", "u", "rho_vec", "z", "y"))


def check_refined_args(K_inv, K, A, q, l, u, rho_vec, x, z, y):
    """Raise unless the arguments are what the refined-iteration kernels
    (`admm_iterate_vpu`, `admm_iterate_vpu_packed`, `admm_iterate`) take;
    returns (B, n, m).

    All float32, on one device, contiguous; K_inv, K (B, n, n), A (B, m, n),
    q, x (B, n), l, u, rho_vec, z, y (B, m)."""
    named = dict(K_inv=K_inv, K=K, A=A, q=q, l=l, u=u, rho_vec=rho_vec, x=x,
                 z=z, y=y)
    _check_tensors(named, "K_inv")
    return _check_shapes(named, ("K_inv", "K"), ("q", "x"),
                         ("l", "u", "rho_vec", "z", "y"))


def check_fused_args(P, q, A, l, u, eqf, x0, y0):
    """Raise unless the arguments are what the whole-solve kernel takes;
    returns (B, n, m).

    All float32, on one device, contiguous; P (B, n, n), A (B, m, n),
    q, x0 (B, n), l, u, eqf, y0 (B, m)."""
    named = dict(P=P, q=q, A=A, l=l, u=u, eqf=eqf, x0=x0, y0=y0)
    _check_tensors(named, "P")
    return _check_shapes(named, ("P",), ("q", "x0"), ("l", "u", "eqf", "y0"))


def check_spd_args(K):
    """Raise unless K is what the SPD-inverse kernel takes: float32,
    contiguous, (B, n, n); returns (B, n)."""
    _check_tensors({"K": K}, "K")
    if K.dim() != 3 or K.shape[1] != K.shape[2]:
        raise ValueError(f"K must be (B, n, n), got {tuple(K.shape)}")
    B, n, _ = K.shape
    if B < 1 or n < 1:
        raise ValueError(f"empty problem: B={B}, n={n}")
    return B, n


def _check_iters(iters) -> int:
    iters = int(iters)
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    return iters


def _solve_kw(iters, adapt_rounds, equilibrate_iters, rho0, sigma, alpha,
              rho_eq_scale, inf) -> dict:
    """The whole-solve kernels' scalar arguments, checked and typed."""
    kw = dict(iters=_check_iters(iters), adapt_rounds=int(adapt_rounds),
              equilibrate_iters=int(equilibrate_iters), rho0=float(rho0),
              sigma=float(sigma), alpha=float(alpha),
              rho_eq_scale=float(rho_eq_scale), inf=float(inf))
    if kw["equilibrate_iters"] < 0:
        raise ValueError("equilibrate_iters must be >= 0")
    return kw


# ------------------------------------------------------------- plain versions

def _mv(M, v):
    """Batched (B, r, c) @ (B, c) -> (B, r)."""
    return torch.bmm(M, v[:, :, None])[:, :, 0]


def _mtv(M, v):
    """Batched M' v: (B, r, c), (B, r) -> (B, c), without a transposed copy."""
    return torch.bmm(v[:, None, :], M)[:, 0]


def _clip(v, lo, hi):
    return torch.minimum(torch.maximum(v, lo), hi)


def admm_iterate_m2_reference(M2, A, q, l, u, rho_vec, x, z, y,
                              iters: int = 25, sigma: float = 1e-6,
                              alpha: float = 1.6):
    """Plain PyTorch version of the M2 iteration; returns (x, z, y)."""
    rho_inv = 1.0 / rho_vec
    for _ in range(iters):
        rhs = sigma * x - q + _mtv(A, rho_vec * z - y)
        x_t = _mtv(M2, rhs)                                # M2' rhs
        z_t = _mv(A, x_t)
        x = alpha * x_t + (1.0 - alpha) * x
        z_r = alpha * z_t + (1.0 - alpha) * z
        z_n = _clip(z_r + rho_inv * y, l, u)
        y = y + rho_vec * (z_r - z_n)
        z = z_n
    return x, z, y


def _refined_loop(K_inv, K, A, q, l, u, rho_vec, x, z, y, iters: int,
                  sigma: float, alpha: float, k_transposed: bool):
    """The iteration with the explicit refinement r = rhs - K' x_a
    (`k_transposed`) or r = rhs - K x_a; returns (x, z, y)."""
    k_apply = _mtv if k_transposed else _mv
    rho_inv = 1.0 / rho_vec
    for _ in range(iters):
        rhs = sigma * x - q + _mtv(A, rho_vec * z - y)
        x_a = _mv(K_inv, rhs)                              # K^-1 rhs
        r = rhs - k_apply(K, x_a)
        x_t = x_a + _mv(K_inv, r)
        z_t = _mv(A, x_t)
        x = alpha * x_t + (1.0 - alpha) * x
        z_r = alpha * z_t + (1.0 - alpha) * z
        z_n = _clip(z_r + rho_inv * y, l, u)
        y = y + rho_vec * (z_r - z_n)
        z = z_n
    return x, z, y


def admm_iterate_refined_reference(K_inv, K, A, q, l, u, rho_vec, x, z, y,
                                   iters: int = 25, sigma: float = 1e-6,
                                   alpha: float = 1.6):
    """Plain PyTorch version of the iteration with the explicit refinement,
    K TRANSPOSED (r = rhs - K' x_a); returns (x, z, y).

    One plain version serves `admm_iterate_vpu` and `admm_iterate_vpu_packed`:
    the two kernels compute the same function and differ only in how they
    lay scenarios out on the card."""
    return _refined_loop(K_inv, K, A, q, l, u, rho_vec, x, z, y, iters,
                         sigma, alpha, k_transposed=True)


def admm_iterate_reference(K_inv, K, A, q, l, u, rho_vec, x, z, y,
                           iters: int = 25, sigma: float = 1e-6,
                           alpha: float = 1.6):
    """Plain PyTorch version of `admm_iterate`: the same loop with K AS GIVEN
    (r = rhs - K x_a); returns (x, z, y)."""
    return _refined_loop(K_inv, K, A, q, l, u, rho_vec, x, z, y, iters,
                         sigma, alpha, k_transposed=False)


def _amax(t):
    return t.abs().amax(dim=-1, keepdim=True)


def admm_solve_fused_reference(P, q, A, l, u, eqf, x0, y0,
                               iters: int, adapt_rounds: int,
                               equilibrate_iters: int, rho0: float,
                               sigma: float, alpha: float,
                               rho_eq_scale: float, inf: float):
    """Plain PyTorch version of the whole-solve kernel, step for step;
    returns the scaled (x, y) and the scales (D, E, c), c (B,).

    Mirrors `_admm_fused_kernel`: FULL-RESCALE Ruiz (the matrices are
    rescaled every round and the abs-max taken of the rescaled ones), warm
    start scaling, z = clip(A x, l, u), then per round K, its inverse
    (Jacobi scaling, Cholesky, triangular inverse, one guarded Newton-Schulz
    step, finite fallback: qp/blockinv.py), iters // adapt_rounds refined
    iterations and the rho adaptation.  A test oracle, not a fast path."""
    B, n = q.shape
    D = P.new_ones((B, n))
    E = P.new_ones((B, A.shape[1]))
    c = P.new_ones((B, 1))
    one = P.new_ones(())
    for _ in range(equilibrate_iters):
        cn = torch.maximum(P.abs().amax(dim=1), A.abs().amax(dim=1))
        cm = A.abs().amax(dim=2)
        dn = torch.where(cn < 1e-10, one,
                         torch.rsqrt(torch.clamp_min(cn, 1e-12)))
        dm = torch.where(cm < 1e-10, one,
                         torch.rsqrt(torch.clamp_min(cm, 1e-12)))
        P = P * dn[:, :, None] * dn[:, None, :]
        q = q * dn
        A = A * dm[:, :, None] * dn[:, None, :]
        D = D * dn
        E = E * dm
        pcol = P.abs().amax(dim=1)
        gamma = 1.0 / torch.clamp_min(
            torch.maximum(pcol.mean(dim=1, keepdim=True), _amax(q)), 1e-12)
        P = P * gamma[:, :, None]
        q = q * gamma
        c = c * gamma
    l = torch.where(l <= -inf, l, E * l)
    u = torch.where(u >= inf, u, E * u)

    x = x0 / D
    y = y0 * c / E
    z = _clip(_mv(A, x), l, u)

    rho_pat = 1.0 + eqf * (rho_eq_scale - 1.0)
    rho_s = P.new_full((B, 1), rho0)
    n_rounds = max(1, adapt_rounds)
    iters_per = max(1, iters // n_rounds)
    eye = torch.eye(n, dtype=P.dtype, device=P.device)
    for r_i in range(n_rounds):
        rho = rho_pat * rho_s
        K = P + sigma * eye + torch.bmm(
            (A * rho[:, :, None]).transpose(1, 2), A)
        K_inv = spd_inverse_chol(K, ns_steps=1)
        x, z, y = admm_iterate_refined_reference(
            K_inv, K, A, q, l, u, rho, x, z, y, iters=iters_per, sigma=sigma,
            alpha=alpha)
        if r_i + 1 < n_rounds:
            ax = _mv(A, x)
            px = _mtv(P, x)
            aty = _mtv(A, y)
            rp = _amax(ax - z) / torch.clamp_min(
                torch.maximum(_amax(ax), _amax(z)), 1e-12)
            rd = _amax(px + q + aty) / torch.clamp_min(
                torch.maximum(_amax(px),
                              torch.maximum(_amax(q), _amax(aty))), 1e-12)
            rho_s = torch.clamp(
                rho_s * torch.sqrt(rp / torch.clamp_min(rd, 1e-12)),
                1e-3, 1e3)
    return x, y, D, E, c[:, 0]


# ------------------------------------------------------------------ libraries

# name -> (sources, headers) under qp/csrc/; one shared library per kernel
LIBRARIES = {
    "admm_m2": (("admm_m2.cu",), ("cluster_exchange.cuh",)),
    "admm_vpu": (("admm_vpu.cu",), ("admm_block.cuh", "cluster_exchange.cuh",
                                     "warp_regs.cuh")),
    "admm_packed": (("admm_packed.cu",), ("admm_block.cuh",
                                           "cluster_exchange.cuh",
                                           "packed_slot.h", "warp_regs.cuh")),
    "admm_fused": (("admm_fused.cu",), ("admm_block.cuh", "spd_blocked.h",
                                         "spd_inverse.cuh", "warp_regs.cuh")),
    "admm_mma": (("admm_mma.cu",), ("admm_block.cuh", "cluster_exchange.cuh")),
    "spd_inverse": (("spd_inverse.cu",), ("admm_block.cuh",
                                           "cluster_exchange.cuh",
                                           "spd_blocked.h",
                                           "spd_inverse.cuh")),
    "ruiz": (("ruiz.cu",), ("ruiz.h", "cluster_exchange.cuh")),
}

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_FLT = ctypes.c_float
_LAUNCH_ARGTYPES = {
    "admm_m2": [_PTR] * 12 + [_INT] * 4 + [_FLT] * 2 + [_INT] * 5 + [_PTR],
    "admm_vpu": [_PTR] * 13 + [_INT] * 4 + [_FLT] * 2 + [_INT] * 4 + [_PTR],
    "admm_packed": [_PTR] * 13 + [_INT] * 4 + [_FLT] * 2 + [_INT] * 4 + [_PTR],
    "admm_fused": [_PTR] * 14 + [_INT] * 6 + [_FLT] * 5 + [_INT] * 4 + [_PTR],
    "admm_mma": [_PTR] * 13 + [_INT] * 4 + [_FLT] * 2 + [_INT] * 6 + [_PTR],
}
# the libraries' other entry points: name -> {function: (argtypes, restype)}
_ENTRY_POINTS = {
    "admm_m2": {"admm_m2_active_clusters": ([_INT] * 4, _INT)},
    "admm_packed": {"admm_packed_slot_floats": ([_INT] * 3, _INT)},
    "admm_fused": {
        "admm_fused_workspace_floats": ([_INT] * 4, ctypes.c_longlong),
        "admm_plain_warp_launch": (
            [_PTR] * 13 + [_INT] * 6 + [_FLT] * 5 + [_INT] * 3 + [_PTR],
            _INT)},
    "ruiz": {
        "ruiz_launch": ([ctypes.POINTER(_PTR),
                         ctypes.POINTER(ctypes.c_longlong),
                         ctypes.POINTER(_PTR)] + [_INT] * 8 + [_PTR], _INT),
        "ruiz_smem_floats": ([_INT] * 6, ctypes.c_longlong),
        "ruiz_threads": ([_INT] * 3, _INT),
        "ruiz_blocks_per_sm": ([_INT] * 6, _INT)},
    "spd_inverse": {
        "spd_inverse_warp_launch": ([_PTR] * 2 + [_INT] * 3 + [_PTR], _INT),
        "spd_inverse_factor_launch": ([_PTR] * 6 + [_INT] * 4 + [_PTR],
                                      _INT),
        "spd_inverse_select_launch": ([_PTR] * 6 + [_INT] * 2 + [_PTR],
                                      _INT)},
}

_LIBS: dict = {}


def build_specs() -> list:
    """(name, sources, headers) of each library under qp/csrc/, for
    `qp/_build.py::build_libraries`."""
    return [(name, src, hdr) for name, (src, hdr) in LIBRARIES.items()]


def build_all() -> None:
    """Build every kernel library that is missing, all `nvcc` runs started
    together (each library is otherwise built at its first launch)."""
    from mpctsid_tpu_torch.qp import _build

    _build.build_libraries(build_specs())


def _library(name: str):
    """The built library of one kernel (builds it on first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        from mpctsid_tpu_torch.qp import _build

        lib = _build.load_library(name, *LIBRARIES[name])
        entries = dict(_ENTRY_POINTS.get(name, {}))
        if name in _LAUNCH_ARGTYPES:
            entries[f"{name}_launch"] = (_LAUNCH_ARGTYPES[name], _INT)
        entries[f"{name}_error_string"] = ([_INT], ctypes.c_char_p)
        for fn, (argtypes, restype) in entries.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _LIBS[name] = lib
    return lib


def _raise_on(rc: int, lib, name: str, B: int, n: int, m: int) -> None:
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed (B={B}, n={n}, "
                           f"m={m}): CUDA error {rc}: {msg}")


def _require_cuda(dev: torch.device, what: str) -> None:
    if dev.type != "cuda":
        raise RuntimeError(f"{what} runs on cuda or cpu, not {dev}")


def _pick_threads(n: int) -> int:
    """Block size: up to four row-chunk groups of one thread per column."""
    col_threads = min((n + 31) // 32 * 32, 1024)
    return col_threads * max(1, min(1024 // col_threads, 4))


def device_limits(dev: torch.device):
    """(shared memory a block may opt in to, in bytes; multiprocessors)."""
    props = torch.cuda.get_device_properties(dev)
    return props.shared_memory_per_block_optin, props.multi_processor_count


def _slots_per_block(fit: int, cap: int, B: int, n_sm: int) -> int:
    """Scenarios (warps) per block: what fits, at most `cap`, and no more
    than spreads B over `n_sm` multiprocessors."""
    return max(1, min(cap, fit, -(-B // max(1, n_sm))))


# ------------------------------------------------------------------- wrappers

def _launch_iteration(name: str, inputs, x, z, y, dims, iters: int,
                      sigma: float, alpha: float, geometry):
    """Launch `<name>_launch` of an iteration kernel on the current stream:
    `inputs` then the iterates x, z, y in, new x, z, y out (allocated here),
    then B, n, m, iters, sigma, alpha and the kernel's launch `geometry`.
    Raises on a launch error; returns (x, z, y)."""
    lib = _library(name)
    outs = tuple(torch.empty_like(t) for t in (x, z, y))
    dev = x.device
    with torch.cuda.device(dev):
        rc = getattr(lib, f"{name}_launch")(
            *(t.data_ptr() for t in (*inputs, x, z, y, *outs)), *dims, iters,
            float(sigma), float(alpha), *geometry,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, lib, name, *dims)
    return outs


MAX_CLUSTER = 8         # blocks per cluster, the portable maximum
MAX_M2_THREADS = 512    # admm_m2.cu: __launch_bounds__
M2_REG_ROWS = 12        # admm_m2.cu: rows of M2 per thread in registers
M2_BARRIER_FLOATS = 4   # admm_m2.cu: two 8-byte barriers of the exchange
RES_M2, RES_M2_A, RES_M2_REGS = 1, 2, 4


class M2Layout(NamedTuple):
    """How one launch of the M2 iteration kernel is laid out."""
    cluster: int       # blocks per scenario (a thread-block cluster)
    threads: int       # threads per block
    ld: int            # row stride of the matrices in shared memory
    resident: int      # RES_M2 | RES_M2_A | RES_M2_REGS: where slices live
    smem_floats: int   # floats of shared memory per block
    rows_n: int        # rows of M2 per block
    rows_m: int        # rows of A per block

    @property
    def geometry(self):
        """The launcher's trailing arguments."""
        return (self.cluster, self.threads, self.ld, self.resident,
                self.smem_floats)


def _round4(v: int) -> int:
    return (v + 3) // 4 * 4


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def m2_block(n: int, m: int, cluster: int, threads: int = 0):
    """(rows_n, rows_m, threads, vector floats) of one block of kernel 1 at
    a cluster size: whole groups of four rows per block, the last slices
    ragged or empty; unless `threads` is given, about 16 rows of A per chunk
    of a transposed product for each group of four columns, 64 to 512
    threads, and where that many threads hold M2's slice in registers
    (M2_REG_ROWS rows of four columns each), one such part per thread
    instead, none idle in the M2 product (384 threads against 480 at the
    MPC shape, 3.4 % faster: PERF.md); the vector floats as
    admm_m2.cu's m2_vec_floats()."""
    np_ = _round4(n)
    rows_n = _round4(_cdiv(n, cluster))
    rows_m = _round4(_cdiv(m, cluster))
    if not threads:
        threads = min(MAX_M2_THREADS, max(
            64, _cdiv((np_ // 4) * max(1, _cdiv(rows_m, 16)), 32) * 32))
        parts = (np_ // 4) * _cdiv(rows_n, M2_REG_ROWS)
        if parts <= threads:
            threads = max(64, _cdiv(parts, 32) * 32)
    part = max(4 * threads, np_, rows_m)
    vec = (M2_BARRIER_FLOATS + 3 * np_ + rows_n + M2_REG_ROWS + 7 * rows_m
           + part + cluster * (rows_n + np_))
    return rows_n, rows_m, threads, vec


def m2_layout(n: int, m: int, smem_bytes: int) -> M2Layout:
    """Which geometry a launch of `admm_iterate_m2` takes.

    A cluster of C blocks per scenario, C the least of 1 to 8 (8 is the
    portable maximum) at which a block holds its row slices of M2 and A:
    M2's in REGISTERS where each thread's part is at most M2_REG_ROWS rows
    of four columns (measured faster than M2 in shared memory: PERF.md),
    else in shared memory; A's in shared memory (rows padded to the
    stride ld, 4 mod 8 floats: the rows a quarter warp reads lie on
    different banks), beside the vectors, partial sums and exchange
    buffers.  The fewer blocks share a scenario, the less each exchange
    costs per FMA.  Shapes that one block holds stay one block (a cluster of
    1).  Where even 8 blocks cannot hold both slices, A is streamed from
    device memory every iteration (and M2 too where its slice does not fit
    either).  Neither the batch nor the multiprocessor count enters: one
    scenario is one cluster whatever the batch.  The launcher recomputes the
    block's floats from the geometry and refuses a mismatch.  Raises if the
    vectors alone do not fit."""
    np_ = _round4(n)
    ld = np_ if np_ % 8 == 4 else np_ + 4
    for cluster in range(1, MAX_CLUSTER + 1):
        rows_n, rows_m, threads, vec = m2_block(n, m, cluster)
        regs = (np_ // 4) * _cdiv(rows_n, M2_REG_ROWS) <= threads
        floats = vec + rows_m * ld + (0 if regs else rows_n * ld)
        if 4 * floats <= smem_bytes:
            resident = RES_M2_A | (RES_M2_REGS if regs else RES_M2)
            return M2Layout(cluster, threads, ld, resident, floats, rows_n,
                            rows_m)
    if 4 * vec > smem_bytes:
        raise ValueError(
            f"admm_iterate_m2: the vectors of n={n}, m={m} need {4 * vec} "
            f"bytes of shared memory per block even across a cluster of 8, "
            f"a block has {smem_bytes}")
    resident, floats = 0, vec
    for bit, rows in ((RES_M2, rows_n), (RES_M2_A, rows_m)):
        if 4 * (floats + rows * ld) <= smem_bytes:
            resident |= bit
            floats += rows * ld
    return M2Layout(MAX_CLUSTER, threads, ld, resident, floats, rows_n,
                    rows_m)


def admm_iterate_m2(M2, A, q, l, u, rho_vec, x, z, y,
                    iters: int = 25, sigma: float = 1e-6, alpha: float = 1.6):
    """`iters` M2-folded ADMM updates for a batch; returns (x, z, y).

    CUDA tensors: launches the hand-written kernel with the geometry of
    `m2_layout`, or raises (also when the card cannot schedule the
    cluster: nothing is handed to another layout).  CPU tensors: the plain
    version.  See the module docstring."""
    B, n, m = check_m2_args(M2, A, q, l, u, rho_vec, x, z, y)
    iters = _check_iters(iters)
    if M2.device.type == "cpu":
        return admm_iterate_m2_reference(M2, A, q, l, u, rho_vec, x, z, y,
                                         iters=iters, sigma=sigma, alpha=alpha)
    _require_cuda(M2.device, "admm_iterate_m2")
    lay = m2_layout(n, m, device_limits(M2.device)[0])
    out = _launch_iteration("admm_m2", (M2, A, q, l, u, rho_vec), x, z, y,
                            (B, n, m), iters, sigma, alpha, lay.geometry)
    admm_iterate_m2.launches += 1
    return out


admm_iterate_m2.launches = 0


def m2_active_clusters(lay: M2Layout, dev=None) -> int:
    """How many clusters of `lay` the card holds at once (the occupancy
    calculator's answer; 0: the launch would be refused)."""
    lib = _library("admm_m2")
    with torch.cuda.device(dev if dev is not None else
                           torch.cuda.current_device()):
        got = lib.admm_m2_active_clusters(lay.cluster, lay.threads,
                                          lay.resident, lay.smem_floats)
    if got < 0:
        _raise_on(-got, lib, "admm_m2", 0, 0, 0)
    return got


MAX_VPU_N = 32          # kernel 2's warp path: lane i owns row i
VPU_LD = 36             # its row stride of A: 4 mod 8 floats, at least 32
MAX_VPU_SLOTS = 4       # warps per block there (admm_vpu.cu allows 8)


class VpuLayout(NamedTuple):
    """How one launch of the generic refined-iteration kernel is laid out."""
    path: str          # "warp": a warp per scenario; "block": a block each
    g: int             # scenarios (warps) per block on the warp path, else 0
    threads: int       # threads per block
    ld: int            # row stride of A in shared memory (warp path)
    slot_floats: int   # floats of shared memory per scenario (warp path)

    @property
    def geometry(self):
        """The launcher's trailing arguments."""
        return (self.g, self.threads, self.ld, self.slot_floats)


def vpu_layout(n: int, m: int, B: int, smem_bytes: int,
               n_sm: int) -> VpuLayout:
    """Which path a launch of `admm_iterate_vpu` takes, and its parameters.

    n <= 32 and at least four scenarios fitting a block: the warp path.  One
    scenario's slot holds A (round4(m) rows of stride VPU_LD, the pad rows
    zero), rhs, x_a, r, x_t (32 floats each) and its seven m-vectors
    (round4(m) each); g is what fits in `smem_bytes`, at most MAX_VPU_SLOTS,
    and no more than spreads B over `n_sm` multiprocessors.  K^-1 and K sit
    in registers.  Otherwise the block path: one block per scenario,
    matrices in shared memory as far as they fit, the rest streamed."""
    mp = _round4(m)
    slot = mp * VPU_LD + 4 * MAX_VPU_N + 7 * mp
    fit = smem_bytes // (4 * slot)
    if n <= MAX_VPU_N and fit >= MIN_WARP_SLOTS:
        g = _slots_per_block(fit, MAX_VPU_SLOTS, B, n_sm)
        return VpuLayout("warp", g, 32 * g, VPU_LD, slot)
    return VpuLayout("block", 0, _pick_threads(n), 0, 0)


def admm_iterate_vpu(K_inv, K, A, q, l, u, rho_vec, x, z, y,
                     iters: int = 25, sigma: float = 1e-6, alpha: float = 1.6):
    """`iters` ADMM updates with the explicit refinement, any n and m (one
    warp per scenario for n <= 32, else one block: `vpu_layout`); returns
    (x, z, y).

    CUDA tensors: launches the hand-written kernel, or raises.  CPU tensors:
    the plain version.  See the module docstring."""
    B, n, m = check_refined_args(K_inv, K, A, q, l, u, rho_vec, x, z, y)
    iters = _check_iters(iters)
    if K_inv.device.type == "cpu":
        return admm_iterate_refined_reference(
            K_inv, K, A, q, l, u, rho_vec, x, z, y, iters=iters, sigma=sigma,
            alpha=alpha)
    _require_cuda(K_inv.device, "admm_iterate_vpu")
    lay = vpu_layout(n, m, B, *device_limits(K_inv.device))
    out = _launch_iteration("admm_vpu", (K_inv, K, A, q, l, u, rho_vec),
                            x, z, y, (B, n, m), iters, sigma, alpha,
                            lay.geometry)
    admm_iterate_vpu.launches += 1
    return out


admm_iterate_vpu.launches = 0

MAX_PACKED_REG_SLOTS = 4    # register path: warps per block (admm_packed.cu
                            # allows 16; PERF.md has the measurement)
MAX_PACKED_SHARED_SLOTS = 16    # shared path: warps per block
PACKED_PATHS = {"shared": 0, "registers": 1}    # packed_slot.h's PATH_*
PACKED_REG_LD = 36      # register path: A's row stride (packed_slot.h)


class PackedLayout(NamedTuple):
    """How one launch of the packed refined-iteration kernel is laid out."""
    path: str          # "registers": K^-1, K in registers; "shared": in the
                       # warp's slice of shared memory
    g: int             # scenarios (warps) per block
    threads: int       # threads per block
    ld: int            # row stride of A (of K^-1, K too on the shared path)
    slot_floats: int   # floats of shared memory per scenario

    @property
    def geometry(self):
        """The launcher's trailing arguments."""
        return (PACKED_PATHS[self.path], self.g, self.ld, self.slot_floats)


def packed_layout(n: int, m: int, B: int, smem_bytes: int, n_sm: int,
                  slot_floats) -> PackedLayout:
    """Which path a launch of `admm_iterate_vpu_packed` takes, and its
    parameters.

    `slot_floats(path, n, m)` is the kernel's own count of one scenario's
    floats of shared memory on a path (packed_slot.h, exported by the
    library as `admm_packed_slot_floats`: `packed_slot_floats`), -1 where
    the path does not take the shape.  n <= 32 with a slot that fits: the
    register path (K^-1 and K in registers, A at the row stride 36);
    otherwise, where a slot fits, the shared path (K^-1, K and A at the odd
    stride n | 1 in the warp's slice).  g, the scenarios (warps) per block,
    is what fits in `smem_bytes`, at most MAX_PACKED_REG_SLOTS or
    MAX_PACKED_SHARED_SLOTS, and no more than spreads B over `n_sm`
    multiprocessors.  Raises if not even one scenario fits: the packed
    kernel is for small matrices and hands nothing to another kernel."""
    for path, cap, ld in (("registers", MAX_PACKED_REG_SLOTS, PACKED_REG_LD),
                          ("shared", MAX_PACKED_SHARED_SLOTS, n | 1)):
        slot = int(slot_floats(PACKED_PATHS[path], n, m))
        if slot > 0 and 4 * slot <= smem_bytes:
            g = _slots_per_block(smem_bytes // (4 * slot), cap, B, n_sm)
            return PackedLayout(path, g, 32 * g, ld, slot)
    slot = int(slot_floats(PACKED_PATHS["shared"], n, m))
    raise ValueError(
        f"admm_iterate_vpu_packed: one scenario of n={n}, m={m} needs "
        f"{4 * slot} bytes of shared memory (K^-1, K, A and the vectors), a "
        f"block has {smem_bytes}; use admm_iterate_vpu (backend 'vpu'), "
        "which streams what does not fit")


def packed_slot_floats(path: int, n: int, m: int) -> int:
    """The packed kernel's floats of shared memory per scenario on `path`
    (0 shared, 1 registers), from its library (builds it on first use)."""
    return _library("admm_packed").admm_packed_slot_floats(path, n, m)


def admm_iterate_vpu_packed(K_inv, K, A, q, l, u, rho_vec, x, z, y,
                            iters: int = 25, sigma: float = 1e-6,
                            alpha: float = 1.6):
    """The function of `admm_iterate_vpu` for small matrices: several
    scenarios per block, one warp each (`packed_layout`); returns
    (x, z, y).

    CUDA tensors: launches the hand-written kernel, or raises (also when one
    scenario does not fit a block).  CPU tensors: the plain version.  See
    the module docstring."""
    B, n, m = check_refined_args(K_inv, K, A, q, l, u, rho_vec, x, z, y)
    iters = _check_iters(iters)
    dev = K_inv.device
    if dev.type == "cpu":
        return admm_iterate_refined_reference(
            K_inv, K, A, q, l, u, rho_vec, x, z, y, iters=iters, sigma=sigma,
            alpha=alpha)
    _require_cuda(dev, "admm_iterate_vpu_packed")
    lay = packed_layout(n, m, B, *device_limits(dev), packed_slot_floats)
    out = _launch_iteration("admm_packed", (K_inv, K, A, q, l, u, rho_vec),
                            x, z, y, (B, n, m), iters, sigma, alpha,
                            lay.geometry)
    admm_iterate_vpu_packed.launches += 1
    return out


admm_iterate_vpu_packed.launches = 0


MAX_FUSED_N = 32        # the warp path: lane i owns row i
FUSED_SCRATCH_STRIDE = 32   # row stride of the factorization's scratch
MAX_FUSED_SLOTS = 12    # warps per block there (leaves 170 registers each)
MIN_WARP_SLOTS = 4      # fewer scenarios per block: not worth a warp each


class FusedLayout(NamedTuple):
    """How one launch of the whole-solve kernel is laid out."""
    path: str          # "warp": a warp per scenario; "block": a block each
    threads: int       # block size of the block path (0 on the warp path)
    g: int             # scenarios (warps) per block on the warp path, else 0
    ld: int            # row stride in shared memory on the warp path
    slot_floats: int   # floats of shared memory per scenario there


def fused_layout(n: int, m: int, B: int, smem_bytes: int,
                 n_sm: int) -> FusedLayout:
    """Which path a launch of `admm_solve_fused` takes, and its parameters.

    n <= 32 and at least four scenarios fitting a block: the warp path.  One
    scenario's slot holds the scratch matrix W of the factorization (n rows
    of 32 floats, 16-byte aligned; at the end it holds K^-1), then P, A and
    K with rows padded to the odd stride ld = n | 1 (no bank conflicts by
    rows or by columns), as K^-1 is once it is done, and its 7 n + 10 m
    vector entries; g is what fits in `smem_bytes`, at most 12, and no more
    than spreads B over `n_sm` multiprocessors.  Otherwise the block path:
    one block per scenario, matrices in shared memory or, where they do not
    fit, in a global workspace."""
    ld = n | 1
    slot_floats = -(-(n * max(ld, FUSED_SCRATCH_STRIDE) + (2 * n + m) * ld
                      + 7 * n + 10 * m) // 4) * 4
    fit = smem_bytes // (4 * slot_floats)
    if n <= MAX_FUSED_N and fit >= MIN_WARP_SLOTS:
        g = _slots_per_block(fit, MAX_FUSED_SLOTS, B, n_sm)
        return FusedLayout("warp", 0, g, ld, slot_floats)
    return FusedLayout("block", _pick_threads(n), 0, 0, 0)


def admm_solve_fused(P, q, A, l, u, eqf, x0, y0,
                     iters: int, adapt_rounds: int, equilibrate_iters: int,
                     rho0: float, sigma: float, alpha: float,
                     rho_eq_scale: float, inf: float):
    """The whole ADMM solve of a batch in one launch; returns the SCALED
    (x, y) and the scales (D, E, c) with x_unscaled = D x, y_unscaled =
    E y / c; c is (B,).

    CUDA tensors: launches the hand-written kernel, or raises.  CPU tensors:
    the plain version.  See the module docstring."""
    B, n, m = check_fused_args(P, q, A, l, u, eqf, x0, y0)
    kw = _solve_kw(iters, adapt_rounds, equilibrate_iters, rho0, sigma, alpha,
                   rho_eq_scale, inf)
    dev = P.device
    if dev.type == "cpu":
        return admm_solve_fused_reference(P, q, A, l, u, eqf, x0, y0, **kw)
    _require_cuda(dev, "admm_solve_fused")
    lib = _library("admm_fused")
    lay = fused_layout(n, m, B, *device_limits(dev))
    x_o = torch.empty_like(q)
    y_o = torch.empty_like(l)
    d_o = torch.empty_like(q)
    e_o = torch.empty_like(l)
    c_o = q.new_empty((B,))
    with torch.cuda.device(dev):
        workspace = None
        if lay.path == "block":
            ws_floats = lib.admm_fused_workspace_floats(B, n, m, lay.threads)
            if ws_floats < 0:
                raise RuntimeError("admm_fused: cannot size the workspace "
                                   f"(CUDA error {-ws_floats})")
            # matrices that do not fit in shared memory live here for the
            # launch
            workspace = q.new_empty((ws_floats,)) if ws_floats else None
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.admm_fused_launch(
            P.data_ptr(), q.data_ptr(), A.data_ptr(), l.data_ptr(),
            u.data_ptr(), eqf.data_ptr(), x0.data_ptr(), y0.data_ptr(),
            x_o.data_ptr(), y_o.data_ptr(), d_o.data_ptr(), e_o.data_ptr(),
            c_o.data_ptr(),
            workspace.data_ptr() if workspace is not None else None,
            B, n, m, kw["iters"], kw["adapt_rounds"],
            kw["equilibrate_iters"], kw["rho0"], kw["sigma"], kw["alpha"],
            kw["rho_eq_scale"], kw["inf"], lay.threads, lay.g, lay.ld,
            lay.slot_floats, stream)
    _raise_on(rc, lib, "admm_fused", B, n, m)
    admm_solve_fused.launches += 1
    return x_o, y_o, d_o, e_o, c_o


admm_solve_fused.launches = 0


PLAIN_WARP_LD = 36      # kernel A: row stride of P and A (admm_fused.cu, PA)


def plain_warp_slot_floats(n: int, m: int) -> int:
    """Floats of one scenario's slot on kernel A's path (admm_fused.cu's
    `plain_slot_floats`): the factorization's scratch (n rows of 32), P (n
    rows of 36), A (round4(m) rows of 36), four 32-vectors, seven
    round4(m)-vectors (warp_regs.cuh's slot), D (32) and three more
    round4(m)-vectors (E, the Ruiz row scale, the rho pattern)."""
    mp = _round4(m)
    return (n * FUSED_SCRATCH_STRIDE + n * PLAIN_WARP_LD + mp * PLAIN_WARP_LD
            + 4 * 32 + 7 * mp + 32 + 3 * mp)


def plain_warp_layout(n: int, m: int, B: int, smem_bytes: int,
                      n_sm: int) -> FusedLayout:
    """The layout of `admm_solve_plain_warp`: a warp per scenario, g of them
    a block (what fits `smem_bytes`, at most 12, no more than spreads B over
    `n_sm` multiprocessors), rows of P and A at the stride 36, the slot of
    `plain_warp_slot_floats`.  Raises where there is no warp path: n > 32,
    or fewer than four slots in a block (the plain backend's solve has no
    block path on the card)."""
    slot = plain_warp_slot_floats(n, m)
    fit = smem_bytes // (4 * slot)
    if n > MAX_FUSED_N or fit < MIN_WARP_SLOTS:
        raise ValueError(
            f"admm_solve_plain_warp: n={n}, m={m} does not fit the warp path "
            f"(n <= {MAX_FUSED_N} and {MIN_WARP_SLOTS} slots of "
            f"{4 * slot} bytes in {smem_bytes}); the plain "
            "backend's solve has no block path on the card")
    g = _slots_per_block(fit, MAX_FUSED_SLOTS, B, n_sm)
    return FusedLayout("warp", 0, g, PLAIN_WARP_LD, slot)


def admm_solve_plain_reference(P, q, A, l, u, eqf, x0, y0,
                               iters: int, adapt_rounds: int,
                               equilibrate_iters: int, rho0: float,
                               sigma: float, alpha: float,
                               rho_eq_scale: float, inf: float):
    """Plain version of `admm_solve_plain_warp`: qp/admm.py's own chain of
    `admm_solve(backend="torch", mode="blockinv")` (`admm.scaled_solve`),
    stopped before the unscaling; returns the scaled (x, y) and (D, E, c).
    Any device and dtype; `inf` must be admm.INF, the chain's convention."""
    from mpctsid_tpu_torch.qp import admm

    if inf != admm.INF:
        raise ValueError(f"inf must be the plain chain's INF = {admm.INF:g}, "
                         f"got {inf:g}")
    x, y, D, E, c = admm.scaled_solve(
        P, q, A, l, u, eqf, x0, y0, iters=iters, rho=rho0, sigma=sigma,
        alpha=alpha, rho_eq_scale=rho_eq_scale,
        equilibrate_iters=equilibrate_iters, adapt_rounds=adapt_rounds)[:5]
    return x, y, D, E, c


def admm_solve_plain_warp(P, q, A, l, u, eqf, x0, y0,
                          iters: int, adapt_rounds: int,
                          equilibrate_iters: int, rho0: float, sigma: float,
                          alpha: float, rho_eq_scale: float, inf: float):
    """qp/admm.py's plain solve (norm-only Ruiz, per round K, its
    Cholesky-based inverse, the refined iterations, the rho adaptation) of a
    batch in one launch; returns the SCALED (x, y) and the scales (D, E, c),
    as `admm_solve_fused` does.

    CUDA tensors: launches the hand-written kernel (kernel A: a warp per
    scenario on the register loop, `plain_warp_layout`), or raises (a shape
    the warp path cannot take, a build or launch failure).  CPU tensors: the
    plain version, the chain itself.  See the module docstring."""
    B, n, m = check_fused_args(P, q, A, l, u, eqf, x0, y0)
    kw = _solve_kw(iters, adapt_rounds, equilibrate_iters, rho0, sigma, alpha,
                   rho_eq_scale, inf)
    dev = P.device
    if dev.type == "cpu":
        return admm_solve_plain_reference(P, q, A, l, u, eqf, x0, y0, **kw)
    _require_cuda(dev, "admm_solve_plain_warp")
    lay = plain_warp_layout(n, m, B, *device_limits(dev))
    lib = _library("admm_fused")
    outs = (torch.empty_like(q), torch.empty_like(l), torch.empty_like(q),
            torch.empty_like(l), q.new_empty((B,)))
    with torch.cuda.device(dev):
        rc = lib.admm_plain_warp_launch(
            *(t.data_ptr() for t in (P, q, A, l, u, eqf, x0, y0, *outs)),
            B, n, m, kw["iters"], kw["adapt_rounds"], kw["equilibrate_iters"],
            kw["rho0"], kw["sigma"], kw["alpha"], kw["rho_eq_scale"],
            kw["inf"], lay.g, lay.ld, lay.slot_floats,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, lib, "admm_fused", B, n, m)
    admm_solve_plain_warp.launches += 1
    x_o, y_o, d_o, e_o, c_o = outs
    return x_o, y_o, d_o, e_o, c_o


admm_solve_plain_warp.launches = 0


MAX_SPD_WARP_N = 32     # the warp path: lane i owns row i
MAX_SPD_SLOTS = 8       # matrices (warps) per block there (spd_inverse.cu)
SPD_PANEL = 32          # block path: panel width (spd_blocked.h, PW)
SPD_TILE = 4            # block path: a thread's register tile, 4 x 4 (TR)
SPD_PANEL_LD = SPD_PANEL + 4   # row stride of the panel buffer (PLD)


class SpdLayout(NamedTuple):
    """How one call of the SPD-inverse kernel is laid out."""
    path: str          # "warp": a warp per matrix; "block": a block each
    g: int             # matrices (warps) per block on the warp path, else 0
    threads: int       # threads per block
    in_smem: bool      # block path: the working matrix in shared memory
    smem_floats: int   # floats of shared memory per block
    panel: int = 0     # block path: columns per panel (one warp's lanes)
    tile: int = 0      # block path: rows = columns of a thread's tile
    ld: int = 0        # block path: row stride of the working matrix


def spd_block_floats(n: int, in_smem: bool) -> int:
    """Shared-memory floats of the block path (spd_blocked.h's
    `smem_floats`): the Jacobi scale and the panel buffer (np = n rounded up
    to a multiple of 32 entries, np rows of 36), the load's barrier (4) and,
    in_smem, the working matrix (np rows of np + 4)."""
    np_ = -(-n // SPD_PANEL) * SPD_PANEL
    return np_ + np_ * SPD_PANEL_LD + 4 + (np_ * (np_ + 4) if in_smem else 0)


def spd_inverse_layout(n: int, B: int, smem_bytes: int,
                       n_sm: int) -> SpdLayout:
    """Which path `chol_inverse` takes, and its parameters.

    n <= 32: the warp path, one warp per matrix with a scratch of n rows of
    32 floats; g matrices per block, what fits `smem_bytes`, at most 8, and
    no more than spreads B over `n_sm` multiprocessors.  Larger n: the block
    path, one block per matrix, the blocked factorization by panels of 32
    columns in 4 x 4 register tiles (64 threads a 32 x 32 tile; 128 threads
    up to two panels, 256 up to three, else 512).  Its working matrix (n
    padded to np, a multiple of 32, rows of np + 4 floats) lives in shared
    memory beside the panel buffer where both fit (n <= 192 on an H100),
    else in a device-memory workspace of B np (np + 4) floats."""
    if n <= MAX_SPD_WARP_N:
        slot = n * 32
        g = _slots_per_block(smem_bytes // (4 * slot), MAX_SPD_SLOTS, B,
                             n_sm)
        return SpdLayout("warp", g, 32 * g, False, g * slot)
    np_ = -(-n // SPD_PANEL) * SPD_PANEL
    panels = np_ // SPD_PANEL
    threads = 128 if panels <= 2 else 256 if panels <= 3 else 512
    in_smem = 4 * spd_block_floats(n, True) <= smem_bytes
    return SpdLayout("block", 0, threads, in_smem,
                     spd_block_floats(n, in_smem), SPD_PANEL, SPD_TILE,
                     np_ + 4)


def chol_inverse(K):
    """K^-1 of a batch of SPD matrices (B, n, n): the function of
    blockinv.spd_inverse_chol(K, ns_steps=1) (Jacobi scaling, Cholesky with
    the 1e-10 pivot floor, triangular inverse, one Newton-Schulz step kept
    only where it does not diverge, the identity where the result is not
    finite), per matrix.

    CUDA tensors: the hand-written kernel (`spd_inverse_layout`: n <= 32 one
    launch; larger n the blocked factorization with X0 = L^-T L^-1, the
    Newton-Schulz step's three torch.bmm products and the guard's launch),
    or an exception.  CPU tensors: the plain version.
    See the module docstring."""
    B, n = check_spd_args(K)
    dev = K.device
    if dev.type == "cpu":
        return spd_inverse_chol(K, ns_steps=1)
    _require_cuda(dev, "chol_inverse")
    lay = spd_inverse_layout(n, B, *device_limits(dev))
    lib = _library("spd_inverse")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if lay.path == "warp":
            out = torch.empty_like(K)
            rc = lib.spd_inverse_warp_launch(K.data_ptr(), out.data_ptr(), B,
                                             n, lay.g, stream)
            _raise_on(rc, lib, "spd_inverse", B, n, n)
            chol_inverse.launches += 1
            return out
        Ks, X0, M = (torch.empty_like(K) for _ in range(3))
        s = K.new_empty((B, n))
        work = None if lay.in_smem else K.new_empty((B * (lay.ld - 4)
                                                     * lay.ld,))
        rc = lib.spd_inverse_factor_launch(
            K.data_ptr(), Ks.data_ptr(), s.data_ptr(), X0.data_ptr(),
            M.data_ptr(), None if work is None else work.data_ptr(), B, n,
            lay.threads, int(lay.in_smem), stream)
        _raise_on(rc, lib, "spd_inverse", B, n, n)
        M.baddbmm_(Ks, X0, alpha=-1.0)         # 2 I - Ks X0
        X = torch.bmm(X0, M)
        T1 = torch.bmm(Ks, X)
        out = Ks                               # Ks has served
        rc = lib.spd_inverse_select_launch(
            X0.data_ptr(), M.data_ptr(), X.data_ptr(), T1.data_ptr(),
            s.data_ptr(), out.data_ptr(), B, n, stream)
        _raise_on(rc, lib, "spd_inverse", B, n, n)
    chol_inverse.launches += 1
    return out


chol_inverse.launches = 0


MAX_MMA_SLOTS = 4       # warps per block on kernel 5's warp path
MMA_KSPLIT = 8          # depth slices per product, at most (admm_mma.cu)
MMA_BARRIER_FLOATS = 8  # cluster path: four 8-byte barriers of the exchange
RES_KINV, RES_A, RES_K = 1, 2, 4


class MmaLayout(NamedTuple):
    """How one launch of the tensor-core iteration kernel is laid out."""
    path: str          # "warp": a warp per scenario; "cluster": a cluster each
    g: int             # scenarios (warps) per block on the warp path, else 0
    cluster: int       # blocks per scenario on the cluster path, else 0
    threads: int       # threads per block
    ld: int            # row stride of the matrices in shared memory
    resident: int      # cluster path: RES_KINV | RES_A | RES_K held on chip
    smem_floats: int   # floats of shared memory per block
    rows_n: int        # cluster path: rows of K^-1 and K per block
    rows_m: int        # cluster path: rows of A per block

    @property
    def geometry(self):
        """The launcher's trailing arguments."""
        return (self.g, self.cluster, self.threads, self.ld, self.resident,
                self.smem_floats)


def _pad16(v: int) -> int:
    return (v + 15) // 16 * 16


def row_slices(total: int, rows_per: int, cluster: int):
    """[start, stop) of the rows each block of a cluster owns (the kernel's
    own arithmetic): whole 16-row tiles, the last slices ragged or empty."""
    return [(min(total, r * rows_per), min(total, (r + 1) * rows_per))
            for r in range(cluster)]


def mma_layout(n: int, m: int, B: int, smem_bytes: int,
               n_sm: int) -> MmaLayout:
    """Which path a launch of `admm_iterate` takes, and its parameters.

    Rows are padded in shared memory to a multiple of four floats, for the
    16-byte reads of rows "as given" (a stride free of bank conflicts, 16
    modulo 32, was measured and lost: admm_mma.cu, "Row stride").

    Warp path: one scenario's K^-1, K, A and its vectors (each padded to a
    multiple of 16; rhs, x_a, r, x_t and w also as the TF32 parts the
    products read) are a slot; where at least four slots fit `smem_bytes`,
    a block holds g scenarios, one warp each (g: what fits, at most 4 —
    several small blocks per multiprocessor overlap one's load with
    another's iterations — and no more than spreads B over `n_sm`
    multiprocessors).

    Cluster path: a cluster of C blocks per scenario, C the least of 1 to 8
    (8 is the portable maximum) at which a block's row slices of the three
    matrices (whole 16-row tiles: rows_n of K^-1 and K, rows_m of A), its
    vectors, its partial-sum buffer, the C x n exchange buffer and the
    exchange's barriers fit
    `smem_bytes`: the fewer blocks share a scenario, the more work each
    barrier and each exchange is spread over (measured: admm_mma.cu).
    Where even C = 8 does not hold all three slices they go to shared memory
    greedily by reads per iteration (K^-1, A, K) and the rest is streamed.
    Raises if the vectors alone do not fit."""
    ld = (n + 3) // 4 * 4
    np_, mp = _pad16(n), _pad16(m)
    slot_floats = (2 * n + m) * ld + 13 * np_ + 9 * mp
    fit = smem_bytes // (4 * slot_floats)
    if fit >= MIN_WARP_SLOTS:
        g = _slots_per_block(fit, MAX_MMA_SLOTS, B, n_sm)
        return MmaLayout("warp", g, 0, 32 * g, ld, 0, g * slot_floats, 0, 0)

    def block(cluster):
        rows_n = -(-(np_ // 16) // cluster) * 16
        rows_m = -(-(mp // 16) // cluster) * 16
        vec = (14 * np_ + 9 * rows_m + MMA_KSPLIT * max(np_, rows_m)
               + cluster * np_ + MMA_BARRIER_FLOATS)
        return rows_n, rows_m, vec

    for cluster in range(1, MAX_CLUSTER + 1):
        rows_n, rows_m, floats = block(cluster)
        resident = 0
        # greedily by reads per iteration; all three or the next size
        for bit, rows in ((RES_KINV, rows_n), (RES_A, rows_m),
                          (RES_K, rows_n)):
            if 4 * (floats + rows * ld) <= smem_bytes:
                resident |= bit
                floats += rows * ld
        if resident == RES_KINV | RES_A | RES_K or cluster == MAX_CLUSTER:
            break
    if 4 * floats > smem_bytes:
        raise ValueError(
            f"admm_iterate: the vectors of n={n}, m={m} need {4 * floats} "
            f"bytes of shared memory per block even across a cluster of 8, "
            f"a block has {smem_bytes}")
    # about five 16 x 16 tiles of the block's slice of A per warp, at most
    # twelve warps (measured at the MPC shape: 8 and 16 warps are slower)
    warps = max(2, min(12, (rows_m // 16) * (np_ // 16) // 5))
    return MmaLayout("cluster", 0, cluster, 32 * warps, ld, resident, floats,
                     rows_n, rows_m)


def admm_iterate(K_inv, K, A, q, l, u, rho_vec, x, z, y,
                 iters: int = 25, sigma: float = 1e-6, alpha: float = 1.6):
    """`iters` ADMM updates with the explicit refinement and K AS GIVEN,
    every mat-vec on the tensor cores; any n and m (`mma_layout` picks a warp
    or a thread-block cluster per scenario); returns (x, z, y).

    CUDA tensors: launches the hand-written kernel, or raises.  CPU tensors:
    the plain version.  See the module docstring.

    The kernel splits every operand into TF32 parts: two ("3xTF32") for A' w,
    K^-1 rhs, K^-1 r and A x_t, three (an exact split of an f32) for the
    cancelling product K x_a of the residual.  That is part of the function's
    accuracy and fixed in admm_mma.cu.  Measured when the kernel was written,
    on 4096 WBC-sized QPs with equality rows (H100, PERF.md): two parts
    everywhere sat 8.2e-4 from a float64 run (the float32 plain version:
    6.2e-4), three for K x_a alone 4.0e-4, three everywhere 3.6e-4; the third
    part of K x_a cost 4-7 % of the kernel's time, a third part of the other
    four 20-45 % more."""
    B, n, m = check_refined_args(K_inv, K, A, q, l, u, rho_vec, x, z, y)
    iters = _check_iters(iters)
    if K_inv.device.type == "cpu":
        return admm_iterate_reference(K_inv, K, A, q, l, u, rho_vec, x, z, y,
                                      iters=iters, sigma=sigma, alpha=alpha)
    _require_cuda(K_inv.device, "admm_iterate")
    lay = mma_layout(n, m, B, *device_limits(K_inv.device))
    out = _launch_iteration("admm_mma", (K_inv, K, A, q, l, u, rho_vec),
                            x, z, y, (B, n, m), iters, sigma, alpha,
                            lay.geometry)
    admm_iterate.launches += 1
    return out


admm_iterate.launches = 0


RUIZ_GROUPS = 4         # row groups of a block (ruiz.h, GROUPS)
RUIZ_MAX_WIDTH = 96     # threads of a group at most (ruiz.h, MAX_WIDTH)
RUIZ_HEAD = 72          # floats before the arrays (ruiz.h, HEAD)
RUIZ_P_GROUPS = 16      # runs of rows of the passes over P (ruiz.h)
RUIZ_SLOTS = 4          # nonzeros of A kept per (row group, column)
RUIZ_MAX_CLUSTER = 8    # blocks a scenario at most (ruiz.h, MAX_CLUSTER)
RUIZ_WARP_N, RUIZ_WARP_M = 32, 64   # the warp path's shapes (ruiz.h)
RUIZ_WARPS = 4          # scenarios a block on the warp path, at most
RUIZ_BATCH_CLUSTER = 2  # blocks a scenario where the batch fills the card
RUIZ_SMALL_CLUSTER = 4  # ... where it does not, at most (8 measured slower)
RUIZ_PATHS = ("warp", "cluster")    # ruiz.h's Path codes, in order


class RuizLayout(NamedTuple):
    """How one launch of the Ruiz kernel is laid out."""
    path: str          # "warp" or "cluster"
    blocks: int        # of the grid
    threads: int       # of a block
    cluster: int       # blocks a scenario (1 on the warp path)
    warps: int         # scenarios a block on the warp path (else 0)
    width: int         # columns a block holds: 32 (warp) or its slice
    p_in_smem: bool    # its columns of P in shared memory (else read each
                       # pass; the warp path holds them in registers)
    slots: int         # nonzeros of A kept per (group, column), or 0
    smem_floats: int   # dynamic shared memory of a block, in floats

    @property
    def geometry(self) -> tuple:
        """(path, size, p_in_smem, slots): the launcher's arguments."""
        size = self.warps if self.path == "warp" else self.cluster
        return (RUIZ_PATHS.index(self.path), size, int(self.p_in_smem),
                self.slots)


def ruiz_slice_width(n: int, cluster: int) -> int:
    """ruiz.h's `slice_width`: a block's columns, a multiple of 4."""
    cols = -(-n // cluster)
    return -(-cols // 4) * 4


def ruiz_smem_floats(n: int, m: int, cluster: int, p_in_smem: bool,
                     slots: int) -> int:
    """ruiz.h's `cluster_smem_floats`: the head (barriers, flags, the sums'
    scratch), the block's columns of P (where held), D, E, its row maxima,
    every block's row maxima (C m), the column maxima over P by run of rows
    (16 w) and over A by row group (G w), the sends' staging (2 w), the
    column norms and |q| D (2 n) and, with `slots`, the kept nonzeros of A
    (a count and `slots` rows and values per group and column)."""
    w = ruiz_slice_width(n, cluster)
    n4, m4 = -(-n // 4) * 4, -(-m // 4) * 4     # each array 16-byte aligned
    return (RUIZ_HEAD + (n * w if p_in_smem else 0) + 3 * n4 + 2 * m4
            + cluster * m4 + (RUIZ_P_GROUPS + RUIZ_GROUPS + 2) * w
            + (RUIZ_GROUPS * w * (1 + 2 * slots) if slots else 0))


def _ruiz_cluster_size(n: int, B: int, n_sm: int) -> int:
    """RUIZ_BATCH_CLUSTER blocks a scenario where B of them fill the card,
    twice as many while they do not (up to RUIZ_SMALL_CLUSTER), and no more
    than leave every block some columns."""
    cluster = RUIZ_BATCH_CLUSTER
    while cluster < RUIZ_SMALL_CLUSTER and B * cluster < n_sm:
        cluster *= 2
    while cluster > 1 and (cluster - 1) * ruiz_slice_width(n, cluster) >= n:
        cluster //= 2
    return cluster


def ruiz_layout(n: int, m: int, B: int, smem_bytes: int,
                n_sm: int) -> RuizLayout:
    """The layout of `ruiz_equilibrate`.  n <= 32 and m <= 64 (the WBC's
    QPs): the warp path, a warp per scenario, RUIZ_WARPS a block (fewer
    where B does not fill the card).  Else the cluster path: C blocks per
    scenario (`_ruiz_cluster_size`: 2 at a large B, 4 at a small one), G =
    4 row groups of W = min(round32(w), 96) threads on a slice of w
    columns, its columns of P in shared memory where they fit beside the
    rest in `smem_bytes` (a larger cluster where that makes them fit), else
    read from device memory each pass; then RUIZ_SLOTS nonzeros of A kept
    per group and column where they fit too.  Raises where not even the
    rest fits."""
    if n <= RUIZ_WARP_N and m <= RUIZ_WARP_M:
        warps = _slots_per_block(RUIZ_WARPS, RUIZ_WARPS, B, n_sm)
        return RuizLayout("warp", -(-B // warps), 32 * warps, 1, warps, 32,
                          False, 0, 0)
    def fits(cluster, p_in_smem, slots):
        return 4 * ruiz_smem_floats(n, m, cluster, p_in_smem,
                                    slots) <= smem_bytes

    cluster = _ruiz_cluster_size(n, B, n_sm)
    in_smem = fits(cluster, True, 0)
    larger = cluster
    while not in_smem and larger < RUIZ_MAX_CLUSTER:
        larger *= 2
        if fits(larger, True, 0):
            cluster, in_smem = larger, True
    slots = RUIZ_SLOTS if fits(cluster, in_smem, RUIZ_SLOTS) else 0
    floats = ruiz_smem_floats(n, m, cluster, in_smem, slots)
    if 4 * floats > smem_bytes:
        raise ValueError(f"ruiz_equilibrate: n={n}, m={m} needs {4 * floats} "
                         f"bytes of shared memory per block without P, a "
                         f"block has {smem_bytes}")
    w = ruiz_slice_width(n, cluster)
    width = min(-(-w // 32) * 32, RUIZ_MAX_WIDTH)
    return RuizLayout("cluster", B * cluster, RUIZ_GROUPS * width, cluster,
                      0, w, in_smem, slots, floats)


def check_ruiz_args(P, q, A, l, u):
    """Raise unless the arguments are what the Ruiz kernel takes; returns
    (B, n, m).  All float32 on one device; P (B, n, n), A (B, m, n), q (B,
    n), l, u (B, m); a scenario's entries contiguous, scenarios at any
    stride (A may be a stride-0 broadcast)."""
    named = dict(P=P, q=q, A=A, l=l, u=u)
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != P.device:
            raise ValueError(f"{name} is on {t.device}, P on {P.device}: one "
                             "device only")
    if P.dim() != 3 or P.shape[1] != P.shape[2]:
        raise ValueError(f"P must be (B, n, n), got {tuple(P.shape)}")
    B, n, _ = P.shape
    if A.dim() != 3 or A.shape[2] != n:
        raise ValueError(f"A must be (B={B}, m, n={n}), got {tuple(A.shape)}")
    m = A.shape[1]
    if B < 1 or n < 1 or m < 1:
        raise ValueError(f"empty problem: B={B}, n={n}, m={m}")
    return B, n, m


def ruiz_equilibrate(P, q, A, l, u, iters: int = 8):
    """qp/admm.py's `ruiz_equilibrate` (norm-only modified Ruiz scaling and
    cost scaling, then the scaled problem): (Pb, qb, Ab, lb, ub, D, E, c)
    with D (B, n), E (B, m), c (B,).

    CUDA tensors: one launch of the hand-written kernel (a warp or a
    thread-block cluster per scenario, `ruiz_layout`; float32 only,
    TypeError otherwise), or an exception.  CPU tensors: the plain version,
    admm.ruiz_equilibrate (any dtype).  The kernel reads A through its
    batch stride: a stride-0 broadcast is never copied.  See the module
    docstring."""
    if P.device.type == "cpu":
        from mpctsid_tpu_torch.qp import admm

        return admm.ruiz_equilibrate(P, q, A, l, u, iters)
    B, n, m = check_ruiz_args(P, q, A, l, u)
    dev = P.device
    _require_cuda(dev, "ruiz_equilibrate")
    lay = ruiz_layout(n, m, B, *device_limits(dev))
    lib = _library("ruiz")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc, outs = run_ruiz(lambda *a: lib.ruiz_launch(*a, stream), P, q, A,
                            l, u, iters, lay.geometry)
    _raise_on(rc, lib, "ruiz", B, n, m)
    ruiz_equilibrate.launches += 1
    return outs


def run_ruiz(launch_fn, P, q, A, l, u, iters: int, geometry):
    """(rc, (Pb, qb, Ab, lb, ub, D, E, c)): the Ruiz kernel's operands
    packed for `launch_fn(in, stride, out, B, n, m, iters, path, size,
    p_in_smem, slots) -> rc` (the library's `ruiz_launch` less the stream,
    or the CPU tests' host build of ruiz.h), `geometry` a layout's (path,
    size, p_in_smem, slots), its outputs allocated here."""
    B, n, m = check_ruiz_args(P, q, A, l, u)
    ins = [rows("P", P, B, (n, n), P), rows("q", q, B, (n,), P),
           rows("A", A, B, (m, n), P), rows("l", l, B, (m,), P),
           rows("u", u, B, (m,), P)]
    outs = (P.new_empty((B, n, n)), P.new_empty((B, n)),
            P.new_empty((B, m, n)), P.new_empty((B, m)), P.new_empty((B, m)),
            P.new_empty((B, n)), P.new_empty((B, m)), P.new_empty((B,)))
    rc = launch_fn((_PTR * len(ins))(*[t.data_ptr() for t, _ in ins]),
                   (ctypes.c_longlong * len(ins))(*[s for _, s in ins]),
                   (_PTR * len(outs))(*[t.data_ptr() for t in outs]),
                   B, n, m, _check_iters(iters), *(int(g) for g in geometry))
    return rc, outs


ruiz_equilibrate.launches = 0
