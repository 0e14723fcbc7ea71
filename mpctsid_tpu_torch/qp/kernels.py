"""The port's hand-written kernels and their plain PyTorch versions.

Five kernels, all CUDA C++ under qp/csrc/, each replacing a TPU kernel of the
JAX package's qp/pallas_kernels.py and keeping its function name:

  * `admm_iterate_m2` (admm_m2.cu) <- `admm_iterate_m2` /
    `admm_iterate_m2_packed_batch`: `iters` ADMM updates with the refinement
    folded into one precomputed map M2 = 2 K^-1 - K^-1 K K^-1.  The MPC
    stage's iterations (inequality-only QPs).
  * `admm_iterate_vpu` (admm_vpu.cu) <- `admm_iterate_vpu`: `iters` updates
    with the EXPLICIT refinement x_a = K^-1 rhs, r = rhs - K' x_a,
    x_t = x_a + K^-1 r; valid with equality rows.  One block per scenario,
    any shape.
  * `admm_iterate_vpu_packed` (admm_packed.cu) <- `admm_iterate_vpu_packed` /
    `admm_iterate_packed`: the same function for small matrices, several
    scenarios per block, one warp each.
  * `admm_solve_fused` (admm_fused.cu) <- `admm_solve_fused` /
    `admm_solve_fused_batch`: the whole solve in one launch (full-rescale
    Ruiz, per adapt round K, its Cholesky-based inverse with one
    Newton-Schulz step, the refined iterations, rho adaptation); returns the
    SCALED x, y and the scales D, E, c.  n <= 32: one warp per scenario,
    several per block; larger: one block per scenario (`fused_layout`).
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
only where the kernel launches).

Plain versions, used by the CPU tests and by the on-card comparison of
chip_smoke.py and by nothing on the CUDA main path:
`admm_iterate_m2_reference`, `admm_iterate_refined_reference` (ONE plain
version for `admm_iterate_vpu` and `admm_iterate_vpu_packed`: they compute
the same function), `admm_iterate_reference` (the same loop with K as given)
and `admm_solve_fused_reference`.

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

from mpctsid_tpu_torch.qp.blockinv import spd_inverse_chol

__all__ = ["admm_iterate_m2", "admm_iterate_m2_reference", "check_m2_args",
           "admm_iterate_vpu", "admm_iterate_vpu_packed",
           "admm_iterate_refined_reference", "check_refined_args",
           "admm_iterate", "admm_iterate_reference",
           "device_limits", "packed_layout", "fused_layout", "mma_layout",
           "row_slices",
           "FusedLayout", "MmaLayout", "admm_solve_fused",
           "admm_solve_fused_reference",
           "check_fused_args", "build_all", "LIBRARIES"]


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


def _check_iters(iters) -> int:
    iters = int(iters)
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    return iters


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
    "admm_m2": (("admm_m2.cu",), ()),
    "admm_vpu": (("admm_vpu.cu",), ("admm_block.cuh",)),
    "admm_packed": (("admm_packed.cu",), ("admm_block.cuh",)),
    "admm_fused": (("admm_fused.cu",), ("admm_block.cuh",)),
    "admm_mma": (("admm_mma.cu",), ("admm_block.cuh",)),
}

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_FLT = ctypes.c_float
_LAUNCH_ARGTYPES = {
    "admm_m2": [_PTR] * 12 + [_INT] * 4 + [_FLT] * 2 + [_INT, _PTR],
    "admm_vpu": [_PTR] * 13 + [_INT] * 4 + [_FLT] * 2 + [_INT, _PTR],
    "admm_packed": [_PTR] * 13 + [_INT] * 4 + [_FLT] * 2 + [_INT] * 3 + [_PTR],
    "admm_fused": [_PTR] * 14 + [_INT] * 6 + [_FLT] * 5 + [_INT] * 4 + [_PTR],
    "admm_mma": [_PTR] * 13 + [_INT] * 4 + [_FLT] * 2 + [_INT] * 6 + [_PTR],
}

_LIBS: dict = {}


def build_all() -> None:
    """Build every kernel library that is missing, all `nvcc` runs started
    together (each library is otherwise built at its first launch)."""
    from mpctsid_tpu_torch.qp import _build

    _build.build_libraries(
        [(name, src, hdr) for name, (src, hdr) in LIBRARIES.items()])


def _library(name: str):
    """The built library of one kernel (builds it on first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        from mpctsid_tpu_torch.qp import _build

        lib = _build.load_library(name, *LIBRARIES[name])
        launch = getattr(lib, f"{name}_launch")
        launch.argtypes = _LAUNCH_ARGTYPES[name]
        launch.restype = _INT
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [_INT]
        err.restype = ctypes.c_char_p
        if name == "admm_fused":
            lib.admm_fused_workspace_floats.argtypes = [_INT] * 4
            lib.admm_fused_workspace_floats.restype = ctypes.c_longlong
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


def admm_iterate_m2(M2, A, q, l, u, rho_vec, x, z, y,
                    iters: int = 25, sigma: float = 1e-6, alpha: float = 1.6):
    """`iters` M2-folded ADMM updates for a batch; returns (x, z, y).

    CUDA tensors: launches the hand-written kernel, or raises.  CPU tensors:
    the plain version.  See the module docstring."""
    B, n, m = check_m2_args(M2, A, q, l, u, rho_vec, x, z, y)
    iters = _check_iters(iters)
    if M2.device.type == "cpu":
        return admm_iterate_m2_reference(M2, A, q, l, u, rho_vec, x, z, y,
                                         iters=iters, sigma=sigma, alpha=alpha)
    _require_cuda(M2.device, "admm_iterate_m2")
    out = _launch_iteration("admm_m2", (M2, A, q, l, u, rho_vec), x, z, y,
                            (B, n, m), iters, sigma, alpha,
                            (_pick_threads(n),))
    admm_iterate_m2.launches += 1
    return out


admm_iterate_m2.launches = 0


def admm_iterate_vpu(K_inv, K, A, q, l, u, rho_vec, x, z, y,
                     iters: int = 25, sigma: float = 1e-6, alpha: float = 1.6):
    """`iters` ADMM updates with the explicit refinement, one block per
    scenario, any n and m; returns (x, z, y).

    CUDA tensors: launches the hand-written kernel, or raises.  CPU tensors:
    the plain version.  See the module docstring."""
    B, n, m = check_refined_args(K_inv, K, A, q, l, u, rho_vec, x, z, y)
    iters = _check_iters(iters)
    if K_inv.device.type == "cpu":
        return admm_iterate_refined_reference(
            K_inv, K, A, q, l, u, rho_vec, x, z, y, iters=iters, sigma=sigma,
            alpha=alpha)
    _require_cuda(K_inv.device, "admm_iterate_vpu")
    out = _launch_iteration("admm_vpu", (K_inv, K, A, q, l, u, rho_vec),
                            x, z, y, (B, n, m), iters, sigma, alpha,
                            (_pick_threads(n),))
    admm_iterate_vpu.launches += 1
    return out


admm_iterate_vpu.launches = 0

MAX_PACKED_G = 16


def packed_layout(n: int, m: int, B: int, smem_bytes: int, n_sm: int):
    """Shared-memory layout of the packed kernel: (g, ld, slot_floats).

    One scenario's slot holds K^-1, K and A with rows padded to the odd
    stride ld = n | 1 (no bank conflicts by rows or by columns) and its
    twelve vectors.  g, the scenarios (warps) per block, is what fits in
    `smem_bytes`, at most 16, and no more than spreads B over `n_sm`
    multiprocessors.  Raises if not even one scenario fits: the packed kernel
    is for small matrices and hands nothing to another kernel."""
    ld = n | 1
    slot_floats = (2 * n + m) * ld + 5 * n + 7 * m
    fit = smem_bytes // (4 * slot_floats)
    if fit < 1:
        raise ValueError(
            f"admm_iterate_vpu_packed: one scenario of n={n}, m={m} needs "
            f"{4 * slot_floats} bytes of shared memory (K^-1, K, A and the "
            f"vectors), a block has {smem_bytes}; use admm_iterate_vpu "
            "(backend 'vpu'), which streams what does not fit")
    return _slots_per_block(fit, MAX_PACKED_G, B, n_sm), ld, slot_floats


def admm_iterate_vpu_packed(K_inv, K, A, q, l, u, rho_vec, x, z, y,
                            iters: int = 25, sigma: float = 1e-6,
                            alpha: float = 1.6):
    """The function of `admm_iterate_vpu` for small matrices: several
    scenarios per block, one warp each; returns (x, z, y).

    CUDA tensors: launches the hand-written kernel, or raises (also when one
    scenario does not fit the packed layout).  CPU tensors: the plain
    version.  See the module docstring."""
    B, n, m = check_refined_args(K_inv, K, A, q, l, u, rho_vec, x, z, y)
    iters = _check_iters(iters)
    dev = K_inv.device
    if dev.type == "cpu":
        return admm_iterate_refined_reference(
            K_inv, K, A, q, l, u, rho_vec, x, z, y, iters=iters, sigma=sigma,
            alpha=alpha)
    _require_cuda(dev, "admm_iterate_vpu_packed")
    out = _launch_iteration("admm_packed", (K_inv, K, A, q, l, u, rho_vec),
                            x, z, y, (B, n, m), iters, sigma, alpha,
                            packed_layout(n, m, B, *device_limits(dev)))
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
    iters = _check_iters(iters)
    kw = dict(iters=iters, adapt_rounds=int(adapt_rounds),
              equilibrate_iters=int(equilibrate_iters), rho0=float(rho0),
              sigma=float(sigma), alpha=float(alpha),
              rho_eq_scale=float(rho_eq_scale), inf=float(inf))
    if kw["equilibrate_iters"] < 0:
        raise ValueError("equilibrate_iters must be >= 0")
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


MAX_MMA_SLOTS = 4       # warps per block on kernel 5's warp path
MMA_KSPLIT = 8          # depth slices per product, at most (admm_mma.cu)
MMA_BARRIER_FLOATS = 8  # cluster path: four 8-byte barriers of the exchange
MAX_CLUSTER = 8         # blocks per cluster, the portable maximum
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
