"""The port's hand-written kernels and their plain PyTorch versions.

One kernel so far: the M2 ADMM iteration (CUDA C++, qp/csrc/admm_m2.cu),
which replaces `_admm_kernel_m2_packed` / `admm_iterate_m2_packed_batch` /
`admm_iterate_m2` of the JAX package's qp/pallas_kernels.py.  It runs the MPC
stage's iterations: `iters` ADMM updates with the iterative-refinement step
folded into one precomputed map M2 = 2 K^-1 - K^-1 K K^-1 (built by the
caller with batched matmuls, qp/admm.py).

  * `admm_iterate_m2` is the wrapper.  On CUDA tensors it checks its
    arguments, launches the kernel on PyTorch's current stream and raises on
    any failure (bad argument, build failure, launch error): there is no
    fallback.  On CPU tensors, and only because the tensors lie on the CPU,
    it runs the plain version.  `admm_iterate_m2.launches` counts kernel
    launches (a plain integer, incremented only where the kernel launches).
  * `admm_iterate_m2_reference` is the plain version: a Python loop of
    batched matmuls and elementwise ops.  The CPU tests and the on-card
    comparison in chip_smoke.py use it; nothing on the CUDA main path does.

Layout passed to the kernel: A as the caller holds it, row-major (B, m, n),
and nothing else; no transposed copy.  The kernel makes both of its A
products coalesced from that one layout (see the note in the source).

M2 is symmetric only up to rounding.  Both versions apply M2 TRANSPOSED
(x_t[j] = sum_i M2[i, j] rhs[i]), as the TPU kernel does by reducing
M2 * rhs_col over rows.

The four other TPU kernels of qp/pallas_kernels.py (`admm_iterate_vpu`,
`admm_iterate_vpu_packed`, `admm_solve_fused_batch`, `admm_iterate`) are not
ported yet; qp/admm.py raises NotImplementedError for their backends.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["admm_iterate_m2", "admm_iterate_m2_reference", "check_m2_args"]


def check_m2_args(M2, A, q, l, u, rho_vec, x, z, y):
    """Raise unless the arguments are what the kernel takes; returns (B, n, m).

    All float32, on one device, contiguous; M2 (B, n, n), A (B, m, n),
    q, x (B, n), l, u, rho_vec, z, y (B, m)."""
    named = dict(M2=M2, A=A, q=q, l=l, u=u, rho_vec=rho_vec, x=x, z=z, y=y)
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != M2.device:
            raise ValueError(
                f"{name} is on {t.device}, M2 on {M2.device}: one device only")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (strides "
                             f"{t.stride()} for shape {tuple(t.shape)})")
    if M2.dim() != 3 or M2.shape[1] != M2.shape[2]:
        raise ValueError(f"M2 must be (B, n, n), got {tuple(M2.shape)}")
    B, n, _ = M2.shape
    if A.dim() != 3 or A.shape[0] != B or A.shape[2] != n:
        raise ValueError(f"A must be (B={B}, m, n={n}), got {tuple(A.shape)}")
    m = A.shape[1]
    if B < 1 or n < 1 or m < 1:
        raise ValueError(f"empty problem: B={B}, n={n}, m={m}")
    for name in ("q", "x"):
        if tuple(named[name].shape) != (B, n):
            raise ValueError(f"{name} must be ({B}, {n}), got "
                             f"{tuple(named[name].shape)}")
    for name in ("l", "u", "rho_vec", "z", "y"):
        if tuple(named[name].shape) != (B, m):
            raise ValueError(f"{name} must be ({B}, {m}), got "
                             f"{tuple(named[name].shape)}")
    return B, n, m


def admm_iterate_m2_reference(M2, A, q, l, u, rho_vec, x, z, y,
                              iters: int = 25, sigma: float = 1e-6,
                              alpha: float = 1.6):
    """Plain PyTorch version of the M2 iteration; returns (x, z, y)."""
    rho_inv = 1.0 / rho_vec
    for _ in range(iters):
        w = rho_vec * z - y
        atw = torch.bmm(w[:, None, :], A)[:, 0]            # A' w
        rhs = sigma * x - q + atw
        x_t = torch.bmm(rhs[:, None, :], M2)[:, 0]         # M2' rhs
        z_t = torch.bmm(A, x_t[:, :, None])[:, :, 0]       # A x_t
        x = alpha * x_t + (1.0 - alpha) * x
        z_r = alpha * z_t + (1.0 - alpha) * z
        z_n = torch.minimum(torch.maximum(z_r + rho_inv * y, l), u)
        y = y + rho_vec * (z_r - z_n)
        z = z_n
    return x, z, y


_LIB = None


def _library():
    """The built kernel library (builds it on first use)."""
    global _LIB
    if _LIB is None:
        from mpctsid_tpu_torch.qp._build import load_library

        lib = load_library("admm_m2", ("admm_m2.cu",))
        ptr = ctypes.c_void_p
        lib.admm_m2_launch.argtypes = (
            [ptr] * 12 + [ctypes.c_int] * 4 + [ctypes.c_float] * 2
            + [ctypes.c_int, ptr])
        lib.admm_m2_launch.restype = ctypes.c_int
        lib.admm_m2_error_string.argtypes = [ctypes.c_int]
        lib.admm_m2_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _pick_threads(n: int) -> int:
    """Block size: up to four row-chunk groups of one thread per column."""
    col_threads = min((n + 31) // 32 * 32, 1024)
    return col_threads * max(1, min(1024 // col_threads, 4))


def admm_iterate_m2(M2, A, q, l, u, rho_vec, x, z, y,
                    iters: int = 25, sigma: float = 1e-6, alpha: float = 1.6):
    """`iters` M2-folded ADMM updates for a batch; returns (x, z, y).

    CUDA tensors: launches the hand-written kernel, or raises.  CPU tensors:
    the plain version.  See the module docstring."""
    B, n, m = check_m2_args(M2, A, q, l, u, rho_vec, x, z, y)
    iters = int(iters)
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    dev = M2.device
    if dev.type == "cpu":
        return admm_iterate_m2_reference(M2, A, q, l, u, rho_vec, x, z, y,
                                         iters=iters, sigma=sigma, alpha=alpha)
    if dev.type != "cuda":
        raise RuntimeError(f"admm_iterate_m2 runs on cuda or cpu, not {dev}")
    lib = _library()
    x_o = torch.empty_like(x)
    z_o = torch.empty_like(z)
    y_o = torch.empty_like(y)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.admm_m2_launch(
            M2.data_ptr(), A.data_ptr(), q.data_ptr(), l.data_ptr(),
            u.data_ptr(), rho_vec.data_ptr(), x.data_ptr(), z.data_ptr(),
            y.data_ptr(), x_o.data_ptr(), z_o.data_ptr(), y_o.data_ptr(),
            B, n, m, iters, float(sigma), float(alpha), _pick_threads(n),
            stream)
    if rc != 0:
        msg = lib.admm_m2_error_string(rc).decode()
        raise RuntimeError(
            f"admm_m2 kernel launch failed (B={B}, n={n}, m={m}): "
            f"CUDA error {rc}: {msg}")
    admm_iterate_m2.launches += 1
    return x_o, z_o, y_o


admm_iterate_m2.launches = 0
