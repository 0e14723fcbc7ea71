#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for sm_90a).

    python3 chip_smoke.py

Drives `mpctsid_tpu_torch` end to end on the card and fails (non-zero exit,
no result line) if any phase fails.  It needs a CUDA device and the CUDA
toolkit (`nvcc`); there is no CPU fallback.  Phases:

  1. device   card name and power limit (nvidia-smi), torch/CUDA versions,
              the asserted full-f32 matmul settings
  2. build    builds the five kernel libraries from
              mpctsid_tpu_torch/qp/csrc, one nvcc each, all started together
  3. kernels  each kernel against its plain PyTorch version on the card, same
              inputs (numpy seed), then its time, the plain version's time
              and the card's bound at the main path's shape:
              3a the M2 iteration: MPC shape (B=64, n=192, m=320), the test
                 shape (B=3, n=24, m=40), B=1, a WBC-sized odd shape and the
                 main path's shape (B=4096, 192, 320), 30 iterations;
              3b the generic and the packed refined iteration, inputs WITH
                 equality rows and infinite bounds: WBC shape (B=64, n=30,
                 m=50), test shape, B=1, B=37 (a partial last block), the MPC
                 shape (B=8, generic kernel only; the packed kernel must
                 refuse it) and the main path's shape (B=4096, 30, 50), 13
                 iterations; also against EACH OTHER;
              3c the whole-solve kernel on the same QPs, 40 iterations in 3
                 rounds, warm-started: unscaled x, y and the scales.  Its
                 warp path (one warp per scenario, n <= 32) at B = 1, 37, 64
                 and 4096 (a partial last block) at the WBC and the test
                 shape and at n = 32, the edge; its block path at n = 33 and
                 at the MPC shape (global workspace); the path each launch
                 takes is checked, and two launches must agree bit for bit
              3d the tensor-core iteration (K as given) against its plain
                 version: its warp path at the same B's and shapes; its
                 cluster path (matrices resident across a thread-block
                 cluster) at the MPC shape (B = 1, 8, 4096: clusters of 3), at
                 shapes that take clusters of 1, 2 and 6, at one whose n and
                 m are no multiples of 16 per block and at two that even a
                 cluster of 8 holds only in part (one with rows that are not
                 16-byte aligned in device memory); against the generic kernel
                 on a symmetric K; on a visibly skewed K, where "as given"
                 and "transposed" part, on BOTH paths; two launches bit for
                 bit; timed at both main-path shapes
  4. rollout  the main path at full size: cascade_rollout of the preset
              config4_cascade_4k (B=4096 trot, v = 0.3 m/s), per-scenario
              friction in [0.5, 0.9], default solver budgets, MPC backend =
              the M2 kernel; once with the plain WBC and once with each
              kernel WBC backend ("fused", "packed", "vpu"); checks
              finiteness, mpc_ok, wbc_ok_frac, base height, and the launch
              counts of every kernel (set to 0 before each rollout); then
              the same preset on the ESTIMATED state (complementary filter in
              the loop, hint-free) with both QP stages on the tensor-core
              kernel
  5. backends kernel on the path against plain on the path, B=256: the MPC
              backends "m2" and "torch" over two periods; each WBC backend
              against the plain WBC on one mid-gait WBC tick and one period;
              the estimator loop on the tensor-core kernel against the
              estimator loop on the plain backends, one period
  6. single   B=1, one period per WBC backend (the single-robot shape)
  7. sweep    the Monte-Carlo entry point: run_sweep over 2048 scenarios
              (mixed gaits, commands, friction, payload) in chunks of 1024, 3
              periods, default backends; then the same sweep stopped after
              one chunk, saved, loaded and finished: the two metric tables
              must be equal bit for bit

The line before the last is one JSON object describing every kernel of the
path; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from mpctsid_tpu_torch.cascade import (CascadeConfigured, cascade_rollout,
                                       engine, init_controller)
from mpctsid_tpu_torch.config import PRESETS, EngineConfig
from mpctsid_tpu_torch.env.plant import ContactParams, PlantState
from mpctsid_tpu_torch.est.filter import EstimatorState, estimator_init
from mpctsid_tpu_torch.model.gaits import GAIT_IDS
from mpctsid_tpu_torch.model.solo12 import SOLO12
from mpctsid_tpu_torch.qp import _build, kernels
from mpctsid_tpu_torch.sweep import (METRIC_KEYS, SweepState, run_sweep,
                                     summarize)
from mpctsid_tpu_torch.utils import enforce_f32_matmuls
from mpctsid_tpu_torch.wbc.tsid import solve_wbc

# Published peaks of one H100 SXM (NVIDIA data sheet): the yardstick of the
# bound, whatever the power limit of the card at hand (printed beside it).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# The tensor cores' dense TF32 rate.  A product that keeps f32 accuracy takes
# at least three TF32 products (hi hi, hi lo, lo hi), so the f32-equivalent
# peak of split-TF32 work is a third of it: the operations side of kernel 5.
TF32_FLOP_PER_S = 495e12
SPLIT_TF32_FLOP_PER_S = TF32_FLOP_PER_S / 3.0

KERNEL_TOL = 1e-4      # abs, x/z/y on unit-scaled inequality-only QPs: same
                       # arithmetic, other summation order
# The refined iteration on QPs WITH equality rows.  On such a row rho is
# ~200, so y += rho (z_r - z) turns one f32 rounding of z (|z| ~ 3: 2e-7)
# into 4e-5 of y per iteration, and A' (rho z - y) feeds it back into x: two
# summation orders of the same arithmetic sit up to 4e-4 apart after 13
# iterations (measured on the CPU between the plain version and the TPU
# kernel in interpret mode: x 1.4e-4, z 3.7e-4, y 1.6e-4).  Without equality
# rows the same kernels are held to KERNEL_TOL.
REFINED_EQ_TOL = 1e-3
# The whole solve (two or three factorizations of cond ~1e4 matrices, 39-60
# iterations): the JAX package's own budget between two of its backends, on
# the UNSCALED solution.
FUSED_X_TOL = 1e-3
FUSED_Y_TOL = 1e-2
FUSED_SCALE_RTOL = 1e-4    # D, E, c: products of eight rsqrt's
# Downstream of a whole WBC solve the f32 noise of the 40-iteration solver
# decides (tests/test_torch_wbc.py: the JAX package differs from itself by
# 5.9e-2 Nm between lowerings; two backends of one package by up to 1.2e-1).
WBC_TAU_TOL = 0.2          # Nm, max over scenarios, one tick
WBC_TAU_MEDIAN_TOL = 5e-2  # Nm, median over scenarios
WBC_PERIOD_Q_TOL = 2e-3    # plant q after one period (20 ticks)
ROLLOUT_PERIODS = 3        # 60 WBC ticks per scenario
# Hint-free leg odometry drifts in x-y.  The JAX package's own test allows
# 0.065 m over 600 ms of trot (tests/test_estimator.py); this rollout lasts
# 60 ms from standing and was measured at 6.5e-4 m (max of 4096 scenarios,
# H100), so it is held to eight times that.
EST_DRIFT_TOL = 5e-3
SWEEP_TOTAL, SWEEP_CHUNK, SWEEP_PERIODS = 2048, 1024, 3
REFINED_ITERS = 13         # the WBC's 40 iterations in 3 rounds
FAILURES: list[str] = []


def check(cond: bool, what: str) -> None:
    print(f"  [{'ok' if cond else 'FAIL'}] {what}", flush=True)
    if not cond:
        FAILURES.append(what)


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


# ------------------------------------------------------------ kernel inputs

def random_qps(seed: int, B: int, n: int, m: int, eq: bool):
    """Unit-scaled random QPs (numpy, seeded): P, q, A, l, u.  With `eq`,
    four equality rows and a few infinite bounds (+-1e20, the convention of
    the WBC's swing rows)."""
    r = np.random.default_rng(seed)
    Q = r.normal(size=(B, n, n))
    P = Q @ Q.transpose(0, 2, 1) / n + 0.1 * np.eye(n)
    q = r.normal(size=(B, n))
    A = r.normal(size=(B, m, n))
    x_feas = r.normal(size=(B, n)) * 0.1
    margin = np.abs(r.normal(size=(B, m))) + 0.1
    Ax = np.einsum("bmn,bn->bm", A, x_feas)
    l, u = Ax - margin, Ax + margin
    if eq:
        l[:, :4] = u[:, :4] = Ax[:, :4]
        l[:, 10:13] = -1e20
        u[:, 12:15] = 1e20
    return r, P, q, A, l, u


def _dev(device):
    return lambda a, dt=torch.float32: torch.as_tensor(a).to(  # noqa: E731
        device, dt).contiguous()


def iteration_inputs(seed: int, B: int, n: int, m: int, device, eq: bool):
    """What the solver hands an iteration kernel: K = P + sigma I + A' rho A
    and its inverse (float64 on the card, rounded to float32 and left as
    unsymmetric as rounding makes them), rho with the 1e3 boost on equality
    rows, warm iterates.  Returns (m2_args, refined_args)."""
    r, P, q, A, l, u = random_qps(seed, B, n, m, eq)
    rho = 0.1 * (1.0 + r.uniform(size=(B, m))) * np.where(
        (u - l) < 1e-9, 1e3, 1.0)
    x = r.normal(size=(B, n)) * 0.1
    y = r.normal(size=(B, m)) * 0.1
    z = np.clip(np.einsum("bmn,bn->bm", A, x), l, u)
    dev = _dev(device)
    A64, P64, rho64 = (dev(a, torch.float64) for a in (A, P, rho))
    K = P64 + 1e-6 * torch.eye(n, dtype=torch.float64, device=device) \
        + torch.bmm((A64 * rho64[:, :, None]).transpose(1, 2), A64)
    Ki = torch.linalg.inv(K)
    M2 = (2.0 * Ki - Ki @ K @ Ki).float().contiguous()
    vecs = [dev(a) for a in (A, q, l, u, rho, x, z, y)]
    return [M2] + vecs, [Ki.float().contiguous(), K.float().contiguous()] + vecs


def fused_inputs(seed: int, B: int, n: int, m: int, device):
    r, P, q, A, l, u = random_qps(seed, B, n, m, eq=True)
    eqf = ((u - l) < 1e-9).astype(np.float32)
    x0 = r.normal(size=(B, n)) * 0.1
    y0 = r.normal(size=(B, m)) * 0.1
    dev = _dev(device)
    return [dev(a) for a in (P, q, A, l, u, eqf, x0, y0)]


def shape_of(args, a_index: int):
    B, n = args[0].shape[:2]
    return B, n, args[a_index].shape[1]


def max_err(got, want) -> float:
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def all_finite(tensors) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in tensors)


def check_repeatable(label: str, fn) -> None:
    """Two launches on the same inputs must agree bit for bit (no atomics,
    no order that changes from run to run)."""
    first, second = fn(), fn()
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(first, second)),
          f"{label}: two launches agree bit for bit")


def compare_m2(name: str, args, iters: int = 30) -> float:
    kw = dict(iters=iters, sigma=1e-6, alpha=1.6)
    got = kernels.admm_iterate_m2(*args, **kw)
    torch.cuda.synchronize()
    want = kernels.admm_iterate_m2_reference(*args, **kw)
    err = max_err(got, want)
    B, n, m = shape_of(args, 1)
    print(f"  m2 {name}: B={B} n={n} m={m} iters={iters} "
          f"max|d(x,z,y)|={err:.3e}", flush=True)
    check(all_finite(got) and err < KERNEL_TOL,
          f"m2 kernel vs plain, {name}: max abs err {err:.3e} < "
          f"{KERNEL_TOL:g}")
    return err


def compare_refined(name: str, args, tol: float, packed: bool = True):
    """Kernels 2 and 3 against the one plain version and against each other;
    returns (err of the generic kernel, err of the packed kernel)."""
    kw = dict(iters=REFINED_ITERS, sigma=1e-6, alpha=1.6)
    B, n, m = shape_of(args, 2)
    want = kernels.admm_iterate_refined_reference(*args, **kw)
    got_v = kernels.admm_iterate_vpu(*args, **kw)
    torch.cuda.synchronize()
    err_v = max_err(got_v, want)
    line = (f"  refined {name}: B={B} n={n} m={m} iters={REFINED_ITERS} "
            f"vpu vs plain {err_v:.3e}")
    ok = all_finite(got_v) and err_v < tol
    err_p = 0.0
    if packed:
        got_p = kernels.admm_iterate_vpu_packed(*args, **kw)
        torch.cuda.synchronize()
        err_p = max_err(got_p, want)
        err_vp = max_err(got_p, got_v)
        line += f", packed vs plain {err_p:.3e}, packed vs vpu {err_vp:.3e}"
        ok = ok and all_finite(got_p) and err_p < tol and err_vp < tol
    print(line, flush=True)
    check(ok, f"refined kernels vs plain and each other, {name}: < {tol:g}")
    return err_v, err_p


def compare_mma(name: str, args, tol: float, iters: int = REFINED_ITERS,
                f64: bool = True, path: str = "warp", cluster: int = 0):
    """Kernel 5 against its plain version (K as given), and against the
    generic kernel on the same inputs with K made exactly symmetric (there
    the two sides of K are one function); returns the error against plain.
    The launch must take `path` ("warp", or "cluster" with `cluster` blocks
    per scenario), and two launches must agree bit for bit.

    With `f64` also the precision contract of the split-TF32 products:
    against a float64 run of the plain version the kernel must be as accurate
    as the float32 plain version is (within a factor 2; both distances are
    maxima of chaotic rounding noise, hence the tenth of the tolerance)."""
    kw = dict(iters=iters, sigma=1e-6, alpha=1.6)
    B, n, m = shape_of(args, 2)
    lay = kernels.mma_layout(n, m, B,
                             *kernels.device_limits(args[0].device))
    check((lay.path, lay.cluster) == (path, cluster),
          f"mma kernel, {name}: takes the {path} path"
          + (f" with clusters of {cluster}" if cluster else "")
          + f" ({lay})")
    want = kernels.admm_iterate_reference(*args, **kw)
    got = kernels.admm_iterate(*args, **kw)
    torch.cuda.synchronize()
    err = max_err(got, want)
    check_repeatable(f"mma kernel, {name}",
                     lambda: kernels.admm_iterate(*args, **kw))
    if f64:
        want64 = [t.float() for t in kernels.admm_iterate_reference(
            *[a.double() for a in args], **kw)]
        k64, p64 = max_err(got, want64), max_err(want, want64)
        print(f"  mma {name}: distance to a float64 run: kernel {k64:.3e}, "
              f"plain {p64:.3e}", flush=True)
        check(k64 <= 2.0 * p64 + tol / 10,
              f"mma kernel, {name}: as close to the float64 run as the plain "
              "float32 version (factor 2, plus a tenth of the tolerance)")
    sym = list(args)
    sym[1] = (0.5 * (args[1] + args[1].transpose(1, 2))).contiguous()
    got_s = kernels.admm_iterate(*sym, **kw)
    got_v = kernels.admm_iterate_vpu(*sym, **kw)
    torch.cuda.synchronize()
    err_v = max_err(got_s, got_v)
    print(f"  mma {name}: B={B} n={n} m={m} iters={iters} vs plain "
          f"{err:.3e}; symmetric K, vs the generic kernel {err_v:.3e}",
          flush=True)
    check(all_finite(got) and all_finite(got_s) and err < tol
          and err_v < tol,
          f"mma kernel vs plain and (symmetric K) vs the generic kernel, "
          f"{name}: < {tol:g}")
    return err


def time_mma(args, iters: int, reps: int, smi: str) -> dict:
    """Kernel 5, its plain version and the bound at the shape of `args`; also
    the generic FMA kernel's time (kernel 2: the same work with K
    transposed) as the yardstick of the tensor-core mat-vec."""
    kw = dict(iters=iters, sigma=1e-6, alpha=1.6)
    B, n, m = shape_of(args, 2)
    ms = time_ms(lambda: kernels.admm_iterate(*args, **kw), 2, reps)
    plain_ms = time_ms(
        lambda: kernels.admm_iterate_reference(*args, **kw), 1, 3)
    bound = refined_bound_ms(B, n, m, iters, SPLIT_TF32_FLOP_PER_S)
    report_times("mma", f"B={B} n={n} m={m} iters={iters}", ms, plain_ms,
                 bound, smi)
    vpu_ms = time_ms(lambda: kernels.admm_iterate_vpu(*args, **kw), 2, reps)
    print(f"    the generic FMA kernel on the same inputs: {vpu_ms:.4f} ms",
          flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                bound_by=bound[1])


SKEW = 3e-5     # of max |K|, added above the diagonal only


def compare_mma_skewed(name: str, args) -> float:
    """K made visibly non-symmetric: kernel 5 must follow the plain version
    that applies K AS GIVEN, and the plain version that applies K transposed
    (kernels 2 and 3) must lie far from both.  x and z are compared: on a
    skewed K the refinement no longer cancels, and y (rho ~200 on equality
    rows) amplifies the rounding of z beyond any fixed tolerance."""
    kw = dict(iters=REFINED_ITERS, sigma=1e-6, alpha=1.6)
    skewed = list(args)
    K = args[1]
    g = torch.Generator(device="cpu").manual_seed(0)
    noise = torch.randn(K.shape, generator=g).to(K.device)
    skewed[1] = (K + SKEW * K.abs().max() * torch.triu(noise, 1)).contiguous()
    got = kernels.admm_iterate(*skewed, **kw)
    torch.cuda.synchronize()
    as_given = kernels.admm_iterate_reference(*skewed, **kw)
    transposed = kernels.admm_iterate_refined_reference(*skewed, **kw)
    err = max_err(got[:2], as_given[:2])
    apart = max_err(got[:2], transposed[:2])
    sides = max_err(as_given[:2], transposed[:2])
    print(f"  mma {name}, skewed K ({SKEW:g} of max|K| above the diagonal): "
          f"x, z vs plain K as given {err:.3e}; vs plain K transposed "
          f"{apart:.3e} (the two plain versions {sides:.3e} apart)",
          flush=True)
    check(all_finite(got) and err < REFINED_EQ_TOL,
          f"mma kernel, {name}, applies K as given: < {REFINED_EQ_TOL:g} of "
          "that plain version")
    check(apart > 10 * REFINED_EQ_TOL and apart > 10 * err,
          f"mma kernel, {name}, on a skewed K is far (> 10 tolerances, > 10 "
          "x its error) from K applied transposed")
    return err


FUSED_KW = dict(iters=40, adapt_rounds=3, equilibrate_iters=8, rho0=0.1,
                sigma=1e-6, alpha=1.6, rho_eq_scale=1e3, inf=1e20)


def compare_fused(name: str, args, path: str = "warp") -> float:
    """Kernel 4 against its plain version: the unscaled solution and the
    scales; returns the max abs error of the unscaled x.  The launch must
    take `path` ("warp" or "block"), and two launches must agree bit for bit.

    Two float32 runs of this solver differ by chaotic rounding noise whose
    largest value grows with the number of QPs looked at (measured: max |dx|
    5e-4 over 64 random QPs, 1.5e-3 over 4096).  So the kernel is held to
    the tolerance on all but 1 in 200 scenarios (on every one when B < 200),
    and, against a float64 run of the plain version, to being as accurate
    as the float32 plain version is (within a factor 2)."""
    B, n, m = shape_of(args, 2)
    lay = kernels.fused_layout(n, m, B,
                               *kernels.device_limits(args[0].device))
    check(lay.path == path,
          f"fused kernel, {name}: takes the {path} path ({lay})")
    xs, ys, D, E, c = kernels.admm_solve_fused(*args, **FUSED_KW)
    torch.cuda.synchronize()
    check_repeatable(f"fused kernel, {name}",
                     lambda: kernels.admm_solve_fused(*args, **FUSED_KW))

    def unscaled(xs_, ys_, D_, E_, c_):
        return D_ * xs_, E_ * ys_ / c_[:, None]

    x_k, y_k = unscaled(xs, ys, D, E, c)
    ref = kernels.admm_solve_fused_reference(*args, **FUSED_KW)
    x_p, y_p = unscaled(*ref)
    x_64, y_64 = (t.float() for t in unscaled(
        *kernels.admm_solve_fused_reference(*[a.double() for a in args],
                                            **FUSED_KW)))
    ex = (x_k - x_p).abs().amax(dim=1)
    ey = (y_k - y_p).abs().amax(dim=1)
    err_x, err_y = float(ex.max()), float(ey.max())
    over = int(((ex >= FUSED_X_TOL) | (ey >= FUSED_Y_TOL)).sum())
    k64 = (float((x_k - x_64).abs().max()), float((y_k - y_64).abs().max()))
    p64 = (float((x_p - x_64).abs().max()), float((y_p - y_64).abs().max()))
    err_s = max(float(((a - b).abs() / b.abs()).max())
                for a, b in ((D, ref[2]), (E, ref[3]), (c, ref[4])))
    print(f"  fused {name}: B={B} n={n} m={m} iters=40/3 unscaled "
          f"max|dx|={err_x:.3e} max|dy|={err_y:.3e} ({over} of {B} scenarios "
          f"over tolerance), scales rel {err_s:.3e}; distance to a float64 "
          f"run (x, y): kernel {k64[0]:.3e}, {k64[1]:.3e}; plain "
          f"{p64[0]:.3e}, {p64[1]:.3e}", flush=True)
    check(all_finite((xs, ys, D, E, c)) and over <= B // 200
          and err_s < FUSED_SCALE_RTOL,
          f"fused kernel vs plain, {name}: x < {FUSED_X_TOL:g}, y < "
          f"{FUSED_Y_TOL:g} on all but {B // 200} scenarios, scales < "
          f"{FUSED_SCALE_RTOL:g} rel")
    check(k64[0] <= 2.0 * p64[0] + 1e-4 and k64[1] <= 2.0 * p64[1] + 1e-4,
          f"fused kernel, {name}: as close to the float64 run as the plain "
          "float32 version (factor 2)")
    return err_x


def time_ms(fn, warmup: int, reps: int) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(floats: float, flops: float,
             flop_per_s: float = F32_FLOP_PER_S):
    """Least time the card could take: the bytes moved (every input read
    once, every output written once, 4 B each) against the memory rate, the
    operations against the peak rate of the unit that does them (the f32 FMA
    peak unless given); the larger of the two.  Returns
    (bound_ms, "bytes" | "operations", bytes_ms, flops_ms, flop_per_s)."""
    bytes_ms = 4.0 * floats / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / flop_per_s * 1e3
    return (max(bytes_ms, flops_ms),
            "bytes" if bytes_ms >= flops_ms else "operations",
            bytes_ms, flops_ms, flop_per_s)


def m2_bound_ms(B: int, n: int, m: int, iters: int):
    """M2, A, q, x, l, u, rho, z, y in, x, z, y out; iters * (4 m n + 2 n^2)
    flops per scenario."""
    floats = B * (n * n + m * n + 2 * n + 5 * m + n + 2 * m)
    return bound_ms(floats, B * iters * (4.0 * m * n + 2.0 * n * n))


def refined_bound_ms(B: int, n: int, m: int, iters: int,
                     flop_per_s: float = F32_FLOP_PER_S):
    """K^-1, K, A, q, x, l, u, rho, z, y in, x, z, y out; iters *
    (4 m n + 6 n^2) flops per scenario (two products with A, three n x n),
    against the f32 FMA peak for kernels 2 and 3 and against the split-TF32
    tensor-core peak for kernel 5."""
    floats = B * (2 * n * n + m * n + 2 * n + 5 * m + n + 2 * m)
    return bound_ms(floats, B * iters * (4.0 * m * n + 6.0 * n * n),
                    flop_per_s)


def fused_bound_ms(B: int, n: int, m: int, iters: int, adapt_rounds: int,
                   equilibrate_iters: int):
    """P, A, q, x0, l, u, eqf, y0 in, x, D, y, E, c out.  Operations per
    scenario: each Ruiz round two abs-max passes and one rescale of P and A
    and the cost scale (6 n^2 + 4 m n); each adapt round K (2 m n^2 + m n),
    the Cholesky and the triangular inverse (n^3 / 3 each), X0 (2 n^3 / 3),
    the Newton-Schulz step and its two residual products (3 x 2 n^3); the
    iterations ((4 m n + 6 n^2) each); between rounds the residual ratios
    (4 m n + 2 n^2)."""
    rounds = max(1, adapt_rounds)
    iters_per = max(1, iters // rounds)
    floats = B * (n * n + m * n + 2 * n + 4 * m + 2 * n + 2 * m + 1)
    n3 = float(n) ** 3
    flops = B * (
        equilibrate_iters * (6.0 * n * n + 4.0 * m * n)
        + rounds * (2.0 * m * n * n + m * n + 2.0 * n3 / 3.0
                    + 2.0 * n3 / 3.0 + 6.0 * n3)
        + rounds * iters_per * (4.0 * m * n + 6.0 * n * n)
        + (rounds - 1) * (4.0 * m * n + 2.0 * n * n))
    return bound_ms(floats, flops)


def report_times(label, shape, kernel_ms, plain_ms, bound, smi) -> None:
    b_ms, by, bytes_ms, flops_ms, flop_per_s = bound
    unit = ("f32" if flop_per_s == F32_FLOP_PER_S
            else "f32-equivalent in split TF32 on the tensor cores")
    print(f"  {label} {shape}: kernel {kernel_ms:.4f} ms, plain "
          f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms by {by} (bytes "
          f"{bytes_ms:.4f} ms at {HBM_BYTES_PER_S / 1e12:.2f} TB/s, flops "
          f"{flops_ms:.4f} ms at {flop_per_s / 1e12:.0f} TFLOP/s {unit})  "
          f"[{smi}]", flush=True)


# ---------------------------------------------------------------- main path

COUNTED = {"admm_iterate_m2": kernels.admm_iterate_m2,
           "admm_iterate_vpu": kernels.admm_iterate_vpu,
           "admm_iterate_vpu_packed": kernels.admm_iterate_vpu_packed,
           "admm_solve_fused": kernels.admm_solve_fused,
           "admm_iterate": kernels.admm_iterate}


def reset_launch_counts() -> None:
    for fn in COUNTED.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in COUNTED.items()}


WBC_KERNEL_OF = {"fused": "admm_solve_fused",
                 "packed": "admm_iterate_vpu_packed",
                 "vpu": "admm_iterate_vpu",
                 "pallas": "admm_iterate"}
MPC_KERNEL_OF = {"auto_mpc": "admm_iterate_m2", "m2": "admm_iterate_m2",
                 "pallas": "admm_iterate"}


def expected_launches(cfg, periods: int, wbc_backend: str,
                      mpc_backend: str = None):
    """(the kernel this rollout is there to count, every kernel's expected
    launches): the MPC's iteration kernel once per MPC adapt round; the
    whole-solve kernel once per WBC tick; a WBC iteration kernel once per WBC
    adapt round."""
    expect = dict.fromkeys(COUNTED, 0)
    mpc_kernel = MPC_KERNEL_OF[mpc_backend or cfg.solver.mpc_backend]
    expect[mpc_kernel] = periods * cfg.solver.mpc_adapt_rounds
    counted = WBC_KERNEL_OF.get(wbc_backend, mpc_kernel)
    if wbc_backend in WBC_KERNEL_OF:
        ticks = periods * cfg.cascade.mpc_every
        expect[counted] += ticks * (
            1 if wbc_backend == "fused" else cfg.solver.wbc_adapt_rounds)
    return counted, expect


def standing(B: int):
    q0 = np.zeros((B, 19), np.float32)
    q0[:, 2] = SOLO12.h_ref
    q0[:, 6] = 1.0
    q0[:, 7:] = SOLO12.q_stand
    return q0


def make_scenarios(cfg, B: int, seed: int, device):
    cc = CascadeConfigured(SOLO12, cfg)
    q0 = standing(B)
    gid = np.full((B,), GAIT_IDS[cfg.gait], np.int32)
    ctl = init_controller(SOLO12, cfg, cc.tree, q0, gid, device=device)
    plant = PlantState.init(q0, device=device)
    cp = ContactParams.default(B, device=device)
    mu = np.random.default_rng(seed).uniform(0.5, 0.9, size=B)
    cp.mu = torch.as_tensor(mu, dtype=torch.float32).to(device)
    v = np.tile(np.asarray(cfg.v_ref, np.float32), (B, 1))
    return cc, ctl, plant, gid, v, cp


def full_width_rollout(cfg, wbc_backend: str, expect: dict, smi: str, device,
                       mpc_backend: str = None, use_estimator: bool = False):
    """The main path at full width with one WBC backend: ROLLOUT_PERIODS
    periods of the preset from standing, every launch count set to 0 just
    before and read just after.  With `use_estimator` the controller runs on
    the hint-free complementary filter's estimate.  Returns the counts."""
    B = cfg.batch
    cc, ctl, plant, gid, v, cp = make_scenarios(cfg, B, seed=0, device=device)
    est = estimator_init(standing(B), device=device) if use_estimator else None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.time()
    ctl, plant, metrics = cascade_rollout(
        cc, ctl, plant, gid, v, cp, n_periods=ROLLOUT_PERIODS, device=device,
        est=est, use_estimator=use_estimator, mpc_backend=mpc_backend,
        wbc_backend=wbc_backend)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = launch_counts()
    ticks = B * ROLLOUT_PERIODS * cfg.cascade.mpc_every
    x = metrics["x_srb"]
    finite = all_finite((plant.q, plant.v, ctl.f_plan, x, metrics["tau_rms"]))
    dz = float((x[:, :, 2] - SOLO12.h_ref).abs().max())
    wbc_ok = float(metrics["wbc_ok_frac"].mean())
    tag = f"wbc_backend={wbc_backend}"
    if mpc_backend is not None:
        tag = f"mpc_backend={mpc_backend} " + tag
    if use_estimator:
        tag = "estimator in the loop, " + tag
    print(f"  {tag}: {ticks / wall:.1f} ticks/s, "
          f"{wall / ROLLOUT_PERIODS:.3f} s per period, wall {wall:.2f} s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  "
          f"[{smi}]")
    print(f"    launches {counts}; max |z - h_ref| {dz:.4f} m; wbc_ok_frac "
          f"{wbc_ok:.4f}; mean mpc dual res "
          f"{float(metrics['mpc_dual_res'].mean()):.3e}; mean x after "
          f"{ROLLOUT_PERIODS} periods {float(plant.q[:, 0].mean()):+.4f} m",
          flush=True)
    check(tuple(x.shape) == (B, ROLLOUT_PERIODS, 12), f"{tag}: metrics shape")
    check(finite, f"{tag}: everything finite")
    check(bool(metrics["mpc_ok"].all()), f"{tag}: mpc_ok all true")
    check(wbc_ok >= 0.99, f"{tag}: wbc_ok_frac >= 0.99")
    check(dz < 0.03, f"{tag}: base height within 0.03 m of h_ref, every "
                     "scenario and period")
    check(counts == expect, f"{tag}: kernel launches are {expect}")
    if use_estimator:
        drift = metrics["est_xy_err"]
        print(f"    hint-free estimator drift |est xy - plant xy| after "
              f"{ROLLOUT_PERIODS} periods: mean "
              f"{float(drift[:, -1].mean()):.3e} m, max "
              f"{float(drift[:, -1].max()):.3e} m", flush=True)
        check(tuple(drift.shape) == (B, ROLLOUT_PERIODS)
              and bool(torch.isfinite(drift).all())
              and float(drift.max()) < EST_DRIFT_TOL,
              f"{tag}: est_xy_err finite and < {EST_DRIFT_TOL} m")
    return counts


def capture_wbc_tick(cc, ctl, plant, gid, v, cp, tick: int, device):
    """Arguments of the `tick`-th solve_wbc call of one period (a real
    mid-gait WBC problem with its warm start), and the state after it."""
    captured = []
    original = engine.solve_wbc

    def hook(tree, cfg, q, v_, refs, **kw):
        captured.append((tree, cfg, q, v_, refs, kw))
        return original(tree, cfg, q, v_, refs, **kw)

    engine.solve_wbc = hook
    try:
        ctl, plant, _ = cascade_rollout(cc, ctl, plant, gid, v, cp,
                                        n_periods=1, device=device)
    finally:
        engine.solve_wbc = original
    return captured[tick], ctl, plant


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU and has no CPU fallback", file=sys.stderr)
        return 2
    t_script = time.time()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    # ---- 1. device ------------------------------------------------------
    print("== 1. device", flush=True)
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"  nvidia-smi name, power.limit: {smi}")
    print(f"  python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  "
          f"capability {torch.cuda.get_device_capability(0)}")
    enforce_f32_matmuls()
    print(f"  allow_tf32={torch.backends.cuda.matmul.allow_tf32}  "
          f"float32_matmul_precision={torch.get_float32_matmul_precision()}")
    check(torch.backends.cuda.matmul.allow_tf32 is False
          and torch.get_float32_matmul_precision() == "highest",
          "matrix products pinned to full float32")

    # ---- 2. build -------------------------------------------------------
    print("== 2. build", flush=True)
    t0 = time.time()
    kernels.build_all()
    for name in kernels.LIBRARIES:
        kernels._library(name)
    print(f"  nvcc {' '.join(_build.NVCC_FLAGS)}  ->  {_build.build_dir()}")
    print(f"  {len(kernels.LIBRARIES)} libraries built together and loaded in "
          f"{time.time() - t0:.2f} s; nvcc seconds each: "
          + ", ".join(f"{k} {v:.2f}" for k, v in _build.BUILD_SECONDS.items()),
          flush=True)
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {name}: {line.strip()}")

    reports = {}

    # ---- 3a. kernel 1 vs plain ------------------------------------------
    print("== 3a. M2 iteration kernel vs plain PyTorch version, on the card",
          flush=True)
    mpc_args, _ = iteration_inputs(0, 64, 192, 320, device, eq=False)
    errs = [compare_m2("mpc shape", mpc_args),
            compare_m2("test shape",
                       iteration_inputs(1, 3, 24, 40, device, eq=False)[0]),
            compare_m2("single",
                       iteration_inputs(2, 1, 192, 320, device, eq=False)[0]),
            compare_m2("wbc-sized, odd",
                       iteration_inputs(3, 5, 30, 50, device, eq=False)[0])]
    # the main path's own shape: the 64 scenarios tiled to B = 4096 (every
    # scenario has its own memory; the kernel's time does not depend on the
    # values), compared once more and then timed
    Bt, n, m, iters = 4096, 192, 320, 30
    big = [a.repeat((Bt // a.shape[0],) + (1,) * (a.dim() - 1)).contiguous()
           for a in mpc_args]
    errs.append(compare_m2("main path shape", big, iters=iters))
    kw = dict(iters=iters, sigma=1e-6, alpha=1.6)
    kernel_ms = time_ms(lambda: kernels.admm_iterate_m2(*big, **kw), 1, 3)
    plain_ms = time_ms(
        lambda: kernels.admm_iterate_m2_reference(*big, **kw), 1, 2)
    bound = m2_bound_ms(Bt, n, m, iters)
    del big, mpc_args
    torch.cuda.empty_cache()
    report_times("m2", f"B={Bt} n={n} m={m} iters={iters}", kernel_ms,
                 plain_ms, bound, smi)
    reports["admm_iterate_m2"] = dict(
        source="mpctsid_tpu_torch/qp/csrc/admm_m2.cu",
        replaces="mpctsid_tpu/qp/pallas_kernels.py:440",
        max_abs_err=max(errs), ms=kernel_ms, plain_ms=plain_ms,
        bound_ms=bound[0], bound_by=bound[1])

    # ---- 3b. kernels 2 and 3 vs plain and each other --------------------
    print("== 3b. generic and packed refined-iteration kernels vs their "
          "plain version and each other", flush=True)
    _, wbc_args = iteration_inputs(10, 64, 30, 50, device, eq=True)
    ev, ep = zip(
        compare_refined("wbc shape", wbc_args, REFINED_EQ_TOL),
        compare_refined("test shape", iteration_inputs(
            11, 3, 24, 40, device, eq=True)[1], REFINED_EQ_TOL),
        compare_refined("single", iteration_inputs(
            12, 1, 30, 50, device, eq=True)[1], REFINED_EQ_TOL),
        compare_refined("partial last block", iteration_inputs(
            13, 37, 30, 50, device, eq=True)[1], REFINED_EQ_TOL),
        compare_refined("wbc shape, no equality rows", iteration_inputs(
            14, 64, 30, 50, device, eq=False)[1], KERNEL_TOL))
    ev, ep = list(ev), list(ep)
    _, mpc_refined = iteration_inputs(15, 8, 192, 320, device, eq=True)
    ev.append(compare_refined("mpc shape (streamed matrices)", mpc_refined,
                              REFINED_EQ_TOL, packed=False)[0])
    refused = False
    try:
        kernels.admm_iterate_vpu_packed(*mpc_refined, iters=1)
    except ValueError as e:
        refused = "shared memory" in str(e)
    check(refused, "packed kernel refuses the MPC shape with the reason "
                   "(it never hands work to the generic kernel)")
    del mpc_refined
    Bt, n, m = 4096, 30, 50
    _, big = iteration_inputs(16, Bt, n, m, device, eq=True)
    e_v, e_p = compare_refined("main path shape", big, REFINED_EQ_TOL)
    ev.append(e_v)
    ep.append(e_p)
    kw = dict(iters=REFINED_ITERS, sigma=1e-6, alpha=1.6)
    vpu_ms = time_ms(lambda: kernels.admm_iterate_vpu(*big, **kw), 2, 10)
    packed_ms = time_ms(
        lambda: kernels.admm_iterate_vpu_packed(*big, **kw), 2, 10)
    plain_ms = time_ms(
        lambda: kernels.admm_iterate_refined_reference(*big, **kw), 1, 3)
    bound = refined_bound_ms(Bt, n, m, REFINED_ITERS)
    shape = f"B={Bt} n={n} m={m} iters={REFINED_ITERS}"
    report_times("vpu", shape, vpu_ms, plain_ms, bound, smi)
    report_times("packed", shape, packed_ms, plain_ms, bound, smi)
    del big
    reports["admm_iterate_vpu"] = dict(
        source="mpctsid_tpu_torch/qp/csrc/admm_vpu.cu",
        replaces="mpctsid_tpu/qp/pallas_kernels.py:155",
        max_abs_err=max(ev), ms=vpu_ms, plain_ms=plain_ms,
        bound_ms=bound[0], bound_by=bound[1])
    reports["admm_iterate_vpu_packed"] = dict(
        source="mpctsid_tpu_torch/qp/csrc/admm_packed.cu",
        replaces="mpctsid_tpu/qp/pallas_kernels.py:274",
        max_abs_err=max(ep), ms=packed_ms, plain_ms=plain_ms,
        bound_ms=bound[0], bound_by=bound[1])

    # ---- 3c. kernel 4 vs plain ------------------------------------------
    print("== 3c. whole-solve kernel vs its plain version", flush=True)
    errs = [compare_fused("wbc shape", fused_inputs(20, 64, 30, 50, device)),
            compare_fused("test shape", fused_inputs(21, 3, 24, 40, device)),
            compare_fused("single", fused_inputs(22, 1, 30, 50, device)),
            compare_fused("odd batch", fused_inputs(23, 37, 30, 50, device)),
            compare_fused("n = 32, the warp path's edge",
                          fused_inputs(26, 64, 32, 50, device)),
            compare_fused("n = 33 (block path)",
                          fused_inputs(27, 8, 33, 55, device), path="block"),
            compare_fused("mpc shape (block path, global workspace)",
                          fused_inputs(24, 8, 192, 320, device),
                          path="block")]
    for seed, B_ in ((28, 1), (57, 37), (50, 64), (51, 4096)):
        errs.append(compare_fused(f"test shape, B={B_}",
                                  fused_inputs(seed, B_, 24, 40, device)))
    big = fused_inputs(25, Bt, n, m, device)
    errs.append(compare_fused("main path shape", big))
    fused_ms = time_ms(lambda: kernels.admm_solve_fused(*big, **FUSED_KW),
                       2, 10)
    plain_ms = time_ms(
        lambda: kernels.admm_solve_fused_reference(*big, **FUSED_KW), 1, 2)
    bound = fused_bound_ms(Bt, n, m, FUSED_KW["iters"],
                           FUSED_KW["adapt_rounds"],
                           FUSED_KW["equilibrate_iters"])
    report_times("fused", f"B={Bt} n={n} m={m} iters=40/3", fused_ms,
                 plain_ms, bound, smi)
    del big
    torch.cuda.empty_cache()
    reports["admm_solve_fused"] = dict(
        source="mpctsid_tpu_torch/qp/csrc/admm_fused.cu",
        replaces="mpctsid_tpu/qp/pallas_kernels.py:851",
        max_abs_err=max(errs), ms=fused_ms, plain_ms=plain_ms,
        bound_ms=bound[0], bound_by=bound[1])

    # ---- 3d. kernel 5 vs plain ------------------------------------------
    print("== 3d. tensor-core iteration kernel (K as given) vs its plain "
          "version", flush=True)
    _, wbc_args = iteration_inputs(30, 64, 30, 50, device, eq=True)
    _, mpc_args = iteration_inputs(35, 8, 192, 320, device, eq=True)
    errs = [compare_mma("wbc shape", wbc_args, REFINED_EQ_TOL),
            compare_mma("test shape", iteration_inputs(
                31, 3, 24, 40, device, eq=True)[1], REFINED_EQ_TOL),
            compare_mma("single", iteration_inputs(
                32, 1, 30, 50, device, eq=True)[1], REFINED_EQ_TOL),
            compare_mma("odd batch", iteration_inputs(
                33, 37, 30, 50, device, eq=True)[1], REFINED_EQ_TOL),
            compare_mma("wbc shape, no equality rows", iteration_inputs(
                34, 64, 30, 50, device, eq=False)[1], KERNEL_TOL),
            compare_mma("mpc shape, equality rows", mpc_args, REFINED_EQ_TOL,
                        path="cluster", cluster=3),
            compare_mma("mpc shape, single", iteration_inputs(
                38, 1, 192, 320, device, eq=True)[1], REFINED_EQ_TOL,
                        path="cluster", cluster=3),
            compare_mma("n=128 m=208 (clusters of 2)", iteration_inputs(
                39, 8, 128, 208, device, eq=True)[1], REFINED_EQ_TOL,
                        path="cluster", cluster=2),
            compare_mma("n=150 m=250 (ragged slices)", iteration_inputs(
                40, 8, 150, 250, device, eq=True)[1], REFINED_EQ_TOL,
                        path="cluster", cluster=2),
            compare_mma("n=100 m=170 (one block holds all)", iteration_inputs(
                41, 8, 100, 170, device, eq=True)[1], REFINED_EQ_TOL,
                        path="cluster", cluster=1),
            compare_mma("n=256 m=400 (clusters of 6)", iteration_inputs(
                42, 4, 256, 400, device, eq=True)[1], REFINED_EQ_TOL,
                        path="cluster", cluster=6),
            compare_mma("n=400 m=700 (K and A streamed)", iteration_inputs(
                43, 2, 400, 700, device, eq=True)[1], REFINED_EQ_TOL,
                        iters=5, f64=False, path="cluster", cluster=8),
            compare_mma("n=401 m=701 (streamed, rows not 16-byte aligned)",
                        iteration_inputs(44, 2, 401, 701, device, eq=True)[1],
                        REFINED_EQ_TOL, iters=5, f64=False, path="cluster",
                        cluster=8),
            compare_mma("n=37 m=61 (odd n on the warp path)",
                        iteration_inputs(45, 5, 37, 61, device, eq=True)[1],
                        REFINED_EQ_TOL),
            compare_mma_skewed("warp path", wbc_args),
            compare_mma_skewed("cluster path", mpc_args)]
    for seed, B_ in ((52, 1), (53, 37), (54, 64), (55, 4096)):
        errs.append(compare_mma(f"test shape, B={B_}", iteration_inputs(
            seed, B_, 24, 40, device, eq=True)[1], REFINED_EQ_TOL))
    del wbc_args, mpc_args
    mma_reports = {}
    # the main path's two shapes: the WBC stage's (13 iterations, equality
    # rows) and the MPC stage's (30 iterations, none; 64 scenarios tiled to
    # B = 4096 as in 3a)
    _, big = iteration_inputs(36, Bt, n, m, device, eq=True)
    _, mpc64 = iteration_inputs(37, 64, 192, 320, device, eq=False)
    mpc_big = [a.repeat((Bt // 64,) + (1,) * (a.dim() - 1)).contiguous()
               for a in mpc64]
    del mpc64
    # (the float64 run of 4096 MPC-sized scenarios is left out: the MPC
    # shape's precision is held at B=8 above)
    errs.append(compare_mma("main path shape, wbc stage", big, REFINED_EQ_TOL))
    mma_reports["wbc"] = time_mma(big, REFINED_ITERS, 10, smi)
    del big
    errs.append(compare_mma("main path shape, mpc stage", mpc_big, KERNEL_TOL,
                            iters=30, f64=False, path="cluster", cluster=3))
    mma_reports["mpc"] = time_mma(mpc_big, 30, 3, smi)
    del mpc_big
    torch.cuda.empty_cache()
    # 60 of the 62 launches per period are at the WBC shape: its numbers are
    # the entry's; the MPC shape's ride along under *_mpc_shape
    reports["admm_iterate"] = dict(
        source="mpctsid_tpu_torch/qp/csrc/admm_mma.cu",
        replaces="mpctsid_tpu/qp/pallas_kernels.py:929",
        max_abs_err=max(errs), **mma_reports["wbc"],
        **{k + "_mpc_shape": v for k, v in mma_reports["mpc"].items()})

    # ---- 4. main path at full size, each WBC backend --------------------
    print("== 4. main path: cascade_rollout, preset config4_cascade_4k",
          flush=True)
    cfg = PRESETS["config4_cascade_4k"]
    print(f"  B={cfg.batch} gait={cfg.gait} v_ref={cfg.v_ref} periods="
          f"{ROLLOUT_PERIODS} mpc {cfg.solver.mpc_iters}/"
          f"{cfg.solver.mpc_adapt_rounds} wbc {cfg.solver.wbc_iters}/"
          f"{cfg.solver.wbc_adapt_rounds} mpc_backend="
          f"{cfg.solver.mpc_backend} (default wbc_backend="
          f"{cfg.solver.wbc_backend})")
    path_launches = {}
    for wbc_backend in (cfg.solver.wbc_backend, "fused", "packed", "vpu"):
        counted, expect = expected_launches(cfg, ROLLOUT_PERIODS, wbc_backend)
        counts = full_width_rollout(cfg, wbc_backend, expect, smi, device)
        path_launches[counted] = counts[counted]
        torch.cuda.empty_cache()
    # the estimator-in-the-loop path, both QP stages on kernel 5
    counted, expect = expected_launches(cfg, ROLLOUT_PERIODS, "pallas",
                                        mpc_backend="pallas")
    counts = full_width_rollout(cfg, "pallas", expect, smi, device,
                                mpc_backend="pallas", use_estimator=True)
    path_launches[counted] = counts[counted]
    torch.cuda.empty_cache()
    for name, count in path_launches.items():
        check(count > 0, f"{name} was launched on the main path")
        reports[name]["launches"] = count

    # ---- 5. kernels on the path vs plain on the path --------------------
    print("== 5a. mpc_backend 'm2' (kernel) vs 'torch' (plain), B=256",
          flush=True)
    cfg256 = PRESETS["config2_gait_sweep"]
    outs = {}
    for backend in ("m2", "torch"):
        cc, ctl, plant, gid, v, cp = make_scenarios(cfg256, 256, seed=1,
                                                    device=device)
        ctl1, plant1, _ = cascade_rollout(cc, ctl, plant, gid, v, cp,
                                          n_periods=1, device=device,
                                          mpc_backend=backend)
        ctl2, plant2, _ = cascade_rollout(cc, ctl1, plant1, gid, v, cp,
                                          n_periods=1, device=device,
                                          mpc_backend=backend)
        outs[backend] = (ctl1.f_plan, plant2.q, ctl2.f_plan)
    d_plan = float((outs["m2"][0] - outs["torch"][0]).abs().max())
    d_q = float((outs["m2"][1] - outs["torch"][1]).abs().max())
    d_plan2 = float((outs["m2"][2] - outs["torch"][2]).abs().max())
    print(f"  plan solved from the same state: max |df_plan| {d_plan:.3e} N; "
          f"after the period that consumes it: max |dq| {d_q:.3e}, "
          f"max |df_plan| {d_plan2:.3e} N", flush=True)
    check(d_plan < 1e-3, "backends: f_plan within 1e-3 N")
    check(d_q < 1e-4, "backends: plant q within 1e-4 after the plan is "
                      "consumed")

    print("== 5b. kernel WBC backends vs the plain WBC, B=256, mid-gait",
          flush=True)
    # two periods from standing reach mid-gait; the third is the test bed
    (tree, wcfg, q_t, v_t, refs, wkw), ctl3, plant3 = capture_wbc_tick(
        cc, ctl2, plant2, gid, v, cp, tick=10, device=device)
    wkw = {k: a for k, a in wkw.items() if k != "backend"}
    tau_plain = solve_wbc(tree, wcfg, q_t, v_t, refs, backend="torch",
                          **wkw)[0]
    for backend in ("fused", "packed", "vpu", "pallas"):
        tau, _, _, sol = solve_wbc(tree, wcfg, q_t, v_t, refs,
                                   backend=backend, **wkw)
        d_tau = (tau - tau_plain).abs().amax(dim=1)
        _, plant_k, met_k = cascade_rollout(cc, ctl2, plant2, gid, v, cp,
                                            n_periods=1, device=device,
                                            wbc_backend=backend)
        d_q = float((plant_k.q - plant3.q).abs().max())
        print(f"  {backend}: one tick max |dtau| {float(d_tau.max()):.3e} "
              f"Nm, median {float(d_tau.median()):.3e} Nm; one period max "
              f"|dq| {d_q:.3e}, wbc_ok_frac "
              f"{float(met_k['wbc_ok_frac'].mean()):.4f}", flush=True)
        check(bool(sol.ok.all()) and float(d_tau.max()) < WBC_TAU_TOL
              and float(d_tau.median()) < WBC_TAU_MEDIAN_TOL,
              f"{backend}: one WBC tick within {WBC_TAU_TOL} Nm (median "
              f"{WBC_TAU_MEDIAN_TOL}) of the plain WBC")
        check(d_q < WBC_PERIOD_Q_TOL and bool(
            (met_k["wbc_ok_frac"] == 1.0).all()),
              f"{backend}: one period within {WBC_PERIOD_Q_TOL} of the plain "
              "WBC's q, every tick ok")

    print("== 5c. estimator loop on the tensor-core kernel vs on the plain "
          "backends, B=256, one mid-gait period", flush=True)
    outs = {}
    for backend in ("pallas", "torch"):
        est = EstimatorState(q=plant2.q.clone(), v=plant2.v.clone())
        ctl_e, plant_e, met_e = cascade_rollout(
            cc, ctl2, plant2, gid, v, cp, n_periods=1, device=device, est=est,
            use_estimator=True, mpc_backend=backend, wbc_backend=backend)
        outs[backend] = (ctl_e.f_plan, plant_e.q, met_e)
    d_plan = float((outs["pallas"][0] - outs["torch"][0]).abs().max())
    d_q = float((outs["pallas"][1] - outs["torch"][1]).abs().max())
    d_est = float((outs["pallas"][2]["est_xy_err"]
                   - outs["torch"][2]["est_xy_err"]).abs().max())
    print(f"  max |df_plan| {d_plan:.3e} N, max |dq| {d_q:.3e}, max "
          f"|d est_xy_err| {d_est:.3e} m; wbc_ok_frac "
          f"{float(outs['pallas'][2]['wbc_ok_frac'].mean()):.4f}", flush=True)
    check(d_plan < 1e-3, "estimator loop: f_plan within 1e-3 N")
    check(d_q < WBC_PERIOD_Q_TOL and d_est < WBC_PERIOD_Q_TOL and bool(
        (outs["pallas"][2]["wbc_ok_frac"] == 1.0).all())
        and bool(outs["pallas"][2]["mpc_ok"].all()),
          f"estimator loop: plant q and est_xy_err within {WBC_PERIOD_Q_TOL} "
          "of the plain backends', every solve ok")

    # ---- 6. B = 1 --------------------------------------------------------
    print("== 6. single robot, B=1, one period per WBC backend", flush=True)
    cfg1 = PRESETS["config1_trot_single"]
    for wbc_backend in (cfg1.solver.wbc_backend, "fused", "packed", "vpu",
                        "pallas"):
        cc, ctl, plant, gid, v, cp = make_scenarios(cfg1, 1, seed=2,
                                                    device=device)
        reset_launch_counts()
        t0 = time.time()
        ctl, plant, metrics = cascade_rollout(
            cc, ctl, plant, gid, v, cp, n_periods=1, device=device,
            wbc_backend=wbc_backend)
        torch.cuda.synchronize()
        counts = launch_counts()
        print(f"  wbc_backend={wbc_backend}: one period "
              f"{time.time() - t0:.3f} s; launches {counts}", flush=True)
        check(all_finite((plant.q, plant.v, ctl.f_plan))
              and bool(metrics["mpc_ok"].all())
              and bool((metrics["wbc_ok_frac"] == 1.0).all()),
              f"B=1, {wbc_backend}: finite, mpc_ok, every WBC tick ok")
        expect = expected_launches(cfg1, 1, wbc_backend)[1]
        check(counts == expect, f"B=1, {wbc_backend}: launches are {expect}")

    # ---- 7. the Monte-Carlo sweep entry point ----------------------------
    print(f"== 7. run_sweep: {SWEEP_TOTAL} scenarios in chunks of "
          f"{SWEEP_CHUNK}, {SWEEP_PERIODS} periods; then interrupted, saved, "
          "loaded, finished", flush=True)
    reset_launch_counts()
    t0 = time.time()
    whole = run_sweep(SweepState.fresh(0, SWEEP_TOTAL, SWEEP_PERIODS),
                      SWEEP_CHUNK, verbose=False, device=device)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "sweep.npz")
        part = run_sweep(SweepState.fresh(0, SWEEP_TOTAL, SWEEP_PERIODS),
                         SWEEP_CHUNK, ckpt_path=ckpt, max_chunks=1,
                         verbose=False, device=device)
        stopped_at = part.cursor
        resumed = run_sweep(SweepState.load(ckpt), SWEEP_CHUNK,
                            ckpt_path=ckpt, verbose=False, device=device)
        reloaded = SweepState.load(ckpt)
    summary = summarize(whole)
    sweep_cfg = EngineConfig()     # run_sweep builds its own, the default
    ticks = SWEEP_TOTAL * SWEEP_PERIODS * sweep_cfg.cascade.mpc_every
    print(f"  {ticks / wall:.1f} "
          f"ticks/s, wall {wall:.2f} s; launches {counts}; {summary}  "
          f"[{smi}]", flush=True)
    differing = [k for k in METRIC_KEYS if not np.array_equal(
        whole.metrics[k].view(np.uint32), resumed.metrics[k].view(np.uint32))]
    check(whole.cursor == SWEEP_TOTAL and stopped_at == SWEEP_CHUNK
          and resumed.cursor == SWEEP_TOTAL and reloaded.cursor == SWEEP_TOTAL,
          "sweep: cursors of the whole, the stopped and the resumed run")
    check(all(np.isfinite(whole.metrics[k]).all() for k in METRIC_KEYS),
          "sweep: every stored metric finite (no padding, no NaN left)")
    check(not differing, "sweep: interrupted and resumed run equals the "
          f"uninterrupted one bit for bit (differing metrics: {differing})")
    check(all(np.array_equal(reloaded.metrics[k].view(np.uint32),
                             resumed.metrics[k].view(np.uint32))
              for k in METRIC_KEYS),
          "sweep: the last checkpoint holds the finished table")
    expect = expected_launches(
        sweep_cfg, SWEEP_TOTAL // SWEEP_CHUNK * SWEEP_PERIODS,
        sweep_cfg.solver.wbc_backend)[1]
    check(counts == expect, f"sweep: kernel launches are {expect}")
    check(summary["upright_frac"] == 1.0,
          "sweep: every scenario upright after its 60 ms")

    print(f"== total {time.time() - t_script:.1f} s", flush=True)
    if FAILURES:
        print("chip_smoke FAILED:", *FAILURES, sep="\n  ", file=sys.stderr)
        return 1

    # no single PyTorch call computes any of these functions: library_ms null
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", library_ms=None, **r)
        for name, r in reports.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
