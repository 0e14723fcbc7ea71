#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for sm_90a).

    python3 chip_smoke.py

Drives `mpctsid_tpu_torch` end to end on the card and fails (non-zero exit,
no result line) if any phase fails.  It needs a CUDA device and the CUDA
toolkit (`nvcc`); there is no CPU fallback.  Phases:

  1. device   card name and power limit (nvidia-smi), torch/CUDA versions,
              the asserted full-f32 matmul settings
  2. build    builds the M2 iteration kernel from mpctsid_tpu_torch/qp/csrc
  3. kernel   the kernel against its plain PyTorch version on the card, same
              inputs (numpy seed): MPC shape (B=64, n=192, m=320), the test
              shape (B=3, n=24, m=40), B=1 and a WBC-sized odd shape (B=5,
              n=30, m=50) and the main path's shape (B=4096, 192, 320), 30
              iterations, max-abs error of x, z, y under 1e-4; then kernel
              time, plain time and the card's bound at the main path's shape
  4. rollout  the main path at full size: cascade_rollout of the preset
              config4_cascade_4k (B=4096 trot, v = 0.3 m/s), per-scenario
              friction in [0.5, 0.9], default solver budgets, MPC backend =
              the kernel; checks finiteness, mpc_ok, wbc_ok_frac, base
              height, and that the kernel was launched periods x 2 times
  5. backends the kernel on the path against the plain path: B=256, two
              periods from the same state with mpc_backend "m2" and "torch"
  6. single   B=1, one period (the single-robot shape)

The line before the last is one JSON object describing every kernel of the
path; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from mpctsid_tpu_torch.cascade import (CascadeConfigured, cascade_rollout,
                                       init_controller)
from mpctsid_tpu_torch.config import PRESETS
from mpctsid_tpu_torch.env.plant import ContactParams, PlantState
from mpctsid_tpu_torch.model.gaits import GAIT_IDS
from mpctsid_tpu_torch.model.solo12 import SOLO12
from mpctsid_tpu_torch.qp import _build, kernels
from mpctsid_tpu_torch.utils import enforce_f32_matmuls

# Published peaks of one H100 SXM (NVIDIA data sheet): the yardstick of the
# bound, whatever the power limit of the card at hand (printed beside it).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

KERNEL_TOL = 1e-4      # abs, x/z/y on unit-scaled random QPs after 30
                       # iterations: same arithmetic, other summation order
ROLLOUT_PERIODS = 5    # 100 WBC ticks per scenario
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

def m2_inputs(seed: int, B: int, n: int, m: int, device):
    """Unit-scaled inequality-only random QPs (numpy, seeded) and the M2 /
    rho / warm iterates the solver would hand the kernel."""
    r = np.random.default_rng(seed)
    Q = r.normal(size=(B, n, n))
    P = Q @ Q.transpose(0, 2, 1) / n + 0.1 * np.eye(n)
    q = r.normal(size=(B, n))
    A = r.normal(size=(B, m, n))
    x_feas = r.normal(size=(B, n)) * 0.1
    margin = np.abs(r.normal(size=(B, m))) + 0.1
    Ax = np.einsum("bmn,bn->bm", A, x_feas)
    l, u = Ax - margin, Ax + margin
    rho = 0.1 * (1.0 + r.uniform(size=(B, m)))
    x = r.normal(size=(B, n)) * 0.1
    y = r.normal(size=(B, m)) * 0.1
    z = np.clip(np.einsum("bmn,bn->bm", A, x), l, u)
    dev = lambda a, dt=torch.float32: torch.as_tensor(a).to(device, dt)  # noqa: E731
    # M2 = 2 K^-1 - K^-1 K K^-1 of K = P + sigma I + A' rho A, in float64 on
    # the card, rounded to float32 (left as unsymmetric as rounding makes it)
    A64, P64, rho64 = dev(A, torch.float64), dev(P, torch.float64), dev(
        rho, torch.float64)
    K = P64 + 1e-6 * torch.eye(n, dtype=torch.float64, device=device) \
        + torch.bmm((A64 * rho64[:, :, None]).transpose(1, 2), A64)
    Ki = torch.linalg.inv(K)
    M2 = (2.0 * Ki - Ki @ K @ Ki).float().contiguous()
    return [M2] + [dev(a).contiguous() for a in (A, q, l, u, rho, x, z, y)]


def compare_kernel(name: str, args, iters: int = 30) -> float:
    kw = dict(iters=iters, sigma=1e-6, alpha=1.6)
    got = kernels.admm_iterate_m2(*args, **kw)
    torch.cuda.synchronize()
    want = kernels.admm_iterate_m2_reference(*args, **kw)
    errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    B, n = args[0].shape[:2]
    m = args[1].shape[1]
    print(f"  {name}: B={B} n={n} m={m} iters={iters} max|dx|={errs[0]:.3e} "
          f"max|dz|={errs[1]:.3e} max|dy|={errs[2]:.3e}", flush=True)
    check(finite and max(errs) < KERNEL_TOL,
          f"kernel vs plain, {name}: max abs err {max(errs):.3e} < "
          f"{KERNEL_TOL:g}")
    return max(errs)


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


def m2_bound_ms(B: int, n: int, m: int, iters: int):
    """Least time the card could take: every input read once and every output
    written once against the memory rate, iters * (4 m n + 2 n^2) flops per
    scenario against the f32 FMA peak; the larger of the two."""
    floats = B * (n * n + m * n + 2 * n + 5 * m      # M2, A, q, x, l u rho z y
                  + n + 2 * m)                       # x, z, y written
    bytes_ms = 4.0 * floats / HBM_BYTES_PER_S * 1e3
    flops_ms = B * iters * (4.0 * m * n + 2.0 * n * n) / F32_FLOP_PER_S * 1e3
    return ((bytes_ms, "bytes") if bytes_ms >= flops_ms
            else (flops_ms, "operations")), bytes_ms, flops_ms


# ---------------------------------------------------------------- main path

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
    kernels._library()
    print(f"  admm_m2: nvcc {' '.join(_build.NVCC_FLAGS)}  ->  "
          f"{_build.build_dir()}")
    print(f"  build+load {time.time() - t0:.2f} s "
          f"(nvcc {_build.BUILD_SECONDS['admm_m2']:.2f} s)", flush=True)

    # ---- 3. kernel vs plain --------------------------------------------
    print("== 3. kernel vs plain PyTorch version, on the card", flush=True)
    mpc_args = m2_inputs(0, 64, 192, 320, device)
    errs = [compare_kernel("mpc shape", mpc_args),
            compare_kernel("test shape", m2_inputs(1, 3, 24, 40, device)),
            compare_kernel("single", m2_inputs(2, 1, 192, 320, device)),
            compare_kernel("wbc-sized, odd", m2_inputs(3, 5, 30, 50, device))]

    # the main path's own shape: the 64 scenarios tiled to B = 4096 (every
    # scenario has its own memory; the kernel's time does not depend on the
    # values), compared once more and then timed
    Bt, n, m, iters = 4096, 192, 320, 30
    big = [a.repeat((Bt // a.shape[0],) + (1,) * (a.dim() - 1)).contiguous()
           for a in mpc_args]
    errs.append(compare_kernel("main path shape", big, iters=iters))
    max_abs_err = max(errs)
    kw = dict(iters=iters, sigma=1e-6, alpha=1.6)
    kernel_ms = time_ms(lambda: kernels.admm_iterate_m2(*big, **kw), 1, 3)
    plain_ms = time_ms(
        lambda: kernels.admm_iterate_m2_reference(*big, **kw), 1, 2)
    (bound_ms, bound_by), bytes_ms, flops_ms = m2_bound_ms(Bt, n, m, iters)
    del big
    torch.cuda.empty_cache()
    print(f"  B={Bt} n={n} m={m} iters={iters}: kernel {kernel_ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms by {bound_by} "
          f"(bytes {bytes_ms:.3f} ms at {HBM_BYTES_PER_S / 1e12:.2f} TB/s, "
          f"flops {flops_ms:.3f} ms at {F32_FLOP_PER_S / 1e12:.0f} TFLOP/s "
          f"f32)  [{smi}]", flush=True)

    # ---- 4. main path at full size -------------------------------------
    print("== 4. main path: cascade_rollout, preset config4_cascade_4k",
          flush=True)
    cfg = PRESETS["config4_cascade_4k"]
    B = cfg.batch
    cc, ctl, plant, gid, v, cp = make_scenarios(cfg, B, seed=0, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.admm_iterate_m2.launches = 0
    t0 = time.time()
    ctl, plant, metrics = cascade_rollout(
        cc, ctl, plant, gid, v, cp, n_periods=ROLLOUT_PERIODS, device=device)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = kernels.admm_iterate_m2.launches
    ticks = B * ROLLOUT_PERIODS * cfg.cascade.mpc_every
    x = metrics["x_srb"]
    finite = all(bool(torch.isfinite(t).all()) for t in
                 (plant.q, plant.v, ctl.f_plan, x, metrics["tau_rms"]))
    dz = float((x[:, :, 2] - SOLO12.h_ref).abs().max())
    wbc_ok = float(metrics["wbc_ok_frac"].mean())
    print(f"  B={B} gait={cfg.gait} v_ref={cfg.v_ref} periods="
          f"{ROLLOUT_PERIODS} mpc {cfg.solver.mpc_iters}/"
          f"{cfg.solver.mpc_adapt_rounds} wbc {cfg.solver.wbc_iters}/"
          f"{cfg.solver.wbc_adapt_rounds} mpc_backend="
          f"{cfg.solver.mpc_backend}")
    print(f"  {ticks / wall:.1f} ticks/s, {wall / ROLLOUT_PERIODS:.3f} s per "
          f"period, wall {wall:.2f} s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  [{smi}]")
    print(f"  kernel launches {launches}; max |z - h_ref| {dz:.4f} m; "
          f"wbc_ok_frac {wbc_ok:.4f}; mean mpc dual res "
          f"{float(metrics['mpc_dual_res'].mean()):.3e}; mean x after "
          f"{ROLLOUT_PERIODS} periods {float(plant.q[:, 0].mean()):+.4f} m",
          flush=True)
    check(tuple(x.shape) == (B, ROLLOUT_PERIODS, 12), "metrics shape")
    check(finite, "rollout: everything finite")
    check(bool(metrics["mpc_ok"].all()), "rollout: mpc_ok all true")
    check(wbc_ok >= 0.99, "rollout: wbc_ok_frac >= 0.99")
    check(dz < 0.03, "rollout: base height within 0.03 m of h_ref, every "
                     "scenario and period")
    check(launches == ROLLOUT_PERIODS * cfg.solver.mpc_adapt_rounds,
          f"rollout: kernel launched periods x adapt rounds = "
          f"{ROLLOUT_PERIODS * cfg.solver.mpc_adapt_rounds} times")
    del ctl, plant, metrics, x
    torch.cuda.empty_cache()

    # ---- 5. kernel on the path vs plain on the path --------------------
    print("== 5. mpc_backend 'm2' (kernel) vs 'torch' (plain), B=256",
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

    # ---- 6. B = 1 --------------------------------------------------------
    print("== 6. single robot, B=1, one period", flush=True)
    cfg1 = PRESETS["config1_trot_single"]
    cc, ctl, plant, gid, v, cp = make_scenarios(cfg1, 1, seed=2, device=device)
    before = kernels.admm_iterate_m2.launches
    t0 = time.time()
    ctl, plant, metrics = cascade_rollout(cc, ctl, plant, gid, v, cp,
                                          n_periods=1, device=device)
    torch.cuda.synchronize()
    print(f"  one period {time.time() - t0:.3f} s; launches "
          f"{kernels.admm_iterate_m2.launches - before}", flush=True)
    check(bool(torch.isfinite(plant.q).all() and torch.isfinite(plant.v).all()
               and torch.isfinite(ctl.f_plan).all()), "B=1: finite")
    check(bool(metrics["mpc_ok"].all()), "B=1: mpc_ok")
    check(kernels.admm_iterate_m2.launches - before
          == cfg1.solver.mpc_adapt_rounds, "B=1: kernel launched")

    print(f"== total {time.time() - t_script:.1f} s", flush=True)
    if FAILURES:
        print("chip_smoke FAILED:", *FAILURES, sep="\n  ", file=sys.stderr)
        return 1

    print(json.dumps({"kernels": [{
        "name": "admm_iterate_m2",
        "route": "cuda",
        "source": "mpctsid_tpu_torch/qp/csrc/admm_m2.cu",
        "replaces": "mpctsid_tpu/qp/pallas_kernels.py:440",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        # no single PyTorch call computes this function
        "library_ms": None,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
