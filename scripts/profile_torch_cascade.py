#!/usr/bin/env python3
"""Where one MPC period of the PyTorch port spends its time on the GPU.

    python3 scripts/profile_torch_cascade.py [--batch 4096] [--out DIR]
                                             [--wbc-backend torch fused ...]
                                             [--mpc-backend pallas]
                                             [--estimator]

Needs a CUDA device (it fails without one).  For each batch size it

  1. rolls two periods of closed-loop trot from standing (warm-up: builds the
     kernel, fills the constant caches, reaches a mid-gait state);
  2. times the stages of the next period by calling the port's public
     functions on that state, each ended by a synchronize: footstep plan +
     MPC QP assembly, the MPC solve (kernel backend and plain backend), the
     WBC QP assembly alone, one WBC tick (QP assembly + solve) with each WBC
     backend asked for, one plant step; with --mpc-backend also the MPC
     solve on that backend, with --estimator also one estimator tick (IMU
     model + filter update);
  3. for each WBC backend, times one whole period (wall clock, synchronized)
     and traces one more with torch.profiler: number of device kernels
     launched, launches of the port's own kernels, the device's busy time
     and idle share, and the ten kernels with the most device time.  With
     --estimator the period runs on the estimated state (hint-free filter in
     the loop), with --mpc-backend its MPC stage runs on that backend.

Prints one JSON object per batch size; with --out also writes it to
DIR/profile_torch_cascade.json.  The card's name and power limit are in it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from mpctsid_tpu_torch import dyn  # noqa: E402
from mpctsid_tpu_torch.cascade import (CascadeConfigured,  # noqa: E402
                                       cascade_period, init_controller,
                                       srb_state)
from mpctsid_tpu_torch.config import EngineConfig  # noqa: E402
from mpctsid_tpu_torch.env.plant import (ContactParams, PlantState,  # noqa: E402
                                         plant_step)
from mpctsid_tpu_torch.est.filter import (estimator_init,  # noqa: E402
                                          estimator_tick)
from mpctsid_tpu_torch.model.gaits import GAIT_IDS  # noqa: E402
from mpctsid_tpu_torch.model.solo12 import SOLO12  # noqa: E402
from mpctsid_tpu_torch.mpc.srb import (MPC_A_BLOCKS, build_mpc_qp,  # noqa: E402
                                       reference_rollout)
from mpctsid_tpu_torch.plan import (contacts_at,  # noqa: E402
                                    contacts_horizon,
                                    plan_footsteps_horizon)
from mpctsid_tpu_torch.qp import kernels  # noqa: E402
from mpctsid_tpu_torch.qp.admm import admm_solve  # noqa: E402
from mpctsid_tpu_torch.wbc.tsid import (WbcRefs, build_wbc_qp,  # noqa: E402
                                        solve_wbc)

OWN_KERNELS = (kernels.admm_iterate_m2, kernels.admm_iterate_vpu,
               kernels.admm_iterate_vpu_packed, kernels.admm_solve_fused,
               kernels.admm_iterate)


def timed(fn, reps: int = 3) -> float:
    """Median wall milliseconds of fn(), each run ended by a synchronize."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


def profile_batch(B: int, device, wbc_backends, mpc_backend=None,
                  use_estimator: bool = False) -> dict:
    cfg = EngineConfig(gait="trot", v_ref=(0.3, 0.0, 0.0))
    cc = CascadeConfigured(SOLO12, cfg)
    q0 = np.zeros((B, 19), np.float32)
    q0[:, 2] = SOLO12.h_ref
    q0[:, 6] = 1.0
    q0[:, 7:] = SOLO12.q_stand
    gid_np = np.full((B,), GAIT_IDS["trot"], np.int32)
    ctl = init_controller(SOLO12, cfg, cc.tree, q0, gid_np, device=device)
    plant = PlantState.init(q0, device=device)
    cp = ContactParams.default(B, device=device)
    cp.mu = torch.as_tensor(
        np.random.default_rng(0).uniform(0.5, 0.9, size=B),
        dtype=torch.float32).to(device)
    v_np = np.tile(np.asarray(cfg.v_ref, np.float32), (B, 1))
    gid = torch.as_tensor(gid_np).to(device)
    v = torch.as_tensor(v_np).to(device)
    est = estimator_init(q0, device=device) if use_estimator else None
    for _ in range(2):
        ctl, plant, est, _ = cascade_period(cc, ctl, plant, gid, v, cp,
                                            est=est,
                                            use_estimator=use_estimator)
    dtype = plant.q.dtype
    N = cfg.mpc.horizon

    # ---- stages of one period, on the warm state
    x_srb = srb_state(plant.q, plant.v)
    feet_now = dyn.foot_positions(cc.tree, plant.q)

    def assemble():
        fsteps, _ = plan_footsteps_horizon(SOLO12, cfg.mpc, cfg.cascade, gid,
                                           ctl.phase, x_srb, v, feet_now)
        x_ref = reference_rollout(SOLO12, cfg.mpc, x_srb, v)
        cont_h = contacts_horizon(gid, ctl.phase, N, dtype)
        return build_mpc_qp(SOLO12, cfg.mpc, x_srb, x_ref, fsteps, cont_h)

    qp = assemble()

    def mpc(backend):
        return admm_solve(*qp, x0=ctl.mpc_warm_x, y0=ctl.mpc_warm_y,
                          iters=cfg.solver.mpc_iters,
                          adapt_rounds=cfg.solver.mpc_adapt_rounds, rho=0.1,
                          backend=backend, a_blocks=MPC_A_BLOCKS)

    contacts = contacts_at(gid, ctl.phase, dtype)
    refs = WbcRefs(
        contacts=contacts, f_mpc=ctl.f_plan[:, 1] * contacts[..., None],
        foot_pos_ref=feet_now, foot_vel_ref=torch.zeros_like(feet_now),
        foot_acc_ref=torch.zeros_like(feet_now),
        q_posture=plant.q[:, 7:], base_rpy_ref=plant.q.new_zeros((B, 2)),
        h_ref=plant.q.new_full((B,), SOLO12.h_ref))

    def wbc(backend):
        return solve_wbc(cc.tree, cfg.wbc, plant.q, plant.v, refs,
                         iters=cfg.solver.wbc_iters,
                         adapt_rounds=cfg.solver.wbc_adapt_rounds,
                         warm_x=ctl.wbc_warm_x, warm_y=ctl.wbc_warm_y,
                         backend=backend)

    tau = plant.q.new_zeros((B, 12))
    stages = {
        "plan_and_mpc_qp_ms": timed(assemble),
        "mpc_solve_m2_ms": timed(lambda: mpc("m2")),
        "mpc_solve_plain_ms": timed(lambda: mpc("torch")),
        "wbc_qp_assembly_ms": timed(lambda: build_wbc_qp(
            cc.tree, cfg.wbc, plant.q, plant.v, refs)),
        "wbc_tick_ms": {b: timed(lambda: wbc(b)) for b in wbc_backends},
        "plant_step_ms": timed(lambda: plant_step(cc.tree, plant, tau,
                                                  params=cp)),
    }
    if mpc_backend is not None:
        stages["mpc_solve_ms"] = {mpc_backend: timed(lambda: mpc(mpc_backend))}
    if use_estimator:
        stages["estimator_tick_ms"] = timed(lambda: estimator_tick(
            cc.tree, est, plant.q, plant.v, contacts,
            dt=cfg.cascade.wbc_dt))
    del qp
    torch.cuda.empty_cache()

    # ---- one whole period per WBC backend: wall clock, then a profiler trace
    from torch.profiler import ProfilerActivity, profile

    def profile_period(backend):
        def period():
            return cascade_period(cc, ctl, plant, gid, v, cp, est=est,
                                  use_estimator=use_estimator,
                                  mpc_backend=mpc_backend,
                                  wbc_backend=backend)

        period_ms = timed(period, reps=2)
        before = [f.launches for f in OWN_KERNELS]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            period()
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3
        own = {f.__name__: f.launches - b
               for f, b in zip(OWN_KERNELS, before)}
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.device_time_total for e in events)
        launches = sum(e.count for e in events)
        top = sorted(events, key=lambda e: -e.device_time_total)[:10]
        return {
            "period_wall_ms": period_ms,
            "ticks_per_s": B * cfg.cascade.mpc_every / (period_ms / 1e3),
            "stage_sum_ms": (
                stages["plan_and_mpc_qp_ms"]
                + (stages["mpc_solve_m2_ms"] if mpc_backend is None
                   else stages["mpc_solve_ms"][mpc_backend])
                + cfg.cascade.mpc_every * (
                    stages["wbc_tick_ms"][backend] + stages["plant_step_ms"]
                    + stages.get("estimator_tick_ms", 0.0))),
            "traced_period_wall_ms": traced_ms,
            "device_kernels_launched": launches,
            "own_kernel_launches": own,
            "device_busy_ms": busy_us / 1e3,
            "device_idle_share_of_untraced_wall": (
                None if not launches else 1.0 - busy_us / 1e3 / period_ms),
            "top_kernels_by_device_ms": [
                {"name": e.key[:80], "count": e.count,
                 "device_ms": e.device_time_total / 1e3} for e in top],
        }

    return {"batch": B, "mpc_backend": mpc_backend or cfg.solver.mpc_backend,
            "estimator": use_estimator, "stages": stages,
            "periods": {b: profile_period(b) for b in wbc_backends}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch", type=int, nargs="+", default=[4096, 1])
    ap.add_argument("--wbc-backend", nargs="+", default=["torch"],
                    help="WBC backends to time (qp/admm.py names), e.g. "
                         "torch fused packed vpu pallas")
    ap.add_argument("--mpc-backend", default=None,
                    help="MPC backend of the whole periods (default: the "
                         "config's, the M2 kernel), e.g. pallas")
    ap.add_argument("--estimator", action="store_true",
                    help="run the periods on the estimated state "
                         "(complementary filter in the loop, hint-free)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: this script measures the GPU only",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    result = {"card": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda,
              "batches": [profile_batch(B, device, args.wbc_backend,
                                        args.mpc_backend, args.estimator)
                          for B in args.batch]}
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        (Path(args.out) / "profile_torch_cascade.json").write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
