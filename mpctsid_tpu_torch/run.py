"""Entry script: run the closed-loop cascade in simulation from the CLI.

    python -m mpctsid_tpu_torch.run --gait trot --vx 0.3 --seconds 2
    python -m mpctsid_tpu_torch.run --gait walk --profile weave --estimator \\
        --jsonl run.jsonl --plot run.png --batch 16
    python -m mpctsid_tpu_torch.run --cpu --seconds 0.2

Runs on the GPU unless --cpu is given, and fails if there is none.  Metrics
accumulate on the device and cross to the host once per run; they are
optionally emitted as JSONL per MPC period plus a matplotlib summary plot.
--estimator puts the complementary filter (est/filter.py) in the loop."""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--gait", default="trot",
                   choices=["trot", "walk", "bound", "static", "pace"])
    p.add_argument("--vx", type=float, default=0.3)
    p.add_argument("--vy", type=float, default=0.0)
    p.add_argument("--wz", type=float, default=0.0)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--profile", default="constant",
                   choices=["constant", "ramp", "weave"])
    p.add_argument("--estimator", action="store_true",
                   help="run the complementary filter in the loop")
    p.add_argument("--batch", type=int, default=1,
                   help="number of identical scenarios (throughput check)")
    p.add_argument("--mu", type=float, default=0.7, help="ground friction")
    p.add_argument("--jsonl", default=None, help="write per-period metrics")
    p.add_argument("--plot", default=None, help="write a summary plot PNG")
    p.add_argument("--cpu", action="store_true", help="force CPU")
    args = p.parse_args(argv)

    from mpctsid_tpu_torch import command
    from mpctsid_tpu_torch.cascade import (CascadeConfigured, cascade_rollout,
                                           init_controller)
    from mpctsid_tpu_torch.config import EngineConfig
    from mpctsid_tpu_torch.env.plant import ContactParams, PlantState
    from mpctsid_tpu_torch.est.filter import estimator_init
    from mpctsid_tpu_torch.model.gaits import GAIT_IDS
    from mpctsid_tpu_torch.model.solo12 import SOLO12
    from mpctsid_tpu_torch.utils import resolve_device

    device = resolve_device("cpu" if args.cpu else "cuda")

    model = SOLO12
    cfg = EngineConfig(gait=args.gait, v_ref=(args.vx, args.vy, args.wz))
    cc = CascadeConfigured(model, cfg)
    n_periods = max(int(round(args.seconds / cfg.mpc.dt)), 1)
    B = max(args.batch, 1)

    if args.profile == "constant":
        v_seq = command.constant(n_periods, args.vx, args.vy, args.wz)
    elif args.profile == "ramp":
        v_seq = command.ramp(n_periods, (args.vx, args.vy, args.wz),
                             t_ramp_periods=n_periods // 3)
    else:
        v_seq = command.weave(n_periods, vx=args.vx)

    q0 = np.zeros((B, 19), np.float32)
    q0[:, 2] = model.h_ref
    q0[:, 6] = 1.0
    q0[:, 7:] = model.q_stand
    gid = np.full((B,), GAIT_IDS[args.gait], np.int32)
    ctl = init_controller(model, cfg, cc.tree, q0, gid, device=device)
    plant = PlantState.init(q0, device=device)
    est = estimator_init(q0, device=device) if args.estimator else None
    cp = ContactParams.default(B, device=device)
    cp.mu = torch.full_like(cp.mu, args.mu)
    vs = np.broadcast_to(v_seq, (B,) + v_seq.shape)

    t0 = time.time()
    ctl, plant, metrics = cascade_rollout(
        cc, ctl, plant, gid, np.ascontiguousarray(vs), cp,
        n_periods=n_periods, est=est, use_estimator=args.estimator,
        device=device)
    # the one device -> host transfer of the run (it also waits for the device)
    metrics_np = {k: v[0].cpu().numpy() for k, v in metrics.items()}
    wall = time.time() - t0
    x = metrics_np["x_srb"]

    fell = bool((x[:, 2] < 0.12).any())
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"gait={args.gait} profile={args.profile} periods={n_periods} "
          f"batch={B} estimator={args.estimator} device={where}")
    print(f"  wall {wall:.1f}s | "
          f"{B * n_periods * cfg.cascade.mpc_every / wall:,.0f} "
          f"ticks/s")
    print(f"  final pos ({x[-1, 0]:+.3f}, {x[-1, 1]:+.3f}) m | "
          f"height {x[-1, 2]:.3f} m | mean vx {x[n_periods // 3:, 6].mean():+.3f} "
          f"(cmd {args.vx}) | fell={fell}")

    if args.jsonl:
        with open(args.jsonl, "w") as f:
            for k in range(n_periods):
                f.write(json.dumps({
                    "period": k, "t": k * cfg.mpc.dt,
                    "x_srb": metrics_np["x_srb"][k].tolist(),
                    "tau_rms": float(metrics_np["tau_rms"][k]),
                    "fz_sum": float(metrics_np["fz_sum"][k]),
                    "mpc_prim_res": float(metrics_np["mpc_prim_res"][k]),
                }) + "\n")
        print(f"  wrote {args.jsonl}")

    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        t = np.arange(n_periods) * cfg.mpc.dt
        fig, axes = plt.subplots(2, 2, figsize=(10, 6))
        axes[0, 0].plot(t, x[:, 6], label="vx")
        axes[0, 0].plot(t, v_seq[:, 0], "--", label="vx cmd")
        axes[0, 0].set_title("forward velocity [m/s]")
        axes[0, 0].legend()
        axes[0, 1].plot(t, x[:, 2])
        axes[0, 1].axhline(SOLO12.h_ref, ls="--", c="gray")
        axes[0, 1].set_title("base height [m]")
        axes[1, 0].plot(t, x[:, 3], label="roll")
        axes[1, 0].plot(t, x[:, 4], label="pitch")
        axes[1, 0].set_title("attitude [rad]")
        axes[1, 0].legend()
        axes[1, 1].plot(t, metrics_np["fz_sum"])
        axes[1, 1].axhline(SOLO12.total_mass * 9.81, ls="--", c="gray")
        axes[1, 1].set_title("total normal force [N]")
        fig.tight_layout()
        fig.savefig(args.plot, dpi=110)
        print(f"  wrote {args.plot}")

    return 1 if fell else 0


if __name__ == "__main__":
    sys.exit(main())
