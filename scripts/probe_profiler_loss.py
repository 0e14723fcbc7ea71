#!/usr/bin/env python3
"""How many of a graph replay's device events the profiler reports as the
process ages, with and without a forced CUPTI flush.

    python3 scripts/probe_profiler_loss.py [--seconds 300] [--every 12]

Captures one B = 1 MPC solve on backend `fused` (kernel 4's block path, the
kernel near the end of the replay) as a CUDA graph (the bench's
`_solve_chain`), then every `--every` seconds profiles one replay four ways
and prints, per way, the device events the profiler returned and whether
kernel 4 is among them:

  plain  the replay, a synchronize, the window closes;
  flush  the same, then `cuptiActivityFlushAll(1)` (chip_smoke.py's
         `flush_cupti`) before the window closes;
  wait   the same as plain with a 0.25 s host wait before and after;
  spin   the same as wait with a spin kernel (`torch.cuda._sleep`) after the
         replay, so that the replay's kernels are not the window's last.

Between probes the card runs B = 1024 graphed periods, as chip_smoke.py's
later phases keep it busy.  Needs a CUDA device; prints the card's name and
power limit first.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import flush_cupti  # noqa: E402
from mpctsid_tpu_torch import bench  # noqa: E402
from mpctsid_tpu_torch.cascade import cascade_rollout_graphed  # noqa: E402
from mpctsid_tpu_torch.config import EngineConfig  # noqa: E402
from mpctsid_tpu_torch.qp import kernels  # noqa: E402
from mpctsid_tpu_torch.utils import enforce_f32_matmuls  # noqa: E402

WAYS = ("plain", "flush", "wait", "spin")


def profiled_events(call, way: str) -> list:
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    margin = 0.25 if way in ("wait", "spin") else 0.0
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        time.sleep(margin)
        call()
        if way == "spin":
            torch.cuda._sleep(100_000_000)
        torch.cuda.synchronize()
        time.sleep(margin)
        if way == "flush":
            flush_cupti()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "spin" not in e.name]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seconds", type=float, default=300.0)
    ap.add_argument("--every", type=float, default=12.0)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_profiler_loss: needs a CUDA device", file=sys.stderr)
        return 2
    t_start = time.time()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    enforce_f32_matmuls()
    print(bench.nvidia_smi_line(), flush=True)
    kernels.build_all()
    cfg = EngineConfig(gait="trot", v_ref=(0.3, 0.0, 0.0))
    cc, args = bench.build_batch(cfg, 1, device=dev)
    call, make_run = bench._solve_chain(
        bench._mpc_qp_batch(cc, args), "fused", cfg.solver.mpc_iters,
        cfg.solver.mpc_adapt_rounds, "MPC solve chain (fused, B=1)")
    make_run(1)().item()
    ccb, argsb = bench.build_batch(cfg, 1024, device=dev)
    t0 = time.time()
    try:
        while time.time() - t0 < a.seconds:
            line = []
            for way in WAYS:
                names = profiled_events(call, way)
                seen = any("admm_fused_" in n for n in names)
                line.append(f"{way} {len(names)} events, kernel 4 {seen}")
            print(f"process age {time.time() - t_start:6.1f} s: "
                  + "; ".join(line), flush=True)
            t1 = time.time()
            while time.time() - t1 < a.every:
                cascade_rollout_graphed(ccb, *argsb, n_periods=10,
                                        device=dev)[2]["x_srb"].sum().item()
    finally:
        call.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
