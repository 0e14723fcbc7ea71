#!/usr/bin/env python3
"""The device events of one replay of a captured period, by name.

    python3 scripts/period_kernel_census.py [--batch 4096] [--wbc-backend xla]
        [--mpc-backend auto_mpc] [--estimator] [--timed N] [--root DIR]
        [--out FILE]

Captures `cascade_period` of the preset config4_cascade_4k (trot) at the
given batch with chip_smoke.py's runner (`period_runner`, as phase 12
does; with --estimator on the hint-free estimate, as phase 12's estimator
configuration), replays it once to warm up, then profiles one replay in a
fresh process and prints every device event (kernels, copies, memsets)
with its count and its device ms, and the totals; with --timed N also the
wall ms of N more replays, each ended by a synchronize, and their median.
Run it from two checkouts in one call on the same card and diff the
outputs to see what a change adds to or takes out of a period (phase 12's
count is taken late in a long process, where the profiler's records vary
by a few); --root DIR takes chip_smoke.py and the package from the
checkout at DIR (an older one, unpacked by `git archive`) in place of this
script's own.  Needs an NVIDIA GPU (exits 2 without one); the first line
names the card and its power limit.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys

import time

import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--wbc-backend", default="xla")
    ap.add_argument("--mpc-backend", default=None)
    ap.add_argument("--estimator", action="store_true")
    ap.add_argument("--timed", type=int, default=0)
    ap.add_argument("--root", default=None)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    root = a.root or os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))
    sys.path.insert(0, os.path.abspath(root))
    import chip_smoke as cs
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    cs.enforce_f32_matmuls()
    cfg = cs.PRESETS["config4_cascade_4k"]
    cc, ctl, plant, gid, v, cp = cs.make_scenarios(cfg, a.batch, seed=4,
                                                   device=device)
    gid_t = torch.as_tensor(gid).to(device)
    v_t = torch.as_tensor(v).to(device)
    est = (cs.estimator_init(cs.standing(a.batch), device=device)
           if a.estimator else None)
    runner = cs.period_runner(cc, ctl, plant, gid_t, cp, est=est,
                              use_estimator=a.estimator, device=device,
                              wbc_backend=a.wbc_backend,
                              mpc_backend=a.mpc_backend)
    runner.load(ctl, plant, gid_t, cp, est=est)
    runner(v_t)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        runner(v_t)
        torch.cuda.synchronize()
        cs.flush_cupti()
    names, ms = collections.Counter(), collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            names[e.name] += 1
            ms[e.name] += e.time_range.elapsed_us() / 1e3
    walls = []
    for _ in range(a.timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner(v_t)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    lines = [f"[{cs.nvidia_smi_line()}] {os.path.abspath(cs.__file__)} "
             f"B={a.batch} wbc_backend={a.wbc_backend} mpc_backend="
             f"{a.mpc_backend} estimator={a.estimator}: "
             f"{sum(names.values())} device events in one replay, "
             f"{sum(ms.values()):.3f} device ms"]
    if walls:
        lines.append(f"graphed period wall ms, median of {len(walls)}: "
                     f"{sorted(walls)[len(walls) // 2]:.3f} ({walls})")
    lines += [f"{c:6d} {ms[name]:10.4f} {name}"
              for name, c in sorted(names.items())]
    text = "\n".join(lines) + "\n"
    print(text, end="")
    if a.out:
        with open(a.out, "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
